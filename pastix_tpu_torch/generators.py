"""Test-matrix generators.

Equivalent of the reference's built-in Laplacian generator (the ``-lap N``
driver used by every example as the data-free smoke test; reference anchor
``src/matrix_drivers``/examples `get_options.c` — SURVEY.md section 2 row
17 and section 4).  Extended with the 3D Poisson and 3D elasticity
generators required by the BASELINE.md config ladder.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.sparse import SparseMatrix


def laplacian_1d(n: int, dtype=np.float64) -> SparseMatrix:
    """Tridiagonal [-1, 2, -1] — the reference's `-lap n` 1D matrix."""
    d = np.full(n, 2.0, dtype=dtype)
    e = np.full(n - 1, -1.0, dtype=dtype)
    A = sp.diags([e, d, e], [-1, 0, 1], format="csc")
    return SparseMatrix.from_scipy(A, symmetric_storage=True)


def laplacian_2d(nx: int, ny: int | None = None, dtype=np.float64) -> SparseMatrix:
    """2D 5-point Laplacian on an nx-by-ny grid (SPD). BASELINE config 1."""
    ny = ny or nx
    Ix, Iy = sp.eye(nx), sp.eye(ny)
    Tx = sp.diags(
        [np.full(nx - 1, -1.0), np.full(nx, 2.0), np.full(nx - 1, -1.0)], [-1, 0, 1]
    )
    Ty = sp.diags(
        [np.full(ny - 1, -1.0), np.full(ny, 2.0), np.full(ny - 1, -1.0)], [-1, 0, 1]
    )
    A = sp.kron(Iy, Tx) + sp.kron(Ty, Ix)
    return SparseMatrix.from_scipy(A.astype(dtype).tocsc(), symmetric_storage=True)


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None, dtype=np.float64) -> SparseMatrix:
    """3D 7-point Poisson on an nx*ny*nz grid (SPD). BASELINE config 2."""
    ny = ny or nx
    nz = nz or nx

    def T(m):
        return sp.diags(
            [np.full(m - 1, -1.0), np.full(m, 2.0), np.full(m - 1, -1.0)], [-1, 0, 1]
        )

    Ix, Iy, Iz = sp.eye(nx), sp.eye(ny), sp.eye(nz)
    A = (
        sp.kron(Iz, sp.kron(Iy, T(nx)))
        + sp.kron(Iz, sp.kron(T(ny), Ix))
        + sp.kron(T(nz), sp.kron(Iy, Ix))
    )
    return SparseMatrix.from_scipy(A.astype(dtype).tocsc(), symmetric_storage=True)


def elasticity_3d(nx: int, ny: int | None = None, nz: int | None = None, dtype=np.float64) -> SparseMatrix:
    """3D linear-elasticity-like SPD operator (3 dofs per grid node).

    A vector Laplacian with inter-component coupling — the standard stand-in
    for the >=10M-dof elasticity ladder rung (BASELINE config 5) when no
    FEM assembly is at hand; same 27-ish point coupling density per dof row.
    """
    ny = ny or nx
    nz = nz or nx
    L = poisson_3d(nx, ny, nz, dtype=dtype).to_scipy()
    # couple the 3 displacement components: block [[4,1,1],[1,4,1],[1,1,4]]/4
    C = np.array([[4.0, 1.0, 1.0], [1.0, 4.0, 1.0], [1.0, 1.0, 4.0]], dtype=dtype) / 4
    A = sp.kron(L, sp.csr_matrix(C)).tocsc()
    return SparseMatrix.from_scipy(A, symmetric_storage=True)


def convection_diffusion_3d(
    nx: int, ny: int | None = None, nz: int | None = None,
    peclet: float = 20.0, dtype=np.float64,
) -> SparseMatrix:
    """3D convection-diffusion, central differences: -lap(u) + v.grad(u).

    Nonsymmetric VALUES on the symmetric 7-point pattern — the standard
    CFD-class test for LU with static pivoting (BASELINE config 4 names
    atmosmodd-class matrices; this is the generated stand-in).  ``peclet``
    sets the convection strength per cell (v = peclet/2 on each axis)."""
    ny = ny or nx
    nz = nz or nx

    def TD(m, c):
        # 1D -u'' + c u' with central differences: sub = -1 - c/2,
        # diag = 2, super = -1 + c/2
        return sp.diags(
            [np.full(m - 1, -1.0 - c / 2), np.full(m, 2.0),
             np.full(m - 1, -1.0 + c / 2)],
            [-1, 0, 1],
        )

    c = peclet / max(nx, 1)
    Ix, Iy, Iz = sp.eye(nx), sp.eye(ny), sp.eye(nz)
    A = (
        sp.kron(Iz, sp.kron(Iy, TD(nx, c)))
        + sp.kron(Iz, sp.kron(TD(ny, c), Ix))
        + sp.kron(TD(nz, c), sp.kron(Iy, Ix))
    )
    return SparseMatrix.from_scipy(A.astype(dtype).tocsc())


def random_spd(n: int, density: float = 0.01, seed: int = 0, dtype=np.float64) -> SparseMatrix:
    """Random sparse SPD matrix (diagonally dominant) for property tests."""
    rng = np.random.default_rng(seed)
    m = max(1, int(density * n * n / 2))
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    v = rng.standard_normal(m).astype(dtype)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n))
    A = (A + A.T).tocsc()
    # make it SPD: diagonal dominance
    rowsum = np.abs(A).sum(axis=1).A.ravel()
    A = A + sp.diags(rowsum + 1.0)
    return SparseMatrix.from_scipy(A.tocsc().astype(dtype), symmetric_storage=True)


def random_unsym(n: int, density: float = 0.01, seed: int = 0, dtype=np.float64) -> SparseMatrix:
    """Random sparse diagonally-dominant unsymmetric matrix (for LU tests)."""
    rng = np.random.default_rng(seed)
    m = max(1, int(density * n * n))
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    v = rng.standard_normal(m).astype(dtype)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsc()
    rowsum = np.abs(A).sum(axis=1).A.ravel()
    A = A + sp.diags(rowsum + 1.0)
    return SparseMatrix.from_scipy(A.tocsc().astype(dtype), symmetric_storage=False)


def irregular_fem_3d(
    npts: int,
    dof_nbr: int = 3,
    grading: float = 2.5,
    seed: int = 0,
    dtype=np.float64,
) -> SparseMatrix:
    """Unstructured graded 3D FEM-graph SPD matrix (audikw_1/Fault_639
    stand-in — BASELINE ladder rung 3's *irregular* intent, built in-repo
    so that no SuiteSparse download is needed).

    ``npts`` mesh vertices are sampled with a graded density (points
    concentrate near a "contact" plane by the ``grading`` power, like
    refined zones of a crash/fault mesh), tetrahedralized with Delaunay,
    and assembled into a vector-valued (``dof_nbr`` dofs/vertex) SPD
    stiffness-like matrix: per-edge random SPSD couplings summed
    element-wise plus diagonal dominance.  The resulting graph has the
    hallmarks that separate real FEM matrices from grid Poisson:
    irregular vertex degrees (~14-18), graded cliques, and no tensor
    structure for the ordering to exploit.
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((npts, 3))
    # grade the z-coordinate toward the z=0 plane (refinement zone)
    pts[:, 2] = pts[:, 2] ** grading
    tri = Delaunay(pts)
    # vertex adjacency from tetrahedra edges
    t = tri.simplices  # (ntet, 4)
    pairs = np.concatenate(
        [t[:, [a, b]] for a in range(4) for b in range(a + 1, 4)]
    )
    i = np.minimum(pairs[:, 0], pairs[:, 1])
    j = np.maximum(pairs[:, 0], pairs[:, 1])
    key = i.astype(np.int64) * npts + j
    key = np.unique(key)
    i = (key // npts).astype(np.int64)
    j = (key % npts).astype(np.int64)
    ne = i.size
    d = dof_nbr
    # per-edge coupling block: -(w·I + u uᵀ)  (SPSD), so the assembled
    # matrix is a weighted vector graph Laplacian + dominance margin
    w = rng.uniform(0.5, 1.5, ne)
    u = rng.standard_normal((ne, d)) * 0.5
    blk = -(
        w[:, None, None] * np.eye(d)[None]
        + np.einsum("ei,ej->eij", u, u)
    )
    # scatter the d x d blocks
    bi = (i[:, None, None] * d + np.arange(d)[None, :, None]).repeat(d, 2)
    bj = (j[:, None, None] * d + np.arange(d)[None, None, :]).repeat(d, 1)
    rows = np.concatenate([bi.ravel(), bj.ravel()])
    cols = np.concatenate([bj.ravel(), bi.ravel()])
    vals = np.concatenate([blk.ravel(), np.transpose(blk, (0, 2, 1)).ravel()])
    n = npts * d
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    rowsum = np.abs(A).sum(axis=1).A.ravel() - np.abs(A.diagonal())
    A = A + sp.diags(rowsum + 1.0)
    return SparseMatrix.from_scipy(
        A.tocsc().astype(dtype), symmetric_storage=True
    )


def helmholtz_2d(
    nx: int, ny: int | None = None, k: float = 10.0, damping: float = 0.05,
) -> SparseMatrix:
    """2D Helmholtz operator -Δ - (k² + i·damping·k²) on the unit square.

    Complex *symmetric* (A = Aᵀ, not Hermitian) — the classic c/z workload
    for the complex-symmetric LDLᵀ path (absorbing media make it
    non-Hermitian but symmetric).
    """
    ny = ny or nx
    h2 = 1.0 / ((nx + 1) * (ny + 1))
    L = laplacian_2d(nx, ny).to_scipy().astype(np.complex128)
    n = L.shape[0]
    shift = (k * k + 1j * damping * k * k) * h2
    A = L - shift * sp.eye(n, format="csc")
    return SparseMatrix.from_scipy(sp.csc_matrix(A))
