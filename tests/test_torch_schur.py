"""The Schur-complement path of the port against the JAX reference, on the
CPU: ``set_schur_unknowns`` → ``factorize`` → ``get_schur`` /
``solve_with_schur``.

Cases (float32): laplacian_2d(12) with its last 17 dofs (not tile-aligned, as
``tests/test_pastix_api.py`` takes them) and poisson_3d(6) with its last
36, T=16, float32 factors.  Tolerances: with ``update_dtype=None`` the
port's S matches the reference's to 1e-4 max|S| (both fp32, the port all
left-looking with fp32 products, the reference right-looking with XLA
products) and the fp64 formula A22 - A21 A11^-1 A12 to 1e-5 max|S| (fp32
rounding); ``solve_with_schur`` reaches a fp64 residual <= 1e-10 and
agrees with the reference's x to 1e-8 relative (both refined to 1e-10, on
matrices of condition below 100).  fp64 pools (ROADMAP A3b): poisson_3d(8),
T=16, its last 64 unknowns, under LLᵗ, LDLᵗ and LU against the
reference's fp64 ``get_schur`` (1e-12 max|S|; bf16 updates 1e-2) and
``solve_with_schur`` to max|x - 1| <= 1e-10; a complex pool still
raises (the reference has no complex Schur).
"""

import numpy as np
import pytest

from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import laplacian_2d as j_laplacian_2d
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.pastix import Pastix as JPastix

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.convert import factors_from_jax
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.numeric import pipelined as PL
from pastix_tpu_torch.pastix import Pastix

import torch

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

CASES = {
    "laplacian_2d(12)": (laplacian_2d, j_laplacian_2d, 12, 17),
    "poisson_3d(6)": (poisson_3d, j_poisson_3d, 6, 36),
}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dense_schur(A, schur):
    M = A.to_scipy().toarray()
    rest = np.setdiff1d(np.arange(A.n), schur)
    return M[np.ix_(schur, schur)] - M[np.ix_(schur, rest)] @ np.linalg.solve(
        M[np.ix_(rest, rest)], M[np.ix_(rest, schur)])


def _port(A, schur, T=16, upd=None, align=True):
    s = Pastix(A, PastixConfig(tile_size=T, update_dtype=upd,
                               align_supernodes=align), device="cpu")
    return s.set_schur_unknowns(schur)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(A, schur, b, reference solver and x, port solver and x)."""
    gen, j_gen, size, ns = CASES[request.param]
    A = gen(size)
    schur = np.arange(A.n - ns, A.n)
    b = A.to_scipy() @ np.random.default_rng(5).standard_normal(A.n)
    ref = JPastix(j_gen(size), JPastixConfig(tile_size=16))
    ref.set_schur_unknowns(schur)
    x_ref = ref.solve_with_schur(b)
    port = _port(A, schur)
    x = port.solve_with_schur(b)
    return A, schur, b, ref, x_ref, port, x


def test_get_schur_matches_reference(case):
    _, schur, _, ref, _, port, _ = case
    S, S_ref = port.get_schur(), ref.get_schur()
    assert S.shape == S_ref.shape == (schur.size, schur.size)
    assert np.abs(S - S_ref).max() <= 1e-4 * np.abs(S_ref).max()


def test_get_schur_matches_dense_formula(case):
    A, schur, _, _, _, port, _ = case
    S, S_ref = port.get_schur(), _dense_schur(A, schur)
    np.testing.assert_array_equal(S, S.T)
    assert np.abs(S - S_ref).max() <= 1e-5 * np.abs(S_ref).max()


def test_solve_with_schur_matches_reference(case):
    A, _, b, ref, x_ref, port, x = case
    assert port.report.residual <= 1e-10
    assert np.linalg.norm(b - A.to_scipy() @ x) <= 1e-10 * np.linalg.norm(b)
    assert _rel(x, x_ref) <= 1e-8


def test_factors_from_jax_give_the_reference_schur(case):
    A, schur, _, ref, _, _, _ = case
    port = _port(A, schur, align=False)  # the reference's Schur layout
    port.analyze()
    port.factors = factors_from_jax(ref.factors, "cpu")
    np.testing.assert_array_equal(port.get_schur(), ref.get_schur())
    sb = port._schur_first_bcol
    assert not port.factors.dinv[sb:].any()  # Schur slots left zero


def test_schur_columns_never_inverted_or_swept(case):
    """The Schur diagonal tiles hold S: no inverse is formed for them, no
    diagonal op of either sweep names them, and the backward sweep writes
    no Schur row."""
    _, _, _, _, _, port, _ = case
    sb = port._schur_first_bcol
    assert not port.factors.dinv[sb:].any()
    plan = port._fwd_fn.plan
    for key in ("fwd", "bwd"):
        for ph in plan[key]:
            if ph.kind == "diag":
                assert int(ph.cols.max()) < sb
            elif key == "bwd":
                assert int(ph.op_dst.max()) < sb
        # K2's work items: no diagonal item, and no backward item at all,
        # on a Schur column (the forward sweep flushes the Schur rows)
        kind, col = plan["items"][key].item[:, :2].T
        assert int(col[kind == 0].max()) < sb
        if key == "bwd":
            assert int(col.max()) < sb


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [None, "bfloat16"])
def test_tile_sizes_and_update_dtypes(T, upd):
    """Schur = the last plane of poisson_3d(6); the residue goes through
    the K3 twin on the CPU; bf16 updates are refined to 1e-10 too."""
    A = poisson_3d(6)
    schur = np.arange(A.n - 36, A.n)
    s = _port(A, schur, T=T, upd=upd)
    t0 = PL.gemm_scatter_pipelined.twin_launches
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve_with_schur(b)
    assert PL.gemm_scatter_pipelined.twin_launches > t0
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() <= 1e-9
    tol = 1e-5 if upd is None else 1e-2  # bf16 operands: 2^-8 rounding
    S_ref = _dense_schur(A, schur)
    assert np.abs(s.get_schur() - S_ref).max() <= tol * np.abs(S_ref).max()


def test_schur_block_rhs():
    A = laplacian_2d(12)
    s = _port(A, np.arange(A.n - 17, A.n))
    X = np.random.default_rng(2).standard_normal((A.n, 3))
    got = s.solve_with_schur(A.to_scipy() @ X)
    assert got.shape == X.shape and _rel(got, X) <= 1e-9


def test_custom_schur_solve_is_called():
    A = laplacian_2d(12)
    s = _port(A, np.arange(A.n - 17, A.n))
    calls = []

    def schur_solve(S, y):
        calls.append(S.shape)
        return np.linalg.solve(S, y)

    x = s.solve_with_schur(A.to_scipy() @ np.ones(A.n), schur_solve)
    assert calls and all(c == (17, 17) for c in calls)
    assert np.abs(x - 1).max() <= 1e-9


def test_plain_solve_refused_in_schur_mode():
    A = laplacian_2d(6)
    s = _port(A, np.arange(A.n - 5, A.n))
    with pytest.raises(ValueError, match="solve_with_schur"):
        s.solve(np.ones(A.n))


def test_get_schur_without_unknowns_raises():
    s = Pastix(laplacian_2d(6), PastixConfig(tile_size=16), device="cpu")
    with pytest.raises(ValueError, match="no Schur unknowns"):
        s.get_schur()


# fp64 Schur (the residue by torch ops in the pool's dtype): poisson_3d(8),
# T=16, the last 64 unknowns, against the reference's fp64 get_schur
NX64, NS64 = 8, 64


@pytest.mark.parametrize("upd", [None, "bfloat16"], ids=["fp64", "bf16"])
@pytest.mark.parametrize("kind", ["LLT", "LDLT", "LU"])
def test_fp64_schur_matches_reference(kind, upd):
    """With fp64 updates S agrees with the reference's fp64 S to 1e-12
    max|S| (both 3e-16 off the dense formula) and solve_with_schur gives
    max|x - 1| <= 1e-10; with bf16 updates on the fp64 pool (operands
    rounded, products accumulated in fp64, as the reference's) S agrees
    with the reference's to 1e-2 max|S| (this file's bf16 tolerance: 2^-8
    operand rounding) and the solve refines to 1e-10.  No hand kernel's
    twin runs: the route is torch ops."""
    from pastix_tpu.config import Factorization as JF

    from pastix_tpu_torch.config import Factorization

    A = poisson_3d(NX64)
    schur = np.arange(A.n - NS64, A.n)
    b = A.to_scipy() @ np.ones(A.n)
    ref = JPastix(j_poisson_3d(NX64), JPastixConfig(
        tile_size=16, compute_dtype="float64", factorization=JF[kind],
        update_dtype=upd))
    ref.set_schur_unknowns(schur)
    ref.factorize()
    S_ref = ref.get_schur()
    s = Pastix(A, PastixConfig(tile_size=16, compute_dtype="float64",
                               factorization=Factorization[kind],
                               update_dtype=upd), device="cpu")
    s.set_schur_unknowns(schur)
    t0 = PL.gemm_scatter_pipelined.twin_launches
    s.factorize()
    assert s.factors.dtype == torch.float64
    assert any(lv.res for lv in s._fact_fn.levels)
    S = s.get_schur()
    x = s.solve_with_schur(b)
    assert PL.gemm_scatter_pipelined.twin_launches == t0
    tol = 1e-12 if upd is None else 1e-2
    assert np.abs(S - S_ref).max() <= tol * np.abs(S_ref).max()
    assert s.report.residual <= 1e-10
    if upd is None:
        assert np.abs(x - 1).max() <= 1e-10


@pytest.mark.parametrize("dt", ["complex64", "complex128"])
def test_complex_schur_still_raises(dt):
    """The reference has no complex Schur complement: set_schur_unknowns
    refuses a complex pool, and so does its factorization route."""
    from pastix_tpu_torch.analyze import build_layout
    from pastix_tpu_torch.numeric import factorize as F

    s = Pastix(poisson_3d(4), PastixConfig(compute_dtype=dt, tile_size=16),
               device="cpu")
    with pytest.raises(NotImplementedError, match="reference has none"):
        s.set_schur_unknowns([0, 1])
    s = _port(poisson_3d(4), np.arange(48, 64))
    s.symbfact()
    lay = build_layout(s._pat_perm_ext, 16,
                       schur_first_bcol=s._schur_first_bcol)
    with pytest.raises(NotImplementedError, match="no complex Schur"):
        F.build_factorize_fn(lay, "cpu", dtype=getattr(torch, dt))
