"""Scalar-grain ILU(k): host-side level-of-fill preconditioner (a copy of
``pastix_tpu/analyze/scalar_ilu.py``, numpy and scipy only, with its import
path and the source of one figure reworded; the device named below is the
reference's TPU).

The reference computes ILU(k) patterns at SCALAR granularity
(``src/kass/src/SF_level.c``, ``IPARM_LEVEL_OF_FILL`` — SURVEY.md §2 row
5) and only then amalgamates blocks.  The tile-grain block ILU
(analyze/blocksym.tile_symbolic_ilu) buys its iteration counts with
~3-4x the factor memory because each unit of block fill is T^2 scalar
terms (measured in exp_ilu.py).  This module closes that gap with a
scalar-grain path: the symbolic level-of-fill runs on the scalar graph
(the tile quotient machinery at T=1 — same algorithm, exact scalar
levels), and the numeric factorization is a host IKJ ILU restricted to
that pattern.

Design position: a preconditioner factor is consumed once per Krylov
iteration as two sparse triangular solves — irregular, latency-bound,
tiny-flop work that a TPU tile pipeline is the wrong shape for (the
reference's measured ~65 ns/row TPU scatter wall).  So the scalar grain
lives entirely on the host, like the reference's sequential kass/sopalin
ILU mode, while ``ilu_grain="block"`` remains the device path.  The
factored solves are applied through SuperLU objects built on the
(already triangular) factors — compiled substitution, no extra fill.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def scalar_ilu_pattern(
    pattern: sp.csc_matrix, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact scalar ILU(k) lower pattern (rows, cols), diag included.

    Runs the generic level-of-fill column merge at T=1, where the tile
    quotient graph IS the scalar graph: fill-level(i,j) = min over
    eliminated t of lev(i,t) + lev(j,t) + 1, entries with level > k
    dropped (the SF_level.c recurrence).
    """
    from pastix_tpu_torch.analyze.blocksym import tile_symbolic_ilu

    r, c, _, _ = tile_symbolic_ilu(pattern, 1, k)
    return r, c


def _full_pattern_csr(
    n: int, lrows: np.ndarray, lcols: np.ndarray
) -> sp.csr_matrix:
    """Symmetric full pattern L + strict(L^T) as canonical CSR."""
    off = lrows != lcols
    rows = np.concatenate([lrows, lcols[off]])
    cols = np.concatenate([lcols, lrows[off]])
    F = sp.csr_matrix(
        (np.ones(rows.size, np.int8), (rows, cols)), shape=(n, n)
    )
    F.sum_duplicates()
    F.sort_indices()
    return F


class ScalarILUFactors:
    """Host scalar ILU(k) factors: unit-lower L and upper U (CSR).

    Duck-types the attributes Pastix.solve inspects on device Factors
    (``dinv``/``pool_u``/flags) so the host path flows through the same
    refinement loop.
    """

    _streamed = False
    _offloaded = False
    dinv = None
    dinv_u = None
    pool = None
    pool_u = None
    d = None

    def __init__(self, L: sp.csr_matrix, U: sp.csr_matrix, pivots: int):
        self.L = L
        self.U = U
        self.static_pivots = pivots
        # the apples-to-apples memory metric vs scipy spilu (exp_ilu.py):
        # stored coefficient terms of both triangles
        self.nnz_terms = int(L.nnz + U.nnz)
        from scipy.sparse.linalg import splu

        # SuperLU over an already-triangular matrix with the natural
        # ordering does no pivoting and adds no fill: it is a compiled
        # substitution kernel (scipy's spsolve_triangular row loop is
        # ~100x slower at preconditioner call rates)
        opts = dict(
            permc_spec="NATURAL",
            diag_pivot_thresh=0.0,
            options=dict(SymmetricMode=False),
        )
        self._Ls = splu(L.tocsc(), **opts)
        self._Us = splu(U.tocsc(), **opts)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Apply M^{-1} = U^{-1} L^{-1} to one or a block of RHS."""
        bb = np.asarray(b)
        dt = np.result_type(self.U.dtype, bb.dtype)
        y = self._Ls.solve(bb.astype(dt, copy=False))
        return self._Us.solve(y)


def scalar_ilu_factor(
    A: sp.csc_matrix,
    lrows: np.ndarray,
    lcols: np.ndarray,
    pivot_eps: float,
) -> ScalarILUFactors:
    """Numeric IKJ ILU restricted to the given (symmetrized) pattern.

    Classic row-wise incomplete elimination (the sopalin numeric kernel's
    scalar analog): for each row i and each lower entry k (ascending),
    l_ik = a_ik / u_kk, then subtract l_ik * (row k's upper part) on the
    entries present in row i's pattern — updates outside the pattern are
    dropped.  Diagonals with magnitude below ``pivot_eps`` are replaced
    by ±pivot_eps (the static-pivoting analog; reference
    DPARM_EPSILON_MAGN_CTRL)."""
    n = A.shape[0]
    F = _full_pattern_csr(n, lrows, lcols)
    indptr = F.indptr.astype(np.int64)
    indices = F.indices.astype(np.int64)
    dt = np.result_type(A.dtype, np.float64)
    vals = np.zeros(indices.size, dtype=dt)

    # scatter A's values into the pattern (A subset-of F by construction:
    # level-0 entries are A's symmetrized pattern) via row-major keys
    Ac = sp.coo_matrix(A)  # canonical: no duplicate entries
    fkey = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)) * n + indices
    akey = Ac.row.astype(np.int64) * n + Ac.col.astype(np.int64)
    pos = np.searchsorted(fkey, akey)
    if not np.array_equal(fkey[pos], akey):  # pragma: no cover - invariant
        raise AssertionError("A pattern not contained in ILU pattern")
    vals[pos] = Ac.data.astype(dt)

    # per-row diagonal position
    dpos = np.searchsorted(fkey, np.arange(n, dtype=np.int64) * (n + 1))
    if not np.array_equal(indices[dpos], np.arange(n)):  # pragma: no cover
        raise AssertionError("missing diagonal in ILU pattern")

    pivots = 0
    for i in range(n):
        s = indptr[i]
        di = dpos[i]
        cols = indices[s : indptr[i + 1]]
        for p in range(s, di):
            kcol = indices[p]
            lik = vals[p] / vals[dpos[kcol]]
            vals[p] = lik
            ks, ke = dpos[kcol] + 1, indptr[kcol + 1]
            if ks == ke:
                continue
            ucols = indices[ks:ke]
            q = np.searchsorted(cols, ucols)
            qc = np.minimum(q, cols.size - 1)
            ok = cols[qc] == ucols
            vals[s + qc[ok]] -= lik * vals[ks:ke][ok]
        dv = vals[di]
        if abs(dv) < pivot_eps:
            vals[di] = pivot_eps if (dv.real >= 0) else -pivot_eps
            pivots += 1

    Fv = sp.csr_matrix((vals, indices, indptr), shape=(n, n))
    L = sp.tril(Fv, k=-1, format="csr") + sp.eye(n, dtype=dt, format="csr")
    U = sp.triu(Fv, k=0, format="csr")
    L.sort_indices()
    U.sort_indices()
    return ScalarILUFactors(L, U, pivots)
