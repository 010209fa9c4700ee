"""Triangular solve (PyTorch counterpart of ``pastix_tpu/solve.py``: the
fp32 real LLᵗ, LDLᵗ and LU branches of ``build_solve_fn_sweep`` and
``build_fwd_bwd_fns``, and the per-level ``build_solve_fn`` in every
dtype, LLᴴ and LDLᴴ included).

``rhs_to_blocks`` / ``blocks_to_rhs`` are verbatim copies of the host
helpers in ``pastix_tpu/solve.py`` (that module imports JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.kernels import np_dtype, op_t
from pastix_tpu_torch.numeric.sweep_kernels import (
    _from_rowvec, _to_rowvec, sweep_bwd, sweep_fwd, sweep_plan,
)


def rhs_to_blocks(layout: SolverLayout, b_perm: np.ndarray, dtype=np.float32):
    """(n, R) permuted RHS -> (nbc, T, R) padded block layout."""
    n, T, nbc = layout.n, layout.T, layout.nbc
    b = np.asarray(b_perm, dtype=dtype)
    if b.ndim == 1:
        b = b[:, None]
    pad = np.zeros((nbc * T, b.shape[1]), dtype=dtype)
    pad[:n] = b
    return pad.reshape(nbc, T, -1)


def blocks_to_rhs(layout: SolverLayout, xb) -> np.ndarray:
    """(nbc, T, R) block layout -> (n, R)."""
    x = np.asarray(xb).reshape(layout.nbc * layout.T, -1)
    return x[: layout.n]


def build_fwd_bwd_fns(layout: SolverLayout, device, kind=Factorization.LLT,
                      plan=None):
    """Split sweeps through K2 for ``kind``, each on a float32 (nbc, T, R)
    block RHS on ``device``, after the kind's factor tensors
    (``Factors.solve_args``):

    - LLᵗ: ``fwd(pool, dinv, b) = L⁻¹ b``, ``bwd(pool, dinv, y) = L⁻ᵗ y``;
    - LDLᵗ: ``fwd(pool, dinv, d, b) = D⁻¹ L⁻¹ b``, ``bwd(..., y) = L⁻ᵗ y``;
    - LU: ``fwd(pool, pool_u, dinv, dinv_u, b) = L⁻¹ b``,
      ``bwd(..., y) = U⁻¹ y`` (the Uᵗ pool, the upper inverses and an
      untransposed diagonal).

    The Schur path runs them apart (eliminate, dense-solve the Schur
    system, back-substitute).  Only the levels' columns are swept: the
    forward sweep updates the Schur rows (``y_s -= L_sc y_c``) but never
    divides by their diagonal (their pivots in ``d`` are 1), and the
    backward sweep reads them and never writes them.  ``fwd.plan`` holds
    the sweep tables (``plan``, when given, is shared)."""
    kind = Factorization(kind)
    plan = sweep_plan(layout, device) if plan is None else plan
    nbc, T = layout.nbc, layout.T

    def on_rowvec(run):
        def fn(*args):
            *factors, b = args
            y2 = _to_rowvec(b.to(torch.float32))
            run(y2, *factors)
            return _from_rowvec(y2, nbc, T)

        fn.plan = plan
        return fn

    if kind == Factorization.LU:
        fwd = lambda y2, pool, pool_u, dinv, dinv_u: sweep_fwd(
            pool, dinv, y2, plan)
        bwd = lambda y2, pool, pool_u, dinv, dinv_u: sweep_bwd(
            pool_u, dinv_u, y2, plan, lu=True)
    elif kind == Factorization.LDLT:
        def fwd(y2, pool, dinv, d):
            sweep_fwd(pool, dinv, y2, plan)
            y2.view(nbc, -1, T).div_(d[:, None, :])

        bwd = lambda y2, pool, dinv, d: sweep_bwd(pool, dinv, y2, plan)
    else:
        fwd = lambda y2, pool, dinv: sweep_fwd(pool, dinv, y2, plan)
        bwd = lambda y2, pool, dinv: sweep_bwd(pool, dinv, y2, plan)
    return on_rowvec(fwd), on_rowvec(bwd)


def run_host(factors, v_perm: np.ndarray, fn, device=None) -> np.ndarray:
    """Apply a sweep of :func:`build_fwd_bwd_fns` (or a solve) to a host
    (n, [R]) permuted vector through the device (in the pool's dtype
    there; the result comes back as fp64, or complex128 for a complex
    pool): the counterpart of the reference's ``run_fwd`` and
    ``run_bwd``.  The vector goes to ``device`` (default: the pool's;
    streamed factors' pools are in host memory)."""
    lay, pool = factors.layout, factors.pool
    vb = torch.as_tensor(rhs_to_blocks(lay, v_perm, np_dtype(pool.dtype)),
                         device=pool.device if device is None else device)
    host = torch.complex128 if pool.dtype.is_complex else torch.float64
    y = fn(*factors.solve_args(), vb).to(host).cpu().numpy()
    out = blocks_to_rhs(lay, y)
    return out if np.asarray(v_perm).ndim > 1 else out[:, 0]


def build_solve_fn_sweep(layout: SolverLayout, device, kind=Factorization.LLT,
                         plan=None):
    """The solve of ``kind`` through the whole-sweep kernel K2:
    ``fn(*factors, b) -> x`` with ``factors`` the kind's tensors
    (``Factors.solve_args``) and ``b`` a float32 (nbc, T, R) block RHS on
    ``device``: the forward then the backward sweep of
    :func:`build_fwd_bwd_fns`.  The op stream covers every level
    including the dense-tail columns, whose factored tiles live in the
    pool.  ``fn.plan`` holds the sweep tables (``plan``, when given, is
    shared)."""
    fwd, bwd = build_fwd_bwd_fns(layout, device, kind, plan)

    def fn(*args):
        *factors, b = args
        return bwd(*factors, fwd(*factors, b))

    fn.plan = fwd.plan
    return fn


# tiles gathered at once by a per-level step: bounds the (chunk, T, T)
# temporaries (the reference's ``_SOLVE_CHUNK``)
_LEVEL_CHUNK = 4096


def build_level_fwd_bwd_fns(layout: SolverLayout, device,
                            kind=Factorization.LLT, dtype=torch.float32,
                            hermitian=None):
    """The per-level sweeps of ``fast_solve=False`` and of every pool but
    fp32 real (reference ``_fwd_level``/``_bwd_level``,
    ``pastix_tpu/solve.py:98-176``), with the signatures of
    :func:`build_fwd_bwd_fns`: ``fwd(*factors, b)`` and ``bwd(*factors,
    y)`` on a (nbc, T, R) block RHS, computed in ``dtype`` (the pool's),
    ``factors`` the kind's ``Factors.solve_args``, whose inverse diagonal
    tiles are not read (``None`` when the factorization made none).
    ``hermitian`` (default: LLᵗ and LDLᴴ, as the reference's) makes a
    complex pool's backward sweep read Lᴴ.

    A level's diagonal tiles go through one batched
    ``torch.linalg.solve_triangular`` (lower, unit lower for LDLᵗ and LU;
    backward Lᵗ or Lᴴ, or LU's upper triangle), its off-diagonal tiles through
    a batched matmul and ``index_add_``, in chunks of ``_LEVEL_CHUNK``
    tiles.  Every level of the layout is swept, the dense tail's columns
    included: the port keeps their factored tiles in the pool, where the
    reference gathers the tail and solves it densely (``_tail_ops``).  As
    the sweep: the forward sweep updates Schur rows without dividing by
    their diagonal, and the backward sweep reads them and never writes
    them."""
    kind = Factorization(kind)
    lu = kind == Factorization.LU
    tab = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    fwd_sweep, bwd_sweep = level_sweeps(
        [(tab(lv.cols), tab(lv.diag), tab(lv.trsm_panel), tab(lv.trsm_row),
          tab(lv.trsm_col)) for lv in layout.levels], kind, dtype, hermitian)
    own = lambda b: b.to(dtype, copy=True)
    if lu:
        def fwd(pool, pool_u, dinv, dinv_u, b):
            return fwd_sweep(pool, own(b))

        def bwd(pool, pool_u, dinv, dinv_u, y):
            return bwd_sweep(pool_u, pool, own(y))
    elif kind in (Factorization.LDLT, Factorization.LDLH):
        def fwd(pool, dinv, d, b):
            return fwd_sweep(pool, own(b)).div_(d[:, :, None])

        def bwd(pool, dinv, d, y):
            return bwd_sweep(pool, pool, own(y))
    else:
        def fwd(pool, dinv, b):
            return fwd_sweep(pool, own(b))

        def bwd(pool, dinv, y):
            return bwd_sweep(pool, pool, own(y))
    return fwd, bwd


def level_sweeps(plan, kind=Factorization.LLT, dtype=torch.float32,
                 hermitian=None):
    """The body of the per-level sweeps, over ``plan``: a list of level
    tables (cols, diag, tp, tr, tc) as int64 tensors, ``diag`` and ``tp``
    indices into the tiles the sweeps are given (the pool, or a streamed
    segment's window, ``numeric/ooc``).  Returns ``fwd_sweep(pool, y)``
    (L⁻¹ y, unit lower but for LLᵗ) and ``bwd_sweep(pool_contrib,
    pool_diag, x)`` (the transposed sweep over the levels in reverse:
    contributions from ``pool_contrib``, Lᵗ or Lᴴ, LU's Uᵗ; diagonal
    solves on ``pool_diag``, LU's upper triangle), both in place on the
    (nbc, T, R) block vector, which they return."""
    kind = Factorization(kind)
    if hermitian is None:
        hermitian = kind in (Factorization.LLT, Factorization.LDLH)
    herm = hermitian and dtype.is_complex
    unit = kind != Factorization.LLT
    lu = kind == Factorization.LU

    def chunks(tp, a, b):
        for i in range(0, tp.numel(), _LEVEL_CHUNK):
            yield (tp[i:i + _LEVEL_CHUNK], a[i:i + _LEVEL_CHUNK],
                   b[i:i + _LEVEL_CHUNK])

    def fwd_sweep(pool, y):
        for cols, diag, tp, tr, tc in plan:
            y[cols] = torch.linalg.solve_triangular(
                pool[diag], y[cols], upper=False, unitriangular=unit)
            for p, r, c in chunks(tp, tr, tc):
                y.index_add_(0, r, torch.bmm(pool[p], y[c]), alpha=-1.0)
        return y

    def bwd_sweep(pool_contrib, pool_diag, x):
        for cols, diag, tp, tr, tc in reversed(plan):
            for p, r, c in chunks(tp, tr, tc):
                x.index_add_(0, c, torch.bmm(op_t(pool_contrib[p], herm),
                                             x[r]), alpha=-1.0)
            D = pool_diag[diag]
            x[cols] = (torch.linalg.solve_triangular(D, x[cols], upper=True)
                       if lu else torch.linalg.solve_triangular(
                           op_t(D, herm), x[cols], upper=True,
                           unitriangular=unit))
        return x

    return fwd_sweep, bwd_sweep


def build_solve_fn(layout: SolverLayout, device, kind=Factorization.LLT,
                   dtype=torch.float32, hermitian=None):
    """The per-level solve of ``fast_solve=False`` and of every pool but
    fp32 real (reference ``build_solve_fn``, ``pastix_tpu/solve.py:187``):
    ``fn(*factors, b) -> x`` as :func:`build_solve_fn_sweep`'s, the
    forward then the backward sweep of :func:`build_level_fwd_bwd_fns` in
    ``dtype``, conjugated as ``hermitian`` says.  It reads no inverse
    diagonal tiles and launches no K2."""
    fwd, bwd = build_level_fwd_bwd_fns(layout, device, kind, dtype,
                                       hermitian)

    def fn(*args):
        *factors, b = args
        return bwd(*factors, fwd(*factors, b))

    return fn
