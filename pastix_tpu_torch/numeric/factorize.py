"""Numeric LLᵗ factorization (PyTorch counterpart of
``pastix_tpu/numeric/factorize.py``, real LLᵗ only).

The reference unrolls flop-heavy levels and scans the rest
(``grouping.group_plan``, which exists to bound XLA program size); levels
outside its unrolled set keep right-looking residue updates.  PyTorch runs
eagerly and has no scan, so here every level is left-looking:
``regroup_left(..., unrolled=None)`` moves every update to its target's
level (or to the dense-tail pre-pass).  The only residue left is the
updates into Schur columns, which no level factors: each level applies its
own right after its TRSM (kernel K3), as the reference applies ``p_full``.
Parity with the reference holds to rounding, not update for update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.kernels import potrf_batch, round_to, tri_inv_batch
from pastix_tpu_torch.numeric.leftlook import (
    build_ll_schedule, gemm_scatter_ll, ll_plan, regroup_left,
)
from pastix_tpu_torch.numeric.pipelined import (
    build_pipeline_schedule, gemm_scatter_pipelined, pipeline_plan,
)

# panel TRSM chunk (tiles): bounds the (nt, T, T) gather transients, as
# the reference's _PANEL_CHUNK does
_PANEL_CHUNK = 16384
# LL schedule knobs: the reference's defaults (PASTIX_LL_GROUP, _LL_CAP)
_LL_GROUP, _LL_CAP = 4, 1024
# pipeline schedule knobs: the reference's defaults (PASTIX_E2_GROUP and
# build_pipeline_schedule's chunk)
_PIPE_GROUP, _PIPE_CHUNK = 2, 8192


def build_coefinit_fn(layout: SolverLayout, A_pattern: sp.spmatrix, device):
    """Device coefinit: ``fn(vals) -> pool`` with ``vals`` the COO data of
    ``A_pattern`` (``sp.coo_matrix(A_perm).data``) as a float32 tensor on
    ``device``.  The flat scatter indices are built once per pattern; the
    lower triangle lands in the pool with an accumulating ``index_put_``
    and the padded diagonal is set to 1 (reference ``build_coefinit_fn``)."""
    T = layout.T
    A = sp.coo_matrix(A_pattern)
    i, j = A.row.astype(np.int64), A.col.astype(np.int64)
    lo = i >= j  # lower triangle only (symmetric storage)
    p = layout.lookup(i[lo] // T, j[lo] // T)
    flat = p * (T * T) + (i[lo] % T) * T + (j[lo] % T)
    sel_t = torch.as_tensor(np.flatnonzero(lo), device=device)
    flat_t = torch.as_tensor(flat, device=device)
    pad_t = torch.as_tensor(np.asarray(layout.diag_pad_flat, np.int64),
                            device=device)
    numel = layout.npool * T * T

    def fn(vals: torch.Tensor) -> torch.Tensor:
        pool = torch.zeros(numel, dtype=torch.float32, device=device)
        pool.index_put_((flat_t,), vals[sel_t].to(torch.float32),
                        accumulate=True)
        pool[pad_t] = 1.0
        return pool.view(layout.pool_shape)

    return fn


@dataclasses.dataclass
class Factors:
    """Factorization result (LLᵗ): the factored tile pool and the inverse
    diagonal tiles, as tensors on one device."""

    kind: Factorization
    layout: SolverLayout
    pool: torch.Tensor  # (npool, T, T) L tiles
    dinv: Optional[torch.Tensor] = None  # (nbc, T, T) inverse diag tiles
    n_static_pivots: int = 0


@dataclasses.dataclass
class _Level:
    diag: torch.Tensor  # pool idx of the level's diagonal tiles
    tp: torch.Tensor  # pool idx of its panel tiles
    tcpos: torch.Tensor  # each panel's column position in the level
    ll: list  # LLChunk plan of the updates into this level
    schur: list  # PipeChunk plan of its updates into Schur columns


def build_factorize_fn(layout: SolverLayout, device, update_dtype=None,
                       dense_tail=None):
    """The LLᵗ program for this pattern: ``fn(pool) -> pool``, in place,
    where the reference donates the pool buffer to its jitted program
    (``pastix_tpu/pastix.py`` ``factorize``).

    Per level: the incoming left-looking pass (kernel K1), batched
    Cholesky of the diagonal tiles, the panel TRSM as a matmul with the
    inverted diagonals, then the level's updates into Schur columns
    (kernel K3; a layout built with ``schur_first_bcol``).  With
    ``dense_tail`` (``plan_dense_tail``):
    the tail pre-pass (K1 again) and a blocked dense Cholesky of the
    trailing block.  ``update_dtype`` (None, torch.float32 or
    torch.bfloat16) rounds the operands of every trailing update.

    ``fn.levels`` / ``fn.tail`` hold the K1 and K3 plans;
    ``fn.e2_saved_flops`` counts the row-bounded savings against the
    full-tile count."""
    T = layout.T
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    tail_s = dense_tail.s if dense_tail is not None else None
    reduced, incoming, tail = regroup_left(levels, layout.blk_col, tail_s)
    factored = factored_cols(layout)
    for lv in reduced:
        stray = int(np.isin(layout.blk_col[lv.gemm_d], factored).sum())
        if stray:
            raise RuntimeError(
                f"{stray} right-looking residue updates into factored "
                "columns left after regroup_left; the port runs every "
                "level left-looking and keeps only Schur-bound residue"
            )
    rb = (layout.row_lo, layout.row_hi) if layout.row_lo is not None else None
    e2_saved = 0.0

    def schedule(ga, gb, gd, mode):
        nonlocal e2_saved
        sched = build_ll_schedule(ga, gb, gd, group=_LL_GROUP, cap=_LL_CAP,
                                  mode=mode, rb=rb, T=T)
        for c in sched:
            e2_saved += c["n_real"] * (T - c["H"]) * 2.0 * T ** 2
        return ll_plan(sched, device)

    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    plan = []
    for lv, inc, res in zip(levels, incoming, reduced):
        ga, gb, gd = inc[:3]
        plan.append(_Level(
            diag=tens(lv.diag), tp=tens(lv.trsm_panel),
            tcpos=tens(np.searchsorted(lv.cols, lv.trsm_col)),
            ll=schedule(ga, gb, gd, "auto") if ga.size else [],
            schur=pipeline_plan(build_pipeline_schedule(
                res.gemm_a, res.gemm_b, res.gemm_d, group=_PIPE_GROUP,
                chunk=_PIPE_CHUNK,
            ), device) if res.gemm_a.size else [],
        ))
    # dense-tail pre-pass: every update into a tail tile, once; the
    # reference measured per-pair fp32 a reads (bcache) best here
    tail_plan = (
        schedule(*tail[:3], "bcache")
        if tail is not None and tail[0].size else []
    )
    tail_factor = (
        _build_tail_factor(dense_tail, T, device, update_dtype)
        if dense_tail is not None else None
    )

    def fn(pool: torch.Tensor) -> torch.Tensor:
        for lv in plan:
            if lv.ll:
                gemm_scatter_ll(pool, lv.ll, update_dtype)
            L = potrf_batch(pool[lv.diag])
            pool[lv.diag] = L
            nt = lv.tp.numel()
            if nt:
                dinv_t = tri_inv_batch(L).transpose(1, 2)
                for lo in range(0, nt, _PANEL_CHUNK):
                    tp = lv.tp[lo:lo + _PANEL_CHUNK]
                    pool[tp] = torch.matmul(
                        pool[tp], dinv_t[lv.tcpos[lo:lo + _PANEL_CHUNK]]
                    )
            if lv.schur:
                gemm_scatter_pipelined(pool, lv.schur, update_dtype)
        if tail_plan:
            gemm_scatter_ll(pool, tail_plan, update_dtype)
        if tail_factor is not None:
            tail_factor(pool)
        return pool

    fn.levels = plan
    fn.tail = tail_plan
    fn.e2_saved_flops = e2_saved
    return fn


def _build_tail_factor(dense_tail, T, device, update_dtype):
    """Blocked right-looking Cholesky of the dense trailing block
    (reference ``tail_factor`` / ``tail_factor_blocked``): gather the tail
    tiles into one (m, m) matrix (missing upper tiles stay zero, only the
    lower triangle is read), factor, scatter the lower tiles back.
    Trailing updates round their operands to ``update_dtype``; upper
    blocks accumulate the symmetric mirror and are never read back."""
    q = dense_tail.q
    m = q * T
    t_p = torch.as_tensor(np.asarray(dense_tail.p_idx, np.int64), device=device)
    t_qi = torch.as_tensor(np.asarray(dense_tail.qi, np.int64), device=device)
    t_qj = torch.as_tensor(np.asarray(dense_tail.qj, np.int64), device=device)

    def tail_factor(pool: torch.Tensor) -> None:
        dense = torch.zeros((q, T, q, T), dtype=pool.dtype, device=device)
        dense[t_qi, :, t_qj, :] = pool[t_p]
        A = dense.view(m, m)
        for j in range(q):
            s0, s1 = j * T, (j + 1) * T
            Lj = potrf_batch(A[None, s0:s1, s0:s1])
            A[s0:s1, s0:s1] = Lj[0]
            if j + 1 == q:
                break
            P = A[s1:, s0:s1] @ tri_inv_batch(Lj)[0].T
            A[s1:, s0:s1] = P
            Pa = round_to(P, update_dtype)
            A[s1:, s1:].addmm_(Pa, Pa.T, alpha=-1.0)
        pool[t_p] = dense[t_qi, :, t_qj, :]

    return tail_factor


def factored_cols(layout: SolverLayout) -> np.ndarray:
    """Sorted block columns that a level factors: every column but the
    Schur columns of a layout built with ``schur_first_bcol``."""
    return np.sort(np.concatenate(
        [np.asarray(lv.cols, np.int64) for lv in layout.levels]
        or [np.empty(0, np.int64)]
    ))


def build_diag_inverse_fn(layout: SolverLayout, device):
    """``fn(pool) -> dinv``: the (nbc, T, T) inverses of the factored
    diagonal tiles, by a batched triangular solve (the reference's
    ``_tri_inverse_doubling`` works around a slow TPU triangular solve).
    A Schur column's diagonal tile holds S, not a triangle: it is neither
    read nor inverted, and its slot stays zero (no sweep reads it)."""
    cols = factored_cols(layout)
    col_t = torch.as_tensor(cols, device=device)
    diag_idx = torch.as_tensor(layout.lookup(cols, cols), device=device)
    nbc, T = layout.nbc, layout.T

    def fn(pool: torch.Tensor) -> torch.Tensor:
        dinv = torch.zeros((nbc, T, T), dtype=pool.dtype, device=pool.device)
        dinv[col_t] = tri_inv_batch(pool[diag_idx])
        return dinv

    return fn


def factorize(layout: SolverLayout, A_perm: sp.spmatrix, coef_fn, fact_fn,
              device) -> Factors:
    """Host driver: coefinit on the device from the nnz values, run the
    factorization, then one breakdown check (reference ``factorize``)."""
    vals = torch.as_tensor(
        sp.coo_matrix(A_perm).data.astype(np.float32), device=device
    )
    pool = fact_fn(coef_fn(vals))
    cols = factored_cols(layout)
    diag_of_col = torch.as_tensor(layout.lookup(cols, cols), device=device)
    dvals = torch.diagonal(pool[diag_of_col], dim1=-2, dim2=-1)
    if not bool(torch.isfinite(dvals).all()):
        raise FloatingPointError(
            "LL^T factorization broke down (NaN/Inf pivot): the matrix is "
            "not positive definite. LDL^T and LU are not ported yet "
            "(ROADMAP.md slice 2)."
        )
    return Factors(Factorization.LLT, layout, pool)
