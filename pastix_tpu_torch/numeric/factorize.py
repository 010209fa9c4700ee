"""Numeric factorization: LLᵗ, LDLᵗ and LU, real (PyTorch counterpart of
``pastix_tpu/numeric/factorize.py``).

The E2 (trailing update) schedule follows the reference's gate
(:func:`e2_schedule`).  By default every level is left-looking (the
reference's round-5 default): the reference unrolls flop-heavy levels and
scans the rest (``grouping.group_plan``, which exists to bound XLA
program size), and levels outside its unrolled set keep right-looking
residue updates; PyTorch runs eagerly and has no scan, so here
``regroup_left(..., unrolled=None)`` moves every update to its target's
level (or to the dense-tail pre-pass).  The only residue left is the
updates into Schur columns, which no level factors: each level applies its
own right after its TRSM (kernel K3), as the reference applies ``p_full``.
Parity with the reference holds to rounding, not update for update.

``PASTIX_E2_LL=0`` (or ``e2=``) selects the reference's round-4
right-looking E2 instead: each level applies its own updates after its
TRSM, through the panel stream (K3 on the TRSM's bf16 copy of the
panels), the dst-block kernel K5, the panel-slab kernel K6 (each with K3
on its fallback pairs) or K3 per pair.  Every level is unrolled (the
reference's scanned levels run XLA's ``gemm_scatter``).

LDLᵗ and LU factor the diagonal tiles with static pivoting (kernel K4);
the number of clamped pivots stays on the device until the end.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.block import (
    block_plan, build_block_plan, gemm_scatter_block,
)
from pastix_tpu_torch.numeric.chol_inv import chol_inv, chol_inv_pool
from pastix_tpu_torch.numeric.kernels import potrf_batch, round_to, tri_inv_batch
from pastix_tpu_torch.numeric.leftlook import (
    build_ll_schedule, gemm_scatter_ll, ll_plan, regroup_left,
)
from pastix_tpu_torch.numeric.pipelined import (
    build_pipeline_schedule, gemm_scatter_pipelined, pipeline_plan,
)
from pastix_tpu_torch.numeric.slab import (
    build_slab_plan, gemm_scatter_slab, slab_plan,
)
from pastix_tpu_torch.numeric.tile_factor import tile_factor

# panel TRSM chunk (tiles): bounds the (nt, T, T) gather transients, as
# the reference's _PANEL_CHUNK does
_PANEL_CHUNK = 16384
# LL schedule knobs: the reference's defaults (PASTIX_LL_GROUP, _LL_CAP)
_LL_GROUP, _LL_CAP = 4, 1024
# pipeline schedule knobs: the reference's defaults (PASTIX_E2_GROUP and
# build_pipeline_schedule's chunk)
_PIPE_GROUP, _PIPE_CHUNK = 2, 8192


def build_coefinit_fn(layout: SolverLayout, A_pattern: sp.spmatrix, device,
                      for_lu: bool = False):
    """Device coefinit: ``fn(vals) -> pool`` (``(pool, pool_u)`` with
    ``for_lu``) with ``vals`` the COO data of ``A_pattern``
    (``sp.coo_matrix(A_perm).data``) as a float32 tensor on ``device``.
    The flat scatter indices are built once per pattern; entries land in
    the pool with an accumulating ``index_put_`` and the padded diagonal
    is set to 1 (reference ``build_coefinit_fn``).  Symmetric kinds keep
    the lower triangle; LU puts the tiles on or below the block diagonal
    in ``pool`` and stores ``Ut(I, J) = A(J, I)ᵗ`` transposed in
    ``pool_u``."""
    T = layout.T
    A = sp.coo_matrix(A_pattern)
    i, j = A.row.astype(np.int64), A.col.astype(np.int64)
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)

    def flat(sel, rows, cols):
        p = layout.lookup(rows[sel] // T, cols[sel] // T)
        return (tens(np.flatnonzero(sel)),
                tens(p * (T * T) + (rows[sel] % T) * T + (cols[sel] % T)))

    # LU: tile on/below the block diagonal; else the lower triangle
    lo = (i // T) >= (j // T) if for_lu else i >= j
    sel_l, flat_l = flat(lo, i, j)
    sel_u, flat_u = flat(~lo, j, i) if for_lu else (None, None)
    pad_t = tens(layout.diag_pad_flat)
    numel = layout.npool * T * T

    def scatter(vals, sel, idx):
        pool = torch.zeros(numel, dtype=torch.float32, device=device)
        pool.index_put_((idx,), vals[sel].to(torch.float32), accumulate=True)
        return pool

    def fn(vals: torch.Tensor):
        pool = scatter(vals, sel_l, flat_l)
        pool[pad_t] = 1.0
        if not for_lu:
            return pool.view(layout.pool_shape)
        return (pool.view(layout.pool_shape),
                scatter(vals, sel_u, flat_u).view(layout.pool_shape))

    return fn


@dataclasses.dataclass
class Factors:
    """Factorization result, as tensors on one device: the factored tile
    pool (L tiles; LU: L and the combined diagonal tiles), the Uᵗ pool
    (LU), the pivots (LDLᵗ) and the inverse diagonal tiles."""

    kind: Factorization
    layout: SolverLayout
    pool: torch.Tensor  # (npool, T, T) L (or combined LU diag) tiles
    pool_u: Optional[torch.Tensor] = None  # (npool, T, T) Ut tiles (LU)
    d: Optional[torch.Tensor] = None  # (nbc, T) pivots (LDLᵗ)
    dinv: Optional[torch.Tensor] = None  # (nbc, T, T) inverse (unit) lower
    dinv_u: Optional[torch.Tensor] = None  # (nbc, T, T) inverse upper (LU)
    n_static_pivots: int = 0

    def solve_args(self) -> tuple:
        """The tensors the kind's sweeps take (``solve.build_fwd_bwd_fns``)."""
        if self.kind == Factorization.LU:
            return (self.pool, self.pool_u, self.dinv, self.dinv_u)
        if self.kind == Factorization.LDLT:
            return (self.pool, self.dinv, self.d)
        return (self.pool, self.dinv)


E2_MODES = ("left", "stream", "block", "slab", "pair")


def e2_schedule(kind, update_dtype, e2=None):
    """(mode, compact): the E2 schedule of ``build_factorize_fn``, by the
    reference's gate (``pastix_tpu/numeric/factorize.py:527-555``).

    ``e2`` (``"left"``, ``"stream"``, ``"block"``, ``"slab"`` or
    ``"pair"``, with ``"+compact"`` for K3's compact operands) overrides
    the environment.  Else the reference's variables decide, with its
    defaults: ``PASTIX_E2_LL`` (1: left-looking), then ``PASTIX_E2_STREAM``
    (1: the panel stream), then for LLᵗ and LDLᵗ ``PASTIX_E2_BLOCK`` (1)
    and ``PASTIX_E2_SLAB`` (1), else per pair; LU goes stream or pair.
    ``PASTIX_E2_COMPACT=1`` makes the K3 calls that read no stream gather
    their operands (the reference's opt-in).  The port's recorded
    deviation (ROADMAP.md C): left-looking also without an update dtype,
    where the reference goes right-looking.  Stream without an update
    dtype reads the pool, as the reference's levels do: that is the pair
    schedule.  Block and slab exist for LLᵗ and LDLᵗ only."""
    kind = Factorization(kind)
    env = os.environ.get
    if e2 is not None:
        mode, plus, extra = e2.partition("+")
        if mode not in E2_MODES or (plus and extra != "compact"):
            raise ValueError(
                f"e2={e2!r}: expected one of {E2_MODES}, optionally "
                "with '+compact'")
        compact = extra == "compact"
    else:
        compact = env("PASTIX_E2_COMPACT", "0") == "1"
        if env("PASTIX_E2_LL", "1") != "0":
            mode = "left"
        elif env("PASTIX_E2_STREAM", "1") != "0":
            mode = "stream"
        elif kind == Factorization.LU:
            mode = "pair"
        elif env("PASTIX_E2_BLOCK", "1") != "0":
            mode = "block"
        elif env("PASTIX_E2_SLAB", "1") != "0":
            mode = "slab"
        else:
            mode = "pair"
    if kind == Factorization.LU and mode in ("block", "slab"):
        raise ValueError(f"the {mode} E2 schedule is LLᵗ/LDLᵗ only (the "
                         "reference's rule); LU runs stream or pair")
    if mode == "stream" and update_dtype in (None, torch.float32):
        mode = "pair"
    return mode, compact


def fused_diag_gate(kind, fused_diag=None) -> bool:
    """Whether the LLᵗ DIAG is fused (``build_factorize_fn``): each level
    with panels factors its diagonal tiles and forms their inverses in
    one launch of K7 (``chol_inv_pool``), and the dense tail's diagonal
    blocks go through K8 (``chol_inv``).

    ``fused_diag`` overrides the environment; else the reference's
    ``PASTIX_FUSED_DIAG`` decides (``pastix_tpu/numeric/factorize.py:
    875-900``, default off).  Its values 1, ``unroll`` and ``scan`` pick
    the reference's unrolled levels, its scanned ones or both; the port
    has no scanned levels, so each of them fuses every level with panels
    (ROADMAP.md C).  The gate is LLᵗ's only: LDLᵗ and LU ignore the
    variable and refuse ``fused_diag=True``."""
    kind = Factorization(kind)
    if fused_diag is None:
        return kind == Factorization.LLT and os.environ.get(
            "PASTIX_FUSED_DIAG", "0") in ("1", "unroll", "scan")
    if fused_diag and kind != Factorization.LLT:
        raise ValueError("the fused DIAG (fused_diag=True) is LLᵗ only, as "
                         "the reference's PASTIX_FUSED_DIAG is")
    return bool(fused_diag)


def _llt_diag(pool: torch.Tensor, lv, fused: bool):
    """An LLᵗ level's DIAG: its diagonal tiles become L in place; returns
    the transposed inverses for the panel TRSM (None without panels).
    Fused, a level with panels is one launch of K7; otherwise, as the
    reference without its gate, ``cholesky_ex`` and a triangular solve."""
    if fused and lv.tp.numel():
        return chol_inv_pool(pool, lv.diag).transpose(1, 2)
    L = potrf_batch(pool[lv.diag])
    pool[lv.diag] = L
    return tri_inv_batch(L).transpose(1, 2) if lv.tp.numel() else None


@dataclasses.dataclass
class _Level:
    cols: torch.Tensor  # the level's block columns
    diag: torch.Tensor  # pool idx of the level's diagonal tiles
    tp: torch.Tensor  # pool idx of its panel tiles
    tc: torch.Tensor  # each panel's block column
    tcpos: torch.Tensor  # each panel's column position in the level
    ll: list = dataclasses.field(default_factory=list)  # LLChunk plan of
    # the updates into this level (left-looking)
    schur: list = dataclasses.field(default_factory=list)  # PipeChunk plan
    # of its updates into Schur columns (left-looking)
    ll_nd: list = dataclasses.field(default_factory=list)  # LU: the
    # Ut-side mirror of ll (off-diagonal targets)
    schur_nd: list = dataclasses.field(default_factory=list)  # LU: the
    # Ut-side mirror of schur
    # right-looking: the level's own updates after its TRSM
    full: list = dataclasses.field(default_factory=list)  # K3 (p_full)
    nd: list = dataclasses.field(default_factory=list)  # LU Ut mirror
    blk: list = dataclasses.field(default_factory=list)  # K5 (p_blk)
    slab: list = dataclasses.field(default_factory=list)  # K6 (p_slab)
    fb: list = dataclasses.field(default_factory=list)  # K3 on the
    # block or slab plan's fallback pairs (p_fb)


def build_factorize_fn(layout: SolverLayout, device, kind=Factorization.LLT,
                       update_dtype=None, dense_tail=None, e2=None,
                       fused_diag=None):
    """The program of ``kind`` for this pattern, in place on the pools,
    where the reference donates them to its jitted program:

    - LLᵗ: ``fn(pool) -> pool``;
    - LDLᵗ: ``fn(pool, eps) -> (pool, d, npiv)``;
    - LU: ``fn(pool, pool_u, eps) -> (pool, pool_u, npiv)``;

    ``npiv`` the number of clamped pivots, a 0-d int32 device tensor.

    Per level: the incoming left-looking pass (kernel K1; LDLᵗ scales a
    by the source columns' pivots, LU runs it on ``pool`` with b from
    ``pool_u`` and again on ``pool_u`` for the off-diagonal mirror), the
    diagonal tiles (LLᵗ: batched Cholesky; LDLᵗ, LU: kernel K4), the panel
    TRSM as a matmul with the inverted diagonals (LDLᵗ then divides by
    d; LU: ``L = A U⁻¹`` and ``Ut = Aᵗ L⁻ᵗ``), then the level's updates
    into Schur columns (kernel K3, with the same variant as K1; a layout
    built with ``schur_first_bcol``).  With ``dense_tail``
    (``plan_dense_tail``, LLᵗ only): the tail pre-pass (K1 again) and a
    blocked dense Cholesky of the trailing block.  ``update_dtype``
    (None, torch.float32 or torch.bfloat16) rounds the operands of every
    trailing update.  ``e2`` picks the E2 schedule (:func:`e2_schedule`;
    None: the reference's environment variables): this description is
    the left-looking one, :func:`_build_right_looking` the others'.
    ``fused_diag`` fuses the LLᵗ DIAG (:func:`fused_diag_gate`; None: the
    reference's ``PASTIX_FUSED_DIAG``), on either schedule.

    ``fn.levels`` / ``fn.tail`` hold the K1 and K3 plans (right-looking:
    the K3, K5 and K6 plans); ``fn.e2_saved_flops`` counts the
    row-bounded savings against the full-tile count; ``fn.e2`` and
    ``fn.compact`` name the schedule, ``fn.fused_diag`` the DIAG."""
    kind = Factorization(kind)
    if kind not in (Factorization.LLT, Factorization.LDLT, Factorization.LU):
        raise NotImplementedError(f"{kind} is not ported (ROADMAP.md slice 3)")
    if dense_tail is not None and kind != Factorization.LLT:
        raise ValueError("the dense tail is LLᵗ only (the reference's rule)")
    mode, compact = e2_schedule(kind, update_dtype, e2)
    fused = fused_diag_gate(kind, fused_diag)
    if mode != "left":
        return _build_right_looking(layout, device, kind, update_dtype,
                                    dense_tail, mode, compact, fused)
    is_lu, scaled = kind == Factorization.LU, kind == Factorization.LDLT
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

    def schedule(ga, gb, gd, gk=None, mode="auto"):
        nonlocal e2_saved
        if not ga.size:
            return []
        sched = build_ll_schedule(ga, gb, gd, gk=gk, group=_LL_GROUP,
                                  cap=_LL_CAP, mode=mode, rb=rb, T=T)
        for c in sched:
            e2_saved += c["n_real"] * (T - c["H"]) * 2.0 * T ** 2
        return ll_plan(sched, device)

    def pipe(ga, gb, gd, gk=None):
        if not ga.size:
            return []
        return pipeline_plan(build_pipeline_schedule(
            ga, gb, gd, gk=gk, group=_PIPE_GROUP, chunk=_PIPE_CHUNK,
        ), device)

    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    plan = []
    for lv, inc, res in zip(levels, incoming, reduced):
        ga, gb, gd, gk, nd = inc
        nd_r = res.gemm_nondiag
        plan.append(_Level(
            cols=tens(lv.cols), diag=tens(lv.diag), tp=tens(lv.trsm_panel),
            tc=tens(lv.trsm_col),
            tcpos=tens(np.searchsorted(lv.cols, lv.trsm_col)),
            ll=schedule(ga, gb, gd, gk if scaled else None),
            schur=pipe(res.gemm_a, res.gemm_b, res.gemm_d,
                       res.gemm_k if scaled else None),
            ll_nd=schedule(ga[nd], gb[nd], gd[nd]) if is_lu else [],
            schur_nd=(pipe(res.gemm_a[nd_r], res.gemm_b[nd_r],
                           res.gemm_d[nd_r]) if is_lu else []),
        ))
    # dense-tail pre-pass: every update into a tail tile, once; the
    # reference measured per-pair fp32 a reads (bcache) best here
    tail_plan = (
        schedule(*tail[:3], mode="bcache") if tail is not None else []
    )
    tail_factor = (
        _build_tail_factor(dense_tail, T, device, update_dtype, fused)
        if dense_tail is not None else None
    )

    def panels(lv):
        """(tp, tcpos, tc) of the level's panel tiles, in chunks."""
        for lo in range(0, lv.tp.numel(), _PANEL_CHUNK):
            sl = slice(lo, lo + _PANEL_CHUNK)
            yield lv.tp[sl], lv.tcpos[sl], lv.tc[sl]

    def fact_llt(pool: torch.Tensor) -> torch.Tensor:
        for lv in plan:
            if lv.ll:
                gemm_scatter_ll(pool, lv.ll, update_dtype)
            dinv_t = _llt_diag(pool, lv, fused)
            if lv.tp.numel():
                for tp, tcpos, _ in panels(lv):
                    pool[tp] = torch.matmul(pool[tp], dinv_t[tcpos])
            if lv.schur:
                gemm_scatter_pipelined(pool, lv.schur, update_dtype,
                                       compact=compact)
        if tail_plan:
            gemm_scatter_ll(pool, tail_plan, update_dtype)
        if tail_factor is not None:
            tail_factor(pool)
        return pool

    def fact_ldlt(pool: torch.Tensor, eps: float):
        d = torch.ones((layout.nbc, T), dtype=pool.dtype, device=pool.device)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            if lv.ll:
                gemm_scatter_ll(pool, lv.ll, update_dtype, d=d)
            d[lv.cols] = tile_factor(pool, lv.diag, eps, npiv, lu=False)
            if lv.tp.numel():
                # L(I, J) = A(I, J) L⁻ᵗ D⁻¹
                linv_t = tri_inv_batch(pool[lv.diag], unit=True).transpose(1, 2)
                for tp, tcpos, tc in panels(lv):
                    pool[tp] = (torch.matmul(pool[tp], linv_t[tcpos])
                                / d[tc][:, None, :])
            if lv.schur:
                gemm_scatter_pipelined(pool, lv.schur, update_dtype, d=d,
                                       compact=compact)
        return pool, d, npiv

    def fact_lu(pool: torch.Tensor, pool_u: torch.Tensor, eps: float):
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            # A(I, K) -= L(I, J) U(J, K) into the L pool (b = Ut tiles),
            # then the Ut-side mirror for off-diagonal targets
            if lv.ll:
                gemm_scatter_ll(pool, lv.ll, update_dtype, src_pool=pool_u)
            if lv.ll_nd:
                gemm_scatter_ll(pool_u, lv.ll_nd, update_dtype, src_pool=pool)
            tile_factor(pool, lv.diag, eps, npiv, lu=True)
            if lv.tp.numel():
                D = pool[lv.diag]
                uinv = tri_inv_batch(D, upper=True)
                linv_t = tri_inv_batch(D, unit=True).transpose(1, 2)
                for tp, tcpos, _ in panels(lv):
                    pool[tp] = torch.matmul(pool[tp], uinv[tcpos])
                    pool_u[tp] = torch.matmul(pool_u[tp], linv_t[tcpos])
            if lv.schur:
                gemm_scatter_pipelined(pool, lv.schur, update_dtype,
                                       src_pool=pool_u, compact=compact)
            if lv.schur_nd:
                gemm_scatter_pipelined(pool_u, lv.schur_nd, update_dtype,
                                       src_pool=pool, compact=compact)
        return pool, pool_u, npiv

    fn = {Factorization.LLT: fact_llt, Factorization.LDLT: fact_ldlt,
          Factorization.LU: fact_lu}[kind]
    fn.kind = kind
    fn.levels = plan
    fn.tail = tail_plan
    fn.e2_saved_flops = e2_saved
    fn.e2, fn.compact = mode, compact
    fn.fused_diag = fused
    return fn


def _build_right_looking(layout, device, kind, update_dtype, dense_tail,
                         mode, compact, fused):
    """The reference's round-4 right-looking program (``PASTIX_E2_LL=0``),
    with the signatures of :func:`build_factorize_fn`.  Per level: the
    diagonal tiles, the panel TRSM, then the level's own updates
    (``lv.gemm_*``), every level unrolled:

    - ``stream``: the TRSM also writes a bf16 copy of the level's panels
      (LU: of both pools') in panel order, and K3 reads both operands
      from it (``xab``; the reference's ``_trsm_stream``);
    - ``block``: K5 over the dst-block plan, then K3 on its fallback;
    - ``slab``: K6 over the panel-slab plan, then K3 on its fallback;
    - ``pair``: K3 over the level's pairs (LU: b from ``pool_u``, and the
      ``pool_u`` mirror of the off-diagonal targets with b from ``pool``);
      a block or slab level whose plan keeps no pair runs so too.

    ``compact``: K3 calls that read no stream gather their operands per
    chunk.  The dense tail (LLᵗ) takes its updates from the levels' pairs
    and has no pre-pass; Schur columns are ordinary targets."""
    is_lu, scaled = kind == Factorization.LU, kind == Factorization.LDLT
    T, nbc, npool = layout.T, layout.nbc, layout.npool
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    env = os.environ.get
    diag_of_col = np.asarray(layout.lookup(np.arange(nbc), np.arange(nbc)))
    rbounds = None
    if layout.row_lo is not None and env("PASTIX_SLAB_BOUND", "1") != "0":
        rbounds = (layout.row_lo, layout.row_hi)
    slab_kw = {  # 0: per-level auto (C from the panel lengths, H = 4C)
        "C": int(env("PASTIX_SLAB_C", "0")),
        "H": int(env("PASTIX_SLAB_H", "0")),
        "G": int(env("PASTIX_SLAB_G", "4")),
        "min_panel": int(env("PASTIX_SLAB_MINPANEL", "6")),
    }
    stats = {"e2_saved": 0.0, "n_block_pairs": 0, "n_slab_pairs": 0}

    def pipe(ga, gb, gd, gk=None, ext=None):
        if not ga.size:
            return []
        return pipeline_plan(build_pipeline_schedule(
            np.asarray(ga, np.int32), np.asarray(gb, np.int32),
            np.asarray(gd, np.int32),
            gk=None if gk is None else np.asarray(gk, np.int32),
            group=_PIPE_GROUP, chunk=_PIPE_CHUNK, ext_tiles=ext,
        ), device)

    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    plan = []
    for lv in levels:
        r = _Level(
            cols=tens(lv.cols), diag=tens(lv.diag), tp=tens(lv.trsm_panel),
            tc=tens(lv.trsm_col),
            tcpos=tens(np.searchsorted(lv.cols, lv.trsm_col)),
        )
        ga, gb, gd, gk = lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k
        nd = np.asarray(lv.gemm_nondiag, bool)
        ext = lv.trsm_panel if mode == "stream" else None
        if ga.size and mode == "block":
            bp = build_block_plan(ga, gb, gd, gk, layout.blk_row,
                                  layout.blk_col, layout.keys, nbc, npool)
            if bp.n_block_pairs:
                r.blk = block_plan(bp, layout.blk_row, device)
                r.fb = pipe(*bp.fallback)
                st = bp.stats
                stats["n_block_pairs"] += bp.n_block_pairs
                # entries execute ha x hb class products on the TPU;
                # the saving can be negative (the reference's count)
                stats["e2_saved"] += (
                    st["pairs_blk"] - st["exec_tile_products"]) * 2.0 * T ** 3
        elif ga.size and mode == "slab":
            sp_ = build_slab_plan(ga, gb, gd, gk, diag_of_col, npool,
                                  rbounds=rbounds, T=T, **slab_kw)
            if sp_.n_slab_pairs:
                r.slab = slab_plan(sp_, T, device)
                r.fb = pipe(*sp_.fallback)
                st = sp_.stats
                stats["n_slab_pairs"] += sp_.n_slab_pairs
                stats["e2_saved"] += (
                    st["pairs_slab"] * (1.0 - st["flop_frac"]) * 2.0 * T ** 3)
        if ga.size and not (r.blk or r.slab):
            r.full = pipe(ga, gb, gd, gk, ext=ext)
            if is_lu and nd.any():
                r.nd = pipe(ga[nd], gb[nd], gd[nd], ext=ext)
        plan.append(r)
    tail_factor = (
        _build_tail_factor(dense_tail, T, device, update_dtype, fused)
        if dense_tail is not None else None
    )
    stream = mode == "stream"
    k3 = lambda pool, chunks, **kw: gemm_scatter_pipelined(
        pool, chunks, update_dtype, **kw)

    def trsm(lv, sides):
        """Panel TRSM of each (pool, fn(tp, tcpos, tc) -> panels) in
        ``sides``, in chunks of _PANEL_CHUNK panels; in stream mode also
        the bf16 panel streams, in the level's panel order."""
        nt = lv.tp.numel()
        xs = [torch.empty((nt, T, T), dtype=update_dtype, device=lv.tp.device)
              for _ in sides] if stream else None
        for lo in range(0, nt, _PANEL_CHUNK):
            sl = slice(lo, lo + _PANEL_CHUNK)
            tp, tcpos, tc = lv.tp[sl], lv.tcpos[sl], lv.tc[sl]
            for i, (pool, panel) in enumerate(sides):
                P = panel(tp, tcpos, tc)
                pool[tp] = P
                if stream:
                    xs[i][sl] = P.to(update_dtype)
        return xs

    def e2_level(lv, pool, xs=None, d=None, pool_u=None):
        """The level's updates after its TRSM (see the docstring)."""
        if lv.blk or lv.slab:
            if lv.blk:
                gemm_scatter_block(pool, lv.blk, update_dtype, d=d)
            else:
                gemm_scatter_slab(pool, lv.slab, update_dtype, d=d)
            if lv.fb:
                k3(pool, lv.fb, d=d, compact=compact)
            return
        if xs is not None:
            xab = xs[0] if pool_u is None else (xs[0], xs[1])
            if lv.full:
                k3(pool, lv.full, d=d, xab=xab)
            if lv.nd:
                k3(pool_u, lv.nd, xab=(xs[1], xs[0]))
            return
        if lv.full:
            k3(pool, lv.full, d=d, src_pool=pool_u, compact=compact)
        if lv.nd:
            k3(pool_u, lv.nd, src_pool=pool, compact=compact)

    def fact_llt(pool: torch.Tensor) -> torch.Tensor:
        for lv in plan:
            dinv_t = _llt_diag(pool, lv, fused)
            if lv.tp.numel():
                xs = trsm(lv, [(pool, lambda tp, tcpos, tc: torch.matmul(
                    pool[tp], dinv_t[tcpos]))])
                e2_level(lv, pool, xs)
        if tail_factor is not None:
            tail_factor(pool)
        return pool

    def fact_ldlt(pool: torch.Tensor, eps: float):
        d = torch.ones((nbc, T), dtype=pool.dtype, device=pool.device)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            d[lv.cols] = tile_factor(pool, lv.diag, eps, npiv, lu=False)
            if lv.tp.numel():
                # L(I, J) = A(I, J) L⁻ᵗ D⁻¹
                linv_t = tri_inv_batch(pool[lv.diag], unit=True).transpose(1, 2)
                xs = trsm(lv, [(pool, lambda tp, tcpos, tc: torch.matmul(
                    pool[tp], linv_t[tcpos]) / d[tc][:, None, :])])
                e2_level(lv, pool, xs, d=d)
        return pool, d, npiv

    def fact_lu(pool: torch.Tensor, pool_u: torch.Tensor, eps: float):
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            tile_factor(pool, lv.diag, eps, npiv, lu=True)
            if lv.tp.numel():
                D = pool[lv.diag]
                uinv = tri_inv_batch(D, upper=True)
                linv_t = tri_inv_batch(D, unit=True).transpose(1, 2)
                # L = A U⁻¹ and Ut = Aᵗ L⁻ᵗ; then A(I, K) -= L(I, J) U(J, K)
                xs = trsm(lv, [
                    (pool, lambda tp, tcpos, tc: torch.matmul(
                        pool[tp], uinv[tcpos])),
                    (pool_u, lambda tp, tcpos, tc: torch.matmul(
                        pool_u[tp], linv_t[tcpos])),
                ])
                e2_level(lv, pool, xs, pool_u=pool_u)
        return pool, pool_u, npiv

    fn = {Factorization.LLT: fact_llt, Factorization.LDLT: fact_ldlt,
          Factorization.LU: fact_lu}[kind]
    fn.kind = kind
    fn.levels = plan
    fn.tail = []
    fn.e2_saved_flops = stats["e2_saved"]
    fn.e2, fn.compact = mode, compact
    fn.fused_diag = fused
    fn.n_block_pairs = stats["n_block_pairs"]
    fn.n_slab_pairs = stats["n_slab_pairs"]
    return fn


def _build_tail_factor(dense_tail, T, device, update_dtype, fused=False):
    """Blocked right-looking Cholesky of the dense trailing block
    (reference ``tail_factor`` / ``tail_factor_blocked``): gather the tail
    tiles into one (m, m) matrix (missing upper tiles stay zero, only the
    lower triangle is read), factor, scatter the lower tiles back.
    Trailing updates round their operands to ``update_dtype``; upper
    blocks accumulate the symmetric mirror and are never read back.
    ``fused``: each diagonal block, symmetrized from its lower triangle
    (the reference's ``_symf``), goes through K8 (``chol_inv``), which
    gives L and L⁻¹ in one launch; else ``cholesky_ex`` and a triangular
    solve."""
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
            if fused:
                blk = A[s0:s1, s0:s1]
                Lj, inv = chol_inv(
                    (torch.tril(blk) + torch.tril(blk, -1).T)[None])
            else:
                Lj = potrf_batch(A[None, s0:s1, s0:s1])
            A[s0:s1, s0:s1] = Lj[0]
            if j + 1 == q:
                break
            if not fused:
                inv = tri_inv_batch(Lj)
            P = A[s1:, s0:s1] @ inv[0].T
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


def build_diag_inverse_fn(layout: SolverLayout, device,
                          kind=Factorization.LLT):
    """``fn(pool) -> dinv`` (LU: ``(dinv, dinv_u)``): the (nbc, T, T)
    inverses of the factored diagonal tiles, by a batched triangular solve
    (the reference's ``_tri_inverse_doubling`` works around a slow TPU
    triangular solve): lower for LLᵗ, unit lower for LDLᵗ and LU, and for
    LU also the upper triangle of the combined tile.  A Schur column's
    diagonal tile holds S, not a triangle: it is neither read nor
    inverted, and its slot stays zero (no sweep reads it)."""
    kind = Factorization(kind)
    cols = factored_cols(layout)
    col_t = torch.as_tensor(cols, device=device)
    diag_idx = torch.as_tensor(layout.lookup(cols, cols), device=device)
    nbc, T = layout.nbc, layout.T
    unit = kind != Factorization.LLT

    def inverse(tiles, upper):
        dinv = torch.zeros((nbc, T, T), dtype=tiles.dtype, device=tiles.device)
        dinv[col_t] = tri_inv_batch(tiles, upper=upper,
                                    unit=unit and not upper)
        return dinv

    def fn(pool: torch.Tensor):
        tiles = pool[diag_idx]
        if kind == Factorization.LU:
            return inverse(tiles, False), inverse(tiles, True)
        return inverse(tiles, False)

    return fn


def factorize(layout: SolverLayout, A_perm: sp.spmatrix, coef_fn, fact_fn,
              device, pivot_threshold: float = 1e-14) -> Factors:
    """Host driver: coefinit on the device from the nnz values, run the
    factorization of ``fact_fn.kind``, then one host read (reference
    ``factorize``): the LLᵗ breakdown check, or the count of clamped
    pivots, whose threshold is ``pivot_threshold · max|A_perm|``."""
    kind = fact_fn.kind
    vals = torch.as_tensor(
        sp.coo_matrix(A_perm).data.astype(np.float32), device=device
    )
    if kind == Factorization.LDLT or kind == Factorization.LU:
        anorm = float(abs(A_perm).max()) if A_perm.nnz else 1.0
        eps = pivot_threshold * anorm
        if kind == Factorization.LU:
            pool, pool_u, npiv = fact_fn(*coef_fn(vals), eps)
            return Factors(kind, layout, pool, pool_u=pool_u,
                           n_static_pivots=int(npiv))
        pool, d, npiv = fact_fn(coef_fn(vals), eps)
        return Factors(kind, layout, pool, d=d, n_static_pivots=int(npiv))
    pool = fact_fn(coef_fn(vals))
    cols = factored_cols(layout)
    diag_of_col = torch.as_tensor(layout.lookup(cols, cols), device=device)
    dvals = torch.diagonal(pool[diag_of_col], dim1=-2, dim2=-1)
    if not bool(torch.isfinite(dvals).all()):
        raise FloatingPointError(
            "LL^T factorization broke down (NaN/Inf pivot): the matrix is "
            "not positive definite. Use Factorization.LDLT (static "
            "pivoting) or LU for indefinite or unsymmetric systems."
        )
    return Factors(Factorization.LLT, layout, pool)
