"""Numeric factorization: LLᵗ (LLᴴ), LDLᵗ, LDLᴴ and LU (PyTorch
counterpart of ``pastix_tpu/numeric/factorize.py``).

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

That is the route of an fp32 real pool.  Every other pool (fp64,
complex64, complex128: :func:`_build_plain`) runs the reference's XLA
functions as torch ops, as the reference sends complex pools around every
Pallas kernel: left-looking over the same ``regroup_left`` tables, the
updates gathered, multiplied with ``bmm`` and scattered with
``index_add_`` in byte-capped chunks (``kernels.gemm_scatter``), the
diagonal tiles through ``cholesky_ex`` or the reference's T-step loops
(``kernels.potrf_sym_batch``, ``ldlt_batch``, ``getrf_batch``), the panel
TRSM through ``solve_triangular``.  ``hermitian`` conjugates the b side
of each update, the TRSM and the dense tail (LLᴴ, LDLᴴ).
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
from pastix_tpu_torch.numeric.kernels import (
    chunk_len, gemm_scatter, gemm_scatter_ab, getrf_batch, ldlt_batch,
    np_dtype, op_t, potrf_batch, round_to, trsm_ldlt, trsm_llt, trsm_lu_l,
    trsm_lu_u, tri_inv_batch,
)
from pastix_tpu_torch.numeric.leftlook import (
    build_ll_schedule, gemm_scatter_ll, ll_plan, regroup_left,
)
from pastix_tpu_torch.numeric.packed import build_packed_fn
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
                      for_lu: bool = False, dtype=torch.float32,
                      pin_memory: bool = False):
    """Device coefinit: ``fn(vals) -> pool`` (``(pool, pool_u)`` with
    ``for_lu``) with ``vals`` the COO data of ``A_pattern``
    (``sp.coo_matrix(A_perm).data``) as a tensor on ``device``, the pools
    in ``dtype`` (``fn.dtype``; on the CPU in pinned memory with
    ``pin_memory``, which the streamed factorization copies from).
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
        pool = torch.zeros(numel, dtype=dtype, device=device,
                           pin_memory=pin_memory)
        pool.index_put_((idx,), vals[sel].to(dtype), accumulate=True)
        return pool

    def fn(vals: torch.Tensor):
        pool = scatter(vals, sel_l, flat_l)
        pool[pad_t] = 1.0
        if not for_lu:
            return pool.view(layout.pool_shape)
        return (pool.view(layout.pool_shape),
                scatter(vals, sel_u, flat_u).view(layout.pool_shape))

    fn.dtype = dtype
    return fn


def coefinit(layout: SolverLayout, A_perm: sp.spmatrix, dtype=torch.float32,
             for_lu: bool = False):
    """Host coefinit (reference ``coefinit``): (pool, pool_u) as tensors
    in host memory (``pool_u`` None unless ``for_lu``), A's values
    scattered as :func:`build_coefinit_fn` scatters them on a device.
    The streamed factorization (``numeric/ooc``) starts from it."""
    fn = build_coefinit_fn(layout, A_perm, torch.device("cpu"), for_lu, dtype)
    pools = fn(torch.as_tensor(sp.coo_matrix(A_perm).data.astype(
        np_dtype(dtype))))
    return pools if for_lu else (pools, None)


@dataclasses.dataclass
class Factors:
    """Factorization result, as tensors on one device: the factored tile
    pool (L tiles; LU: L and the combined diagonal tiles), the Uᵗ pool
    (LU), the pivots (LDLᵗ, LDLᴴ) and the inverse diagonal tiles.  The
    pool's dtype is the factors' (``dtype``); ``hermitian`` says that a
    complex pool holds L of A = L Lᴴ or L D Lᴴ."""

    kind: Factorization
    layout: SolverLayout
    pool: torch.Tensor  # (npool, T, T) L (or combined LU diag) tiles
    pool_u: Optional[torch.Tensor] = None  # (npool, T, T) Ut tiles (LU)
    d: Optional[torch.Tensor] = None  # (nbc, T) pivots (LDLᵗ, LDLᴴ)
    dinv: Optional[torch.Tensor] = None  # (nbc, T, T) inverse (unit) lower
    dinv_u: Optional[torch.Tensor] = None  # (nbc, T, T) inverse upper (LU)
    n_static_pivots: int = 0
    hermitian: bool = False
    # the pools are in host memory: moved there after the factorization
    # (offloaded) or factored there segment by segment (streamed,
    # numeric/ooc); a solve brings them to the card or streams them
    offloaded: bool = False
    streamed: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return self.pool.dtype

    def solve_args(self) -> tuple:
        """The tensors the kind's sweeps take (``solve.build_fwd_bwd_fns``)."""
        if self.kind == Factorization.LU:
            return (self.pool, self.pool_u, self.dinv, self.dinv_u)
        if self.kind in (Factorization.LDLT, Factorization.LDLH):
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


class Workspace:
    """Fixed memory for :func:`diag_trsm`'s gathers, allocated once where
    a budget bounds them (the streamed segments, ``numeric/ooc``): (a, b,
    c) of ``ct`` tiles each (a TRSM chunk's panels, their inverses, their
    product), (g1, g2, g3) of ``g`` tiles each (a group's diagonal tiles,
    their factor or inverses), the ``cholesky_ex`` info and the
    identity.  Without one, :func:`diag_trsm` allocates what each call
    needs."""

    def __init__(self, ct: int, g: int, T: int, dtype, device):
        tiles = lambda n: torch.empty((n, T, T), dtype=dtype, device=device)
        self.a, self.b, self.c = tiles(ct), tiles(ct), tiles(ct)
        self.g1, self.g2, self.g3 = tiles(g), tiles(g), tiles(g)
        self.info = torch.empty(g, dtype=torch.int32, device=device)
        self.eye = torch.eye(T, dtype=dtype, device=device)


def diag_trsm(kind, lv, pool, pool_u=None, d=None, npiv=None, eps=0.0, *,
              fused=False, chunk=None, work=None, xs=None) -> None:
    """The DIAG and panel TRSM of a level, or of a group of its columns
    (``lv``: ``cols``, ``diag``, ``tp``, ``tcpos``, ``tc``), on the fp32
    route, in place: the diagonal tiles (LLᵗ ``cholesky_ex``, a broken
    tile turned NaN as ``kernels.potrf_batch`` makes it, or one launch
    of K7 when ``fused``; LDLᵗ and LU kernel K4, LDLᵗ's pivots into
    ``d[lv.cols]``, the clamps counted in ``npiv``), their inverses, then
    the panels times the inverses, ``chunk`` panels at a time (default
    ``_PANEL_CHUNK``): LLᵗ ``L = A L⁻ᵗ``, LDLᵗ ``L = A L⁻ᵗ D⁻¹``, LU ``L =
    A U⁻¹`` and ``Ut = Aᵗ L⁻ᵗ`` (into ``pool_u``).  The gathers go through
    ``work`` (:class:`Workspace`) or tensors of their size; ``xs`` (the
    stream schedule) takes each side's panels, in panel order."""
    n, nt = lv.diag.numel(), lv.tp.numel()
    T, dt, dev = pool.shape[-1], pool.dtype, pool.device
    tiles = lambda name, m: (getattr(work, name)[:m] if work is not None
                             else torch.empty((m, T, T), dtype=dt, device=dev))
    if kind == Factorization.LLT and fused and nt:
        sides = [(pool, chol_inv_pool(pool, lv.diag).transpose(1, 2), None)]
    else:
        G1, G3 = tiles("g1", n), tiles("g3", n)
        eye = (work.eye if work is not None
               else torch.eye(T, dtype=dt, device=dev)).expand(n, -1, -1)
        if kind == Factorization.LLT:
            G2 = tiles("g2", n)
            torch.index_select(pool, 0, lv.diag, out=G1)
            info = (work.info[:n] if work is not None
                    else torch.empty(n, dtype=torch.int32, device=dev))
            torch.linalg.cholesky_ex(G1, out=(G2, info))
            G2.masked_fill_((info != 0)[:, None, None], float("nan"))
            pool.index_copy_(0, lv.diag, G2)
            if not nt:
                return
            torch.linalg.solve_triangular(G2, eye, upper=False, out=G3)
            sides = [(pool, G3.transpose(1, 2), None)]
        else:
            piv = tile_factor(pool, lv.diag, eps, npiv,
                              lu=kind == Factorization.LU)
            if kind == Factorization.LDLT:
                d[lv.cols] = piv
            if not nt:
                return
            torch.index_select(pool, 0, lv.diag, out=G1)
            torch.linalg.solve_triangular(G1, eye, upper=False,
                                          unitriangular=True, out=G3)
            if kind == Factorization.LDLT:
                sides = [(pool, G3.transpose(1, 2), d)]
            else:
                G2 = tiles("g2", n)
                torch.linalg.solve_triangular(G1, eye, upper=True, out=G2)
                sides = [(pool, G2, None), (pool_u, G3.transpose(1, 2), None)]
    step = chunk or _PANEL_CHUNK
    for lo in range(0, nt, step):
        sl = slice(lo, lo + step)
        p, q, c = lv.tp[sl], lv.tcpos[sl], lv.tc[sl]
        m = p.numel()
        A, B, C = tiles("a", m), tiles("b", m), tiles("c", m)
        for i, (side, inv, dd) in enumerate(sides):
            torch.index_select(side, 0, p, out=A)
            torch.index_select(inv, 0, q, out=B)
            torch.bmm(A, B, out=C)
            if dd is not None:
                C.div_(dd[c][:, None, :])
            side.index_copy_(0, p, C)
            if xs is not None:
                xs[i][sl] = C


def plain_diag_trsm(kind, lv, pool, pool_u=None, d=None, npiv=None, eps=0.0,
                    hermitian=False, chunk=None) -> None:
    """:func:`diag_trsm` of the other pools (fp64, complex), by the torch
    ops of ``numeric/kernels``: ``potrf_batch`` (the unconjugated loop
    for complex-symmetric LLᵗ), ``ldlt_batch`` or ``getrf_batch``, then
    ``trsm_*`` (``hermitian``: LLᴴ, LDLᴴ), ``chunk`` panels at a time
    (default ``_PANEL_CHUNK``).  ``eps`` in the pool's precision."""
    step = chunk or _PANEL_CHUNK
    chunks = [(lv.tp[lo:lo + step], lv.tcpos[lo:lo + step],
               lv.tc[lo:lo + step]) for lo in range(0, lv.tp.numel(), step)]
    if kind == Factorization.LLT:
        L = potrf_batch(pool[lv.diag], hermitian=hermitian)
        pool[lv.diag] = L
        for tp, tcpos, _ in chunks:
            pool[tp] = trsm_llt(pool[tp], L[tcpos], hermitian)
    elif kind == Factorization.LU:
        M, n = getrf_batch(pool[lv.diag], eps)
        pool[lv.diag] = M
        npiv += n
        for tp, tcpos, _ in chunks:
            pool[tp] = trsm_lu_l(pool[tp], M[tcpos])
            pool_u[tp] = trsm_lu_u(pool_u[tp], M[tcpos])
    else:
        # L(I, J) = A(I, J) L⁻ᵗ D⁻¹ (L⁻ᴴ for LDLᴴ)
        L, dl, n = ldlt_batch(pool[lv.diag], eps, hermitian)
        pool[lv.diag] = L
        d[lv.cols] = dl
        npiv += n
        for tp, tcpos, tc in chunks:
            pool[tp] = trsm_ldlt(pool[tp], L[tcpos], d[tc], hermitian)


def plain_update(pool, inc, update_dtype, d=None, hermitian=False,
                 src_pool=None, step=None) -> None:
    """The updates ``inc`` = (ga, gb, gd, gk) into ``pool`` by the torch
    ops of ``numeric/kernels``, ``step`` triples at a time (default
    ``kernels.chunk_len``): ``gemm_scatter`` (LDLᵗ, LDLᴴ: a scaled by
    ``d[gk]``), or with ``src_pool`` (LU) ``gemm_scatter_ab`` with b from
    it."""
    ga, gb, gd, gk = inc
    step = step or chunk_len(pool)
    for lo in range(0, ga.numel(), step):
        sl = slice(lo, lo + step)
        if src_pool is not None:
            gemm_scatter_ab(pool, pool, src_pool, ga[sl], gb[sl], gd[sl],
                            update_dtype)
        else:
            gemm_scatter(pool, ga[sl], gb[sl], gd[sl], update_dtype,
                         None if d is None else d[gk[sl]],
                         hermitian=hermitian)


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
    # non-fp32 pools (_build_plain): the (ga, gb, gd, gk) index tensors of
    # the updates into this level, and (ga, gb, gd) of LU's Ut mirror;
    # the same of its updates into Schur columns
    inc: tuple = ()
    inc_nd: tuple = ()
    res: tuple = ()
    res_nd: tuple = ()
    # right-looking: the level's own updates after its TRSM
    full: list = dataclasses.field(default_factory=list)  # K3 (p_full)
    nd: list = dataclasses.field(default_factory=list)  # LU Ut mirror
    blk: list = dataclasses.field(default_factory=list)  # K5 (p_blk)
    slab: list = dataclasses.field(default_factory=list)  # K6 (p_slab)
    fb: list = dataclasses.field(default_factory=list)  # K3 on the
    # block or slab plan's fallback pairs (p_fb)


def build_factorize_fn(layout: SolverLayout, device, kind=Factorization.LLT,
                       update_dtype=None, dense_tail=None, e2=None,
                       fused_diag=None, dtype=torch.float32, hermitian=None,
                       packed_plan=None, ooc_plan=None):
    """The program of ``kind`` for this pattern, in place on the pools,
    where the reference donates them to its jitted program:

    - LLᵗ: ``fn(pool) -> pool``;
    - LDLᵗ, LDLᴴ: ``fn(pool, eps) -> (pool, d, npiv)``;
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
    ``fn.compact`` name the schedule, ``fn.fused_diag`` the DIAG.

    ``dtype`` is the pools': float32 takes the route above; float64,
    complex64 and complex128 take :func:`_build_plain`.  ``hermitian``
    (default: LLᵗ and LDLᴴ, as the reference's) conjugates a complex
    pool's transposes; LDLᴴ of a real pool is LDLᵗ.

    ``packed_plan`` (``analyze.packed.build_packed_plan`` over the same
    levels) takes the packed E2 path of every dtype,
    ``numeric.packed.build_packed_fn``; it reads neither ``PASTIX_E2_*``
    nor ``PASTIX_FUSED_DIAG``, and an explicit ``e2`` or
    ``fused_diag=True`` with it raises ``ValueError``.

    ``ooc_plan`` (``numeric.ooc.plan_ooc`` over the layout's levels)
    takes the streamed program, ``numeric.ooc.build_streamed_fn``: the
    same signatures on pools in host memory, each segment run on
    ``device``; it reads neither variable either, and an ``e2`` other
    than ``"pair"``, ``fused_diag=True`` or a dense tail with it raises
    ``ValueError``."""
    kind = Factorization(kind)
    if kind == Factorization.LDLH and not dtype.is_complex:
        kind = Factorization.LDLT
    if hermitian is None:
        hermitian = kind in (Factorization.LLT, Factorization.LDLH)
    if update_dtype is not None and dtype.is_complex:
        raise ValueError(
            f"update_dtype={update_dtype} with a {dtype} pool: rounding "
            "drops the imaginary part (the reference's astype does); a "
            "complex pool takes no update dtype")
    if ooc_plan is not None:
        from pastix_tpu_torch.numeric.ooc import build_streamed_fn

        if dense_tail is not None or packed_plan is not None:
            raise ValueError("a streamed factorization has no dense tail "
                             "and no packed plan")
        return build_streamed_fn(layout, ooc_plan, device, kind,
                                 update_dtype, dtype, hermitian, e2,
                                 fused_diag)
    if packed_plan is not None:
        return build_packed_fn(layout, device, kind, update_dtype, dense_tail,
                               packed_plan, dtype, hermitian, e2, fused_diag)
    if dtype != torch.float32:
        return _build_plain(layout, device, kind, update_dtype, dense_tail,
                            e2, fused_diag, dtype, hermitian)
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

    def fact_llt(pool: torch.Tensor) -> torch.Tensor:
        for lv in plan:
            if lv.ll:
                gemm_scatter_ll(pool, lv.ll, update_dtype)
            diag_trsm(kind, lv, pool, fused=fused)
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
            diag_trsm(kind, lv, pool, d=d, npiv=npiv, eps=eps)
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
            diag_trsm(kind, lv, pool, pool_u, npiv=npiv, eps=eps)
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

    def diag_level(lv, pool, pool_u=None, d=None, npiv=None, eps=0.0):
        """:func:`diag_trsm` of the level; in stream mode also the bf16
        panel streams (one a side, LU two), which it returns."""
        xs = [torch.empty((lv.tp.numel(), T, T), dtype=update_dtype,
                          device=pool.device)
              for _ in range(2 if is_lu else 1)] if stream else None
        diag_trsm(kind, lv, pool, pool_u, d, npiv, eps, fused=fused, xs=xs)
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
            xs = diag_level(lv, pool)
            if lv.tp.numel():
                e2_level(lv, pool, xs)
        if tail_factor is not None:
            tail_factor(pool)
        return pool

    def fact_ldlt(pool: torch.Tensor, eps: float):
        d = torch.ones((nbc, T), dtype=pool.dtype, device=pool.device)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            xs = diag_level(lv, pool, d=d, npiv=npiv, eps=eps)
            if lv.tp.numel():
                e2_level(lv, pool, xs, d=d)
        return pool, d, npiv

    def fact_lu(pool: torch.Tensor, pool_u: torch.Tensor, eps: float):
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            # L = A U⁻¹ and Ut = Aᵗ L⁻ᵗ; then A(I, K) -= L(I, J) U(J, K)
            xs = diag_level(lv, pool, pool_u, npiv=npiv, eps=eps)
            if lv.tp.numel():
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


def _build_tail_factor(dense_tail, T, device, update_dtype, fused=False,
                       hermitian=False):
    """Blocked right-looking Cholesky of the dense trailing block
    (reference ``tail_factor`` / ``tail_factor_blocked``): gather the tail
    tiles into one (m, m) matrix (missing upper tiles stay zero, only the
    lower triangle is read), factor, scatter the lower tiles back, in the
    pool's dtype.  Trailing updates round their operands to
    ``update_dtype``; upper blocks accumulate the symmetric mirror and are
    never read back.  ``hermitian``: a complex tail is L Lᴴ (the panel
    solve and the trailing update conjugate; the reference keeps the tail
    for Hermitian LLᵗ only).  ``fused``: each diagonal block, symmetrized
    from its lower triangle (the reference's ``_symf``), goes through K8
    (``chol_inv``), which gives L and L⁻¹ in one launch; else
    ``cholesky_ex`` and a triangular solve."""
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
            P = A[s1:, s0:s1] @ op_t(inv[0], hermitian)
            A[s1:, s0:s1] = P
            Pa = round_to(P, update_dtype)
            A[s1:, s1:].addmm_(Pa, op_t(Pa, hermitian), alpha=-1.0)
        pool[t_p] = dense[t_qi, :, t_qj, :]

    return tail_factor


def _build_plain(layout, device, kind, update_dtype, dense_tail, e2,
                 fused_diag, dtype, hermitian):
    """The route of fp64, complex64 and complex128 pools, with the
    signatures of :func:`build_factorize_fn`: every level left-looking
    over ``regroup_left``'s tables, as the fp32 route, with the
    reference's XLA functions as torch ops in place of the hand kernels
    (the reference runs complex pools around every Pallas kernel).  Per
    level: the updates into it (``kernels.gemm_scatter``, LDLᵗ/LDLᴴ
    scaling a by the source columns' pivots; LU ``gemm_scatter_ab`` with b
    from ``pool_u``, then the Uᵗ mirror), the diagonal tiles
    (``potrf_batch``: ``cholesky_ex`` for LLᴴ and real LLᵗ, the
    unconjugated loop for complex-symmetric LLᵗ; ``ldlt_batch``;
    ``getrf_batch``), then the panel TRSM (``trsm_*``), then the level's
    updates into Schur columns (a layout built with ``schur_first_bcol``:
    the residue ``regroup_left`` leaves, by the same torch ops, LU's Uᵗ
    mirror too), where the fp32 route runs K3.  With ``dense_tail`` (LLᴴ
    and real LLᵗ): the tail pre-pass and the blocked dense Cholesky.
    ``update_dtype`` rounds a real pool's operands (fp64 accumulates bf16
    products, as the reference); a complex pool takes none.  No
    right-looking schedule or fused DIAG (the fp32 kernels), and no
    complex Schur column (the reference has none)."""
    if e2 not in (None, "left"):
        raise NotImplementedError(
            f"e2={e2!r} with a {dtype} pool: the right-looking schedules run "
            "the fp32 kernels K3, K5 and K6 (Pallas schedules the reference "
            "never runs on complex pools); this pool runs left-looking")
    if fused_diag:
        raise NotImplementedError(
            f"fused_diag with a {dtype} pool: the fused DIAG is the fp32 "
            "kernels K7 and K8")
    herm = hermitian and dtype.is_complex
    is_lu = kind == Factorization.LU
    if dense_tail is not None and (kind != Factorization.LLT or (
            dtype.is_complex and not herm)):
        raise ValueError("the dense tail is LLᵗ or LLᴴ only (the "
                         "reference's rule)")
    if dtype.is_complex and factored_cols(layout).size != layout.nbc:
        raise NotImplementedError(
            f"Schur columns with a {dtype} pool: the reference has no "
            "complex Schur complement")
    T = layout.T
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    tail_s = dense_tail.s if dense_tail is not None else None
    reduced, incoming, tail = regroup_left(levels, layout.blk_col, tail_s)
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)

    def updates(ga, gb, gd, gk, nd):
        """(all, LU's Uᵗ mirror) of a list of updates, as index tensors."""
        return (tuple(map(tens, (ga, gb, gd, gk))) if ga.size else (),
                (tuple(map(tens, (ga[nd], gb[nd], gd[nd]))) + (None,)
                 if is_lu and nd.any() else ()))

    plan = []
    for lv, inc, r in zip(levels, incoming, reduced):
        inc, inc_nd = updates(*inc)
        res, res_nd = updates(r.gemm_a, r.gemm_b, r.gemm_d, r.gemm_k,
                              np.asarray(r.gemm_nondiag, bool))
        plan.append(_Level(
            cols=tens(lv.cols), diag=tens(lv.diag), tp=tens(lv.trsm_panel),
            tc=tens(lv.trsm_col),
            tcpos=tens(np.searchsorted(lv.cols, lv.trsm_col)),
            inc=inc, inc_nd=inc_nd, res=res, res_nd=res_nd,
        ))
    tail_inc = (tuple(map(tens, tail[:3]))
                if tail is not None and tail[0].size else ())
    tail_factor = (
        _build_tail_factor(dense_tail, T, device, update_dtype,
                           hermitian=herm)
        if dense_tail is not None else None
    )
    # the clamp threshold as the reference holds it: in the pool's precision
    f_eps = lambda eps: float(torch.tensor(eps, dtype=dtype.to_real()))

    def fact_llt(pool: torch.Tensor) -> torch.Tensor:
        for lv in plan:
            if lv.inc:
                plain_update(pool, lv.inc, update_dtype, hermitian=herm)
            plain_diag_trsm(kind, lv, pool, hermitian=herm)
            if lv.res:
                plain_update(pool, lv.res, update_dtype, hermitian=herm)
        if tail_inc:
            plain_update(pool, tail_inc + (None,), update_dtype,
                         hermitian=herm)
        if tail_factor is not None:
            tail_factor(pool)
        return pool

    def fact_ldlt(pool: torch.Tensor, eps: float):
        eps = f_eps(eps)
        d = torch.ones((layout.nbc, T), dtype=pool.dtype, device=pool.device)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            if lv.inc:
                plain_update(pool, lv.inc, update_dtype, d, herm)
            plain_diag_trsm(kind, lv, pool, d=d, npiv=npiv, eps=eps,
                            hermitian=herm)
            if lv.res:
                plain_update(pool, lv.res, update_dtype, d, herm)
        return pool, d, npiv

    def fact_lu(pool: torch.Tensor, pool_u: torch.Tensor, eps: float):
        eps = f_eps(eps)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            # A(I, K) -= L(I, J) U(J, K) into the L pool (b = Ut tiles),
            # then the Ut-side mirror for off-diagonal targets
            if lv.inc:
                plain_update(pool, lv.inc, update_dtype, src_pool=pool_u)
            if lv.inc_nd:
                plain_update(pool_u, lv.inc_nd, update_dtype, src_pool=pool)
            plain_diag_trsm(kind, lv, pool, pool_u, npiv=npiv, eps=eps)
            if lv.res:
                plain_update(pool, lv.res, update_dtype, src_pool=pool_u)
            if lv.res_nd:
                plain_update(pool_u, lv.res_nd, update_dtype, src_pool=pool)
        return pool, pool_u, npiv

    fn = {Factorization.LLT: fact_llt, Factorization.LDLT: fact_ldlt,
          Factorization.LDLH: fact_ldlt, Factorization.LU: fact_lu}[kind]
    fn.kind = kind
    fn.levels = plan
    fn.tail = tail_inc
    fn.e2_saved_flops = 0.0
    fn.e2, fn.compact = "left", False
    fn.fused_diag = False
    fn.dtype, fn.hermitian = dtype, herm
    return fn


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
    """Host driver: coefinit on the device from the nnz values (cast to
    ``coef_fn.dtype``), run the factorization of ``fact_fn.kind``, then
    one host read (reference ``factorize``): the LLᵗ breakdown check, or
    the count of clamped pivots, whose threshold is ``pivot_threshold ·
    max|A_perm|``."""
    kind = fact_fn.kind
    herm = getattr(fact_fn, "hermitian", False)
    vals = torch.as_tensor(
        sp.coo_matrix(A_perm).data.astype(np_dtype(coef_fn.dtype)),
        device=device,
    )
    if kind != Factorization.LLT:
        anorm = float(abs(A_perm).max()) if A_perm.nnz else 1.0
        eps = pivot_threshold * anorm
        if kind == Factorization.LU:
            pool, pool_u, npiv = fact_fn(*coef_fn(vals), eps)
            return Factors(kind, layout, pool, pool_u=pool_u,
                           n_static_pivots=int(npiv))
        pool, d, npiv = fact_fn(coef_fn(vals), eps)
        return Factors(kind, layout, pool, d=d, n_static_pivots=int(npiv),
                       hermitian=herm)
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
    return Factors(Factorization.LLT, layout, pool, hermitian=herm)
