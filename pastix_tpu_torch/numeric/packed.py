"""The packed E2 path (``packed_update=True`` or ``PASTIX_PACKED``): the
reference's ``llt_level_packed``, ``ldlt_level_packed`` and
``lu_level_packed`` with its ``packed_gemm`` and ``packed_scatter``
(``pastix_tpu/numeric/factorize.py``) as torch ops, over the tables of
``analyze.packed.build_packed_plan``.  The reference writes this path in
plain XLA (gathers, einsums, a row scatter-add; no ``pallas_call``), so
the port adds no kernel for it.

Per level, right-looking: the diagonal tiles are factored (fp32 pools:
``cholesky_ex`` for LLᵗ, kernel K4 for LDLᵗ and LU, then the inverses by
``tri_inv_batch``, as the left-looking route; other pools the T-step
loops of ``kernels``); the level's packed row chunks are gathered from the
row view ``pool.view(npool * T, T)``, solved against their column's
diagonal tile (LDLᵗ then divided by the column's pivots, LU on both
pools) and written back; then each pair of a packed a-chunk and a
post-TRSM grid b-tile forms ``W = a bᵗ`` (LDLᵗ scales a by d; LLᴴ and
LDLᴴ conjugate b), and ``W``'s rows are subtracted from their target rows
(LU: into L through ``dst``, into Uᵗ through ``dst_u``).  The dense tail,
if any, is factored after the levels.  Updates into Schur columns land
there directly, so no residue pass runs.

Out-of-range rows.  The plan marks a pad row of a chunk, the pad chunk
that ends each level and a dropped scatter row by the row index
``npool * T``; JAX clamps such a gather and drops such a scatter.  Here
they are stripped on the host once, when the plan is uploaded: the pad
chunk (which no pair names) is left out, a pad row gathers row 0 and is
never written back, and a dropped scatter row is never scattered, so no
index leaves the pool and no tile is written that the reference leaves
alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.kernels import (
    chunk_len, conj_if, getrf_batch, ldlt_batch, potrf_batch, trsm_ldlt,
    trsm_llt, trsm_lu_l, trsm_lu_u, tri_inv_batch,
)
from pastix_tpu_torch.numeric.tile_factor import tile_factor


@dataclasses.dataclass
class PairChunk:
    """A run of a level's pairs whose gathered operands hold at most
    ``kernels.GATHER_BYTES``, with the rows of ``W`` that land in the
    pool: ``keep`` (positions in the chunk's flattened (k T, T) ``W``; None
    when every row lands) and ``dst`` (their rows in the row view), and
    LU's Uᵗ side ``keep_u``/``dst_u``."""

    pa: torch.Tensor  # (k,) a-chunk of each pair (level-local)
    pgb: torch.Tensor  # (k,) pool index of each pair's b tile
    keep: Optional[torch.Tensor]
    dst: torch.Tensor
    keep_u: Optional[torch.Tensor] = None
    dst_u: Optional[torch.Tensor] = None


@dataclasses.dataclass
class PackedLevelDev:
    """One level of the packed plan on the device: its columns and
    diagonal tiles, its real chunks (``gidx`` with pad rows at row 0;
    ``set_pos`` the positions of the real rows in the flattened chunks,
    None when there is no pad row, ``set_idx`` their rows), each chunk's
    column position ``cpos`` and column ``ccol``, and its pairs in
    chunks."""

    cols: torch.Tensor
    diag: torch.Tensor
    nchunk: int
    gidx: torch.Tensor  # (nchunk, T)
    set_pos: Optional[torch.Tensor]
    set_idx: torch.Tensor
    cpos: torch.Tensor
    ccol: torch.Tensor
    pairs: list


def _kept(dst: np.ndarray, oob: int):
    """(keep positions or None, kept rows) of a flattened (k, T) scatter
    table: the rows below ``oob``."""
    flat = dst.astype(np.int64).ravel()
    ok = flat < oob
    return (None if ok.all() else np.flatnonzero(ok)), flat[ok]


def upload_level(lv, pl, npool: int, T: int, step: int, device,
                 for_lu: bool) -> PackedLevelDev:
    """The device tables of one level ``lv`` and its ``PackedLevel``
    ``pl``, pairs in chunks of ``step``, out-of-range rows stripped (see
    the module docstring)."""
    oob = npool * T
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    nc = int(pl.nchunk)
    pa = np.asarray(pl.pa, np.int64)
    if pa.size and int(pa.max()) >= nc:
        raise ValueError("a pair names the pad chunk: the plan was not built "
                         "for unrolled levels")
    g = np.asarray(pl.gidx[:nc], np.int64)
    ok = g.ravel() < oob
    pairs = []
    for lo in range(0, pa.size, step):
        sl = slice(lo, lo + step)
        keep, dst = _kept(pl.dst[sl], oob)
        keep_u = dst_u = None
        if for_lu:
            keep_u, dst_u = _kept(pl.dst_u[sl], oob)
            keep_u = None if keep_u is None else tens(keep_u)
            dst_u = tens(dst_u)
        pairs.append(PairChunk(
            pa=tens(pa[sl]), pgb=tens(pl.pgb[sl]),
            keep=None if keep is None else tens(keep), dst=tens(dst),
            keep_u=keep_u, dst_u=dst_u))
    return PackedLevelDev(
        cols=tens(lv.cols), diag=tens(lv.diag), nchunk=nc,
        gidx=tens(np.where(g < oob, g, 0)),
        set_pos=None if ok.all() else tens(np.flatnonzero(ok)),
        set_idx=tens(g.ravel()[ok]), cpos=tens(pl.cpos[:nc]),
        ccol=tens(pl.ccol[:nc]), pairs=pairs)


def gather_rows(p2: torch.Tensor, lv: PackedLevelDev) -> torch.Tensor:
    """The level's packed (nchunk, T, T) rows of the row view ``p2``."""
    T = p2.shape[1]
    return p2.index_select(0, lv.gidx.view(-1)).view(lv.nchunk, T, T)


def set_rows(p2: torch.Tensor, lv: PackedLevelDev, O: torch.Tensor) -> None:
    """Write the real rows of the packed ``O`` back into ``p2``."""
    rows = O.reshape(-1, p2.shape[1])
    if lv.set_pos is not None:
        rows = rows.index_select(0, lv.set_pos)
    p2.index_copy_(0, lv.set_idx, rows)


def scatter_pairs(p2: torch.Tensor, b_pool: torch.Tensor, O: torch.Tensor,
                  lv: PackedLevelDev, update_dtype=None, hermitian=False,
                  dcol=None, upper=False) -> None:
    """``p2[dst] -= W`` over the level's pairs, ``W = a bᵗ`` with ``a =
    O[pa]`` (scaled by ``dcol[pa]``, the chunk's column pivots, for
    LDLᵗ) and ``b = b_pool[pgb]`` (conjugated with ``hermitian``);
    ``upper``: LU's Uᵗ side (``keep_u``, ``dst_u``).  ``update_dtype``
    rounds both operands, which are then multiplied in fp32, as the
    reference's ``packed_gemm``; else the product is in the pool's dtype.
    Only the rows that land in the pool are scattered."""
    T = p2.shape[1]
    for c in lv.pairs:
        a = O.index_select(0, c.pa)
        if dcol is not None:
            a = a * dcol.index_select(0, c.pa)[:, None, :]
        b = conj_if(b_pool.index_select(0, c.pgb), hermitian)
        if update_dtype is not None:
            a = a.to(update_dtype).to(torch.float32)
            b = b.to(update_dtype).to(torch.float32)
        W = torch.bmm(a, b.transpose(1, 2)).to(p2.dtype).view(-1, T)
        keep, dst = (c.keep_u, c.dst_u) if upper else (c.keep, c.dst)
        if keep is not None:
            W = W.index_select(0, keep)
        p2.index_add_(0, dst, W, alpha=-1.0)


def build_packed_fn(layout, device, kind, update_dtype, dense_tail,
                    packed_plan, dtype, hermitian, e2=None, fused_diag=None):
    """The packed program of ``kind`` (``factorize.build_factorize_fn``
    with a ``packed_plan``, whose checks it has made), with its
    signatures (LLᵗ ``fn(pool)``, LDLᵗ and LDLᴴ ``fn(pool, eps)``, LU
    ``fn(pool, pool_u, eps)``) and attributes, over ``packed_plan`` built
    on the same levels (``dense_tail.levels_lo`` when the dense tail is
    on; the tail is factored after the levels, LLᵗ and LLᴴ only).  The
    reference turns its Pallas schedules off under a packed plan, so an
    ``e2`` or ``fused_diag=True`` raises.  ``fn.levels`` holds the device
    tables (:class:`PackedLevelDev`); ``fn.e2_saved_flops`` is 0, the
    reference's count (it has no packed term)."""
    # factorize imports this module: its tail builder is imported here
    from pastix_tpu_torch.numeric.factorize import _build_tail_factor

    if e2 is not None or fused_diag:
        raise ValueError(
            "a packed plan runs its own E2 (the reference turns its Pallas "
            "schedules off under packed_update); drop e2= and fused_diag")
    kind = Factorization(kind)
    herm = hermitian and dtype.is_complex
    is_lu = kind == Factorization.LU
    if dense_tail is not None and (kind != Factorization.LLT or (
            dtype.is_complex and not herm)):
        raise ValueError("the dense tail is LLᵗ or LLᴴ only (the "
                         "reference's rule)")
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    if len(packed_plan.levels) != len(levels):
        raise ValueError("the packed plan must be built over the same level "
                         "list as the factorization")
    if is_lu and any(pl.dst_u is None for pl in packed_plan.levels):
        raise ValueError("LU needs a packed plan built with for_lu=True")
    tail_factor = (
        _build_tail_factor(dense_tail, layout.T, device, update_dtype,
                           hermitian=herm)
        if dense_tail is not None else None
    )
    T, npool, nbc = layout.T, layout.npool, layout.nbc
    step = chunk_len(torch.empty(0, T, T, dtype=dtype))
    plan = [upload_level(lv, pl, npool, T, step, device, is_lu)
            for lv, pl in zip(levels, packed_plan.levels)]
    fp32 = dtype == torch.float32
    # the clamp threshold as the reference holds it: in the pool's precision
    f_eps = lambda eps: float(torch.tensor(eps, dtype=dtype.to_real()))

    def rows(pool):
        return pool.view(npool * T, T)

    def fact_llt(pool: torch.Tensor) -> torch.Tensor:
        p2 = rows(pool)
        for lv in plan:
            L = potrf_batch(pool[lv.diag], hermitian=herm)
            pool[lv.diag] = L
            if not lv.nchunk:
                continue
            P = gather_rows(p2, lv)
            if fp32:
                O = torch.matmul(P, tri_inv_batch(L)[lv.cpos].transpose(1, 2))
            else:
                O = trsm_llt(P, L[lv.cpos], herm)
            set_rows(p2, lv, O)
            scatter_pairs(p2, pool, O, lv, update_dtype, herm)
        if tail_factor is not None:
            tail_factor(pool)
        return pool

    def fact_ldlt(pool: torch.Tensor, eps: float):
        p2 = rows(pool)
        d = torch.ones((nbc, T), dtype=dtype, device=pool.device)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            if fp32:
                d[lv.cols] = tile_factor(pool, lv.diag, eps, npiv, lu=False)
            else:
                L, dl, n = ldlt_batch(pool[lv.diag], f_eps(eps), herm)
                pool[lv.diag] = L
                d[lv.cols] = dl
                npiv += n
            if not lv.nchunk:
                continue
            P = gather_rows(p2, lv)
            dcol = d[lv.ccol]
            if fp32:
                # L(r, J) = A(r, J) L⁻ᵗ D⁻¹
                linv_t = tri_inv_batch(pool[lv.diag], unit=True).transpose(1, 2)
                O = torch.matmul(P, linv_t[lv.cpos]) / dcol[:, None, :]
            else:
                O = trsm_ldlt(P, pool[lv.diag][lv.cpos], dcol, herm)
            set_rows(p2, lv, O)
            scatter_pairs(p2, pool, O, lv, update_dtype, herm, dcol=dcol)
        return pool, d, npiv

    def fact_lu(pool: torch.Tensor, pool_u: torch.Tensor, eps: float):
        p2, p2u = rows(pool), rows(pool_u)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for lv in plan:
            if fp32:
                tile_factor(pool, lv.diag, eps, npiv, lu=True)
            else:
                M, n = getrf_batch(pool[lv.diag], f_eps(eps))
                pool[lv.diag] = M
                npiv += n
            if not lv.nchunk:
                continue
            D = pool[lv.diag]
            P, Pu = gather_rows(p2, lv), gather_rows(p2u, lv)
            # L rows: A(r, J) U⁻¹; Uᵗ rows: A(J, r)ᵗ L⁻ᵗ
            if fp32:
                uinv = tri_inv_batch(D, upper=True)
                linv_t = tri_inv_batch(D, unit=True).transpose(1, 2)
                Ol = torch.matmul(P, uinv[lv.cpos])
                Ou = torch.matmul(Pu, linv_t[lv.cpos])
            else:
                Ol = trsm_lu_l(P, D[lv.cpos])
                Ou = trsm_lu_u(Pu, D[lv.cpos])
            set_rows(p2, lv, Ol)
            set_rows(p2u, lv, Ou)
            # rows landing in a combined diagonal tile carry its U part:
            # dst keeps the diagonal tile pairs, dst_u drops them
            scatter_pairs(p2, pool_u, Ol, lv, update_dtype)
            scatter_pairs(p2u, pool, Ou, lv, update_dtype, upper=True)
        return pool, pool_u, npiv

    fn = {Factorization.LLT: fact_llt, Factorization.LDLT: fact_ldlt,
          Factorization.LDLH: fact_ldlt, Factorization.LU: fact_lu}[kind]
    fn.levels = plan
    fn.kind, fn.dtype, fn.hermitian = kind, dtype, herm
    fn.tail, fn.e2_saved_flops = [], 0.0
    fn.e2, fn.compact, fn.fused_diag = "packed", False, False
    return fn
