"""Half-packed E2 plan: packed a-side rows x grid b-tiles, row scatter (a
copy of ``pastix_tpu/analyze/packed.py``, numpy and scipy only, with its
import path changed; its measurements are the reference's, on the TPU).

The uniform tile grid is kept as *storage* (coefinit, solve sweeps, Schur
and the dense tail are unchanged), but the panel TRSM + trailing-update
GEMMs — ~90% of factorization flops — are recast over each block column's
*packed* scalar row support instead of grid tiles:

  * per block column K the host records its below-diagonal scalar row
    support supp(K) (sorted), chopped into mh = ceil(h/T) packed T-row
    chunks;
  * per elimination level the device gathers the chunks from the tile pool
    (one row-gather), applies the panel TRSM on packed rows (one MXU
    matmul per chunk instead of per grid tile), and writes the rows back;
  * the trailing updates pair each packed a-chunk with a *grid* b-tile of
    the same panel: W = O_a @ B^T has full 128-lane rows addressed to one
    target tile row each, so the extend-add is a ROW-granular scatter
    (p2.at[(ng,T) rows].add) — measured at tile-scatter speed on the v5e,
    whereas element-granular scatter runs ~8x slower (exp_scatter.py).

Useful GEMM flops per update become 2*h*m*T^2 (+ chunk-pad fringe)
instead of 2*(m*T)^2*T over grid tile pairs — the saving is the row-fill
efficiency h/(m*T) (~0.31 on 3D Poisson at T=128, i.e. ~3x fewer device
flops and ~3x less scatter traffic).  The b-side stays on the grid: its
off-support rows are structurally zero, contributing zero columns.

This replaces the reference's per-block E2 task list (sopalin_smp,
src/sopalin/src/sopalin3d.c) at packed-supernode granularity — the
reference's coeftab storage is itself packed by row intervals; the tile
grid here is the TPU-friendly rectangularization of the same idea.

Out-of-bounds conventions (JAX scatter drops, gather clamps):
  * pad rows inside a chunk point tbr at the TBcat sentinel, whose value
    is npool, so their dst row is >= npool*T -> dropped;
  * upper cross-tile pairs (row's tile above the b-tile) have TBcat ==
    npool -> dropped; same-tile rows scatter their full row into the
    diagonal tile, whose upper triangle the factorization never reads
    (LLT/LDLT tril the diag; for LU the upper part IS the U update);
  * pad chunks / pad pairs gather junk and scatter nowhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.analyze.layout import SolverLayout


def scalar_supports(pat: sp.csc_matrix, T: int, nbc: int) -> list:
    """Per-block-column union scalar row support of L, strictly below the
    diagonal block — block-column-granular column-merge symbolic (the
    scalar refinement of blocksym.tile_symbolic's quotient fill)."""
    A = sp.coo_matrix(sp.tril(pat, -1))
    order = np.argsort(
        (A.col // T).astype(np.int64) * np.int64(nbc) * T + A.row, kind="stable"
    )
    r, c = A.row[order], (A.col[order] // T)
    ptr = np.searchsorted(c, np.arange(nbc + 1))
    pending: list = [[] for _ in range(nbc)]
    supports: list = [None] * nbc
    for J in range(nbc):
        base = r[ptr[J] : ptr[J + 1]]
        parts = pending[J] + [base]
        supp = (
            np.unique(np.concatenate(parts)) if len(parts) > 1 else np.unique(base)
        )
        supp = supp[supp >= (J + 1) * T]
        pending[J] = None
        supports[J] = supp.astype(np.int64)
        if supp.size:
            parent = int(supp[0] // T)
            pending[parent].append(supp)
    return supports


@dataclasses.dataclass
class PackedLevel:
    """Per-level packed tables (all numpy; last chunk row is the pad chunk)."""

    nchunk: int  # real chunks (pad chunk excluded)
    gidx: np.ndarray  # (nchunk+1, T) row-gather indices into pool2d
    cpos: np.ndarray  # (nchunk+1,) chunk's column position in the level batch
    ccol: np.ndarray  # (nchunk+1,) chunk's block column (LDLT d-scaling)
    pa: np.ndarray  # (ng,) pair a-chunk (level-local index)
    pgb: np.ndarray  # (ng,) pair b-tile pool index (grid gather)
    dst: np.ndarray  # (ng, T) scatter row into pool2d (>= npool*T drops)
    dst_u: Optional[np.ndarray]  # (ng, T) LU U-side rows (diag pairs OOB'd)


@dataclasses.dataclass
class PackedPlan:
    T: int
    npool: int
    levels: list  # list[PackedLevel], aligned with the factorization levels

    def gemm_flops(self) -> float:
        T = float(self.T)
        ng = sum(lv.pa.size for lv in self.levels)
        return 2.0 * ng * T**3

    def trsm_flops(self) -> float:
        T = float(self.T)
        nc = sum(lv.nchunk for lv in self.levels)
        return 2.0 * nc * T**3


def build_packed_plan(
    layout: SolverLayout,
    pattern_ext: sp.csc_matrix,
    levels: Optional[list] = None,
    supports: Optional[list] = None,
    for_lu: bool = False,
) -> PackedPlan:
    """Build the half-packed E2 plan for ``levels`` (default: layout.levels;
    the dense-tail path passes its filtered levels_lo)."""
    T, nbc, npool = layout.T, layout.nbc, layout.npool
    if levels is None:
        levels = layout.levels
    if supports is None:
        supports = scalar_supports(pattern_ext, T, nbc)

    keys = layout.keys

    def lookup_safe(I, J):
        key = np.asarray(J, dtype=np.int64) * nbc + np.asarray(I, dtype=np.int64)
        pos = np.searchsorted(keys, key)
        posc = np.minimum(pos, npool - 1)
        out = np.where(keys[posc] == key, posc, npool)
        return out.astype(np.int64)

    # --- per-column chunk metadata + precomputed scatter rows -----------
    # only columns that appear in some level with off-diag support need one
    active = np.zeros(nbc, dtype=bool)
    for lv in levels:
        active[lv.cols] = True

    OOB_ROW = npool * T
    assert (npool + 1) * T <= np.iinfo(np.int32).max, (
        "tile pool too large for int32 row indexing"
    )

    col_meta: list = [None] * nbc
    for Kcol in range(nbc):
        if not active[Kcol]:
            continue
        supp = supports[Kcol]
        h = supp.size
        if h == 0:
            continue
        tiles = np.unique(supp // T)
        m = tiles.size
        ti = np.searchsorted(tiles, supp // T).astype(np.int64)
        rloc = (supp % T).astype(np.int64)
        prow = lookup_safe(supp // T, np.full(h, Kcol)) * T + rloc
        mh = -(-h // T)
        pad = mh * T - h
        # per-(row, b-tile) scatter destinations, fully host-computed:
        # dst(r, tb) = pool_idx(tile(r), tiles[tb]) * T + r % T
        ai, bi = np.tril_indices(m)
        TB = np.full((m, m), npool, dtype=np.int64)
        TB[ai, bi] = lookup_safe(tiles[ai], tiles[bi])
        DST = TB[ti] * T + rloc[:, None]  # (h, m); upper pairs -> OOB
        DST = np.concatenate(
            [DST, np.full((pad, m), OOB_ROW, np.int64)]
        ).reshape(mh, T, m)
        if for_lu:
            TBu = TB.copy()
            np.fill_diagonal(TBu, npool)  # diag pairs: L-side covers them
            DSTU = TBu[ti] * T + rloc[:, None]
            DSTU = np.concatenate(
                [DSTU, np.full((pad, m), OOB_ROW, np.int64)]
            ).reshape(mh, T, m)
        else:
            DSTU = None
        gidx = np.concatenate(
            [prow, np.full(pad, OOB_ROW, np.int64)]
        ).reshape(mh, T)
        # pairs: chunk c x local b-tile tb for tb = 0 .. ti_last(c)
        last = np.minimum((np.arange(mh) + 1) * T, h) - 1
        nb = ti[last] + 1  # pairs per chunk
        pgb_col = lookup_safe(tiles, np.full(m, Kcol))
        col_meta[Kcol] = (gidx, DST, DSTU, nb, pgb_col, mh)

    plevels = []
    for lv in levels:
        g_list, cp_list, cc_list = [], [], []
        pa_list, pgb_list, dst_list, dstu_list = [], [], [], []
        c0 = 0
        for pos, Kcol in enumerate(lv.cols):
            meta = col_meta[Kcol]
            if meta is None:
                continue
            gidx, DST, DSTU, nb, pgb_col, mh = meta
            g_list.append(gidx)
            cp_list.append(np.full(mh, pos, np.int64))
            cc_list.append(np.full(mh, Kcol, np.int64))
            pa_list.append(c0 + np.repeat(np.arange(mh), nb))
            for c in range(mh):
                k = nb[c]
                pgb_list.append(pgb_col[:k])
                dst_list.append(DST[c, :, :k].T)  # (k, T)
                if DSTU is not None:
                    dstu_list.append(DSTU[c, :, :k].T)
            c0 += mh

        nchunk = c0
        pad_g = np.full((1, T), OOB_ROW, np.int64)

        def cat2(lst, padrow):
            return np.concatenate(lst + [padrow]) if lst else padrow

        def cat1(lst, fill=None):
            if lst:
                return np.concatenate(lst)
            return np.empty(0, np.int64)

        cpos = (
            np.concatenate(cp_list + [np.zeros(1, np.int64)])
            if cp_list
            else np.zeros(1, np.int64)
        )
        ccol = (
            np.concatenate(cc_list + [np.full(1, nbc, np.int64)])
            if cc_list
            else np.full(1, nbc, np.int64)
        )
        dst = (
            np.concatenate(dst_list)
            if dst_list
            else np.empty((0, T), np.int64)
        )
        dst_u = (
            np.concatenate(dstu_list)
            if dstu_list
            else (np.empty((0, T), np.int64) if for_lu else None)
        )
        plevels.append(
            PackedLevel(
                nchunk=nchunk,
                gidx=cat2(g_list, pad_g).astype(np.int32),
                cpos=cpos.astype(np.int32),
                ccol=ccol.astype(np.int32),
                pa=cat1(pa_list).astype(np.int32),
                pgb=cat1(pgb_list).astype(np.int32),
                dst=dst.astype(np.int32),
                dst_u=dst_u.astype(np.int32) if dst_u is not None else None,
            )
        )

    return PackedPlan(T=T, npool=npool, levels=plevels)
