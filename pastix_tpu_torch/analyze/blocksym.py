"""Tile-level symbolic factorization and level scheduling.

Block-quotient symbolic factorization: treat each T x T tile as one scalar
and run the classic column-merge fill computation.  The resulting pattern
is a superset of the exact scalar fill at tile granularity and is closed
under right-looking updates (if tiles (I,K) and (J,K) exist with I>=J>K
then (I,J) exists), which is exactly what the batched GEMM tables require.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def tile_pattern_of_a(pattern: sp.csc_matrix, T: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Lower-triangular tile pattern of A: returns (tile_rows, tile_cols, nbc)."""
    n = pattern.shape[0]
    nbc = -(-n // T)
    A = sp.coo_matrix(sp.tril(pattern))
    I = A.row // T
    J = A.col // T
    key = np.unique(J.astype(np.int64) * nbc + I.astype(np.int64))
    # ensure all diagonal tiles are present (padding identity lives there)
    dk = np.arange(nbc, dtype=np.int64) * nbc + np.arange(nbc, dtype=np.int64)
    key = np.unique(np.concatenate([key, dk]))
    return (key % nbc).astype(np.int64), (key // nbc).astype(np.int64), nbc


def tile_symbolic_ilu(
    pattern: sp.csc_matrix, T: int, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Tile-level ILU(k) pattern: level-of-fill symbolic factorization.

    The reference computes scalar ILU(k) levels in kass (``SF_level.c``,
    ``IPARM_LEVEL_OF_FILL`` — SURVEY.md section 2 row 5); here levels are
    tracked on the tile quotient graph (block ILU(k): a slight superset of
    scalar ILU(k) fill, which is the natural granularity for the tiled
    device pools).  fill-level(I,J) = min over eliminated K of
    lev(I,K) + lev(J,K) + 1; tiles with level > k are dropped.

    Returns (blk_row, blk_col, level_of_col, nbc) like :func:`tile_symbolic`.
    """
    tI, tJ, nbc = tile_pattern_of_a(pattern, T)
    order_idx = np.argsort(tJ * np.int64(nbc) + tI, kind="stable")
    tI, tJ = tI[order_idx], tJ[order_idx]
    ptr = np.searchsorted(tJ, np.arange(nbc + 1))

    # per-column {row -> fill level}; original tiles are level 0
    rows_of: list[np.ndarray] = [None] * nbc  # type: ignore
    lev_of: list[np.ndarray] = [None] * nbc  # type: ignore
    # pending fill contributions per column: list of (rows, levels)
    pend_r: list[list[np.ndarray]] = [[] for _ in range(nbc)]
    pend_l: list[list[np.ndarray]] = [[] for _ in range(nbc)]
    sched = np.zeros(nbc, dtype=np.int64)
    out_rows, out_cols = [], []
    for J in range(nbc):
        base = tI[ptr[J] : ptr[J + 1]]
        r = np.concatenate([base] + pend_r[J])
        l = np.concatenate([np.zeros(base.size, np.int64)] + pend_l[J])
        pend_r[J] = pend_l[J] = None  # type: ignore
        # min level per distinct row
        uniq, inv = np.unique(r, return_inverse=True)
        lev = np.full(uniq.size, np.iinfo(np.int64).max)
        np.minimum.at(lev, inv, l)
        keep = lev <= k
        uniq, lev = uniq[keep], lev[keep]
        if uniq.size == 0 or uniq[0] != J:  # diagonal always kept
            uniq = np.concatenate([[J], uniq])
            lev = np.concatenate([[0], lev])
        rows_of[J], lev_of[J] = uniq, lev
        out_rows.append(uniq)
        out_cols.append(np.full(uniq.size, J, np.int64))
        off, offl = uniq[1:], lev[1:]
        if off.size:
            np.maximum.at(sched, off, sched[J] + 1)
            # fill candidates: target column K = off[t] receives rows
            # off[t:] at levels offl[t:] + offl[t] + 1 — the tril pairs
            # grouped by target are exactly the SUFFIX slices of the sorted
            # row list, so no all-pairs materialization is needed (linear
            # memory in the pattern size instead of quadratic per column)
            for t in range(off.size):
                pend_r[int(off[t])].append(off[t:])
                pend_l[int(off[t])].append(offl[t:] + (offl[t] + 1))
    blk_row = np.concatenate(out_rows)
    blk_col = np.concatenate(out_cols)
    return blk_row, blk_col, sched, nbc


def tile_row_bounds(
    pattern: sp.csc_matrix, T: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Conservative per-tile scalar row-support bounds of L.

    Runs the same block-column quotient merge as :func:`tile_symbolic`
    but carries, per stored tile (I, J), the min/max scalar row of the
    column's union support inside the tile's 128-row window.  Every
    structurally nonzero row r of L in tile (I, J) satisfies
    ``rlo <= r - I*T <= rhi`` (bounds of a union are a superset of the
    exact scalar fill, which the quotient support over-approximates
    anyway).  Diagonal tiles are reported full ``(0, T-1)`` — identity
    padding and the factor's diagonal live there.

    Returns ``(keys, rlo, rhi, nbc)`` with ``keys = col*nbc + row``
    sorted ascending (align to a layout's tile list via searchsorted;
    tiles absent from the merge — e.g. dense-tail explicit zeros — must
    fall back to full bounds).

    The bounds feed the slab E2 kernel's row-bounded sub-matmuls
    (numeric/slab_kernels.py): the MXU streams sublane rows, so skipping
    support-empty rows of the ``a`` operand converts padded flops into
    real time (the splitpart/IPARM_MIN_BLOCKSIZE analog at sub-tile
    granularity — reference src/blend/src/splitpart.c).
    """
    n = pattern.shape[0]
    nbc = -(-n // T)
    A = sp.coo_matrix(sp.tril(pattern))
    J_all = (A.col // T).astype(np.int64)
    order = np.argsort(J_all, kind="stable")
    r_all, J_srt = A.row[order].astype(np.int64), J_all[order]
    ptr = np.searchsorted(J_srt, np.arange(nbc + 1))

    pend_t: list[list[np.ndarray]] = [[] for _ in range(nbc)]
    pend_lo: list[list[np.ndarray]] = [[] for _ in range(nbc)]
    pend_hi: list[list[np.ndarray]] = [[] for _ in range(nbc)]
    out_keys, out_lo, out_hi = [], [], []
    for J in range(nbc):
        r = r_all[ptr[J] : ptr[J + 1]]
        t0 = r // T
        lo0 = r % T
        tiles = np.concatenate([t0, [J]] + pend_t[J])
        lo = np.concatenate([lo0, [0]] + pend_lo[J])
        hi = np.concatenate([lo0, [T - 1]] + pend_hi[J])
        pend_t[J] = pend_lo[J] = pend_hi[J] = None  # type: ignore
        uniq, inv = np.unique(tiles, return_inverse=True)
        ulo = np.full(uniq.size, T, np.int64)
        uhi = np.full(uniq.size, -1, np.int64)
        np.minimum.at(ulo, inv, lo)
        np.maximum.at(uhi, inv, hi)
        # diagonal tile is always full (identity padding, factor diagonal)
        dpos = np.searchsorted(uniq, J)
        ulo[dpos] = 0
        uhi[dpos] = T - 1
        out_keys.append(uniq * 0 + np.int64(J) * nbc + uniq)
        out_lo.append(ulo)
        out_hi.append(uhi)
        off = uniq[dpos + 1 :]
        if off.size:
            parent = int(off[0])
            pend_t[parent].append(off)
            pend_lo[parent].append(ulo[dpos + 1 :])
            pend_hi[parent].append(uhi[dpos + 1 :])
    keys = np.concatenate(out_keys)
    rlo = np.concatenate(out_lo)
    rhi = np.concatenate(out_hi)
    order = np.argsort(keys)
    return keys[order], rlo[order].astype(np.int32), rhi[
        order
    ].astype(np.int32), nbc


def tile_symbolic(
    pattern: sp.csc_matrix, T: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Tile-level fill pattern of L and level schedule.

    Returns (blk_row, blk_col, level_of_col, nbc) with blocks sorted by
    (col, row); (J,J) diagonal tiles included.
    """
    tI, tJ, nbc = tile_pattern_of_a(pattern, T)

    # column-merge symbolic on the tile graph
    cols: list[np.ndarray] = [None] * nbc  # type: ignore
    order_idx = np.argsort(tJ * np.int64(nbc) + tI, kind="stable")
    tI, tJ = tI[order_idx], tJ[order_idx]
    ptr = np.searchsorted(tJ, np.arange(nbc + 1))
    pending: list[list[np.ndarray]] = [[] for _ in range(nbc)]
    out_rows: list[np.ndarray] = []
    level = np.zeros(nbc, dtype=np.int64)
    for J in range(nbc):
        base = tI[ptr[J] : ptr[J + 1]]
        parts = pending[J]
        parts.append(base)
        rows = np.unique(np.concatenate(parts)) if len(parts) > 1 else np.unique(base)
        pending[J] = []
        # rows[0] == J (diagonal tile always present)
        out_rows.append(rows)
        off = rows[1:]
        if off.size:
            parent = int(off[0])
            pending[parent].append(off)
            # level propagation: every I with tile (I,J) depends on column J
            np.maximum.at(level, off, level[J] + 1)
    blk_row = np.concatenate(out_rows)
    blk_col = np.repeat(
        np.arange(nbc, dtype=np.int64), [r.size for r in out_rows]
    )
    return blk_row, blk_col, level, nbc
