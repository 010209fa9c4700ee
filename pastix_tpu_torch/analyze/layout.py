"""SolverLayout: flat static index tables for the jitted factorization.

The SolverMatrix analog (reference ``solverMatrixGen.c`` output: local
blocks + per-thread static task lists — SURVEY.md section 2 row 7).  Here
the "task lists" are per-level index tables:

  level l:  diag[l]   — pool indices of diagonal tiles to factor (batch)
            trsm[l]   — (panel tile, its diagonal tile) pairs (batch)
            gemm[l]   — (pa, pb, pd, K) triples: pool[pd] -= op(pool[pa],
                        pool[pb]) for source column K (batch + scatter-add)

and the solve sweeps reuse trsm-style tables with (row, col) companions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.analyze.blocksym import tile_symbolic


@dataclasses.dataclass
class LevelTables:
    cols: np.ndarray  # int32[nc] block-columns in this level
    diag: np.ndarray  # int32[nc] pool idx of their diagonal tiles
    trsm_panel: np.ndarray  # int32[nt] pool idx of off-diag tiles
    trsm_diag: np.ndarray  # int32[nt] pool idx of the column's diag tile
    trsm_row: np.ndarray  # int32[nt] block-row I of each panel tile
    trsm_col: np.ndarray  # int32[nt] block-col J of each panel tile
    gemm_a: np.ndarray  # int32[ng] pool idx of L(I,K)
    gemm_b: np.ndarray  # int32[ng] pool idx of L(J,K)
    gemm_d: np.ndarray  # int32[ng] pool idx of target (I,J)
    gemm_k: np.ndarray  # int32[ng] source block-column K
    gemm_nondiag: np.ndarray  # bool[ng] target is off-diagonal (for LU U-path)


@dataclasses.dataclass
class SolverLayout:
    """Static plan + pool geometry for one sparsity pattern."""

    n: int
    T: int
    nbc: int  # number of block rows/cols (= padded n / T)
    npool: int  # number of stored tiles (lower incl. diag)
    keys: np.ndarray  # int64[npool] sorted tile keys (col*nbc + row)
    blk_row: np.ndarray  # int64[npool]
    blk_col: np.ndarray  # int64[npool]
    level_of_col: np.ndarray  # int64[nbc]
    levels: list  # list[LevelTables]
    # A-value scatter plan (rebuilt values fast for pattern-reuse API):
    scat_pool_flat: np.ndarray  # int64[nnz_lo] flat index into pool for tril(A)
    scat_vals_order: np.ndarray  # int64[nnz_lo] permutation of tril(A).data
    scat_pool_flat_u: Optional[np.ndarray]  # for LU: triu(A) into Ut pool
    scat_vals_order_u: Optional[np.ndarray]
    diag_pad_flat: np.ndarray  # int64[npad] identity positions for padding
    nnz_l_tiles: int = 0
    # conservative per-tile scalar row-support bounds (blocksym.
    # tile_row_bounds): feed the slab E2 kernel's row-bounded sub-matmuls;
    # None on loaded legacy layouts / ILU patterns (kernels fall back to
    # full-height tiles)
    row_lo: Optional[np.ndarray] = None  # int32[npool]
    row_hi: Optional[np.ndarray] = None  # int32[npool]

    @property
    def pool_shape(self):
        return (self.npool, self.T, self.T)

    def lookup(self, I: np.ndarray, J: np.ndarray) -> np.ndarray:
        """Vectorized tile (I,J) -> pool index (must exist)."""
        key = np.asarray(J, dtype=np.int64) * self.nbc + np.asarray(I, dtype=np.int64)
        pos = np.searchsorted(self.keys, key)
        if np.any(self.keys[np.minimum(pos, self.npool - 1)] != key):
            raise KeyError("tile not present in pattern")
        return pos

    # --- cost/report helpers -------------------------------------------

    def check(self) -> None:
        """Invariant checker (reference solver_check.c analog).

        Verifies: tile keys sorted/unique with all diagonals present; every
        level's tasks reference valid pool slots; the level schedule is
        causal (a panel's TRSM fires at its column's level, GEMM targets
        exist, and every update's source column is in the firing level).
        Raises AssertionError on violation.
        """
        nbc, npool = self.nbc, self.npool
        assert np.all(np.diff(self.keys) > 0), "tile keys not sorted/unique"
        dk = np.arange(nbc, dtype=np.int64) * nbc + np.arange(nbc)
        assert np.isin(dk, self.keys).all(), "missing diagonal tiles"
        assert np.all(self.blk_row >= self.blk_col), "upper tile stored"
        seen_cols = np.zeros(nbc, dtype=bool)
        for lev, lv in enumerate(self.levels):
            assert (lv.diag < npool).all() and (lv.cols < nbc).all()
            assert not seen_cols[lv.cols].any(), "column factored twice"
            seen_cols[lv.cols] = True
            assert (lv.trsm_panel < npool).all()
            assert np.isin(lv.trsm_col, lv.cols).all(), "TRSM off-level"
            assert (lv.gemm_d < npool).all(), "GEMM target missing"
            assert np.isin(lv.gemm_k, lv.cols).all(), "GEMM source off-level"
            # causality: an update from source column J must land in a
            # column factored strictly LATER (level_of_col[target] >
            # level_of_col[J]), else the target's DIAG already consumed
            # stale values
            tgt_col = self.blk_col[lv.gemm_d]
            src_col = lv.gemm_k.astype(np.int64)
            assert (
                self.level_of_col[tgt_col] > self.level_of_col[src_col]
            ).all(), "acausal update: target factored before source fired"
        # NB: seen_cols may not cover every column — Schur mode leaves the
        # terminal block-columns unfactored by design

    # --- serialization (reference IPARM_IO_STRATEGY covers order+symbol;
    # the layout/schedule is our third analysis artifact — SURVEY.md §5
    # checkpoint row asks for Order/Symbol/schedule) ---------------------

    def save(self, path: str) -> None:
        """Persist the full static plan (npz); analyze becomes a one-time
        cost across runs on the same pattern."""
        arrs = {
            "n": np.asarray(self.n),
            "T": np.asarray(self.T),
            "nbc": np.asarray(self.nbc),
            "npool": np.asarray(self.npool),
            "keys": self.keys,
            "blk_row": self.blk_row,
            "blk_col": self.blk_col,
            "level_of_col": self.level_of_col,
            "scat_pool_flat": self.scat_pool_flat,
            "scat_vals_order": self.scat_vals_order,
            "diag_pad_flat": self.diag_pad_flat,
            "nnz_l_tiles": np.asarray(self.nnz_l_tiles),
            "nlev": np.asarray(len(self.levels)),
            "has_u": np.asarray(self.scat_pool_flat_u is not None),
        }
        if self.row_lo is not None:
            arrs["row_lo"] = self.row_lo
            arrs["row_hi"] = self.row_hi
        if self.scat_pool_flat_u is not None:
            arrs["scat_pool_flat_u"] = self.scat_pool_flat_u
            arrs["scat_vals_order_u"] = self.scat_vals_order_u
        for i, lv in enumerate(self.levels):
            for f in dataclasses.fields(LevelTables):
                arrs[f"lv{i}_{f.name}"] = getattr(lv, f.name)
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "SolverLayout":
        z = np.load(path if str(path).endswith(".npz") else path + ".npz")
        nlev = int(z["nlev"])
        levels = [
            LevelTables(
                **{
                    f.name: z[f"lv{i}_{f.name}"]
                    for f in dataclasses.fields(LevelTables)
                }
            )
            for i in range(nlev)
        ]
        has_u = bool(z["has_u"])
        lay = cls(
            n=int(z["n"]),
            T=int(z["T"]),
            nbc=int(z["nbc"]),
            npool=int(z["npool"]),
            keys=z["keys"],
            blk_row=z["blk_row"],
            blk_col=z["blk_col"],
            level_of_col=z["level_of_col"],
            levels=levels,
            scat_pool_flat=z["scat_pool_flat"],
            scat_vals_order=z["scat_vals_order"],
            scat_pool_flat_u=z["scat_pool_flat_u"] if has_u else None,
            scat_vals_order_u=z["scat_vals_order_u"] if has_u else None,
            diag_pad_flat=z["diag_pad_flat"],
            nnz_l_tiles=int(z["nnz_l_tiles"]),
            row_lo=z["row_lo"] if "row_lo" in z.files else None,
            row_hi=z["row_hi"] if "row_hi" in z.files else None,
        )
        return lay

    def padded_flops(self, kind: str = "llt") -> float:
        """Device flops actually executed (uniform T x T tiles)."""
        T = float(self.T)
        nd = float(self.nbc)
        ntr = float(sum(lv.trsm_panel.size for lv in self.levels))
        ngm = float(sum(lv.gemm_a.size for lv in self.levels))
        potrf = nd * (T**3 / 3.0)
        trsm = ntr * T**3
        gemm = ngm * 2.0 * T**3
        total = potrf + trsm + gemm
        if kind == "lu":
            total = 2 * potrf + 2 * trsm + 2 * gemm
        return total

    def memory_bytes(self, dtype_bytes: int = 4, lu: bool = False) -> int:
        pool = self.npool * self.T * self.T * dtype_bytes
        tables = sum(
            lv.diag.nbytes
            + lv.trsm_panel.nbytes * 4
            + lv.gemm_a.nbytes * 4
            for lv in self.levels
        )
        return pool * (2 if lu else 1) + tables


@dataclasses.dataclass
class DenseTail:
    """Dense terminal block plan (the top-of-etree critical-path fix).

    The last ``q`` block-columns of an ND-ordered factor form a fully
    dense lower-triangular tile pattern (the top separators interconnect
    densely).  Chaining them as per-tile-column levels puts O(q)
    sequential small kernels on the critical path (the reference's 2D
    block distribution exists for the same reason — SURVEY.md §2 row 7 /
    hard part 3).  Instead: skip their level tasks, let earlier columns
    scatter updates into their tiles as usual, then factor the trailing
    (m, m) Schur complement with ONE dense blocked Cholesky and scatter
    the factor back into the pool — the solve path is unchanged.
    """

    s: int  # first tail block-column
    q: int  # number of tail block-columns
    m: int  # q * T
    p_idx: np.ndarray  # int32[B] pool indices of tail tiles (I >= J)
    qi: np.ndarray  # int32[B] tile row within tail (I - s)
    qj: np.ndarray  # int32[B] tile col within tail (J - s)
    levels_lo: list  # LevelTables filtered to cols < s (factorization plan)


def _filter_level(lv: LevelTables, s: int) -> Optional[LevelTables]:
    """Restrict a level's tasks to generating columns < s (updates into
    tiles >= s are kept: they are produced by columns < s)."""
    cm = lv.cols < s
    if not cm.any():
        return None
    tm = lv.trsm_col < s
    gm = lv.gemm_k < s
    return LevelTables(
        cols=lv.cols[cm],
        diag=lv.diag[cm],
        trsm_panel=lv.trsm_panel[tm],
        trsm_diag=lv.trsm_diag[tm],
        trsm_row=lv.trsm_row[tm],
        trsm_col=lv.trsm_col[tm],
        gemm_a=lv.gemm_a[gm],
        gemm_b=lv.gemm_b[gm],
        gemm_d=lv.gemm_d[gm],
        gemm_k=lv.gemm_k[gm],
        gemm_nondiag=lv.gemm_nondiag[gm],
    )


def plan_dense_tail(layout: SolverLayout, min_q: int = 4,
                    max_m: int = 1 << 15) -> Optional[DenseTail]:
    """Find the largest fully-dense block-column suffix and build the plan.

    Returns None when the suffix is shorter than ``min_q`` tiles (the
    dense detour would not pay for itself).  ``max_m`` caps the dense
    matrix size (memory: m^2 elements live transiently)."""
    nbc, T = layout.nbc, layout.T
    # tiles per column in the suffix: column J is "dense" iff it has a
    # stored tile for every row J..nbc-1
    col_ptr = np.searchsorted(layout.blk_col, np.arange(nbc + 1))
    counts = np.diff(col_ptr)
    dense_col = counts == (nbc - np.arange(nbc))
    q = 0
    while q < nbc and dense_col[nbc - 1 - q]:
        q += 1
    q = min(q, max_m // T)
    if q < min_q:
        return None
    s = nbc - q
    II, JJ = np.tril_indices(q)
    p_idx = layout.lookup(II + s, JJ + s).astype(np.int32)
    levels_lo = []
    for lv in layout.levels:
        f = _filter_level(lv, s)
        if f is not None:
            levels_lo.append(f)
    return DenseTail(
        s=s, q=q, m=q * T,
        p_idx=p_idx,
        qi=II.astype(np.int32),
        qj=JJ.astype(np.int32),
        levels_lo=levels_lo,
    )


def _densify_tail(
    blk_row: np.ndarray,
    blk_col: np.ndarray,
    level_of_col: np.ndarray,
    nbc: int,
    frac: float,
    max_m_tiles: int,
):
    """Relaxed terminal amalgamation: add explicit-zero tiles so the largest
    affordable block-column suffix becomes fully dense (then plan_dense_tail
    factors it with one dense Cholesky).  A suffix qualifies while the added
    tiles stay under ``frac`` of its dense size.  The fill keeps the
    closure property (new tiles live only in the suffix, whose targets are
    all present), so the level tables remain valid; levels are recomputed.
    """
    col_ptr = np.searchsorted(blk_col, np.arange(nbc + 1))
    counts = np.diff(col_ptr)
    dense_cnt = nbc - np.arange(nbc)  # tiles J..nbc-1
    missing = dense_cnt - counts
    # scan suffixes from the end: largest q with cum(missing) <= frac * cum(dense)
    s_best = nbc
    miss_cum = 0
    dense_cum = 0
    for J in range(nbc - 1, -1, -1):
        miss_cum += missing[J]
        dense_cum += dense_cnt[J]
        if nbc - J > max_m_tiles:
            break
        if miss_cum <= frac * dense_cum:
            s_best = J
    if s_best >= nbc or missing[s_best:].sum() == 0:
        return blk_row, blk_col, level_of_col, 0
    add_r, add_c = [], []
    for J in range(s_best, nbc):
        have = blk_row[col_ptr[J] : col_ptr[J + 1]]
        want = np.arange(J, nbc, dtype=np.int64)
        miss = np.setdiff1d(want, have, assume_unique=True)
        if miss.size:
            add_r.append(miss)
            add_c.append(np.full(miss.size, J, np.int64))
    n_added = int(sum(a.size for a in add_r))
    blk_row = np.concatenate([blk_row] + add_r)
    blk_col = np.concatenate([blk_col] + add_c)
    order = np.argsort(blk_col * np.int64(nbc) + blk_row, kind="stable")
    blk_row, blk_col = blk_row[order], blk_col[order]
    # recompute the level schedule on the merged pattern (one pass)
    level = np.zeros(nbc, dtype=np.int64)
    ptr = np.searchsorted(blk_col, np.arange(nbc + 1))
    for J in range(nbc):
        off = blk_row[ptr[J] + 1 : ptr[J + 1]]
        if off.size:
            np.maximum.at(level, off, level[J] + 1)
    return blk_row, blk_col, level, n_added


def build_layout(
    pattern: sp.csc_matrix,
    T: int,
    for_lu: bool = False,
    schur_first_bcol: int | None = None,
    incomplete: bool = False,
    level_of_fill: int = 1,
    densify_tail_frac: float = 0.0,
) -> SolverLayout:
    """Build the static plan from the *permuted* full symmetric pattern.

    ``schur_first_bcol``: block columns >= this are *not* factored (no DIAG/
    TRSM tasks and no updates generated from them) but still receive
    trailing updates — after factorization their tiles hold the Schur
    complement (reference: Schur mode stops before the terminal supernode,
    SURVEY.md section 2 row 16).
    """
    n = pattern.shape[0]
    if incomplete:
        from pastix_tpu_torch.analyze.blocksym import tile_symbolic_ilu

        blk_row, blk_col, level_of_col, nbc = tile_symbolic_ilu(
            pattern, T, level_of_fill
        )
    else:
        blk_row, blk_col, level_of_col, nbc = tile_symbolic(pattern, T)
    if densify_tail_frac > 0 and schur_first_bcol is None and not incomplete:
        blk_row, blk_col, level_of_col, _ = _densify_tail(
            blk_row, blk_col, level_of_col, nbc,
            densify_tail_frac, max_m_tiles=(1 << 15) // T,
        )
    keys = blk_col * np.int64(nbc) + blk_row
    # tile_symbolic emits sorted by (col,row) already; assert & keep
    assert np.all(np.diff(keys) > 0)
    npool = keys.shape[0]

    def lookup(I, J):
        key = np.asarray(J, dtype=np.int64) * nbc + np.asarray(I, dtype=np.int64)
        pos = np.searchsorted(keys, key)
        assert np.all(keys[np.minimum(pos, npool - 1)] == key)
        return pos.astype(np.int64)

    col_ptr = np.searchsorted(blk_col, np.arange(nbc + 1))
    diag_of_col = lookup(np.arange(nbc), np.arange(nbc))

    skip_from = schur_first_bcol if schur_first_bcol is not None else nbc
    active = np.arange(nbc) < skip_from
    nlev = (
        int(level_of_col[active].max()) + 1 if np.any(active) else 0
    )
    levels: list[LevelTables] = []
    for lev in range(nlev):
        cols = np.flatnonzero((level_of_col == lev) & active).astype(np.int64)
        if cols.size == 0:
            continue
        diag = diag_of_col[cols]
        tp_list, td_list, tr_list, tc_list = [], [], [], []
        ga_list, gb_list, gd_list, gk_list = [], [], [], []
        for J in cols:
            lo, hi = col_ptr[J], col_ptr[J + 1]
            rows = blk_row[lo + 1 : hi]  # off-diagonal block rows (sorted)
            m = rows.size
            if m == 0:
                continue
            pidx = np.arange(lo + 1, hi, dtype=np.int32)
            tp_list.append(pidx)
            td_list.append(np.full(m, diag_of_col[J], np.int32))
            tr_list.append(rows.astype(np.int32))
            tc_list.append(np.full(m, J, np.int32))
            # updates: all pairs I >= K from rows.  int32 throughout: the
            # pair tables are the dominant analysis allocation (2.3e8
            # pairs at 10M dof — int64 transients OOMed a 125 GB host)
            ii, kk = np.tril_indices(m)
            ii = ii.astype(np.int32)
            kk = kk.astype(np.int32)
            I = rows[ii]
            K = rows[kk]
            if incomplete:
                # ILU: updates whose target tile was dropped are discarded
                key = K.astype(np.int64) * nbc + I.astype(np.int64)
                pos = np.searchsorted(keys, key)
                hit = keys[np.minimum(pos, npool - 1)] == key
                ii, kk, I, K = ii[hit], kk[hit], I[hit], K[hit]
            ga_list.append(pidx[ii])
            gb_list.append(pidx[kk])
            gd_list.append(lookup(I, K).astype(np.int32))
            gk_list.append(np.full(I.size, J, np.int32))
        cat = lambda lst: (
            np.concatenate(lst).astype(np.int32) if lst else np.empty(0, np.int32)
        )
        ga, gb, gd, gk = cat(ga_list), cat(gb_list), cat(gd_list), cat(gk_list)
        nondiag = (
            blk_row[gd] != blk_col[gd] if gd.size else np.empty(0, bool)
        )
        levels.append(
            LevelTables(
                cols=cols.astype(np.int32),
                diag=diag.astype(np.int32),
                trsm_panel=cat(tp_list),
                trsm_diag=cat(td_list),
                trsm_row=cat(tr_list),
                trsm_col=cat(tc_list),
                gemm_a=ga,
                gemm_b=gb,
                gemm_d=gd,
                gemm_k=gk,
                gemm_nondiag=np.asarray(nondiag, dtype=bool),
            )
        )

    # --- A-value scatter plan ------------------------------------------
    A = sp.coo_matrix(sp.tril(pattern))  # pattern only; values applied later
    # lower part incl diag goes to the L pool
    li, lj = A.row.astype(np.int64), A.col.astype(np.int64)
    pool_idx = lookup(li // T, lj // T)
    scat_pool_flat = pool_idx * (T * T) + (li % T) * T + (lj % T)
    scat_vals_order = np.arange(li.size, dtype=np.int64)  # tril order

    scat_u = scat_u_ord = None
    if for_lu:
        Au = sp.coo_matrix(sp.triu(pattern, k=1))
        ui, uj = Au.row.astype(np.int64), Au.col.astype(np.int64)
        # U(i,j), i<j stored transposed in Ut tile (J_blk=j//T? no:
        # Ut(Ib, Jb) = U(Jb, Ib)^T, so entry (i,j) -> tile (j//T, i//T),
        # local position (j%T, i%T)  [transposed]
        pu = lookup(uj // T, ui // T)
        scat_u = pu * (T * T) + (uj % T) * T + (ui % T)
        scat_u_ord = np.arange(ui.size, dtype=np.int64)

    # padded diagonal identity (rows n..nbc*T-1)
    pad = np.arange(n, nbc * T, dtype=np.int64)
    pdiag = diag_of_col[pad // T]
    diag_pad_flat = pdiag * (T * T) + (pad % T) * T + (pad % T)

    # per-tile scalar row-support bounds for the slab kernel's row-bounded
    # sub-matmuls (sub-tile splitpart analog); tiles absent from the merge
    # (dense-tail explicit zeros) conservatively report full height
    row_lo = row_hi = None
    if not incomplete:
        from pastix_tpu_torch.analyze.blocksym import tile_row_bounds

        bk, blo, bhi, _ = tile_row_bounds(pattern, T)
        row_lo = np.zeros(npool, np.int32)
        row_hi = np.full(npool, T - 1, np.int32)
        pos = np.searchsorted(bk, keys)
        hit = (pos < bk.size) & (bk[np.minimum(pos, bk.size - 1)] == keys)
        row_lo[hit] = blo[pos[hit]]
        row_hi[hit] = bhi[pos[hit]]

    return SolverLayout(
        n=n,
        T=T,
        nbc=nbc,
        npool=npool,
        keys=keys,
        blk_row=blk_row,
        blk_col=blk_col,
        level_of_col=level_of_col,
        levels=levels,
        scat_pool_flat=scat_pool_flat,
        scat_vals_order=scat_vals_order,
        scat_pool_flat_u=scat_u,
        scat_vals_order_u=scat_u_ord,
        diag_pad_flat=diag_pad_flat,
        nnz_l_tiles=npool,
        row_lo=row_lo,
        row_hi=row_hi,
    )
