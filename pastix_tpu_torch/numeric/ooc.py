"""Out-of-core factorization on the card: level-streamed windows under a
device-memory budget (PyTorch counterpart of
``pastix_tpu/numeric/ooc.py``).

The reference pages coeftab blocks to disk during factorization, bounded
by IPARM_OOC_LIMIT (``src/sopalin/src/ooc.c``).  Here the scarce tier is
the card's memory and the backing store is host RAM, so the streaming is
segment-granular:

  * the elimination levels are split into consecutive SEGMENTS whose
    device footprint fits the budget: the segment's own panel tiles (its
    "window") plus a compact accumulator for updates that land beyond it
    (:func:`plan_ooc`);
  * the host keeps the whole tile pool in RAM; per segment it uploads
    the window (A values + every update accumulated so far) followed by
    zeroed export slots, runs the segment program on that buffer
    (trailing updates into window tiles apply in place, updates into
    later segments subtract into the export slots), writes the window
    back and adds the export slots into the host pool (the host
    extend-add);
  * the triangular solves stream the same windows per segment, forward
    then backward, while the (nbc, T, R) right-hand side stays on the
    card (:func:`solve_ooc`).

The host plan (:class:`OOCSegment`, :class:`OOCPlan`, :func:`plan_ooc`)
is a copy of the reference's, with only its import paths changed (that
module imports JAX).

The segment programs (:func:`build_segment_fact_fn`) are the
right-looking ``pair`` level body of ``numeric/factorize`` on the segment
buffer (``n_win + n_out + 1``, T, T) with the plan's remapped tables.  An
fp32 pool runs the hand kernels: ``factorize.diag_trsm`` (the diagonal
tiles by ``cholesky_ex`` (LLᵗ) or kernel K4 (LDLᵗ, LU), the panel TRSM as
a matmul with the inverted diagonal tiles), then kernel K3 over the
level's (ga, gb, gd) pairs (LDLᵗ scaled by the resident pivots ``d``; LU
into the L buffer with b from the Uᵗ buffer, and into the Uᵗ buffer over
the off-diagonal pairs with b from the L buffer).  Other pools (fp64,
complex64, complex128) run the same loop on the torch ops of
``numeric/kernels`` (``factorize.plain_diag_trsm`` and ``plain_update``:
the reference's route for those dtypes).  The budget covers the TRSM
and update transients, in the reservation of four ``plan.gemm_chunk``
tiles that :func:`plan_ooc` makes for them: on the fp32 route the
diagonal tiles go in groups of a quarter chunk and the panels in TRSM
chunks of half a chunk, through a ``factorize.Workspace`` allocated
once (2.25 chunks); K3 reads its operands from the buffer and gathers
nothing; its tables are built once per segment, kept on the host and
uploaded while the segment runs.

The card holds one buffer, sized for the plan's largest segment (two on
LU), for the whole factorization: each segment runs on its leading
tiles, so no two windows are ever held and segments of different sizes
do not fragment the allocator.  A window is a few hundred runs of
consecutive pool tiles: it is copied a run at a time, straight from and
back into the host pools (pinned on a CUDA card, so the copies are
direct DMA); the export slots go through one pinned staging buffer into
the host extend-add.  The copies do not overlap the compute yet.
"""

from __future__ import annotations

import dataclasses
import time
import typing
from typing import Optional

import numpy as np
import torch

from pastix_tpu_torch._device import synchronize
from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.factorize import (
    _PIPE_CHUNK, _PIPE_GROUP, Workspace, diag_trsm, plain_diag_trsm,
    plain_update,
)
from pastix_tpu_torch.numeric.leftlook import piece_ctas
from pastix_tpu_torch.numeric.pipelined import (
    build_pipeline_schedule, gemm_scatter_pipelined, move_chunks,
    pipeline_plan,
)


@dataclasses.dataclass
class OOCSegment:
    win: np.ndarray  # sorted pool idx of the window tiles
    touched_out: np.ndarray  # sorted pool idx of beyond-window targets
    tables: list  # remapped per-level tables (buf coordinates)
    n_win: int
    n_out: int

    def footprint_tiles(self) -> int:
        return self.n_win + self.n_out + 1  # + sacrificial slot


@dataclasses.dataclass
class OOCPlan:
    layout: SolverLayout
    segments: list
    budget_tiles: int
    gemm_chunk: int = 0  # 0 = unchunked; else max gather triples per chunk
    two_pools: bool = False  # LU: window/export tiles count double

    def max_footprint_tiles(self) -> int:
        """Peak device tiles incl. the chunked-GEMM transient (a, b, W
        gathers + the TRSM panel transient share the reservation)."""
        f = max(s.footprint_tiles() for s in self.segments)
        npools = 2 if self.two_pools else 1
        return f * npools + 4 * self.gemm_chunk


def plan_ooc(
    layout: SolverLayout,
    budget_bytes: int,
    dtype_bytes: int = 4,
    levels: Optional[list] = None,
    transient_frac: float = 0.25,
    two_pools: bool = False,
) -> OOCPlan:
    """Greedy segmentation: take consecutive levels while the window +
    export accumulator stays under the budget.  A single level that alone
    exceeds the budget still becomes its own segment (the floor of this
    scheme; the reference pages at cblk granularity and has the same
    floor at its largest supernode).

    ``transient_frac`` of the budget is reserved for the segment programs'
    GEMM/TRSM gather transients; the emitted ``gemm_chunk`` keeps them
    inside the reservation.  ``two_pools`` (LU) counts every window and
    export tile twice (L and Ut buffers)."""
    if levels is None:
        levels = layout.levels
    T = layout.T
    tile_bytes = T * T * dtype_bytes
    total_tiles = max(2, int(budget_bytes // tile_bytes))
    npools = 2 if two_pools else 1
    budget_tiles = max(2, int(total_tiles * (1.0 - transient_frac)) // npools)
    # transient per chunk: a + b + W gathers (3) and a little slack for
    # the TRSM panel pair — 4 tiles per chunk element
    gemm_chunk = max(16, (total_tiles - budget_tiles * npools) // 4)

    col_ptr = np.searchsorted(layout.blk_col, np.arange(layout.nbc + 1))

    def col_tiles(cols):
        return np.concatenate(
            [np.arange(col_ptr[c], col_ptr[c + 1]) for c in cols]
        ) if len(cols) else np.empty(0, np.int64)

    # pre-split any level whose own window would exceed the budget into
    # column-subset sub-levels (columns within a level are independent,
    # so a subset is a valid schedule unit).  Found at the 10M-dof rung:
    # one level's tiles reached 60 GiB — far past any HBM (exp_10m.py).
    # The remaining floor is a single COLUMN's panel + exports, matching
    # the reference's cblk-granular paging floor (src/sopalin/src/ooc.c).
    tiles_of_col = np.diff(col_ptr)
    split_levels = []
    for lv in levels:
        win_sz = int(tiles_of_col[np.asarray(lv.cols)].sum())
        exp_sz = int(np.unique(lv.gemm_d).size) if lv.gemm_d.size else 0
        if win_sz + exp_sz <= budget_tiles:
            split_levels.append(lv)
            continue
        target = max(tiles_of_col[np.asarray(lv.cols)].max(),
                     budget_tiles // 2)
        groups, cur, acc = [], [], 0
        for c in np.asarray(lv.cols):
            if cur and acc + tiles_of_col[c] > target:
                groups.append(np.asarray(cur))
                cur, acc = [], 0
            cur.append(c)
            acc += int(tiles_of_col[c])
        if cur:
            groups.append(np.asarray(cur))
        for g in groups:
            cm = np.isin(lv.cols, g)
            tm = np.isin(lv.trsm_col, g)
            gm = np.isin(lv.gemm_k, g)
            split_levels.append(type(lv)(
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
            ))
    levels = split_levels

    segments = []
    i = 0
    nlev = len(levels)
    while i < nlev:
        j = i
        win_cols: list = []
        gd_all: list = []
        chosen = None
        while j < nlev:
            cand_cols = win_cols + [levels[j].cols]
            cand_gd = gd_all + [levels[j].gemm_d]
            win = col_tiles(np.concatenate(cand_cols))
            gds = (
                np.unique(np.concatenate(cand_gd))
                if any(g.size for g in cand_gd)
                else np.empty(0, np.int64)
            )
            out = np.setdiff1d(gds, win, assume_unique=False)
            foot = win.size + out.size + 1
            if foot <= budget_tiles or j == i:
                chosen = (win, out, j)
                win_cols, gd_all = cand_cols, cand_gd
                j += 1
                if foot > budget_tiles:
                    break  # single over-budget level: emit alone
            else:
                break
        win, out, jlast = chosen
        win = np.sort(win)
        out = np.sort(out)
        n_win, n_out = win.size, out.size

        # export-bounded splitting (10M rung, round 5): one top level's
        # beyond-window update TARGETS alone can exceed any budget (31.5
        # GiB of export slots measured at 9.9M dof) — the column
        # pre-split cannot shrink them because every column updates
        # ~the whole trailing matrix.  Emit multiple PASSES over the
        # same window: pass 0 factors (diag+TRSM) and applies the
        # in-window + first-slice updates; passes k>0 re-upload the
        # (already factored) window with empty diag/TRSM tables and
        # apply the next slice of export targets.  The reference's
        # cblk-granular paging re-reads panels the same way
        # (src/sopalin/src/ooc.c).
        avail_out = budget_tiles - n_win - 1
        if n_out > avail_out and avail_out >= max(32, n_win // 8):
            nslice = -(-n_out // avail_out)
            out_slices = np.array_split(out, nslice)
        else:
            out_slices = [out]

        if len(out_slices) > 1:
            lv_list = levels[i:jlast + 1]
            for kslice, osl in enumerate(out_slices):
                n_osl = osl.size

                def remap_win(idx, win=win, n_win=n_win):
                    pos = np.searchsorted(win, idx)
                    assert np.all(win[np.minimum(pos, n_win - 1)] == idx)
                    return pos.astype(np.int32)

                def remap_tgt(idx, osl=osl, n_osl=n_osl):
                    pos = np.searchsorted(win, idx)
                    hit = (pos < n_win) & (
                        win[np.minimum(pos, n_win - 1)] == idx
                    )
                    pos_out = np.searchsorted(osl, idx)
                    return np.where(
                        hit, pos,
                        n_win + np.minimum(pos_out, max(n_osl - 1, 0)),
                    ).astype(np.int32)

                tables = []
                for lv in lv_list:
                    gd_np = np.asarray(lv.gemm_d)
                    # pass 0 keeps in-window targets + slice 0; later
                    # passes only their slice (in-window would re-apply)
                    in_win = np.isin(gd_np, win)
                    in_sl = np.isin(gd_np, osl)
                    gm = in_sl | (in_win if kslice == 0 else
                                  np.zeros(gd_np.size, bool))
                    e = np.empty(0, np.int32)
                    t = {
                        "cols": (np.asarray(lv.cols, np.int32)
                                 if kslice == 0 else e),
                        "diag": (remap_win(lv.diag) if kslice == 0 else e),
                        "tp": (remap_win(lv.trsm_panel)
                               if kslice == 0 else e),
                        "tr": (np.asarray(lv.trsm_row, np.int32)
                               if kslice == 0 else e),
                        "tc": (np.asarray(lv.trsm_col, np.int32)
                               if kslice == 0 else e),
                        "tcpos": (np.searchsorted(
                            lv.cols, lv.trsm_col
                        ).astype(np.int32) if kslice == 0 else e),
                        "ga": remap_win(lv.gemm_a[gm]),
                        "gb": remap_win(lv.gemm_b[gm]),
                        "gd": remap_tgt(gd_np[gm]),
                        "gk": np.asarray(lv.gemm_k[gm], np.int32),
                    }
                    if two_pools:
                        nd = np.flatnonzero(
                            np.asarray(lv.gemm_nondiag)[gm]
                        )
                        t["ga_nd"] = t["ga"][nd]
                        t["gb_nd"] = t["gb"][nd]
                        t["gd_nd"] = t["gd"][nd]
                    tables.append(t)
                segments.append(
                    OOCSegment(
                        win=win, touched_out=osl, tables=tables,
                        n_win=n_win, n_out=n_osl,
                    )
                )
            i = jlast + 1
            continue

        # remap the segment's level tables into buf coordinates:
        # [0, n_win) window, [n_win, n_win+n_out) exports, last = pad
        def remap_win(idx):
            pos = np.searchsorted(win, idx)
            assert np.all(win[np.minimum(pos, n_win - 1)] == idx)
            return pos.astype(np.int32)

        def remap_tgt(idx):
            pos = np.searchsorted(win, idx)
            hit = (pos < n_win) & (win[np.minimum(pos, n_win - 1)] == idx)
            pos_out = np.searchsorted(out, idx)
            return np.where(
                hit, pos, n_win + np.minimum(pos_out, max(n_out - 1, 0))
            ).astype(np.int32)

        tables = []
        for lv in levels[i:jlast + 1]:
            t = {
                "cols": np.asarray(lv.cols, np.int32),
                "diag": remap_win(lv.diag),
                "tp": remap_win(lv.trsm_panel),
                "tr": np.asarray(lv.trsm_row, np.int32),
                "tc": np.asarray(lv.trsm_col, np.int32),
                "tcpos": np.searchsorted(lv.cols, lv.trsm_col).astype(
                    np.int32
                ),
                "ga": remap_win(lv.gemm_a),
                "gb": remap_win(lv.gemm_b),
                "gd": remap_tgt(lv.gemm_d),
                "gk": np.asarray(lv.gemm_k, np.int32),
            }
            if two_pools:
                # LU: the U-pool update targets (off-diagonal pairs only —
                # diagonal targets live in the L window's combined tile)
                nd = np.flatnonzero(np.asarray(lv.gemm_nondiag))
                t["ga_nd"] = t["ga"][nd]
                t["gb_nd"] = t["gb"][nd]
                t["gd_nd"] = t["gd"][nd]
            tables.append(t)
        segments.append(
            OOCSegment(
                win=win, touched_out=out, tables=tables,
                n_win=n_win, n_out=n_out,
            )
        )
        i = jlast + 1
    return OOCPlan(layout=layout, segments=segments,
                   budget_tiles=budget_tiles, gemm_chunk=gemm_chunk,
                   two_pools=two_pools)


# ---------------------------------------------------------------------------
# the segment programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SegLevel:
    """One level of a segment program, in buffer coordinates: its
    columns in groups (:class:`ColGroup`) and its updates, ``full`` and
    LU's Uᵗ-side ``nd`` over the off-diagonal pairs (fp32: K3's chunks;
    other pools: one (ga, gb, gd, gk) of index tensors)."""

    groups: list
    full: list
    nd: list


class ColGroup(typing.NamedTuple):
    """Block columns of a level and their panels, the ``lv`` of
    ``factorize.diag_trsm``: the columns, their diagonal tiles, the panel
    tiles, each panel's block column and its position among the
    group's columns."""

    cols: torch.Tensor
    diag: torch.Tensor
    tp: torch.Tensor
    tc: torch.Tensor
    tcpos: torch.Tensor


def _to(x, device):
    """``x`` (tensors, K3 chunks, and lists and tuples of them) on
    ``device``."""
    if x is None or isinstance(x, torch.Tensor):
        return x if x is None else x.to(device)
    if isinstance(x, _SegLevel):
        return _SegLevel(_to(x.groups, device), _to(x.full, device),
                         _to(x.nd, device))
    if isinstance(x, ColGroup):
        return ColGroup(*(_to(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    if x and hasattr(x[0], "seg_dst"):
        return move_chunks(x, device)
    return [_to(v, device) for v in x]


def _col_groups(t: dict, gmax: int) -> list:
    """The level ``t``'s columns in groups of at most ``gmax``, each with
    its panels, as :class:`ColGroup` of host int64 tensors."""
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    order = np.argsort(t["tcpos"], kind="stable")
    tcpos = np.asarray(t["tcpos"], np.int64)[order]
    out = []
    for c0 in range(0, t["cols"].size, gmax):
        c1 = min(c0 + gmax, t["cols"].size)
        sel = order[np.searchsorted(tcpos, c0):np.searchsorted(tcpos, c1)]
        out.append(ColGroup(tens(t["cols"][c0:c1]), tens(t["diag"][c0:c1]),
                            tens(t["tp"][sel]), tens(t["tc"][sel]),
                            tens(t["tcpos"][sel] - c0)))
    return out


def _chunks(chunk: int):
    """(panels a TRSM chunk, diagonal tiles a group) of the fp32 route
    for the plan's ``gemm_chunk``: half and a quarter of it, so that the
    :class:`~pastix_tpu_torch.numeric.factorize.Workspace` takes 2.25 of
    the reservation's 4 chunks and the rest is left to the tables and
    the library's own temporaries."""
    return max(1, chunk // 2), max(1, chunk // 4)


def workspace(chunk: int, T: int, dtype, device) -> Workspace:
    """The fp32 route's workspace for the plan's ``gemm_chunk``."""
    return Workspace(*_chunks(chunk), T, dtype, device)


def build_segment_fact_fn(layout: SolverLayout, seg: OOCSegment, device,
                          kind=Factorization.LLT, update_dtype=None,
                          dtype=torch.float32, hermitian: bool = True,
                          chunk: int = 0):
    """The program of one segment (the reference's
    ``build_segment_fact_fn`` and its ``_ldlt`` and ``_lu`` twins), in
    place on segment buffers on ``device``:

    - LLᵗ: ``fn(buf, work=None)``;
    - LDLᵗ, LDLᴴ: ``fn(buf, d, npiv, eps, work=None)``, ``d`` the resident
      (nbc, T) pivots and ``npiv`` the 0-d int32 count of clamped pivots,
      both carried across segments;
    - LU: ``fn(buf_l, buf_u, npiv, eps, work=None)``.

    Per level, the resident right-looking ``pair`` body of
    ``numeric/factorize`` on the segment's tables: the diagonal tiles and
    the panel TRSM (``factorize.diag_trsm``; other pools
    ``plain_diag_trsm``), then the level's updates: fp32 pools through
    K3 (LDLᵗ scaled by ``d[gk]``; LU into the L buffer with b from the Uᵗ
    buffer, then into the Uᵗ buffer over the off-diagonal pairs with b
    from the L buffer), other pools through ``factorize.plain_update``
    (``hermitian`` conjugates a complex pool's b side, LLᴴ and LDLᴴ).  A
    multi-pass segment's later passes have no diagonal tiles or panels
    and run their updates only.  ``chunk`` (``plan.gemm_chunk``; 0
    unchunked) bounds what is gathered at once: an fp32 pool's diagonal
    tiles go in groups of a quarter of it and its panels in TRSM chunks
    of half of it, through the preallocated ``work`` (:func:`workspace`;
    made here when None); other pools' in groups of a quarter and chunks
    of a whole, as torch ops allocate them.  The tables are built here
    once, on the host, and moved to the buffers' device at each call."""
    kind = Factorization(kind)
    is_lu = kind == Factorization.LU
    scaled = kind in (Factorization.LDLT, Factorization.LDLH)
    kernels = dtype == torch.float32
    herm = hermitian and dtype.is_complex
    step = chunk or max(1, seg.n_win)
    ct, g = _chunks(step)
    ctas = piece_ctas(device)

    def updates(ga, gb, gd, gk=None):
        if not ga.size:
            return []
        if kernels:
            return pipeline_plan(build_pipeline_schedule(
                ga, gb, gd, gk=gk, group=_PIPE_GROUP, chunk=_PIPE_CHUNK),
                "cpu", ctas=ctas)
        return [tuple(None if a is None else torch.as_tensor(
            np.asarray(a, np.int64)) for a in (ga, gb, gd, gk))]

    levels = [_SegLevel(
        groups=_col_groups(t, g),
        full=updates(t["ga"], t["gb"], t["gd"], t["gk"] if scaled else None),
        nd=updates(t["ga_nd"], t["gb_nd"], t["gd_nd"]) if is_lu else [],
    ) for t in seg.tables]

    def run(buf, buf_u=None, d=None, npiv=None, eps=0.0, work=None):
        if not kernels:
            eps = float(torch.tensor(eps, dtype=dtype.to_real()))
        elif work is None:
            work = workspace(step, buf.shape[1], dtype, buf.device)
        for lv in _to(levels, buf.device):
            for grp in lv.groups:
                if kernels:
                    diag_trsm(kind, grp, buf, buf_u, d, npiv, eps, chunk=ct,
                              work=work)
                else:
                    plain_diag_trsm(kind, grp, buf, buf_u, d, npiv, eps,
                                    herm, chunk=step)
            if kernels:
                if lv.full:
                    gemm_scatter_pipelined(buf, lv.full, update_dtype,
                                           d=d if scaled else None,
                                           src_pool=buf_u)
                if lv.nd:
                    gemm_scatter_pipelined(buf_u, lv.nd, update_dtype,
                                           src_pool=buf)
                continue
            for inc in lv.full:
                plain_update(buf, inc, update_dtype, d if scaled else None,
                             herm, buf_u, step)
            for inc in lv.nd:
                plain_update(buf_u, inc, update_dtype, src_pool=buf,
                             step=step)

    if is_lu:
        fn = lambda buf_l, buf_u, npiv, eps, work=None: run(
            buf_l, buf_u, npiv=npiv, eps=eps, work=work)
    elif scaled:
        fn = lambda buf, d, npiv, eps, work=None: run(
            buf, d=d, npiv=npiv, eps=eps, work=work)
    else:
        fn = lambda buf, work=None: run(buf, work=work)
    fn.levels = levels
    return fn


# ---------------------------------------------------------------------------
# the streamed factorization
# ---------------------------------------------------------------------------


def reset_io(plan: OOCPlan) -> dict:
    """Zero ``plan.io``: the bytes and seconds the streamed factorization
    and solves have uploaded to the card and downloaded from it (the host
    extend-add included; the card synchronized before each transfer is
    timed and after it)."""
    plan.io = {"up_bytes": 0, "up_s": 0.0, "down_bytes": 0, "down_s": 0.0}
    return plan.io


def _runs(idx) -> list:
    """(first, position, length) of each run of consecutive values in the
    sorted ``idx``: the tiles ``first..first+length`` of the pool are the
    tiles ``position..`` of the window."""
    idx = np.asarray(idx, np.int64)
    if not idx.size:
        return []
    starts = np.flatnonzero(np.r_[True, np.diff(idx) != 1])
    lens = np.diff(np.r_[starts, idx.size])
    return list(zip(idx[starts].tolist(), starts.tolist(), lens.tolist()))


def _seg_index(seg: OOCSegment):
    """(window runs, export tiles) of a segment: :func:`_runs` of its
    window and its ``touched_out`` as a host int64 tensor, kept on it."""
    ix = getattr(seg, "_index", None)
    if ix is None:
        ix = seg._index = (_runs(seg.win), torch.as_tensor(
            np.asarray(seg.touched_out, np.int64)))
    return ix


class _Timed:
    """Adds the bytes and seconds of the transfers in its block to
    ``plan.io[way + "_bytes"]`` and ``[way + "_s"]``."""

    def __init__(self, plan, way, device, nbytes):
        if not getattr(plan, "io", None):
            reset_io(plan)
        self.io, self.way, self.device, self.nbytes = (
            plan.io, way, device, nbytes)

    def __enter__(self):
        synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        synchronize(self.device)
        self.io[self.way + "_s"] += time.perf_counter() - self.t0
        self.io[self.way + "_bytes"] += self.nbytes


def _upload(plan, host, runs, dst):
    """dst = the window of ``runs`` in ``host``: a copy a run (from
    pinned memory, asynchronous ones, waited for once)."""
    with _Timed(plan, "up", dst.device, dst.numel() * dst.element_size()):
        for first, pos, n in runs:
            dst[pos:pos + n].copy_(host[first:first + n], non_blocking=True)


def _write_back(plan, host, runs, out, buf, n_win, stage):
    """The window ``buf[:n_win]`` back into ``host`` (a copy a run), then
    the export slots after it, through the staging buffer, added into
    ``host[out]`` (``index_add_``: faster on the host than an add a run,
    the runs of exports being short): the host extend-add."""
    n_out = out.numel()
    nbytes = (n_win + n_out) * buf[0].numel() * buf.element_size()
    with _Timed(plan, "down", buf.device, nbytes):
        for first, pos, n in runs:
            host[first:first + n].copy_(buf[pos:pos + n], non_blocking=True)
        if n_out:
            s = stage[:n_out]
            s.copy_(buf[n_win:n_win + n_out])
            host.index_add_(0, out, s)


def _staging(plan: OOCPlan, dtype, device, ntiles: int) -> torch.Tensor:
    """The plan's host staging buffer for export slots, at least
    ``ntiles`` tiles of ``dtype`` (pinned for a CUDA card), kept on the
    plan for the next factorization."""
    T = plan.layout.T
    st = getattr(plan, "_stage", None)
    if st is None or st.dtype != dtype or st.shape[0] < ntiles:
        plan._stage = st = None  # drop the old one first
        st = plan._stage = torch.empty(
            (ntiles, T, T), dtype=dtype,
            pin_memory=torch.device(device).type == "cuda")
    return st


def segment_programs(layout: SolverLayout, plan: OOCPlan, device, kind,
                     update_dtype=None, dtype=torch.float32,
                     hermitian: bool = True) -> list:
    """:func:`build_segment_fact_fn` of every segment of ``plan`` (its
    host tables: built once, at analysis, as the resident programs'
    are)."""
    return [build_segment_fact_fn(layout, seg, device, kind, update_dtype,
                                  dtype, hermitian, plan.gemm_chunk)
            for seg in plan.segments]


def _stream(layout, plan, pools, device, programs, verbose, run):
    """Stream the host ``pools`` (one, or LU's L and Uᵗ) through the
    segment ``programs``: per segment, upload the window and zero the
    export slots, ``run(program, buffers, workspace)``, write the window
    back and add the exports into the host pools (they hold −Σ
    contributions).  The card buffer and the fp32 route's
    :func:`workspace` are allocated once; on a CUDA card the
    allocator's cached blocks are released after each segment, whose
    temporaries (tables, group inverses) differ in size from the next
    one's, so that the card's reserved memory stays near what is held."""
    device = torch.device(device)
    T, dtype = layout.T, pools[0].dtype
    foot = max(s.footprint_tiles() for s in plan.segments)
    stage = _staging(plan, dtype, device,
                     max(max(s.n_out for s in plan.segments), 1))
    card = torch.empty((len(pools), foot, T, T), dtype=dtype, device=device)
    work = (workspace(plan.gemm_chunk, T, dtype, device)
            if dtype == torch.float32 else None)
    for si, (seg, fn) in enumerate(zip(plan.segments, programs)):
        runs, out = _seg_index(seg)
        bufs = [card[i, :seg.footprint_tiles()] for i in range(len(pools))]
        for buf, host in zip(bufs, pools):
            _upload(plan, host, runs, buf[:seg.n_win])
            buf[seg.n_win:].zero_()
        run(fn, bufs, work)
        for buf, host in zip(bufs, pools):
            _write_back(plan, host, runs, out, buf, seg.n_win, stage)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if verbose:
            print(f"[pastix-tpu-torch] ooc segment {si + 1}/"
                  f"{len(plan.segments)}: win={seg.n_win} out={seg.n_out} "
                  f"tiles" + (" (x2 pools)" if len(pools) == 2 else ""))
    del card, work


def factorize_ooc(layout: SolverLayout, plan: OOCPlan,
                  host_pool: torch.Tensor, device, hermitian: bool = True,
                  update_dtype=None, verbose: bool = False,
                  programs=None) -> torch.Tensor:
    """Stream the LLᵗ (LLᴴ) factorization through the segment windows on
    ``device``.  ``host_pool`` (npool, T, T), a tensor in host memory,
    holds A's values on entry and the factor on return (in place).
    ``programs``: :func:`segment_programs` (built here when None)."""
    if programs is None:
        programs = segment_programs(layout, plan, device, Factorization.LLT,
                                    update_dtype, host_pool.dtype, hermitian)
    _stream(layout, plan, [host_pool], device, programs, verbose,
            lambda fn, bufs, work: fn(bufs[0], work=work))
    return host_pool


def factorize_ooc_ldlt(layout: SolverLayout, plan: OOCPlan,
                       host_pool: torch.Tensor, eps, device,
                       hermitian: bool = False, update_dtype=None,
                       verbose: bool = False, programs=None):
    """Stream the LDLᵗ (LDLᴴ with ``hermitian``) factorization; returns
    (host_pool, d, npiv): the (nbc, T) pivots and the 0-d int32 count of
    clamped pivots stay on ``device`` across the segments."""
    T, nbc = layout.T, layout.nbc
    if programs is None:
        kind = Factorization.LDLH if hermitian else Factorization.LDLT
        programs = segment_programs(layout, plan, device, kind, update_dtype,
                                    host_pool.dtype, hermitian)
    d = torch.ones((nbc, T), dtype=host_pool.dtype, device=device)
    npiv = torch.zeros((), dtype=torch.int32, device=device)
    _stream(layout, plan, [host_pool], device, programs, verbose,
            lambda fn, bufs, work: fn(bufs[0], d, npiv, eps, work=work))
    return host_pool, d, npiv


def factorize_ooc_lu(layout: SolverLayout, plan: OOCPlan,
                     host_pool: torch.Tensor, host_pool_u: torch.Tensor,
                     eps, device, update_dtype=None, verbose: bool = False,
                     programs=None):
    """Stream the LU factorization (two windows a segment, L and Uᵗ, with
    their own export slots); modifies both host pools in place.  Returns
    (host_pool, host_pool_u, npiv)."""
    if programs is None:
        programs = segment_programs(layout, plan, device, Factorization.LU,
                                    update_dtype, host_pool.dtype)
    npiv = torch.zeros((), dtype=torch.int32, device=device)
    _stream(layout, plan, [host_pool, host_pool_u], device, programs,
            verbose, lambda fn, bufs, work: fn(bufs[0], bufs[1], npiv, eps,
                                               work=work))
    return host_pool, host_pool_u, npiv


def build_streamed_fn(layout: SolverLayout, plan: OOCPlan, device, kind,
                      update_dtype=None, dtype=torch.float32,
                      hermitian: bool = True, e2=None, fused_diag=None):
    """The streamed program of ``kind`` (``factorize.build_factorize_fn``
    with an ``ooc_plan``), with its signatures on host pools (LLᵗ
    ``fn(pool)``, LDLᵗ and LDLᴴ ``fn(pool, eps) -> (pool, d, npiv)``, LU
    ``fn(pool, pool_u, eps) -> (pool, pool_u, npiv)``), run on
    ``device``.  Segments run right-looking per pair (K3 on fp32 pools):
    an ``e2`` other than ``"pair"`` or ``fused_diag=True`` raises, and
    neither ``PASTIX_E2_*`` nor ``PASTIX_FUSED_DIAG`` is read.  The
    segment programs are built here (``fn.programs``)."""
    if e2 not in (None, "pair") or fused_diag:
        raise ValueError(
            "a streamed factorization runs the pair schedule (K3 a level, "
            "cholesky_ex or K4 on the diagonal tiles) on each segment; drop "
            "e2= and fused_diag")
    kind = Factorization(kind)
    if kind == Factorization.LDLH and not dtype.is_complex:
        kind = Factorization.LDLT
    herm = hermitian and dtype.is_complex
    programs = segment_programs(layout, plan, device, kind, update_dtype,
                                dtype, herm)
    if kind == Factorization.LU:
        def fn(pool, pool_u, eps):
            return factorize_ooc_lu(layout, plan, pool, pool_u, eps, device,
                                    update_dtype, fn.verbose, programs)
    elif kind in (Factorization.LDLT, Factorization.LDLH):
        def fn(pool, eps):
            return factorize_ooc_ldlt(layout, plan, pool, eps, device, herm,
                                      update_dtype, fn.verbose, programs)
    else:
        def fn(pool):
            return factorize_ooc(layout, plan, pool, device, herm,
                                 update_dtype, fn.verbose, programs)
    fn.kind = kind
    fn.plan, fn.programs = plan, programs
    fn.verbose = False
    fn.levels, fn.tail = [], []
    fn.e2_saved_flops = 0.0
    fn.e2, fn.compact = "pair", False
    fn.fused_diag = False
    fn.dtype, fn.hermitian = dtype, herm
    return fn


# ---------------------------------------------------------------------------
# the streamed solve
# ---------------------------------------------------------------------------


def build_segment_solve_fns(layout: SolverLayout, seg: OOCSegment, device,
                            kind=Factorization.LLT, dtype=torch.float32,
                            hermitian: bool = True):
    """Forward and backward partial sweeps over one segment's window (the
    reference's ``build_segment_solve_fns`` and ``_lu``): the per-level
    solve's body (``solve.level_sweeps``) over the segment's levels in
    window coordinates.  ``fwd(win, y)`` and ``bwd(win_contrib, win_diag,
    x)`` carry the whole (nbc, T, R) right-hand side and apply only the
    segment's levels (LDLᵗ: unit sweeps; LU: backward with the Uᵗ
    window's contributions and the L window's combined diagonal tiles)."""
    from pastix_tpu_torch.solve import level_sweeps

    tab = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    tables = [tuple(tab(t[k]) for k in ("cols", "diag", "tp", "tr", "tc"))
              for t in seg.tables]
    return level_sweeps(tables, kind, dtype, hermitian)


def segment_sweeps(layout: SolverLayout, plan: OOCPlan, device,
                   kind=Factorization.LLT, dtype=torch.float32,
                   hermitian: bool = True) -> list:
    """:func:`build_segment_solve_fns` of every segment of ``plan``, None
    for a segment without levels."""
    return [build_segment_solve_fns(layout, seg, device, kind, dtype,
                                    hermitian)
            if any(t["cols"].size for t in seg.tables) else None
            for seg in plan.segments]


def solve_ooc(layout: SolverLayout, plan: OOCPlan, host_pool: torch.Tensor,
              b: torch.Tensor, device, kind=Factorization.LLT,
              hermitian: bool = True, d: Optional[torch.Tensor] = None,
              host_pool_u: Optional[torch.Tensor] = None,
              sweeps=None) -> torch.Tensor:
    """Streamed solve on ``device``: forward over the segments, then the
    LDLᵗ scaling by ``d``, then backward over the reversed segments, each
    window uploaded a run at a time into one card buffer (two on LU)
    while the (nbc, T, R) right-hand side ``b`` stays on the card (copied
    to it, in the pools' dtype).  A segment without levels (a later pass
    of a multi-pass segment) uploads nothing.  ``sweeps``:
    :func:`segment_sweeps` (built here when None).  The reference
    runs these sweeps on the host CPU by default
    (``PASTIX_OOC_HOST_SOLVE``); here they run on the card and the
    variable is not read."""
    device = torch.device(device)
    T, dtype = layout.T, host_pool.dtype
    if sweeps is None:
        sweeps = segment_sweeps(layout, plan, device, kind, dtype, hermitian)
    segs = [(s, sw) for s, sw in zip(plan.segments, sweeps) if sw]
    nwin = max((s.n_win for s, _ in segs), default=0)
    card = torch.empty((2 if host_pool_u is not None else 1, nwin, T, T),
                       dtype=dtype, device=device)
    y = b.to(device=device, dtype=dtype, copy=True)
    for seg, (fwd, _) in segs:
        win = card[0, :seg.n_win]
        _upload(plan, host_pool, _seg_index(seg)[0], win)
        y = fwd(win, y)
    if d is not None:
        y.div_(d[:, :, None])
    for seg, (_, bwd) in reversed(segs):
        runs = _seg_index(seg)[0]
        win = card[0, :seg.n_win]
        _upload(plan, host_pool, runs, win)
        if host_pool_u is None:
            y = bwd(win, win, y)
        else:
            win_u = card[1, :seg.n_win]
            _upload(plan, host_pool_u, runs, win_u)
            y = bwd(win_u, win, y)
    return y


def build_streamed_solve_fn(layout: SolverLayout, plan: OOCPlan, device,
                            kind=Factorization.LLT, dtype=torch.float32,
                            hermitian=None):
    """The solve of streamed factors with the signatures of
    ``solve.build_solve_fn`` (``fn(*factors.solve_args(), b)``; the
    pools in host memory, the inverse diagonal tiles unused), through
    :func:`solve_ooc` on ``device``."""
    kind = Factorization(kind)
    if hermitian is None:
        hermitian = kind in (Factorization.LLT, Factorization.LDLH)
    sweeps = segment_sweeps(layout, plan, device, kind, dtype, hermitian)
    run = lambda pool, b, **kw: solve_ooc(layout, plan, pool, b, device,
                                          kind, hermitian, sweeps=sweeps,
                                          **kw)
    if kind == Factorization.LU:
        return lambda pool, pool_u, dinv, dinv_u, b: run(
            pool, b, host_pool_u=pool_u)
    if kind in (Factorization.LDLT, Factorization.LDLH):
        return lambda pool, dinv, d, b: run(pool, b, d=d)
    return lambda pool, dinv, b: run(pool, b)
