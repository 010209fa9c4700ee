"""Panel-slab E2 update: host schedule and kernel K6.

``build_slab_plan`` with ``SlabPlan``, ``_sim_windows`` and the flag
layout is a verbatim copy of the host builder in
``pastix_tpu/numeric/slab_kernels.py`` (that module imports JAX);
``tests/test_torch_slab.py`` holds its tables equal to the reference's.
The schedule reads both operands of a pair from C-tile runs of one
contiguous source panel (a-slab, b-slab) and accumulates into H-tile dst
windows; a pair's a tile is bounded to the rows [r0, r0 + ha) of its
scalar row support (ha in {T/4, T/2, 3T/4, T}), the rows outside being
structural zeros of the panel.  Pairs of short panels go to
``fallback`` for the pair kernel (K3), and so does every pair when the
plan's cost model gates the schedule off.

The TPU words (``pack``: slab and window offsets, ``r0``, the height
class, and the double-buffer flags; ``wcur``/``acur``/``bcur`` and the
prefetch cursors) are decoded once, at analysis time, by
:func:`slab_plan` into what the CUDA kernel reads: per chunk, the
windows' dst tiles in window order, each one dst segment of its pairs
(a tile, b tile, source column, first row ``rl = r0`` and height
``h = ha`` of its row window) in plan order, cut into K1's pieces.

``gemm_scatter_slab`` (K6) has no source of its own: it launches K1's
kernel (``csrc/ll_gemm_scatter.cu``) through K1's launcher
(``leftlook.launch_ll``) with a window height a pair, a and
b both read from the fp32 pool, for a pool on a CUDA device; bf16
updates run on the tensor-core body ``csrc/seg_mma.cuh`` (both operands
rounded as their fragments load), fp32 updates on K1's fp32 body.  A
pool on the CPU goes through the plain twin ``gemm_scatter_slab_ref``.
Plain and scaled (``d``, LDLᵗ): as the reference's kernel does, the
scaled form multiplies the fp32 a-slab by the pivots and rounds once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch.numeric.kernels import check_pool, check_variant, is_bf16
from pastix_tpu_torch.numeric.leftlook import launch_ll, piece_ctas
from pastix_tpu_torch.numeric.pipelined import (
    PipeChunk, pairs_ref, piece_fields,
)

# flag bits (packed with the offsets into one int32 word per pair)
_B_VALID = 1 << 0
_B_WFIRST = 1 << 1
_B_WLAST = 1 << 2
_B_RDSELF = 1 << 3   # window read was not prefetched: start+wait it here
_B_WWPREF = 1 << 4   # before prefetching next window: wait write on that slot
_B_WWSELF = 1 << 5   # before RDSELF read: wait write on own slot
_B_WPAR = 1 << 6
_B_AFIRST = 1 << 7
_B_APAR = 1 << 8
_B_BFIRST = 1 << 9
_B_BPAR = 1 << 10
_SH_IA = 11   # 4 bits
_SH_IB = 15   # 4 bits
_SH_IW = 19   # 6 bits
_SH_R0 = 25   # 4 bits (r0 / 8)
_SH_HC = 29   # 2 bits (ha = 32 * (hcls + 1))


@dataclasses.dataclass
class SlabPlan:
    """Host-built static schedule for one level's slab E2 call."""

    chunks: list          # per-chunk dict of int32 scalar tables
    fallback: tuple       # (ga, gb, gd, gk) pairs for the pair kernel
    C: int
    H: int
    G: int
    stats: dict

    @property
    def n_slab_pairs(self) -> int:
        return int(self.stats["pairs_slab"])


def _sim_windows(win_starts: np.ndarray, H: int):
    """Simulate the 2-slot window state machine for one chunk.

    Per site m (first pair of window m), kernel order is:
      1. if WWPREF: wait the other slot's outstanding write (= write m-1)
      2. if RDSELF: start own read (prefetch was withheld)
      3. wait own read
      4. if wnx >= 0: start window m+1's read into the other slot
    Writes start at each window's last pair; every write is waited exactly
    once (a later site's WWPREF or the end drain).  A window overlapping
    its predecessor's interval (the pool-end clamp case) must not be read
    until that write completes — its read is deferred (RDSELF) and the
    site's WWPREF wait provides the ordering.

    Returns (wpar, rdself, wwpref, wnx_w, endw, endt).
    """
    nw = win_starts.size
    wpar = np.arange(nw) % 2
    rdself = np.zeros(nw, bool)
    wwpref = np.zeros(nw, bool)
    wnx_w = np.full(nw, -1, np.int64)
    ow = [None, None]  # outstanding (un-waited) write per slot
    pref = np.zeros(nw, bool)
    pref[0] = True  # warm-up read
    for m in range(nw):
        s = m % 2
        if ow[1 - s] is not None:
            wwpref[m] = True
            ow[1 - s] = None
        assert ow[s] is None, "slot reused with outstanding write"
        if not pref[m]:
            rdself[m] = True
        if m + 1 < nw:
            if win_starts[m + 1] >= win_starts[m] + H:
                pref[m + 1] = True
                wnx_w[m] = win_starts[m + 1]
            # else: overlap — defer m+1's read to its own site, where the
            # WWPREF wait for write m orders it
        ow[s] = m
    endw = np.zeros(2, np.int32)
    endt = np.zeros(2, np.int32)
    for s in range(2):
        if ow[s] is not None:
            endw[s] = 1
            endt[s] = int(win_starts[ow[s]])
    return wpar, rdself, wwpref, wnx_w, endw, endt


def build_slab_plan(
    ga,
    gb,
    gd,
    gk,
    diag_of_col,
    npool: int,
    *,
    C: int = 16,
    H: int = 32,
    G: int = 4,
    chunk: int = 4096,
    min_panel: int = 6,
    rbounds=None,
    T: int = 128,
) -> SlabPlan:
    """Build the slab schedule for one level's E2 pairs.

    ``rbounds``: optional (rlo, rhi) int arrays over pool tiles (from
    tile_row_bounds matched to the layout keys); None disables row
    bounding (full-height pairs).  Pairs whose source panel is shorter
    than ``min_panel`` tiles (slab fetches would not amortize) go to the
    ``fallback`` list for the pair kernel.
    """
    assert C <= 16 and H <= 64
    ga = np.asarray(ga, np.int64)
    gb = np.asarray(gb, np.int64)
    gd = np.asarray(gd, np.int64)
    gk = np.asarray(gk, np.int64)
    n = ga.size
    stats = dict(pairs_slab=0, pairs_fb=n, desc=0, windows=0, slabs=0,
                 flop_frac=1.0, bytes=0)
    if n == 0 or npool < max(H, C):
        return SlabPlan([], (ga, gb, gd, gk), C, H, G, stats)

    ps = diag_of_col[gk] + 1  # panel start pool index per pair
    ia_all = ga - ps
    # panel length per pair (max a-offset over the pair's source column)
    mcol = np.zeros(int(gk.max()) + 1, np.int64)
    np.maximum.at(mcol, gk, ia_all + 1)
    np.maximum.at(mcol, gk, gb - ps + 1)
    if C == 0:  # adaptive: match the slab size to the panel lengths
        m_med = int(np.median(mcol[gk]))
        C = 4 if m_med < 8 else (8 if m_med < 20 else 16)
    if H == 0:
        H = min(4 * C, 64)
    fb_mask = mcol[gk] < min_panel
    fb = (ga[fb_mask], gb[fb_mask], gd[fb_mask], gk[fb_mask])
    keep = ~fb_mask
    if not keep.any():
        return SlabPlan([], fb, C, H, G, stats)
    ga, gb, gd, gk, ps = ga[keep], gb[keep], gd[keep], gk[keep], ps[keep]
    n = ga.size

    # greedy dst windows over the sorted destinations: each window starts
    # at a cluster's first tile, so fragmented dst regions (leaf levels)
    # are hugged instead of blanketed by a fixed grid (measured 3x window
    # over-read with grid-aligned windows).  Windows are disjoint by
    # construction; only the pool-end clamp can overlap (handled by the
    # slot simulation's deferred read).
    du = np.unique(gd)
    w0u = np.empty(du.size, np.int64)
    cur = du[0]
    for t in range(du.size):
        if du[t] >= cur + H:
            cur = du[t]
        w0u[t] = cur
    w0 = np.minimum(w0u[np.searchsorted(du, gd)], npool - H)
    a0 = np.minimum(ps + ((ga - ps) // C) * C, npool - C)
    b0 = np.minimum(ps + ((gb - ps) // C) * C, npool - C)
    order = np.lexsort((gb, b0, a0, w0))
    ga, gb, gd, gk = ga[order], gb[order], gd[order], gk[order]
    w0, a0, b0 = w0[order], a0[order], b0[order]
    iw = (gd - w0).astype(np.int64)
    ia = (ga - a0).astype(np.int64)
    ib = (gb - b0).astype(np.int64)
    assert (iw < H).all() and (ia < C).all() and (ib < C).all()
    assert (iw >= 0).all() and (ia >= 0).all() and (ib >= 0).all()

    # row bounds -> (r0/8, hcls) per pair; quantum q = T/4 gives height
    # classes {q, 2q, 3q, T} (32/64/96/128 at the production tile size)
    q = T // 4 if (T % 4 == 0 and T >= 32) else T
    if rbounds is not None and 4 * q == T:
        rlo = np.asarray(rbounds[0], np.int64)[ga]
        rhi = np.asarray(rbounds[1], np.int64)[ga]
        r0 = (rlo // 8) * 8
        need = np.maximum(rhi - r0 + 1, 1)
        hcls = np.minimum((need - 1) // q, 3)
        ha = q * (hcls + 1)
        r0 = np.minimum(r0, T - ha)
    else:
        r0 = np.zeros(n, np.int64)
        hcls = np.full(n, 3, np.int64)
        ha = np.full(n, T, np.int64)

    chunks = []
    tot_desc = 0
    tot_windows = 0
    tot_slabs = 0
    tot_bytes = 0.0
    gk_arr = gk
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        m = hi - lo
        cw0 = w0[lo:hi]
        ca0 = a0[lo:hi]
        cb0 = b0[lo:hi]
        cgk = gk_arr[lo:hi]
        wfirst = np.empty(m, bool)
        wfirst[0] = True
        wfirst[1:] = cw0[1:] != cw0[:-1]
        wlast = np.empty(m, bool)
        wlast[-1] = True
        wlast[:-1] = wfirst[1:]
        # a-slab runs break on a0 OR source-column change (a clamp at the
        # pool end can give two columns the same a0; the LDL^T slab-level
        # D-scaling needs one column per run)
        afirst = np.empty(m, bool)
        afirst[0] = True
        afirst[1:] = (ca0[1:] != ca0[:-1]) | (cgk[1:] != cgk[:-1])
        bfirst = np.empty(m, bool)
        bfirst[0] = True
        bfirst[1:] = (cb0[1:] != cb0[:-1]) | afirst[1:]
        firsts = np.flatnonzero(wfirst)
        win_starts = cw0[firsts]
        wpar_w, rdself_w, wwpref_w, wnx_w, endw, endt = _sim_windows(
            win_starts, H
        )

        apar = (np.cumsum(afirst) - 1) % 2
        bpar = (np.cumsum(bfirst) - 1) % 2
        wid = np.cumsum(wfirst) - 1
        pack = (
            _B_VALID
            + wfirst * _B_WFIRST
            + wlast * _B_WLAST
            + (rdself_w[wid] & wfirst) * _B_RDSELF
            + (wwpref_w[wid] & wfirst) * _B_WWPREF
            + wpar_w[wid] * _B_WPAR
            + afirst * _B_AFIRST
            + apar * _B_APAR
            + bfirst * _B_BFIRST
            + bpar * _B_BPAR
            + (ia[lo:hi] << _SH_IA)
            + (ib[lo:hi] << _SH_IB)
            + (iw[lo:hi] << _SH_IW)
            + ((r0[lo:hi] // 8) << _SH_R0)
            + (hcls[lo:hi] << _SH_HC)
        ).astype(np.int64)
        assert (pack < (1 << 31)).all()
        pack = pack.astype(np.int32)
        wnx = np.full(m, -1, np.int32)
        wnx[firsts] = wnx_w
        anx = np.full(m, -1, np.int32)
        af = np.flatnonzero(afirst)
        anx[af[:-1]] = ca0[af[1:]]
        bnx = np.full(m, -1, np.int32)
        bf = np.flatnonzero(bfirst)
        bnx[bf[:-1]] = cb0[bf[1:]]
        t = {
            "pack": pack,
            "wcur": cw0.astype(np.int32),
            "wnx": wnx,
            "acur": ca0.astype(np.int32),
            "anx": anx,
            "bcur": cb0.astype(np.int32),
            "bnx": bnx,
            "endw": endw,
            "endt": endt,
            "gk": gk[lo:hi].astype(np.int32),
        }
        gpad = (-m) % G
        if gpad:
            for key in ("wcur", "acur", "bcur", "gk"):
                t[key] = np.concatenate([t[key], np.repeat(t[key][-1:], gpad)])
            t["pack"] = np.concatenate(
                [t["pack"], np.zeros(gpad, np.int32)]
            )
            for key in ("wnx", "anx", "bnx"):
                t[key] = np.concatenate([t[key], np.full(gpad, -1, np.int32)])
        chunks.append(t)
        nw = firsts.size
        tot_windows += nw
        tot_slabs += int(afirst.sum() + bfirst.sum())
        tot_desc += 2 * nw + int(afirst.sum() + bfirst.sum())
        tot_bytes += (2.0 * nw * H + afirst.sum() * C + bfirst.sum() * C) * (
            T * T * 4
        )
    flop_frac = float(ha.sum()) / (T * n) if n else 1.0
    stats.update(
        pairs_slab=n,
        pairs_fb=int(fb[0].size),
        desc=tot_desc,
        windows=tot_windows,
        slabs=tot_slabs,
        flop_frac=flop_frac,
        bytes=tot_bytes,
    )

    # cost-model gate: use the slab schedule only where it beats the pair
    # kernel's estimate.  v5e-measured constants (exp_dma.py, round 4):
    # kernel-issued DMAs run at ~240 GB/s FLAT from 64 KB to 2 MB with
    # ~50 ns/descriptor — the E2 wall is BYTES MOVED, not descriptor
    # issue (round 3's inference corrected).  The slab schedule only wins
    # where its window+slab bytes undercut the pair kernel's ~2.2
    # tiles/pair, which greedy windows rarely achieve — the dst-block
    # kernel (block_kernels.py) is the byte-efficient schedule.
    import os as _os

    gate = float(_os.environ.get("PASTIX_SLAB_GATE", "1.0"))
    if gate > 0 and n:
        t_desc, bw, mxu = 50e-9, 240e9, 120e12
        tile_b = T * T * 4
        seg = n / max(1, np.unique(gd).size)
        t_pair = max(2.0 * t_desc, (2.0 + 2.0 / seg) * tile_b / bw)
        t_slab = max(
            tot_desc / n * t_desc,
            tot_bytes / n / bw,
            flop_frac * 2.0 * T ** 3 / mxu,
        )
        stats["t_pair_est"] = t_pair
        stats["t_slab_est"] = t_slab
        if t_slab > gate * t_pair:
            fb_all = (
                np.concatenate([fb[0], ga]),
                np.concatenate([fb[1], gb]),
                np.concatenate([fb[2], gd]),
                np.concatenate([fb[3], gk]),
            )
            stats.update(pairs_slab=0, pairs_fb=int(fb_all[0].size),
                         gated_off=True)
            return SlabPlan([], fb_all, C, H, G, stats)
    return SlabPlan(chunks, fb, C, H, G, stats)


@dataclasses.dataclass
class SlabChunk(PipeChunk):
    """One chunk of a slab plan as the kernel reads it: K3's tables
    (:class:`~pastix_tpu_torch.numeric.pipelined.PipeChunk`, its pieces
    included; ``pair_a``/``pair_b`` in the a- and b-slabs, ``pair_k``
    always set) plus each pair's row window, int64 tensors on the pool's
    device.  Dst tiles are grouped by window, in window order; each is
    one segment of pairs."""

    pair_rl: torch.Tensor = None  # [n] first row of a's bounded rows (r0)
    pair_h: torch.Tensor = None  # [n] number of a's bounded rows (ha)

    def pairs(self):
        """(a, b, dst, k, rl, h) of every pair, in kernel order."""
        return super().pairs() + (self.pair_rl, self.pair_h)


def decode_slab_chunk(t, T: int):
    """(a, b, dst, k, r0, ha) of the valid pairs of one
    :func:`build_slab_plan` chunk, in plan order, decoded from its packed
    words: a = acur + ia, b = bcur + ib, dst = wcur + iw, r0 = 8 (r0/8),
    ha = q (hcls + 1) with the reference kernel's q."""
    pack = np.asarray(t["pack"], np.int64)
    v = (pack & _B_VALID) != 0
    pack = pack[v]
    ia = (pack >> _SH_IA) & 15
    ib = (pack >> _SH_IB) & 15
    iw = (pack >> _SH_IW) & 63
    r0 = ((pack >> _SH_R0) & 15) * 8
    hcls = (pack >> _SH_HC) & 3
    q = T // 4 if (T % 4 == 0 and T >= 32) else T
    ha = q * (hcls + 1) if 4 * q == T else np.full(pack.size, T, np.int64)
    cur = lambda key: np.asarray(t[key], np.int64)[v]
    return (cur("acur") + ia, cur("bcur") + ib, cur("wcur") + iw, cur("gk"),
            r0, ha)


def slab_plan(plan: SlabPlan, T: int, device) -> list:
    """Kernel tables (:class:`SlabChunk`) of a :func:`build_slab_plan`
    result, one per chunk, uploaded to ``device``, the dst segments cut
    into K1's pieces for its card (``pipelined.piece_fields``).

    Within a chunk a dst tile lies in one window (a window holds the
    dsts of one cluster), so no two segments share a dst; a window cut by
    a chunk boundary lands in two chunks, which run in order."""
    ctas = piece_ctas(device)
    tens = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.int64),
                                     device=device)
    out = []
    for t in plan.chunks:
        a, b, dst, k, r0, ha = decode_slab_chunk(t, T)
        if not a.size:
            continue
        order = np.argsort(dst, kind="stable")
        a, b, dst, k, r0, ha = (x[order] for x in (a, b, dst, k, r0, ha))
        starts = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]])
        seg_ptr = np.r_[starts, a.size]
        out.append(SlabChunk(
            n_pairs=int(a.size), seg_ptr=tens(seg_ptr),
            seg_dst=tens(dst[starts]), pair_a=tens(a), pair_b=tens(b),
            pair_k=tens(k), pair_rl=tens(r0), pair_h=tens(ha),
            **piece_fields(seg_ptr, a.size, ctas, tens)))
    return out


def gemm_scatter_slab(pool: torch.Tensor, chunks, update_dtype=None, *,
                      d=None):
    """pool[dst] rows [r0, r0 + ha) -= op(a rows diag(d[k])) @ op(b)^T
    for every pair of a :func:`slab_plan`, in place: ``op`` rounds to
    ``update_dtype`` after the scaling, products accumulate in fp32.  The
    plan's fallback pairs are not applied (the caller runs them through
    K3).  A pool on a CUDA device goes through kernel K6, one launch of
    K1's kernel per chunk with a window height a pair, in order on the
    current stream (bf16 updates: a CTA per piece and 128 x 64 half at
    T = 128, as K3 runs fp32 operands); a pool on the CPU through
    :func:`gemm_scatter_slab_ref`."""
    check_pool(pool)
    check_variant(pool, d, None, [])
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_slab_ref(pool, chunks, update_dtype, d=d)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    launch_ll(pool, chunks,
              lambda c: (3 if bf16 else 0, pool, pool, c.pair_a, c.pair_b),
              bf16, d, gemm_scatter_slab)
    return pool


gemm_scatter_slab.launches = 0  # K6 launches (one per chunk)
gemm_scatter_slab.twin_launches = 0  # calls of the plain twin


def gemm_scatter_slab_ref(pool: torch.Tensor, chunks, update_dtype=None,
                          *, d=None):
    """Plain PyTorch twin of :func:`gemm_scatter_slab`, on any device:
    each chunk's pairs as a pair list with a's rows outside [rl, rl + h)
    set to zero (a scaled, then rounded once), chunks in order."""
    check_pool(pool)
    check_variant(pool, d, None, [])
    is_bf16(update_dtype)
    gemm_scatter_slab.twin_launches += 1
    for c in chunks:
        a, b, dst, k, rl, h = c.pairs()
        pairs_ref(pool, pool, pool, a, b, dst, update_dtype, d=d, pair_k=k,
                  rows=(rl, h))
    return pool
