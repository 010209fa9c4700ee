"""Dst-block E2 update: host schedule and kernel K5.

``build_block_plan`` with ``BlockPlan``, ``_pack_ptr``, ``_seg_cover`` and
the flag layout is a verbatim copy of the host builder in
``pastix_tpu/numeric/block_kernels.py`` (that module imports JAX);
``tests/test_torch_block.py`` holds its tables equal to the reference's.
A dst block is the stored tiles of an 8 x 4 rectangle of the tile grid;
one entry is one source panel K's contribution to a block: an a-slab of
up to 8 tiles of K (the block's rows) against a b-slab of up to 4 (its
columns), every cross product landing on one stored dst tile.  Pairs
whose entries do not pay for their slabs go to ``fallback`` for the pair
kernel (K3).

The TPU words (entry flags, size classes, the ``io_ops`` / ``sc_ops``
DMA and sublane-scatter segments, ``rd``/``nx``/``wr``/``endw``) are
decoded once, at analysis time, by :func:`block_plan` into what the
CUDA kernel reads: per dst block row (one tile row I of a block), its up
to four dst tiles, and per entry that reaches the row the a tile (I, K),
its source column K and the b tile (J, K) of each block column, or none.

``gemm_scatter_block`` launches the hand-written CUDA kernel
(``csrc/block_gemm_scatter.cu``) for a pool on a CUDA device and its
plain twin ``gemm_scatter_block_ref`` for a pool on the CPU, plain and
scaled (``d``, LDLᵗ).  As the reference's kernel does, the scaled form
multiplies the fp32 a-slab by the pivots and rounds once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.kernels import check_pool, check_variant, is_bf16
from pastix_tpu_torch.numeric.pipelined import pairs_ref

# entry flag word layout
_E_VALID = 1 << 0
_E_BFIRST = 1 << 1   # first entry of a dst block
_E_BLAST = 1 << 2    # last entry of a dst block
_E_WWPREF = 1 << 3   # wait other slot's write before prefetching next read
_E_BPAR = 1 << 4     # dst block slot parity
_E_APAR = 1 << 5     # a/b slab slot parity (per-entry alternating)
_SH_HA = 6           # 2 bits: a-slab class index (sizes _ACLS)
_SH_HB = 8           # 1 bit: b-slab class index (sizes _BCLS)

_ACLS = (2, 4, 8)
_BCLS = (2, 4)
_SEG = (1, 2, 4, 8)  # dst io / scatter size classes (tiles / tile-rows)
_MAXIO = 12          # max dst io segments per block (B_J cols x 3 segs)


def _pack_ptr(ptr, cnt):
    assert ptr < (1 << 24) and cnt < (1 << 7)
    return np.int32(ptr + (cnt << 24))


def _seg_cover(length):
    """Greedy exact cover of `length` with _SEG classes (descending)."""
    out = []
    off = 0
    for s in reversed(_SEG):
        while length - off >= s:
            out.append((off, s))
            off += s
    return out


@dataclasses.dataclass
class BlockPlan:
    chunks: list
    fallback: tuple  # (ga, gb, gd, gk)
    B_I: int
    B_J: int
    stats: dict

    @property
    def n_block_pairs(self) -> int:
        return int(self.stats["pairs_blk"])


def build_block_plan(
    ga,
    gb,
    gd,
    gk,
    blk_row,
    blk_col,
    keys,
    nbc: int,
    npool: int,
    *,
    B_I: int = 8,
    B_J: int = 4,
    chunk: int = 2048,
    gate: float | None = None,
) -> BlockPlan:
    """Build the dst-block schedule for one level's E2 pairs.

    Pairs whose (block, panel) entry economics lose to the pair kernel
    (few cross products per fetched slab) go to ``fallback``.
    """
    import os as _os

    assert B_I == _ACLS[-1] and B_J == _BCLS[-1], (
        "size classes are built for B_I=8, B_J=4"
    )
    ga = np.asarray(ga, np.int64)
    gb = np.asarray(gb, np.int64)
    gd = np.asarray(gd, np.int64)
    gk = np.asarray(gk, np.int64)
    n = ga.size
    stats = dict(pairs_blk=0, pairs_fb=n, entries=0, blocks=0, bytes=0.0,
                 exec_flops=0.0)
    if n == 0 or npool >= (1 << 24):
        return BlockPlan([], (ga, gb, gd, gk), B_I, B_J, stats)

    I = blk_row[gd]
    J = blk_col[gd]
    bi = I // B_I
    bj = J // B_J
    nbj = -(-nbc // B_J)
    blk = bi * nbj + bj
    order = np.lexsort((ga, gb, gk, blk))
    ga, gb, gd, gk, blk = (
        ga[order], gb[order], gd[order], gk[order], blk[order]
    )
    I, J, bi, bj = I[order], J[order], bi[order], bj[order]

    # entry = (block, K) group
    ent_key = blk * np.int64(nbc + 1) + gk
    ent_first = np.empty(n, bool)
    ent_first[0] = True
    ent_first[1:] = ent_key[1:] != ent_key[:-1]
    eid = np.cumsum(ent_first) - 1
    ne = int(eid[-1]) + 1
    e_start = np.flatnonzero(ent_first)
    e_end = np.append(e_start[1:], n)

    a0 = np.minimum.reduceat(ga, e_start)
    a1 = np.maximum.reduceat(ga, e_start)
    b0 = np.minimum.reduceat(gb, e_start)
    b1 = np.maximum.reduceat(gb, e_start)
    ha = a1 - a0 + 1
    hb = b1 - b0 + 1
    assert (ha <= B_I).all() and (hb <= B_J).all()
    ha_cls = np.searchsorted(_ACLS, np.minimum(ha, _ACLS[-1]))
    hb_cls = np.searchsorted(_BCLS, np.minimum(hb, _BCLS[-1]))
    ha_sz = np.asarray(_ACLS)[ha_cls]
    hb_sz = np.asarray(_BCLS)[hb_cls]
    # class slabs must stay inside the pool (junk reads ok, OOB not)
    a0e = np.minimum(a0, npool - ha_sz)
    b0e = np.minimum(b0, npool - hb_sz)
    e_blk = blk[e_start]
    e_gk = gk[e_start]
    e_pairs = e_end - e_start

    # per-entry economics: slab tiles fetched per pair vs the pair
    # kernel's ~2.2 tiles/pair; dst io amortizes across the block's
    # entries, approximated with the block's entry count
    blk_first_e = np.empty(ne, bool)
    blk_first_e[0] = True
    blk_first_e[1:] = e_blk[1:] != e_blk[:-1]
    bid_of_e = np.cumsum(blk_first_e) - 1
    nblocks = int(bid_of_e[-1]) + 1
    ent_of_blk = np.bincount(bid_of_e, minlength=nblocks)
    pairs_of_blk = np.zeros(nblocks, np.int64)
    np.add.at(pairs_of_blk, bid_of_e, e_pairs)
    # dst tiles touched per block (distinct gd)
    dst_of_blk = np.zeros(nblocks, np.int64)
    uniq_d = np.empty(n, bool)
    uniq_d[0] = True
    uniq_d[1:] = (gd[1:] != gd[:-1]) | (blk[1:] != blk[:-1])
    np.add.at(dst_of_blk, bid_of_e[eid], uniq_d)
    est_tiles_pp = (
        (ha_sz + hb_sz) / np.maximum(e_pairs, 1)
        + (2.0 * dst_of_blk / np.maximum(pairs_of_blk, 1))[bid_of_e]
    )
    if gate is None:
        gate = float(_os.environ.get("PASTIX_BLOCK_GATE", "1.8"))
    keep_e = est_tiles_pp <= gate  # pair kernel ~2.2 tiles/pair
    keep = keep_e[eid]
    fb = (ga[~keep], gb[~keep], gd[~keep], gk[~keep])
    if not keep.any():
        return BlockPlan([], fb, B_I, B_J, stats)

    # re-extract kept pairs/entries (entry boundaries survive: pairs of an
    # entry are kept or dropped together)
    sel_e = np.flatnonzero(keep_e)
    chunks = []
    tot_bytes = 0.0
    tot_entries = 0
    tot_blocks = 0
    tot_exec = 0.0
    T = None  # filled by caller via kernel; flops use T^3 at call site

    # chunk over entries, never splitting a block
    e_ptr = 0
    while e_ptr < sel_e.size:
        e_hi = min(e_ptr + chunk, sel_e.size)
        # extend/shrink to a block boundary
        if e_hi < sel_e.size:
            while (
                e_hi > e_ptr + 1
                and e_blk[sel_e[e_hi]] == e_blk[sel_e[e_hi - 1]]
            ):
                e_hi -= 1
        ce = sel_e[e_ptr:e_hi]
        e_ptr = e_hi

        m = ce.size
        flags = np.full(m, _E_VALID, np.int64)
        cblk = e_blk[ce]
        bfirst = np.empty(m, bool)
        bfirst[0] = True
        bfirst[1:] = cblk[1:] != cblk[:-1]
        blast = np.empty(m, bool)
        blast[-1] = True
        blast[:-1] = bfirst[1:]
        wid = np.cumsum(bfirst) - 1
        nw = int(wid[-1]) + 1
        bpar_w = np.arange(nw) % 2
        # at block m's first entry, the prefetch of block m+1's read goes
        # into slot 1-bpar(m), which block m-1's write still owns: wait it
        # iff m-1 exists AND the prefetch happens (m+1 < nw).  Every write
        # must be waited EXACTLY once (the end drain covers the last two);
        # the off-by-one here (2: instead of 1:) left block 0's write
        # un-waited and double-waited block nw-2 — an undrained/underflowed
        # DMA semaphore faults the chip (bisected on v5e, round 4)
        wwpref_w = np.zeros(nw, bool)
        if nw > 2:
            wwpref_w[1 : nw - 1] = True

        apar = np.arange(m) % 2

        # ---- dst io ops per block in this chunk -------------------------
        io_ops = []
        rd_packed = np.zeros(m, np.int32)
        nx_packed = np.full(m, -1, np.int32)
        wr_packed = np.zeros(m, np.int32)
        blk_io_range = []
        firsts = np.flatnonzero(bfirst)
        lasts = np.flatnonzero(blast)
        for w in range(nw):
            e0 = ce[firsts[w]]
            bb = e_blk[e0]
            w_bi, w_bj = bb // nbj, bb % nbj
            ops = []
            # columns with pairs in this block (from its entries' gd)
            lo_p, hi_p = e_start[e0], e_end[ce[lasts[w]]]
            cols = np.unique(J[lo_p:hi_p][blk[lo_p:hi_p] == bb])
            for Jc in cols:
                jj = int(Jc - w_bj * B_J)
                lo = int(np.searchsorted(keys, Jc * nbc + w_bi * B_I))
                hi = int(
                    np.searchsorted(keys, Jc * nbc + (w_bi + 1) * B_I)
                )
                for off, s in _seg_cover(hi - lo):
                    sc = _SEG.index(s)
                    # start(24b) | off(3b) | sc(2b) | jj(2b) = 31 bits
                    ops.append(
                        np.int32(
                            (lo + off)
                            + (off << 24)
                            + (sc << 27)
                            + (jj << 29)
                        )
                    )
            assert len(ops) <= _MAXIO, "dst io segments exceed _MAXIO"
            blk_io_range.append((len(io_ops), len(ops)))
            io_ops.extend(ops)
        for w in range(nw):
            p, c = blk_io_range[w]
            rd_packed[firsts[w]] = _pack_ptr(p, c)
            wr_packed[lasts[w]] = _pack_ptr(p, c)
            if w + 1 < nw:
                p2, c2 = blk_io_range[w + 1]
                nx_packed[firsts[w]] = _pack_ptr(p2, c2)

        # ---- scatter ops per entry --------------------------------------
        sc_ops = []
        sc_packed = np.zeros(m, np.int32)
        for t, e in enumerate(ce):
            lo_p, hi_p = e_start[e], e_end[e]
            bb = e_blk[e]
            w_bi, w_bj = bb // nbj, bb % nbj
            ar = (ga[lo_p:hi_p] - a0[e]).astype(np.int64)
            jb = (gb[lo_p:hi_p] - b0[e]).astype(np.int64)
            Jp = J[lo_p:hi_p]
            jjp = Jp - w_bj * B_J
            col_lo = np.searchsorted(keys, Jp * nbc + w_bi * B_I)
            slot = gd[lo_p:hi_p] - col_lo
            ops = []
            # group by jb, emit runs contiguous in BOTH ar and slot
            o2 = np.lexsort((ar, jb))
            ars, jbs, jjs, slots = ar[o2], jb[o2], jjp[o2], slot[o2]
            k0 = 0
            for t2 in range(1, ars.size + 1):
                if (
                    t2 == ars.size
                    or jbs[t2] != jbs[k0]
                    or ars[t2] != ars[t2 - 1] + 1
                    or slots[t2] != slots[t2 - 1] + 1
                ):
                    run_len = t2 - k0
                    for off, s in _seg_cover(run_len):
                        sc = _SEG.index(s)
                        ops.append(
                            np.int32(
                                int(ars[k0] + off)
                                + (int(slots[k0] + off) << 4)
                                + (int(jbs[k0]) << 8)
                                + (int(jjs[k0]) << 11)
                                + (sc << 14)
                            )
                        )
                    k0 = t2
            sc_packed[t] = _pack_ptr(len(sc_ops), len(ops))
            sc_ops.extend(ops)

        flags += (
            bfirst * _E_BFIRST
            + blast * _E_BLAST
            + (wwpref_w[wid] & bfirst) * _E_WWPREF
            + bpar_w[wid] * _E_BPAR
            + apar * _E_APAR
            + (ha_cls[ce] << _SH_HA)
            + (hb_cls[ce] << _SH_HB)
        )
        # end drain: outstanding writes (last two blocks)
        endw = np.full(2, -1, np.int32)
        p_last = int(bpar_w[-1])
        pp, cc = blk_io_range[-1]
        endw[p_last] = _pack_ptr(pp, cc)
        if nw >= 2:
            pp, cc = blk_io_range[-2]
            endw[1 - p_last] = _pack_ptr(pp, cc)

        t = {
            "flags": flags.astype(np.int32),
            "a0": a0e[ce].astype(np.int32),
            "b0": b0e[ce].astype(np.int32),
            "sc": sc_packed,
            "rd": rd_packed,
            "nx": nx_packed,
            "wr": wr_packed,
            "endw": endw,
            "io_ops": np.asarray(io_ops, np.int32)
            if io_ops
            else np.zeros(1, np.int32),
            "sc_ops": np.asarray(sc_ops, np.int32)
            if sc_ops
            else np.zeros(1, np.int32),
            "gk": e_gk[ce].astype(np.int32),
        }
        chunks.append(t)
        tot_entries += m
        tot_blocks += nw
        io_tiles = sum(
            _SEG[(int(op) >> 27) & 3] for op in t["io_ops"]
        )
        tot_bytes += float(
            (ha_sz[ce] + hb_sz[ce]).sum() + 2 * io_tiles
        )
        tot_exec += float((ha_sz[ce] * hb_sz[ce]).sum())

    stats.update(
        pairs_blk=int(keep.sum()),
        pairs_fb=int(fb[0].size),
        entries=tot_entries,
        blocks=tot_blocks,
        exec_tile_products=tot_exec,
        tiles_moved=tot_bytes,
    )
    return BlockPlan(chunks, fb, B_I, B_J, stats)


@dataclasses.dataclass
class BlockChunk:
    """One chunk of a block plan as the kernel reads it: int64 tensors on
    the pool's device.  Row r of the chunk is one tile row of one dst
    block; its entries are ``ent_ptr[r]:ent_ptr[r + 1]``, in plan order."""

    n_pairs: int
    row_dst: torch.Tensor  # [nrow, B_J] pool index of each dst tile, or -1
    ent_ptr: torch.Tensor  # [nrow + 1] entry offsets of the rows
    ent_a: torch.Tensor  # [nent] pool index of the entry's a tile (I, K)
    ent_b: torch.Tensor  # [nent, B_J] pool index of b (J, K), or -1
    ent_k: torch.Tensor  # [nent] source column K (LDLᵗ d)

    @property
    def nrow(self) -> int:
        return self.row_dst.shape[0]

    def pairs(self):
        """(a, b, dst, k) of every cross product the chunk applies, in
        the kernel's order per dst tile."""
        e, j = torch.nonzero(self.ent_b >= 0, as_tuple=True)
        row = torch.repeat_interleave(
            torch.arange(self.nrow, device=self.ent_b.device),
            self.ent_ptr.diff())[e]
        return (self.ent_a[e], self.ent_b[e, j], self.row_dst[row, j],
                self.ent_k[e])


def ragged_arange(cnt):
    """[0, cnt[0]), [0, cnt[1]), ... concatenated (int64 numpy)."""
    cnt = np.asarray(cnt, np.int64)
    starts = np.repeat(np.cumsum(cnt) - cnt, cnt)
    return np.arange(int(cnt.sum()), dtype=np.int64) - starts


def decode_block_chunk(t, B_J: int = 4):
    """(a, b, dst, k, entry, block, column) of every cross product of
    one :func:`build_block_plan` chunk, decoded from its packed words: a
    dst block's tiles from its ``io_ops`` (start tile, offset in the
    block column, size class, column), each entry's products from its
    ``sc_ops`` (a offset in the slab, dst slot, b offset, column, run
    class), the slabs from ``a0``/``b0``."""
    flags = np.asarray(t["flags"], np.int64)
    m = flags.size
    blk = np.cumsum((flags & _E_BFIRST) != 0) - 1
    firsts = np.flatnonzero(flags & _E_BFIRST)
    nw = firsts.size
    rd = np.asarray(t["rd"], np.int64)[firsts]
    cnt = rd >> 24
    op = np.asarray(t["io_ops"], np.int64)[
        np.repeat(rd & 0xFFFFFF, cnt) + ragged_arange(cnt)]
    w_op = np.repeat(np.arange(nw), cnt)
    start, off = op & 0xFFFFFF, (op >> 24) & 7
    size = np.asarray(_SEG, np.int64)[(op >> 27) & 3]
    jj = (op >> 29) & 3
    u = ragged_arange(size)
    # slot table: (block, column, slot) -> pool tile
    S = _SEG[-1]
    table = np.full(nw * B_J * S, -1, np.int64)
    table[np.repeat((w_op * B_J + jj) * S + off, size) + u] = (
        np.repeat(start, size) + u)
    sc = np.asarray(t["sc"], np.int64)
    cnt = sc >> 24
    e_op = np.repeat(np.arange(m), cnt)
    op = np.asarray(t["sc_ops"], np.int64)[
        np.repeat(sc & 0xFFFFFF, cnt) + ragged_arange(cnt)]
    ar0, slot0 = op & 15, (op >> 4) & 15
    jb, jj = (op >> 8) & 7, (op >> 11) & 7
    size = np.asarray(_SEG, np.int64)[(op >> 14) & 3]
    u = ragged_arange(size)
    rep = lambda x: np.repeat(x, size)
    e = rep(e_op)
    jj = rep(jj)
    a = np.asarray(t["a0"], np.int64)[e] + rep(ar0) + u
    b = np.asarray(t["b0"], np.int64)[e] + rep(jb)
    dst = table[(blk[e] * B_J + jj) * S + rep(slot0) + u]
    assert (dst >= 0).all(), "a scatter op outside its block's tiles"
    k = np.asarray(t["gk"], np.int64)[e]
    return a, b, dst, k, e, blk[e], jj


def block_plan(plan: BlockPlan, blk_row, device) -> list:
    """Kernel tables (:class:`BlockChunk`) of a :func:`build_block_plan`
    result, one per chunk, uploaded to ``device``.  ``blk_row``: the
    layout's tile rows, which name a dst tile's row in its block.

    Blocks are disjoint, so the rows of one chunk never share a dst tile;
    a block cut by a chunk boundary lands in two chunks, which run in
    order."""
    blk_row = np.asarray(blk_row, np.int64)
    B_J = plan.B_J
    out = []
    for t in plan.chunks:
        a, b, dst, k, e, blk, jj = decode_block_chunk(t, B_J)
        if not a.size:
            continue
        I = blk_row[dst]
        # rows: (block, dst row); row entries: (row, entry)
        order = np.lexsort((jj, e, I, blk))
        a, b, dst, k, e, blk, jj, I = (
            x[order] for x in (a, b, dst, k, e, blk, jj, I))
        new_row = np.r_[True, (blk[1:] != blk[:-1]) | (I[1:] != I[:-1])]
        new_ent = new_row | np.r_[True, e[1:] != e[:-1]]
        row = np.cumsum(new_row) - 1
        ent = np.cumsum(new_ent) - 1
        nrow, nent = int(row[-1]) + 1, int(ent[-1]) + 1
        # one product per (entry, row, column), one a tile (I, K) per
        # (entry, row), one dst tile per (row, column)
        assert np.unique(ent * B_J + jj).size == ent.size
        ent_a = a[new_ent]
        assert (a == ent_a[ent]).all(), "an entry reaches one row twice"
        row_dst = np.full((nrow, B_J), -1, np.int64)
        row_dst[row, jj] = dst
        assert (row_dst[row, jj] == dst).all()
        ent_b = np.full((nent, B_J), -1, np.int64)
        ent_b[ent, jj] = b
        tens = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.int64),
                                         device=device)
        out.append(BlockChunk(
            n_pairs=int(a.size),
            row_dst=tens(row_dst),
            ent_ptr=tens(np.r_[np.flatnonzero(new_row[new_ent]), nent]),
            ent_a=tens(ent_a), ent_b=tens(ent_b), ent_k=tens(k[new_ent]),
        ))
    return out


def gemm_scatter_block(pool: torch.Tensor, chunks, update_dtype=None, *,
                       d=None):
    """pool[dst] -= op(a diag(d[K])) @ op(b)^T for every cross product of
    a :func:`block_plan`, in place: ``op`` rounds to ``update_dtype``
    after the scaling, products accumulate in fp32.  The plan's fallback
    pairs are not applied (the caller runs them through K3).  A pool on
    a CUDA device goes through kernel K5, one launch per chunk, in order
    on the current stream; a pool on the CPU through
    :func:`gemm_scatter_block_ref`."""
    check_pool(pool)
    check_variant(pool, d, None, [])
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_block_ref(pool, chunks, update_dtype, d=d)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    lib = _build.get_lib()
    stream = _build.stream_ptr(pool.device)
    for c in chunks:
        err = lib.pastix_block_gemm_scatter(
            pool.data_ptr(), c.row_dst.data_ptr(), c.ent_ptr.data_ptr(),
            c.ent_a.data_ptr(), c.ent_b.data_ptr(),
            None if d is None else d.data_ptr(), c.ent_k.data_ptr(),
            c.nrow, pool.shape[1], int(bf16), stream,
        )
        _build.check(err, "gemm_scatter_block")
        gemm_scatter_block.launches += 1
    return pool


gemm_scatter_block.launches = 0  # K5 launches (one per chunk)
gemm_scatter_block.twin_launches = 0  # calls of the plain twin


def gemm_scatter_block_ref(pool: torch.Tensor, chunks, update_dtype=None,
                           *, d=None):
    """Plain PyTorch twin of :func:`gemm_scatter_block`, on any device:
    each chunk's cross products as a pair list (a scaled, then rounded
    once), chunks in order."""
    check_pool(pool)
    check_variant(pool, d, None, [])
    is_bf16(update_dtype)
    gemm_scatter_block.twin_launches += 1
    for c in chunks:
        a, b, dst, k = c.pairs()
        pairs_ref(pool, pool, pool, a, b, dst, update_dtype, d=d, pair_k=k)
    return pool
