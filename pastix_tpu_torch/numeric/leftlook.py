"""Left-looking E2 update: host schedule and kernel K1.

``build_ll_schedule`` / ``_ll_chunks`` and ``regroup_left`` are verbatim
copies of the host builders in ``pastix_tpu/numeric/leftlook.py`` (that
module imports JAX); ``tests/test_torch_schedules.py`` holds their tables
equal to the reference's.  The chunks keep the reference's TPU fields
(flags, rd, endw/endt: its DMA bookkeeping), which the port ignores:
:func:`ll_plan` derives the per-segment tables the CUDA kernel reads,
once, at analysis time.

``gemm_scatter_ll`` launches the hand-written CUDA kernel
(``csrc/ll_gemm_scatter.cu``: bf16 products on the tensor cores, fp32
ones on the CUDA cores) for a pool on a CUDA device and its plain twin
``gemm_scatter_ll_ref`` for a pool on the CPU, in the plain, the scaled
(``d``, LDLᵗ) and the cross-pool (``src_pool``, LU) variants.
``launch_ll`` makes K1's launches, for ``gemm_scatter_ll`` and for K6
(``slab.gemm_scatter_slab``, a window height a pair).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.kernels import (
    check_pool, check_variant, is_bf16, round_to,
)

# segment flags of the reference's step tables
# (pastix_tpu/numeric/pallas_kernels.py)
_F_FIRST, _F_LAST, _F_WRWAIT, _F_PAR = 1, 2, 4, 8
# pairs per batched product of the plain twin (bounds its transients)
_REF_BATCH = 4096
# K1's pieces: a chunk's dst segments are cut into pieces of at most
# max(_PIECE_MIN, n_pairs / ctas) pairs, one CTA each, so that a segment
# far longer than the others (the dense tail's top tiles) does not hold
# its chunk; ctas is what the card holds at once (piece_ctas)
_PIECE_MIN = 8


def build_ll_schedule(
    ga,
    gb,
    gd,
    gk=None,
    group: int = 4,
    cap: int = 256,
    chunk_max: int = 16384,
    mode: str = "auto",
    full_reuse_min: float = 3.0,
    rb=None,
    T: int = 128,
):
    """Dst-sorted, segment-padded-to-G chunked schedule for the LL kernel.

    Returns a list of per-chunk dicts.  ``mode``:
      "bcache": only b tiles cached (a via per-pair DMA from the pool)
      "full"  : both operands cached (a-reuse must make the cap worthwhile)
      "auto"  : "full" iff the list's a-side reuse >= ``full_reuse_min``
    ``cap``: max unique cached tiles per chunk (scoped-VMEM budget).

    ``rb``: optional (row_lo, row_hi) per-pool-tile scalar row supports
    (layout.row_lo/row_hi — the splitpart IPARM_MIN_BLOCKSIZE analog,
    reference ``src/blend/src/splitpart.c``).  A pair's contribution has
    nonzero rows only inside its *a* tile's support, so pairs are
    classed by quantized support height H in {T/4, T/2, 3T/4, T}
    (start rounded down to the 8-sublane grid) and chunks are built
    class-uniform: each chunk's dots run at static (H, T) x (T, T)
    shape — device flops drop by the padding the full-tile schedule
    would execute.  ``rb=None`` keeps full-height tiles.
    """
    ga = np.asarray(ga, np.int64)
    gb = np.asarray(gb, np.int64)
    gd = np.asarray(gd, np.int64)
    ng = gd.size
    if ng == 0:
        return []
    if gk is not None:
        gk = np.asarray(gk, np.int64)
    if mode == "auto":
        r_a = ng / max(1, np.unique(ga).size)
        mode = "full" if r_a >= full_reuse_min else "bcache"
    if rb is not None:
        row_lo, row_hi = rb
        rl = np.asarray(row_lo, np.int64)[ga]
        rh = np.asarray(row_hi, np.int64)[ga]
        rl = (rl // 8) * 8
        q = T // 4
        # row_hi is INCLUSIVE (layout.py): support height is rh+1-rl
        H = np.clip(-(-(rh + 1 - rl) // q), 1, 4) * q
        rl = np.minimum(rl, T - H)
        out = []
        for h in (q, 2 * q, 3 * q, 4 * q):
            m = H == h
            if not m.any():
                continue
            out.extend(_ll_chunks(
                ga[m], gb[m], gd[m],
                gk[m] if gk is not None else None,
                rl[m], int(h), group, cap, chunk_max, mode, T,
            ))
        return out
    return _ll_chunks(
        ga, gb, gd, gk, np.zeros(ng, np.int64), T, group, cap,
        chunk_max, mode, T,
    )


def _ll_chunks(ga, gb, gd, gk, rl, H, group, cap, chunk_max, mode, T):
    """Core chunker for one row-height class (H == T: full tiles)."""
    ng = gd.size
    order = np.argsort(gd, kind="stable")
    ga, gb, gd, rl = ga[order], gb[order], gd[order], rl[order]
    if gk is not None:
        gk = gk[order]

    # --- segment-pad to a multiple of group -----------------------------
    G = int(group)
    first = np.empty(ng, np.int64)
    first[0] = 1
    first[1:] = gd[1:] != gd[:-1]
    seg = np.cumsum(first) - 1
    slen = np.bincount(seg)
    plen = (-(-slen // G)) * G
    npad_tot = int(plen.sum())
    # scatter real pairs into the padded arrays (null = -1)
    starts = np.concatenate([[0], np.cumsum(plen)[:-1]])
    pos_in_seg = np.arange(ng) - np.concatenate([[0], np.cumsum(slen)[:-1]])[seg]
    src_pos = starts[seg] + pos_in_seg
    pga = np.full(npad_tot, -1, np.int64)
    pgb = np.full(npad_tot, -1, np.int64)
    pga[src_pos] = ga
    pgb[src_pos] = gb
    prl = np.zeros(npad_tot, np.int64)
    prl[src_pos] = rl
    if gk is not None:
        pgk = np.zeros(npad_tot, np.int64)
        pgk[src_pos] = gk
    seg_dst_all = gd[np.flatnonzero(first)]
    step_dst = np.repeat(seg_dst_all, plen // G)
    step_seg = np.repeat(np.arange(slen.size), plen // G)
    nsteps_total = npad_tot // G

    # --- adaptive chunking: unique cached tiles <= cap ------------------
    out = []
    lo = 0
    ch_steps_max = max(1, chunk_max // G)
    while lo < nsteps_total:
        hi = min(lo + ch_steps_max, nsteps_total)
        while True:
            cgb = pgb[lo * G: hi * G]
            cga = pga[lo * G: hi * G]
            if mode == "full":
                cand = np.concatenate([cga[cga >= 0], cgb[cgb >= 0]])
            else:
                cand = cgb[cgb >= 0]
            u = np.unique(cand)
            if u.size + 1 <= cap or hi - lo <= 1:
                break
            # shrink proportionally (cheap, converges in a few rounds)
            hi = lo + max(1, int((hi - lo) * (cap - 1) / u.size))
        ns = hi - lo
        ZS = u.size  # zero slot: cache rows >= u.size stay zero
        gb_v = np.full(ns * G, ZS, np.int32)
        m = cgb >= 0
        gb_v[m] = np.searchsorted(u, cgb[m])
        if mode == "full":
            ga_v = np.full(ns * G, ZS, np.int32)
            ga_v[m] = np.searchsorted(u, cga[m])
        else:
            # per-pair DMA needs a safe pool index for null pairs: reuse
            # the chunk's first real a tile (its dot against the zero
            # slot contributes exactly 0)
            safe = cga[m][0] if m.any() else 0
            ga_p = np.where(cga >= 0, cga, safe).astype(np.int32)
        # per-step segment flags (same machinery as the pair kernel,
        # one decode per G pairs)
        cseg = step_seg[lo:hi]
        cdst = step_dst[lo:hi]
        sf = np.empty(ns, np.int32)
        sf[0] = 1
        sf[1:] = cseg[1:] != cseg[:-1]
        sl = np.empty(ns, np.int32)
        sl[-1] = 1
        sl[:-1] = cseg[1:] != cseg[:-1]
        lseg = np.cumsum(sf) - 1
        nseg = int(lseg[-1]) + 1
        par = (lseg & 1).astype(np.int32)
        firsts = np.flatnonzero(sf)
        seg_dst = cdst[firsts]
        rd = np.full(ns, -1, np.int32)
        rd[firsts[:-1]] = seg_dst[1:]
        wr_wait = np.zeros(ns, np.int32)
        wr_wait[firsts[1:-1]] = 1
        flags = (sf * _F_FIRST + sl * _F_LAST + wr_wait * _F_WRWAIT
                 + par * _F_PAR).astype(np.int32)
        endw = np.zeros(2, np.int32)
        endt = np.zeros(2, np.int32)
        p_last = (nseg - 1) & 1
        endw[p_last] = 1
        endt[p_last] = seg_dst[-1]
        if nseg >= 2:
            endw[1 - p_last] = 1
            endt[1 - p_last] = seg_dst[-2]
        t = {
            "mode": mode, "group": G, "nsteps": ns,
            "gb_v": gb_v, "gd": cdst.astype(np.int32),
            "flags": flags, "rd": rd, "endw": endw, "endt": endt,
            "cu": u.astype(np.int64),
            # quantized cache height: dedupes kernel compiles across chunks
            "CT": int(-(-(u.size + 1) // 64) * 64),
            "n_real": int(m.sum()),
            "H": int(H), "T": int(T),
            "rl": prl[lo * G: hi * G].astype(np.int32),
        }
        if mode == "full":
            t["ga_v"] = ga_v
        else:
            t["ga"] = ga_p
        if gk is not None:
            t["gk"] = np.where(
                pga[lo * G: hi * G] >= 0, pgk[lo * G: hi * G], 0
            ).astype(np.int32)
        out.append(t)
        lo = hi
    return out


def regroup_left(levels, blk_col, tail_s=None, unrolled=None):
    """Classify every update pair by its TARGET and emit the LL plan.

    Returns (reduced_levels, incoming, tail) where

      * reduced_levels[i] — LevelTables with the outgoing gemm tables cut
        to the RESIDUE (targets in scanned levels / Schur columns, which
        stay right-looking at their source);
      * incoming[i] — (ga, gb, gd, gk, nd) concatenated update lists to
        apply at level i (empty arrays when none) — only for unrolled i;
      * tail — (ga, gb, gd, gk) targeting columns >= ``tail_s`` (the
        dense-tail pre-pass), or None.

    ``unrolled``: set of level indices that will run as unrolled pallas
    programs (scan bodies cannot host per-level static schedules).
    """
    import dataclasses as _dc

    nlev = len(levels)
    if unrolled is None:
        unrolled = set(range(nlev))
    # target column -> level index (in THIS list; -1 = unfactored/Schur)
    ncol = int(blk_col.max()) + 1 if len(blk_col) else 0
    col2li = np.full(ncol, -1, np.int64)
    for li, lv in enumerate(levels):
        col2li[lv.cols] = li

    inc = [[] for _ in range(nlev)]
    tail = [] if tail_s is not None else None
    reduced = []
    for li, lv in enumerate(levels):
        gd = lv.gemm_d
        if gd.size == 0:
            reduced.append(lv)
            continue
        tcol = blk_col[gd]
        is_tail = (
            tcol >= tail_s if tail_s is not None
            else np.zeros(gd.size, bool)
        )
        tli = col2li[tcol]
        to_inc = ~is_tail & (tli >= 0) & np.isin(
            tli, np.fromiter(unrolled, np.int64, len(unrolled))
        )
        resid = ~is_tail & ~to_inc
        if tail is not None and is_tail.any():
            tail.append((lv.gemm_a[is_tail], lv.gemm_b[is_tail],
                         gd[is_tail], lv.gemm_k[is_tail]))
        if to_inc.any():
            for t in np.unique(tli[to_inc]):
                m = to_inc & (tli == t)
                inc[int(t)].append(
                    (lv.gemm_a[m], lv.gemm_b[m], gd[m], lv.gemm_k[m],
                     lv.gemm_nondiag[m])
                )
        reduced.append(_dc.replace(
            lv,
            gemm_a=lv.gemm_a[resid], gemm_b=lv.gemm_b[resid],
            gemm_d=gd[resid], gemm_k=lv.gemm_k[resid],
            gemm_nondiag=lv.gemm_nondiag[resid],
        ))

    def _cat(parts, nfields):
        if not parts:
            return tuple(
                np.empty(0, np.int32 if f < 4 else bool)
                for f in range(nfields)
            )
        return tuple(
            np.concatenate([p[f] for p in parts]) for f in range(nfields)
        )

    incoming = [_cat(p, 5) for p in inc]
    tail_out = _cat(tail, 4) if tail is not None else None
    return reduced, incoming, tail_out


@dataclasses.dataclass
class LLChunk:
    """One chunk of an LL schedule as the kernel reads it: the real pairs
    (null pads dropped) grouped into dst segments.  Index tensors are
    int64 on the pool's device (flat pool offsets overflow int32 at the
    1M flagship, ``pastix_tpu/numeric/factorize.py`` ``build_coefinit_fn``)."""

    mode: str  # "bcache": a read from the pool; "full": a from the cache
    H: int  # row-window height of every pair (T: full tiles)
    n_pairs: int
    cu: torch.Tensor  # [nu] pool index of each cache slot
    seg_ptr: torch.Tensor  # [nseg + 1] pair offsets of the dst segments
    seg_dst: torch.Tensor  # [nseg] pool index of each segment's dst tile
    pair_a: torch.Tensor  # [n] pool index of a
    pair_b: torch.Tensor  # [n] pool index of b
    a_slot: torch.Tensor  # [n] cache slot of a ("full" mode; else pair_a)
    b_slot: torch.Tensor  # [n] cache slot of b
    rl: torch.Tensor  # [n] first row of each pair's window
    piece_ptr: torch.Tensor  # [npiece + 1] pair offsets of the pieces
    piece_seg: torch.Tensor  # [npiece] the segment of each piece
    seg_piece_ptr: torch.Tensor  # [nseg + 1] piece offsets per segment
    piece_slot: torch.Tensor  # [npiece] partial-sum slot, -1: not cut
    nslot: int  # pieces of segments cut in more than one
    pair_k: torch.Tensor = None  # [n] source column of each pair (LDLᵗ d)

    @property
    def nseg(self) -> int:
        return self.seg_dst.numel()

    @property
    def npiece(self) -> int:
        return self.piece_seg.numel()


def piece_ctas(device) -> int:
    """The CTAs K1 and K3 run at once on ``device``'s card: two on each SM
    (the occupancy of their tensor-core body, ``csrc/seg_mma.cuh``); 0 on
    the CPU, where no kernel reads the pieces."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def piece_len(n_pairs, ctas) -> int:
    """Pairs a piece holds at most: max(_PIECE_MIN, ceil(n_pairs /
    ctas)), or _PIECE_MIN for ``ctas`` 0."""
    return max(_PIECE_MIN, -(-n_pairs // ctas)) if ctas else _PIECE_MIN


def ll_pieces(seg_ptr, n_pairs, ctas, cuts=None):
    """(piece_ptr, piece_seg, seg_piece_ptr, piece_slot, nslot) of one
    chunk: each dst segment cut into consecutive pieces of at most
    :func:`piece_len` pairs; the pieces of a segment cut in more than one
    are numbered 0.. in order (their partial sums' slots), the others get
    -1.  ``cuts`` (sorted pair offsets, every segment's start among them;
    K12's step starts) are the only places a piece may start: a piece
    then starts at the first cut at or past each multiple of the piece
    length into its segment, and may run over it by less than a step."""
    L = piece_len(n_pairs, ctas)
    seg_ptr = np.asarray(seg_ptr, np.int64)
    cuts = (np.arange(n_pairs, dtype=np.int64) if cuts is None
            else np.asarray(cuts, np.int64))
    seg = np.searchsorted(seg_ptr, cuts, side="right") - 1
    k = (cuts - seg_ptr[seg]) // L
    new = np.ones(cuts.size, bool)
    new[1:] = (seg[1:] != seg[:-1]) | (k[1:] != k[:-1])
    piece_seg = seg[new]
    npc = np.bincount(piece_seg, minlength=seg_ptr.size - 1)
    cut = npc[piece_seg] > 1
    slot = np.full(piece_seg.size, -1, np.int64)
    slot[cut] = np.arange(int(cut.sum()))
    return (np.r_[cuts[new], n_pairs], piece_seg, np.r_[0, np.cumsum(npc)],
            slot, int(cut.sum()))


def piece_buffers(plan, T, device):
    """(scratch, count) for a launch over ``plan``'s chunks of pieces: the
    partial sums of cut segments (the most slots of a chunk, T x T fp32
    each) and one arrival counter per segment and column block, zero
    (the kernel leaves them zero)."""
    scratch = torch.empty(max((c.nslot for c in plan), default=0) * T * T,
                          dtype=torch.float32, device=device)
    count = torch.zeros(2 * max((c.nseg for c in plan), default=0),
                        dtype=torch.int32, device=device)
    return scratch, count


def ll_plan(schedule, device) -> list:
    """Kernel tables (:class:`LLChunk`) of a :func:`build_ll_schedule`
    result, uploaded to ``device``, the pieces cut for its card."""
    ctas = piece_ctas(device)
    out = []
    for t in schedule:
        cu = np.asarray(t["cu"], np.int64)
        nu = cu.size
        gb_v = np.asarray(t["gb_v"], np.int64)
        real = gb_v < nu  # null pads read the zero slot nu
        if not real.any():
            continue
        dst = np.repeat(np.asarray(t["gd"], np.int64), t["group"])[real]
        b_slot = gb_v[real]
        if t["mode"] == "full":
            a_slot = np.asarray(t["ga_v"], np.int64)[real]
            pair_a = cu[a_slot]
        else:
            pair_a = np.asarray(t["ga"], np.int64)[real]
            a_slot = pair_a
        starts = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]])
        seg_ptr = np.r_[starts, dst.size]
        piece_ptr, piece_seg, seg_piece_ptr, slot, nslot = ll_pieces(
            seg_ptr, dst.size, ctas)
        tens = lambda a: torch.as_tensor(
            np.ascontiguousarray(a, np.int64), device=device
        )
        out.append(LLChunk(
            mode=t["mode"], H=int(t["H"]),
            n_pairs=int(dst.size),
            cu=tens(cu),
            seg_ptr=tens(seg_ptr),
            seg_dst=tens(dst[starts]),
            pair_a=tens(pair_a), pair_b=tens(cu[b_slot]),
            a_slot=tens(a_slot), b_slot=tens(b_slot),
            rl=tens(np.asarray(t["rl"], np.int64)[real]),
            piece_ptr=tens(piece_ptr), piece_seg=tens(piece_seg),
            seg_piece_ptr=tens(seg_piece_ptr), piece_slot=tens(slot),
            nslot=nslot,
            pair_k=(tens(np.asarray(t["gk"], np.int64)[real])
                    if "gk" in t else None),
        ))
    return out


def gemm_scatter_ll(pool: torch.Tensor, plan, update_dtype=torch.bfloat16, *,
                    d=None, src_pool=None):
    """pool[dst] -= op(a diag(d[gk])) @ op(b)^T over every chunk of
    ``plan``, in place.

    ``op`` rounds to ``update_dtype`` (bf16, or None/fp32 for fp32
    operands), after the scaling; products accumulate in fp32.  a is read
    from ``pool``; b from ``src_pool`` when given (the LU cross-pool
    update), else from ``pool``.  ``d`` (nbc, T) scales a's columns by the
    pivots of the pair's source column (LDLᵗ; the plan needs ``gk``).
    The pool is updated in place where the reference donated it to its
    kernel (``input_output_aliases``).  A pool on a CUDA device goes
    through the kernel K1, one launch per chunk, in order on the current
    stream; a pool on the CPU through :func:`gemm_scatter_ll_ref`.

    Unlike the reference, a is never read from the per-chunk operand
    cache when ``src_pool`` or ``d`` is given: the reference fills that
    cache from ``src_pool``, so its ``"full"`` mode would read a (an L
    tile) from the U pool, and it would round a before the scaling."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_ll_ref(pool, plan, update_dtype, d=d,
                                   src_pool=src_pool)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    T = pool.shape[1]
    src = pool if src_pool is None else src_pool
    a_cached = src_pool is None and d is None
    if bf16:
        # per-chunk operand cache, cast once: the reference's Xc
        nu_max = max((c.cu.numel() for c in plan), default=0)
        cache = torch.empty((nu_max, T, T), dtype=torch.bfloat16,
                            device=pool.device)

    def operands(c):
        if not bf16:
            return 0, pool, src, c.pair_a, c.pair_b
        # operand tiles are panels of earlier columns, which no chunk of
        # this list writes: gathering before the launch is exact
        cache[: c.cu.numel()].copy_(src.index_select(0, c.cu))
        if c.mode == "full" and a_cached:
            return 2, cache, cache, c.a_slot, c.b_slot
        return 1, pool, cache, c.pair_a, c.b_slot

    gemm_scatter_ll.half_launches += launch_ll(pool, plan, operands, bf16,
                                               d, gemm_scatter_ll)
    return pool


def launch_ll(pool, chunks, operands, bf16, d, wrapper) -> int:
    """K1's launches over ``chunks`` (:class:`LLChunk`, or K6's
    ``slab.SlabChunk``), one a chunk, in order on the current stream, each
    counted in ``wrapper.launches``; returns how many ran on 128 x 64
    halves.  ``operands(c)`` gives chunk c's (variant, Xa, Xb, pos_a,
    pos_b), gathering them first where the variant reads a cache: variant
    0 fp32 updates (a from the pool, b from the pool or the LU source
    pool); with bf16 updates 1 (a fp32 from the pool, b bf16 from the
    cache), 2 (both from the cache) or 3 (both fp32 from the pool).  The
    window: one height a launch, ``c.H`` with each pair's first row in
    ``c.rl`` (K1), or one a pair, ``c.pair_h`` and ``c.pair_rl`` (K6).
    With bf16 updates a CTA takes a piece and the whole dst tile, or a
    128 x 64 half at T = 128 when both operands are fp32 or the chunk has
    fewer pieces than the card has SMs (as ``pipelined.launch_chunks``
    chooses)."""
    lib = _build.get_lib()
    stream = _build.stream_ptr(pool.device)
    T = pool.shape[1]
    if bf16:
        sms = piece_ctas(pool.device) // 2
        scratch, count = piece_buffers(chunks, T, pool.device)
    halves = 0
    for c in chunks:
        variant, Xa, Xb, pos_a, pos_b = operands(c)
        pair_h = getattr(c, "pair_h", None)
        rl, H = (c.rl, c.H) if pair_h is None else (c.pair_rl, T)
        half = bf16 and T == 128 and (variant == 3 or c.npiece < sms)
        err = lib.pastix_ll_gemm_scatter(
            pool.data_ptr(), Xa.data_ptr(), Xb.data_ptr(),
            c.seg_ptr.data_ptr(), c.seg_dst.data_ptr(), pos_a.data_ptr(),
            pos_b.data_ptr(), rl.data_ptr(),
            None if pair_h is None else pair_h.data_ptr(),
            None if d is None else d.data_ptr(),
            None if d is None else c.pair_k.data_ptr(),
            c.piece_ptr.data_ptr(), c.piece_seg.data_ptr(),
            c.seg_piece_ptr.data_ptr(), c.piece_slot.data_ptr(),
            scratch.data_ptr() if bf16 else None,
            count.data_ptr() if bf16 else None,
            c.nseg, c.npiece, T, H, variant, T // 2 if half else T, stream,
        )
        _build.check(err, wrapper.__name__)
        wrapper.launches += 1
        halves += half
    return halves


gemm_scatter_ll.launches = 0  # K1 launches (one per chunk)
gemm_scatter_ll.half_launches = 0  # of those, on 128 x 64 halves
gemm_scatter_ll.twin_launches = 0  # calls of the plain twin


def gemm_scatter_ll_ref(pool: torch.Tensor, plan, update_dtype=torch.bfloat16,
                        *, d=None, src_pool=None):
    """Plain PyTorch twin of :func:`gemm_scatter_ll`, on any device.

    Operands are scaled, rounded to the update dtype and multiplied in
    fp32 (a bf16 ``bmm`` would round its output on CUDA); a pair's rows
    outside its window [rl, rl + H) are zeroed.  Differs from the kernel
    only in summation order."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    is_bf16(update_dtype)
    gemm_scatter_ll.twin_launches += 1
    T = pool.shape[1]
    src = pool if src_pool is None else src_pool
    rows = torch.arange(T, device=pool.device)
    for c in plan:
        dst = torch.repeat_interleave(
            c.seg_dst, c.seg_ptr[1:] - c.seg_ptr[:-1]
        )
        for lo in range(0, c.n_pairs, _REF_BATCH):
            sl = slice(lo, lo + _REF_BATCH)
            a = pool[c.pair_a[sl]]
            if d is not None:
                a = a * d[c.pair_k[sl]][:, None, :]
            a = round_to(a, update_dtype)
            if c.H < T:
                rl = c.rl[sl, None]
                win = (rows[None, :] >= rl) & (rows[None, :] < rl + c.H)
                a = a * win[:, :, None]
            b = round_to(src[c.pair_b[sl]], update_dtype)
            pool.index_add_(0, dst[sl], torch.bmm(a, b.transpose(1, 2)),
                            alpha=-1.0)
    return pool
