"""Right-looking E2 update: host schedule and kernel K3.

``build_pipeline_schedule`` is a verbatim copy of the host builder in
``pastix_tpu/numeric/pallas_kernels.py`` (that module imports JAX);
``tests/test_torch_pipelined.py`` holds its tables equal to the
reference's.  Its flags, ``rd`` and ``endw``/``endt`` drive the TPU
kernel's DMA double-buffering and are ignored here: :func:`pipeline_plan`
drops the invalid pad pairs and cuts each chunk into dst segments, once,
at analysis time.

``gemm_scatter_pipelined`` launches the hand-written CUDA kernel
(``csrc/pipelined_gemm_scatter.cu``) for a pool on a CUDA device and its
plain twin ``gemm_scatter_pipelined_ref`` for a pool on the CPU, in the
plain, the scaled (``d``, LDLᵗ) and the cross-pool (``src_pool``, LU)
variants, with operands read from the pools or from operand arrays: the
panel TRSM's bf16 stream (``xab``), per-chunk gathers of the distinct
operand tiles (``compact``) or stacked (a, b) pairs (``ab_pack``).  With
bf16 updates the kernel runs K1's tensor-core body over pieces of the dst
segments, which :func:`pipeline_plan` cuts with
``leftlook.ll_pieces``; fp32 updates keep a CTA per segment.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.kernels import (
    check_pool, check_variant, is_bf16, round_to,
)
from pastix_tpu_torch.numeric.leftlook import (
    ll_pieces, piece_buffers, piece_ctas,
)

# pairs per batched product of the plain twin (bounds its transients)
_REF_BATCH = 4096

_F_FIRST, _F_LAST, _F_WRWAIT, _F_PAR, _F_VALID = 1, 2, 4, 8, 16


def build_pipeline_schedule(ga, gb, gd, gk=None, chunk: int = 8192,
                            group: int = 1, ext_tiles=None):
    """Sort triples by dst and emit per-chunk static schedules.

    Returns a list of dicts with int32 arrays (ga, gb, gd, flags, rd) of
    one chunk's length plus the 2-element end-drain tables (endw, endt).
    ``group``: pairs per grid step in the kernel — chunks are padded to a
    multiple with invalid pairs (flag bit _F_VALID clear, predicated off).
    ``ext_tiles``: sorted pool indices of an externally provided compact
    operand array (the TRSM-produced bf16 panel stream): ga_c/gb_c are
    then positions into it instead of per-chunk uniq gathers.
    """
    order = np.argsort(gd, kind="stable")
    ga = np.asarray(ga, np.int32)[order]
    gb = np.asarray(gb, np.int32)[order]
    gd = np.asarray(gd, np.int32)[order]
    # the pipeline prefetches a/b one step ahead of the dst write-backs:
    # sources and destinations must be disjoint within one level (they are,
    # by the level-set schedule — updates flow strictly to later levels)
    assert not np.intersect1d(gd, np.concatenate([ga, gb])).size, (
        "E2 dst tiles overlap operand tiles within a level"
    )
    if gk is not None:
        gk = np.asarray(gk, np.int32)[order]
    ng = gd.size
    out = []
    for lo in range(0, ng, chunk):
        hi = min(lo + chunk, ng)
        d = gd[lo:hi]
        n = hi - lo
        first = np.empty(n, np.int32)
        first[0] = 1
        first[1:] = d[1:] != d[:-1]
        last = np.empty(n, np.int32)
        last[-1] = 1
        last[:-1] = d[1:] != d[:-1]
        seg = np.cumsum(first) - 1  # segment id per step
        nseg = int(seg[-1]) + 1
        par = seg & 1
        # rd[i]: at the first step of segment s, the dst tile of segment
        # s+1 (sentinel -1 when none; also carries segment 0's own dst at
        # step 0 via the kernel's warm-up special case)
        firsts = np.flatnonzero(first)
        seg_dst = d[firsts]
        rd = np.full(n, -1, np.int32)
        rd[firsts[:-1]] = seg_dst[1:]
        # wr_wait: the read into slot (s+1)%2 must complete segment s-1's
        # pending write on that slot first (its dst is gd[i-1])
        # set at first steps of segments 1..nseg-2: a previous segment
        # exists (its write owns slot (s+1)%2) AND a next read will start
        wr_wait = np.zeros(n, np.int32)
        wr_wait[firsts[1:-1]] = 1
        flags = (
            first * _F_FIRST
            + last * _F_LAST
            + wr_wait * _F_WRWAIT
            + par * _F_PAR
            + _F_VALID
        ).astype(np.int32)
        # end drain: writes of the last two segments are never waited by a
        # later read — wait them (per acc slot) at the final grid step
        endw = np.zeros(2, np.int32)
        endt = np.zeros(2, np.int32)
        p_last = (nseg - 1) & 1
        endw[p_last] = 1
        endt[p_last] = seg_dst[-1]
        if nseg >= 2:
            endw[1 - p_last] = 1
            endt[1 - p_last] = seg_dst[-2]
        t = {
            "ga": ga[lo:hi], "gb": gb[lo:hi], "gd": d,
            "flags": flags, "rd": rd, "endw": endw, "endt": endt,
        }
        if gk is not None:
            t["gk"] = gk[lo:hi]
        gpad = (-n) % group
        if gpad:
            # invalid tail pairs: safe reads (last real tiles), no flags
            # set except the closed segment's parity, predicated off
            for k in ("ga", "gb", "gd", "gk"):
                if k in t:
                    t[k] = np.concatenate(
                        [t[k], np.repeat(t[k][-1:], gpad)]
                    )
            t["flags"] = np.concatenate([
                t["flags"],
                np.full(gpad, int(par[-1]) * _F_PAR, np.int32),
            ])
            t["rd"] = np.concatenate([t["rd"], np.full(gpad, -1, np.int32)])
        t["group"] = group
        if ext_tiles is not None:
            # positions into the TRSM-produced panel stream (both E2
            # operands are post-TRSM panel tiles of the firing level)
            ext = np.asarray(ext_tiles)
            ga_c = np.searchsorted(ext, t["ga"])
            gb_c = np.searchsorted(ext, t["gb"])
            assert (ext[np.minimum(ga_c, ext.size - 1)] == t["ga"]).all()
            assert (ext[np.minimum(gb_c, ext.size - 1)] == t["gb"]).all()
            t["ga_c"] = ga_c.astype(np.int32)
            t["gb_c"] = gb_c.astype(np.int32)
        else:
            # compact operand tables: a/b are gathered into per-chunk dense
            # arrays OUTSIDE the kernel (each tile ONCE — real plans reuse
            # a tile across ~10+ pairs) so the kernel reads small
            # sequential arrays (cast to the update dtype: half the bytes
            # per pair for bf16) and the pool is passed exactly once
            t["uniq_a"] = np.unique(t["ga"])
            t["uniq_b"] = np.unique(t["gb"])
            t["ga_c"] = np.searchsorted(t["uniq_a"], t["ga"]).astype(
                np.int32
            )
            t["gb_c"] = np.searchsorted(t["uniq_b"], t["gb"]).astype(
                np.int32
            )
        out.append(t)
    return out


@dataclasses.dataclass
class PipeChunk:
    """One chunk of a pipeline schedule as the kernel reads it: the valid
    pairs, sorted by dst, grouped into dst segments.  int64 tensors on the
    pool's device."""

    n_pairs: int
    seg_ptr: torch.Tensor  # [nseg + 1] pair offsets of the dst segments
    seg_dst: torch.Tensor  # [nseg] pool index of each segment's dst tile
    pair_a: torch.Tensor  # [n] pool index of a
    pair_b: torch.Tensor  # [n] pool index of b
    pair_k: torch.Tensor = None  # [n] source column of each pair (LDLᵗ d)
    # positions of a and b in the panel TRSM's operand stream (a schedule
    # built with ext_tiles), else None
    ext_a: torch.Tensor = None
    ext_b: torch.Tensor = None
    # the compact form: the chunk's distinct a and b tiles (sorted pool
    # indices) and each pair's positions among them
    uniq_a: torch.Tensor = None
    uniq_b: torch.Tensor = None
    cpos_a: torch.Tensor = None
    cpos_b: torch.Tensor = None
    # the bf16 kernel's pieces (leftlook.ll_pieces): piece p runs the
    # pairs piece_ptr[p]..piece_ptr[p+1] of segment piece_seg[p]; segment
    # s has the pieces seg_piece_ptr[s]..seg_piece_ptr[s+1]; piece_slot
    # numbers the pieces of segments cut in more than one (else -1)
    piece_ptr: torch.Tensor = None
    piece_seg: torch.Tensor = None
    seg_piece_ptr: torch.Tensor = None
    piece_slot: torch.Tensor = None
    nslot: int = 0

    @property
    def nseg(self) -> int:
        return self.seg_dst.numel()

    @property
    def npiece(self) -> int:
        return self.piece_seg.numel()

    def pairs(self):
        """(a, b, dst, k) of every pair, in segment order: pool indices
        of a, b and the dst tile, and the source column (None without
        ``pair_k``)."""
        return (self.pair_a, self.pair_b, torch.repeat_interleave(
            self.seg_dst, self.seg_ptr.diff()), self.pair_k)


def piece_fields(seg_ptr, n_pairs, ctas, tens, cuts=None) -> dict:
    """The piece fields of a chunk (:class:`PipeChunk`, and K11's and
    K12's ``cache.CacheChunk``) with dst segments ``seg_ptr`` (host
    array): its segments cut by ``leftlook.ll_pieces`` for ``ctas`` CTAs
    at once (K12: at its step starts ``cuts`` only), each table made a
    device tensor by ``tens``."""
    piece_ptr, piece_seg, seg_piece_ptr, slot, nslot = ll_pieces(
        seg_ptr, n_pairs, ctas, cuts)
    return {"piece_ptr": tens(piece_ptr), "piece_seg": tens(piece_seg),
            "seg_piece_ptr": tens(seg_piece_ptr), "piece_slot": tens(slot),
            "nslot": nslot}


def pipeline_plan(schedule, device, ctas=None) -> list:
    """Kernel tables (:class:`PipeChunk`) of a
    :func:`build_pipeline_schedule` result, uploaded to ``device``, the
    pieces cut for its card (``leftlook.piece_ctas``; ``ctas`` cuts them
    for another device's, tables kept on the host for it:
    :func:`move_chunks`).

    A dst segment cut by a chunk boundary lands in two chunks; the
    chunks run in order, so the second reads what the first wrote."""
    if ctas is None:
        ctas = piece_ctas(device)
    out = []
    for t in schedule:
        valid = (np.asarray(t["flags"]) & _F_VALID) != 0
        if not valid.any():
            continue
        gd = np.asarray(t["gd"], np.int64)[valid]
        ga = np.asarray(t["ga"], np.int64)[valid]
        gb = np.asarray(t["gb"], np.int64)[valid]
        starts = np.flatnonzero(np.r_[True, gd[1:] != gd[:-1]])
        tens = lambda a: torch.as_tensor(
            np.ascontiguousarray(a, np.int64), device=device
        )
        ext = "uniq_a" not in t
        # the schedule's compact tables (pads repeat the last real pair,
        # so its distinct tiles are the valid pairs' own)
        uniq_a = np.unique(ga) if ext else np.asarray(t["uniq_a"])
        uniq_b = np.unique(gb) if ext else np.asarray(t["uniq_b"])
        seg_ptr = np.r_[starts, gd.size]
        out.append(PipeChunk(
            n_pairs=int(gd.size),
            seg_ptr=tens(seg_ptr),
            seg_dst=tens(gd[starts]),
            pair_a=tens(ga),
            pair_b=tens(gb),
            pair_k=(tens(np.asarray(t["gk"])[valid]) if "gk" in t else None),
            ext_a=tens(np.asarray(t["ga_c"])[valid]) if ext else None,
            ext_b=tens(np.asarray(t["gb_c"])[valid]) if ext else None,
            uniq_a=tens(uniq_a),
            uniq_b=tens(uniq_b),
            cpos_a=tens(np.searchsorted(uniq_a, ga)),
            cpos_b=tens(np.searchsorted(uniq_b, gb)),
            **piece_fields(seg_ptr, gd.size, ctas, tens),
        ))
    return out


def operand_plan(ga, gb, gd, gk=None, device=None, chunk: int = 8192,
                 ctas=None) -> list:
    """K3's tables (:class:`PipeChunk`) for operand arrays apart from the
    destination: pair i reads ``Xa[ga[i]]`` and ``Xb[gb[i]]`` (``xab``)
    and updates row ``gd[i]`` of another tensor, as the mesh paths run it
    (``parallel/``: a halo buffer or a replicated pool as the operands, a
    touched-tile buffer as the destination).  The pairs, sorted by
    destination, go in chunks of ``chunk``, as
    :func:`build_pipeline_schedule` cuts them with ``ext_tiles``; its
    check that destinations and operands are other tiles of one pool
    does not apply to two tensors."""
    order = np.argsort(np.asarray(gd, np.int64), kind="stable")
    ga, gb, gd = (np.asarray(x, np.int32)[order] for x in (ga, gb, gd))
    gk = None if gk is None else np.asarray(gk, np.int32)[order]
    sched = []
    for lo in range(0, gd.size, chunk):
        sl = slice(lo, lo + chunk)
        t = {"ga": ga[sl], "gb": gb[sl], "gd": gd[sl], "ga_c": ga[sl],
             "gb_c": gb[sl],
             "flags": np.full(gd[sl].size, _F_VALID, np.int32)}
        if gk is not None:
            t["gk"] = gk[sl]
        sched.append(t)
    return pipeline_plan(sched, device, ctas=ctas)


def move_chunks(chunks, device) -> list:
    """The chunks (:class:`PipeChunk`) with their tables on ``device``."""
    return [dataclasses.replace(c, **{
        f.name: getattr(c, f.name).to(device)
        for f in dataclasses.fields(c)
        if isinstance(getattr(c, f.name), torch.Tensor)}) for c in chunks]


def _operands(pool, src, c, update_dtype, xab, compact, ab_pack):
    """(Xa, Xb, pos_a, pos_b): the tiles a and b of chunk ``c`` are
    ``Xa[pos_a]`` and ``Xb[pos_b]``.

    - plain: the pools, at the pairs' pool indices;
    - ``xab``: the panel TRSM's stream (a tensor, or the (Xa, Xb) pair of
      LU), at the positions of a schedule built with ``ext_tiles``;
    - ``compact``: the chunk's distinct a tiles of ``pool`` and b tiles of
      ``src``, gathered once and cast to the update dtype;
    - ``ab_pack``: every pair's (a, b) stacked and cast, a at 2i and b at
      2i + 1 (gathered from the chunk's distinct tiles, each cast once:
      the same array as casting every pair's fp32 tiles, with fewer
      bytes moved)."""
    cast = (lambda x: x.to(torch.bfloat16)) if is_bf16(update_dtype) else (
        lambda x: x)
    if xab is not None:
        if c.ext_a is None:
            raise ValueError("xab needs a plan built with ext_tiles")
        Xa, Xb = xab if isinstance(xab, (tuple, list)) else (xab, xab)
        return Xa, Xb, c.ext_a, c.ext_b
    if compact:
        return (cast(pool[c.uniq_a]), cast(src[c.uniq_b]), c.cpos_a,
                c.cpos_b)
    if ab_pack:
        C = torch.cat([cast(pool[c.uniq_a]), cast(src[c.uniq_b])])
        AB = C[torch.stack([c.cpos_a, c.cpos_b + c.uniq_a.numel()],
                           dim=1).view(-1)]
        pos = 2 * torch.arange(c.n_pairs, device=pool.device)
        return AB, AB, pos, pos + 1
    return pool, src, c.pair_a, c.pair_b


def _check_xab(pool, xab) -> None:
    for X in (xab if isinstance(xab, (tuple, list)) else (xab,)):
        if X.dtype not in (torch.float32, torch.bfloat16) or X.dim() != 3 or (
            X.shape[1:] != pool.shape[1:] or not X.is_contiguous()
            or X.device != pool.device
        ):
            raise ValueError(
                "xab must be contiguous (n, T, T) float32 or bfloat16 "
                f"tensors on the pool's device, got {X.dtype} "
                f"{tuple(X.shape)}"
            )


def gemm_scatter_pipelined(pool: torch.Tensor, plan, update_dtype=None, *,
                           d=None, src_pool=None, xab=None, compact=False,
                           ab_pack=False):
    """pool[gd] -= op(a diag(d[gk])) @ op(b)^T over every chunk of
    ``plan`` (:func:`pipeline_plan`), in place.

    a and b come from the pools (a from ``pool``, b from ``src_pool`` when
    given, the LU cross-pool update, else from ``pool``) or from operand
    arrays (:func:`_operands`): ``xab`` the panel TRSM's stream,
    ``compact`` per-chunk gathers of the distinct tiles, ``ab_pack``
    stacked pairs.  ``op`` rounds to ``update_dtype`` (bf16, or None/fp32
    for fp32 operands), after the scaling; an operand array of bf16 is
    rounded already, and a scaled one is rounded again, as the
    reference's kernel does.  Products accumulate in fp32.  ``d`` (nbc,
    T) scales a's columns by the pivots of the pair's source column
    (LDLᵗ; the plan needs ``gk``).  The reference splits fp32 operands
    into three bf16 passes (its TPU has no fp32 matrix unit); the kernel
    multiplies them in fp32 instead (ROADMAP.md C).  A pool on a CUDA
    device goes through the kernel K3, one launch per chunk, in order on
    the current stream (:func:`launch_chunks`); a pool on the CPU through
    :func:`gemm_scatter_pipelined_ref`."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    if xab is not None:
        _check_xab(pool, xab)
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_pipelined_ref(
            pool, plan, update_dtype, d=d, src_pool=src_pool, xab=xab,
            compact=compact, ab_pack=ab_pack)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    src = pool if src_pool is None else src_pool
    launch_chunks(pool, plan, lambda c: _operands(
        pool, src, c, update_dtype, xab, compact, ab_pack), bf16, d,
        gemm_scatter_pipelined)
    return pool


def launch_chunks(pool, chunks, operands, bf16, d, wrapper) -> None:
    """K3's launches over ``chunks`` (:class:`PipeChunk`, K10's
    ``fused.SegChunk`` or K11's ``cache.CacheChunk``), one a chunk, in
    order on the current stream, each counted in ``wrapper.launches``.
    ``operands(c)`` gives chunk c's (Xa, Xb, pos_a, pos_b): both of one
    dtype, or (K10's scaled bf16 updates) Xa fp32 and Xb bf16.  With
    bf16 updates a CTA takes a piece and the whole dst tile, or a
    128 x 64 half at T = 128 when both operands are fp32 (a stage of
    whole fp32 tiles would leave one CTA an SM) or the chunk has fewer
    pieces than the card has SMs."""
    lib = _build.get_lib()
    stream = _build.stream_ptr(pool.device)
    T = pool.shape[1]
    if bf16:
        sms = piece_ctas(pool.device) // 2
        scratch, count = piece_buffers(chunks, T, pool.device)
    for c in chunks:
        Xa, Xb, pos_a, pos_b = operands(c)
        if Xa.dtype != Xb.dtype and not (
                bf16 and d is not None and Xa.dtype == torch.float32):
            raise ValueError("the a and b operand arrays differ in dtype "
                             "(only a scaled fp32 a with a bf16 b may)")
        if Xa.data_ptr() % 16 or Xb.data_ptr() % 16:
            raise ValueError("the operand arrays must start on 16 bytes "
                             "(the kernel copies 16 bytes at a time)")
        f32 = Xa.dtype == Xb.dtype == torch.float32
        half = bf16 and T == 128 and (f32 or c.npiece < sms)
        err = lib.pastix_pipelined_gemm_scatter(
            pool.data_ptr(), Xa.data_ptr(), Xb.data_ptr(),
            c.seg_ptr.data_ptr(), c.seg_dst.data_ptr(), pos_a.data_ptr(),
            pos_b.data_ptr(), None if d is None else d.data_ptr(),
            None if d is None else c.pair_k.data_ptr(),
            c.piece_ptr.data_ptr(), c.piece_seg.data_ptr(),
            c.seg_piece_ptr.data_ptr(), c.piece_slot.data_ptr(),
            scratch.data_ptr() if bf16 else None,
            count.data_ptr() if bf16 else None,
            c.nseg, c.npiece, T, int(bf16), int(Xa.dtype == torch.bfloat16),
            int(Xb.dtype == torch.bfloat16), T // 2 if half else T, stream,
        )
        _build.check(err, wrapper.__name__)
        wrapper.launches += 1


gemm_scatter_pipelined.launches = 0  # K3 launches (one per chunk)
gemm_scatter_pipelined.twin_launches = 0  # calls of the plain twin


def gemm_scatter_pipelined_ref(pool: torch.Tensor, plan, update_dtype=None,
                               *, d=None, src_pool=None, xab=None,
                               compact=False, ab_pack=False):
    """Plain PyTorch twin of :func:`gemm_scatter_pipelined`, on any device.

    Operands are taken as the kernel takes them, scaled, rounded to the
    update dtype and multiplied in fp32, full tiles (B3 has no row
    bounds); differs from the kernel only in summation order.  Chunks
    run in order, as the kernel's launches do."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    if xab is not None:
        _check_xab(pool, xab)
    is_bf16(update_dtype)
    gemm_scatter_pipelined.twin_launches += 1
    src = pool if src_pool is None else src_pool
    for c in plan:
        Xa, Xb, pos_a, pos_b = _operands(pool, src, c, update_dtype, xab,
                                         compact, ab_pack)
        pairs_ref(pool, Xa, Xb, pos_a, pos_b, c.pairs()[2], update_dtype,
                  d=d, pair_k=c.pair_k)
    return pool


def pairs_ref(pool, Xa, Xb, pos_a, pos_b, dst, update_dtype, *, d=None,
              pair_k=None, rows=None):
    """pool[dst] -= op(Xa[pos_a] diag(d[pair_k])) @ op(Xb[pos_b])^T over a
    pair list, in order, in batches of _REF_BATCH pairs: the plain form
    of every right-looking E2 kernel.  ``rows`` (r0, ha) keeps only the
    rows [r0, r0 + ha) of each pair's a (the slab kernel's row bounds)."""
    for lo in range(0, dst.numel(), _REF_BATCH):
        sl = slice(lo, lo + _REF_BATCH)
        a = Xa[pos_a[sl]].to(torch.float32)
        if d is not None:
            a = a * d[pair_k[sl]][:, None, :]
        a = round_to(a, update_dtype)
        if rows is not None:
            r = torch.arange(a.shape[1], device=a.device)
            r0, ha = rows[0][sl, None], rows[1][sl, None]
            a = a * ((r >= r0) & (r < r0 + ha))[:, :, None]
        b = round_to(Xb[pos_b[sl]].to(torch.float32), update_dtype)
        pool.index_add_(0, dst[sl], torch.bmm(a, b.transpose(1, 2)),
                        alpha=-1.0)
    return pool
