"""The reference's chunk-resident operand cache for the right-looking E2
update: kernels K11 and K12.

- B10, ``exp_cache.py`` ``gemm_scatter_vcache``: per dst-sorted chunk of a
  ``build_pipeline_schedule(..., ext_tiles=panel)`` table, the chunk's
  distinct bf16 operand tiles are gathered from the panel stream ``xab``
  into a compact array, and every pair reads a and b there by index
  (:func:`vcache_tables`, :func:`vcache_plan`,
  :func:`gemm_scatter_vcache`, K11);
- B11, ``exp_mp.py`` ``gemm_scatter_mp``: the same cache, but each dst
  segment padded to a multiple of G with null pairs that read a zero slot,
  and G pairs summed per step before the accumulator is updated
  (:func:`build_mp_schedule`, :func:`mp_plan`, :func:`gemm_scatter_mp`,
  K12, variants ``loop`` and ``dot2``).

K11 is a launch of K3's kernel (``csrc/pipelined_gemm_scatter.cu``) on
the chunk's cache, K12 one of ``csrc/cache_gemm_scatter.cu``.  The host
tables are the reference's, copied verbatim (``exp_cache.py:67-74``,
``exp_mp.py:82-159``; those scripts run a 64³ analysis at import, so the
copies live here).  Per chunk the wrapper fills one bf16 buffer, allocated
once per call at the largest cache size: ``buf[:cu.size] = xab[cu]``, the
rest zero, as the reference gathers ``Xc`` in XLA outside its kernel; then
one launch.  A pool on a CUDA device goes through the kernel, a pool on
the CPU through the plain twin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.fused import _segments
from pastix_tpu_torch.numeric.kernels import check_pool
from pastix_tpu_torch.numeric.leftlook import piece_ctas
from pastix_tpu_torch.numeric.pipelined import (
    _F_FIRST, _F_LAST, _F_PAR, _F_VALID, _F_WRWAIT, _REF_BATCH,
    launch_chunks, pairs_ref, piece_fields,
)

# tile sizes K11 and K12 are built for
_KERNEL_T = (32, 64, 128)
MP_VARIANTS = ("loop", "dot2")


def vcache_tables(sched):
    """Per-chunk uniq compact ids and the cache size, in place on the
    chunks of a ``build_pipeline_schedule(..., ext_tiles=)`` result
    (``exp_cache.py:67-74``): ``cu`` the chunk's distinct stream positions,
    ``ga_v``/``gb_v`` each pair's slot among them.  Returns CT, the most
    distinct tiles of a chunk rounded up to 8."""
    CT = 0
    for t in sched:
        u = np.unique(np.concatenate([t["ga_c"], t["gb_c"]]))
        t["cu"] = u.astype(np.int32)
        t["ga_v"] = np.searchsorted(u, t["ga_c"]).astype(np.int32)
        t["gb_v"] = np.searchsorted(u, t["gb_c"]).astype(np.int32)
        CT = max(CT, u.size)
    CT = -(-CT // 8) * 8
    return CT


def build_mp_schedule(ga, gb, gd, chunk, G, ext_tiles):
    """Dst-sorted, segment-padded-to-G schedule with per-STEP tables."""
    order = np.argsort(gd, kind="stable")
    ga = np.asarray(ga, np.int64)[order]
    gb = np.asarray(gb, np.int64)[order]
    gd = np.asarray(gd, np.int64)[order]
    ext = np.asarray(ext_tiles)
    ga_c = np.searchsorted(ext, ga).astype(np.int64)
    gb_c = np.searchsorted(ext, gb).astype(np.int64)
    assert (ext[ga_c] == ga).all() and (ext[gb_c] == gb).all()
    # pad each segment to a multiple of G (null pairs: compact idx -1)
    first = np.concatenate([[1], (gd[1:] != gd[:-1]).astype(np.int64)])
    seg = np.cumsum(first) - 1
    slen = np.bincount(seg)
    plen = (np.ceil(slen / G) * G).astype(np.int64)
    nsteps_total = int(plen.sum()) // G
    # emit padded pair arrays
    np2_ = int(plen.sum())
    pga = np.full(np2_, -1, np.int64)
    pgb = np.full(np2_, -1, np.int64)
    sdst = gd[np.concatenate([[0], np.flatnonzero(first[1:]) + 1])]
    step_dst = np.repeat(sdst, plen // G)      # per-step dst
    step_seg = np.repeat(np.arange(slen.size), plen // G)
    starts = np.concatenate([[0], np.cumsum(plen)[:-1]])
    src_pos = starts[seg] + np.arange(ga.size) - np.concatenate(
        [[0], np.cumsum(slen)[:-1]])[seg]
    pga[src_pos] = ga_c
    pgb[src_pos] = gb_c
    # chunk at step granularity
    ch_steps = max(1, chunk // G)
    out = []
    for lo in range(0, nsteps_total, ch_steps):
        hi = min(lo + ch_steps, nsteps_total)
        ns = hi - lo
        cga = pga[lo * G: hi * G]
        cgb = pgb[lo * G: hi * G]
        cdst = step_dst[lo:hi]
        cseg = step_seg[lo:hi]
        # per-chunk unique cache (real pairs only) + zero slot for nulls
        real = cga >= 0
        u = np.unique(np.concatenate([cga[real], cgb[real]]))
        CT = u.size + 1  # +1 zero slot
        ga_v = np.full(cga.size, u.size, np.int32)
        gb_v = np.full(cgb.size, u.size, np.int32)
        ga_v[real] = np.searchsorted(u, cga[real])
        gb_v[cgb >= 0] = np.searchsorted(u, cgb[cgb >= 0])
        # per-step flags
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
        out.append({
            "ga_v": ga_v, "gb_v": gb_v, "gd": cdst.astype(np.int32),
            "flags": flags, "rd": rd, "endw": endw, "endt": endt,
            "cu": u.astype(np.int32), "CT": CT, "G": G, "nsteps": ns,
        })
    return out


@dataclasses.dataclass
class CacheChunk:
    """One chunk as K11 or K12 reads it, int64 tensors on the pool's
    device.  K11: the valid pairs, sorted by dst, ``seg_ptr`` in pairs.
    K12: every step's G pairs, null pairs included (slot ``len(cu)``, the
    zero slot), ``seg_ptr`` in steps."""

    cu: torch.Tensor  # [nu] stream positions of the chunk's distinct tiles
    seg_ptr: torch.Tensor  # [nseg + 1] pair (K11) or step (K12) offsets
    seg_dst: torch.Tensor  # [nseg] pool index of each segment's dst tile
    pos_a: torch.Tensor  # cache slot of each pair's a
    pos_b: torch.Tensor  # cache slot of each pair's b
    n_pairs: int  # real pairs
    # K11's pieces, as in pipelined.PipeChunk (K12 has none)
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


@dataclasses.dataclass
class CachePlan:
    """A level's chunks and the cache buffer they share: ``ct`` tiles
    (the reference's CT: the most slots of a chunk, zero slot included,
    rounded up to 8); ``mp``: K12's plan, ``group`` G pairs a step."""

    chunks: list
    ct: int
    mp: bool = False
    group: int = 1


def _tens(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)


def vcache_plan(schedule, device) -> CachePlan:
    """K11's tables of a ``build_pipeline_schedule(..., ext_tiles=)``
    result, uploaded to ``device`` once: :func:`vcache_tables` (added to
    the schedule's chunks in place, as the reference does), then each
    chunk's valid pairs cut into dst segments, and those into K3's pieces
    for ``device``'s card (``pipelined.piece_fields``)."""
    if any("ga_c" not in t or "uniq_a" in t for t in schedule):
        raise ValueError("gemm_scatter_vcache takes a schedule built with "
                         "ext_tiles (positions in the panel stream)")
    ct = vcache_tables(schedule)
    ctas = piece_ctas(device)
    tens = lambda a: _tens(a, device)
    chunks = []
    for t in schedule:
        valid = (np.asarray(t["flags"]) & _F_VALID) != 0
        if not valid.any():
            continue
        gd = np.asarray(t["gd"])[valid]
        flags = np.asarray(t["flags"])[valid]
        starts = _segments(gd, flags & _F_FIRST, flags & _F_LAST)
        seg_ptr = np.r_[starts, gd.size]
        chunks.append(CacheChunk(
            cu=tens(t["cu"]), seg_ptr=tens(seg_ptr),
            seg_dst=tens(gd[starts]), pos_a=tens(t["ga_v"][valid]),
            pos_b=tens(t["gb_v"][valid]), n_pairs=int(gd.size),
            **piece_fields(seg_ptr, gd.size, ctas, tens)))
    return CachePlan(chunks, ct)


def mp_plan(schedule, device) -> CachePlan:
    """K12's tables of a :func:`build_mp_schedule` result, uploaded to
    ``device`` once: each chunk's steps cut into dst segments by the
    schedule's per-step flags, and its padded pair tables as they are."""
    chunks, group = [], None
    for t in schedule:
        G = int(t["G"])
        if group not in (None, G):
            raise ValueError("the chunks of an mp schedule differ in G")
        group = G
        gd = np.asarray(t["gd"])
        flags = np.asarray(t["flags"])
        starts = _segments(gd, flags & _F_FIRST, flags & _F_LAST)
        chunks.append(CacheChunk(
            cu=_tens(t["cu"], device), seg_ptr=_tens(np.r_[starts, gd.size],
                                                     device),
            seg_dst=_tens(gd[starts], device), pos_a=_tens(t["ga_v"], device),
            pos_b=_tens(t["gb_v"], device),
            n_pairs=int((np.asarray(t["ga_v"]) < t["cu"].size).sum())))
    ct = max((t["CT"] for t in schedule), default=1)
    return CachePlan(chunks, -(-ct // 8) * 8, mp=True, group=group or 1)


def _check(pool, xab, plan, variant=None) -> int:
    """Checks the arguments of K11 (``variant`` None), K12 and their
    twins; returns T."""
    check_pool(pool)
    T = pool.shape[1]
    if xab.dtype != torch.bfloat16 or xab.dim() != 3 or (
        xab.shape[1:] != pool.shape[1:] or not xab.is_contiguous()
        or xab.device != pool.device
    ):
        raise ValueError(
            "xab must be a contiguous bfloat16 (n, T, T) tensor on the "
            f"pool's device, got {xab.dtype} {tuple(xab.shape)}")
    mp = variant is not None
    if not isinstance(plan, CachePlan) or plan.mp != mp:
        raise ValueError(f"{'gemm_scatter_mp' if mp else 'gemm_scatter_vcache'}"
                         f" takes a {'mp_plan' if mp else 'vcache_plan'}")
    if mp and variant not in MP_VARIANTS:
        raise ValueError(f"variant must be one of {MP_VARIANTS}, got "
                         f"{variant!r}")
    return T


def _fill(buf, xab, c) -> torch.Tensor:
    """The chunk's cache: ``buf[:cu.size] = xab[cu]``, the rest zero."""
    nu = c.cu.numel()
    torch.index_select(xab, 0, c.cu, out=buf[:nu])
    buf[nu:].zero_()
    return buf


def _cuda_setup(pool, xab, plan, T):
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    if T not in _KERNEL_T:
        raise ValueError(f"K11/K12 are built for T in {_KERNEL_T}, got "
                         f"T={T}")
    buf = torch.empty((plan.ct, T, T), dtype=torch.bfloat16,
                      device=pool.device)
    return _build.get_lib(), _build.stream_ptr(pool.device), buf


def gemm_scatter_vcache(pool: torch.Tensor, xab: torch.Tensor,
                        plan: CachePlan) -> torch.Tensor:
    """pool[gd] -= a @ b^T over a :func:`vcache_plan`, in place, with a and
    b the bf16 tiles ``buf[ga_v]``, ``buf[gb_v]`` of the chunk's cache
    (filled from the panel stream ``xab``), products accumulated in fp32.

    A pool on a CUDA device goes through K11: per chunk, the buffer is
    filled and K3's kernel (``csrc/pipelined_gemm_scatter.cu``, its bf16
    tensor-core body over the chunk's pieces) runs once with both operand
    arrays the buffer, in order on the current stream
    (``pipelined.launch_chunks``); a pool on the CPU through
    :func:`gemm_scatter_vcache_ref`."""
    T = _check(pool, xab, plan)
    if pool.device.type == "cpu":
        return gemm_scatter_vcache_ref(pool, xab, plan)
    _, _, buf = _cuda_setup(pool, xab, plan, T)

    def operands(c):
        _fill(buf, xab, c)
        return buf, buf, c.pos_a, c.pos_b

    launch_chunks(pool, plan.chunks, operands, True, None,
                  gemm_scatter_vcache)
    return pool


gemm_scatter_vcache.launches = 0  # K11 launches (one per chunk)
gemm_scatter_vcache.twin_launches = 0  # calls of the plain twin


def gemm_scatter_vcache_ref(pool: torch.Tensor, xab: torch.Tensor,
                            plan: CachePlan) -> torch.Tensor:
    """Plain PyTorch twin of :func:`gemm_scatter_vcache`, on any device;
    chunks run in order, as the kernel's launches do."""
    T = _check(pool, xab, plan)
    gemm_scatter_vcache.twin_launches += 1
    buf = torch.empty((plan.ct, T, T), dtype=torch.bfloat16,
                      device=pool.device)
    for c in plan.chunks:
        _fill(buf, xab, c)
        dst = torch.repeat_interleave(c.seg_dst, c.seg_ptr.diff())
        pairs_ref(pool, buf, buf, c.pos_a, c.pos_b, dst, torch.bfloat16)
    return pool


def gemm_scatter_mp(pool: torch.Tensor, xab: torch.Tensor, plan: CachePlan,
                    variant: str = "loop") -> torch.Tensor:
    """:func:`gemm_scatter_vcache`'s update over an :func:`mp_plan`: per
    step the G products of the step's pairs are summed in fp32 (``loop``:
    G T-deep sums added; ``dot2``: one G·T-deep sum), then subtracted
    from the dst segment's accumulator, which holds the dst tile from the
    segment's first step to its last.

    A pool on a CUDA device goes through K12, one launch per chunk; a pool
    on the CPU through :func:`gemm_scatter_mp_ref`."""
    T = _check(pool, xab, plan, variant)
    if pool.device.type == "cpu":
        return gemm_scatter_mp_ref(pool, xab, plan, variant)
    lib, stream, buf = _cuda_setup(pool, xab, plan, T)
    for c in plan.chunks:
        _fill(buf, xab, c)
        err = lib.pastix_mp_gemm_scatter(
            pool.data_ptr(), buf.data_ptr(), c.seg_ptr.data_ptr(),
            c.seg_dst.data_ptr(), c.pos_a.data_ptr(), c.pos_b.data_ptr(),
            c.nseg, plan.group, c.cu.numel(), T, int(variant == "dot2"),
            stream)
        _build.check(err, f"gemm_scatter_mp[{variant}]")
        gemm_scatter_mp.launches += 1
    return pool


gemm_scatter_mp.launches = 0  # K12 launches (one per chunk), both variants
gemm_scatter_mp.twin_launches = 0  # calls of the plain twin


def gemm_scatter_mp_ref(pool: torch.Tensor, xab: torch.Tensor,
                        plan: CachePlan, variant: str = "loop"
                        ) -> torch.Tensor:
    """Plain PyTorch twin of :func:`gemm_scatter_mp`, on any device, in
    the reference's order: a step's contribution is the sum of its G
    products (``loop``: G batched products summed; ``dot2``: one product
    of the (T, G·T) and (G·T, T) concatenations), and each segment's
    steps are subtracted from its dst one after the other."""
    T = _check(pool, xab, plan, variant)
    gemm_scatter_mp.twin_launches += 1
    G = plan.group
    buf = torch.empty((plan.ct, T, T), dtype=torch.bfloat16,
                      device=pool.device)
    for c in plan.chunks:
        _fill(buf, xab, c)
        ns = c.pos_a.numel() // G
        contrib = torch.empty((ns, T, T), dtype=pool.dtype,
                              device=pool.device)
        batch = max(1, _REF_BATCH // G)
        for lo in range(0, ns, batch):
            sl = slice(lo * G, min(lo + batch, ns) * G)
            a = buf[c.pos_a[sl]].to(torch.float32).view(-1, G, T, T)
            b = buf[c.pos_b[sl]].to(torch.float32).view(-1, G, T, T)
            if variant == "loop":
                out = (a @ b.transpose(2, 3)).sum(1)
            else:
                out = torch.bmm(a.transpose(1, 2).reshape(-1, T, G * T),
                                b.transpose(1, 2).reshape(-1, T, G * T)
                                .transpose(1, 2))
            contrib[lo:lo + out.shape[0]] = out
        # step j of every segment at once, j = 0, 1, ...: a segment's
        # steps reach its dst in order
        seg_len = c.seg_ptr.diff()
        for j in range(int(seg_len.max())):
            live = seg_len > j
            pool.index_add_(0, c.seg_dst[live],
                            contrib[c.seg_ptr[:-1][live] + j], alpha=-1.0)
    return pool
