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
variants.  The TPU's compact and packed operand streams (``xab``,
``compact``, ``ab_pack``) are formats of the reference's right-looking
stream path, which the port's left-looking plan never produces; they
raise (ROADMAP.md B3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.kernels import (
    check_pool, check_variant, is_bf16, round_to,
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

    @property
    def nseg(self) -> int:
        return self.seg_dst.numel()


def pipeline_plan(schedule, device) -> list:
    """Kernel tables (:class:`PipeChunk`) of a
    :func:`build_pipeline_schedule` result, uploaded to ``device``.

    A dst segment cut by a chunk boundary lands in two chunks; the
    chunks run in order, so the second reads what the first wrote."""
    out = []
    for t in schedule:
        valid = (np.asarray(t["flags"]) & _F_VALID) != 0
        if not valid.any():
            continue
        gd = np.asarray(t["gd"], np.int64)[valid]
        starts = np.flatnonzero(np.r_[True, gd[1:] != gd[:-1]])
        tens = lambda a: torch.as_tensor(
            np.ascontiguousarray(a, np.int64), device=device
        )
        out.append(PipeChunk(
            n_pairs=int(gd.size),
            seg_ptr=tens(np.r_[starts, gd.size]),
            seg_dst=tens(gd[starts]),
            pair_a=tens(np.asarray(t["ga"])[valid]),
            pair_b=tens(np.asarray(t["gb"])[valid]),
            pair_k=(tens(np.asarray(t["gk"])[valid]) if "gk" in t else None),
        ))
    return out


def _refuse_variants(xab, compact, ab_pack) -> None:
    for name, v in (("xab", xab), ("compact", compact),
                    ("ab_pack", ab_pack or None)):
        if v is not None:
            raise NotImplementedError(
                f"gemm_scatter_pipelined: the {name} operand stream is a "
                "format of the reference's right-looking stream path, which "
                "the port does not produce; not ported (ROADMAP.md B3)"
            )


def gemm_scatter_pipelined(pool: torch.Tensor, plan, update_dtype=None, *,
                           d=None, src_pool=None, xab=None, compact=None,
                           ab_pack=False):
    """pool[gd] -= op(pool[ga] diag(d[gk])) @ op(src[gb])^T over every
    chunk of ``plan`` (:func:`pipeline_plan`), in place.

    ``op`` rounds to ``update_dtype`` (bf16, or None/fp32 for fp32
    operands), after the scaling; products accumulate in fp32.  b is read
    from ``src_pool`` when given (the LU cross-pool update), else from
    ``pool``; ``d`` (nbc, T) scales a's columns by the pivots of the
    pair's source column (LDLᵗ; the plan needs ``gk``).  The reference
    splits fp32 operands into three bf16 passes (its TPU has no fp32
    matrix unit); the kernel multiplies them in fp32 instead (ROADMAP.md
    C).  A pool on a CUDA device goes through the kernel K3, one launch
    per chunk, in order on the current stream; a pool on the CPU through
    :func:`gemm_scatter_pipelined_ref`."""
    _refuse_variants(xab, compact, ab_pack)
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_pipelined_ref(pool, plan, update_dtype, d=d,
                                          src_pool=src_pool)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    lib = _build.get_lib()
    stream = _build.stream_ptr(pool.device)
    T = pool.shape[1]
    src = pool if src_pool is None else src_pool
    for c in plan:
        err = lib.pastix_pipelined_gemm_scatter(
            pool.data_ptr(), src.data_ptr(), c.seg_ptr.data_ptr(),
            c.seg_dst.data_ptr(), c.pair_a.data_ptr(), c.pair_b.data_ptr(),
            None if d is None else d.data_ptr(),
            None if d is None else c.pair_k.data_ptr(),
            c.nseg, T, int(bf16), stream,
        )
        _build.check(err, "gemm_scatter_pipelined")
        gemm_scatter_pipelined.launches += 1
    return pool


gemm_scatter_pipelined.launches = 0  # K3 launches (one per chunk)
gemm_scatter_pipelined.twin_launches = 0  # calls of the plain twin


def gemm_scatter_pipelined_ref(pool: torch.Tensor, plan, update_dtype=None,
                               *, d=None, src_pool=None):
    """Plain PyTorch twin of :func:`gemm_scatter_pipelined`, on any device.

    Operands are scaled, rounded to the update dtype and multiplied in
    fp32, full tiles (B3 has no row bounds); differs from the kernel only
    in summation order.  Chunks run in order, as the kernel's launches
    do."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    is_bf16(update_dtype)
    gemm_scatter_pipelined.twin_launches += 1
    src = pool if src_pool is None else src_pool
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
            b = round_to(src[c.pair_b[sl]], update_dtype)
            pool.index_add_(0, dst[sl], torch.bmm(a, b.transpose(1, 2)),
                            alpha=-1.0)
    return pool
