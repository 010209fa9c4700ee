"""The reference's other two E2 kernels, over the same pair lists as K3:
kernels K9 and K10.

- ``gemm_scatter_fused`` (B6, ``pastix_tpu/numeric/pallas_kernels.py``),
  the round-2 E2 over :func:`sort_triples` output, one pair per TPU grid
  step: :func:`gemm_scatter_fused` (K9) over a :func:`fused_plan`;
- ``gemm_scatter_blockspec`` (B7), the BlockSpec-pipelined E2 over a
  ``build_pipeline_schedule`` table whose operands are gathered into
  compact arrays first: :func:`gemm_scatter_blockspec` (K10) over a
  :func:`blockspec_plan`.

Neither has a source of its own: both run through K3's entry
(``csrc/pipelined_gemm_scatter.cu``, ``pipelined.launch_chunks``), K9 on
the pools themselves, K10 on the chunk's compact gathers.  Bf16 updates
run on K3's tensor-core body (``csrc/seg_mma.cuh``) over the pieces the
plans cut (``pipelined.piece_fields``), the fp32 pools rounded as the
fragments load; fp32 updates run on K3's fp32 body, a CTA per segment.

The reference runs them only in its E2 A/B harness (``exp_pipe.py``) and
its tests; ``chip_smoke.py`` phase 13 is the port's harness.  The plans
hold the reference's tables on the device, built once, as
``pipelined.pipeline_plan`` does for K3.  Each wrapper launches its
kernel for a pool on a CUDA device and its plain twin for a pool on the
CPU.  With ``update_dtype`` None the reference forms fp32 products from
three bf16 passes; the kernels multiply in fp32 (ROADMAP.md C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch.numeric.kernels import check_pool, check_variant, is_bf16
from pastix_tpu_torch.numeric.leftlook import piece_ctas
from pastix_tpu_torch.numeric.pipelined import (
    _F_FIRST, _F_LAST, PipeChunk, launch_chunks, pairs_ref, piece_fields,
)

# tile sizes K9 and K10 are built for
_KERNEL_T = (32, 64, 128)


def sort_triples(ga, gb, gd, gk=None):
    """Sort contribution triples by destination and emit first/last flags."""
    order = np.argsort(gd, kind="stable")
    ga, gb, gd = ga[order], gb[order], gd[order]
    first = np.empty(gd.size, np.int32)
    last = np.empty(gd.size, np.int32)
    if gd.size:
        first[0] = 1
        first[1:] = gd[1:] != gd[:-1]
        last[-1] = 1
        last[:-1] = gd[1:] != gd[:-1]
    out = [ga, gb, gd, first, last]
    if gk is not None:
        out.append(gk[order])
    return tuple(out)


@dataclasses.dataclass
class SegChunk(PipeChunk):
    """A pair list sorted by dst as K9 and K10 read it: K3's tables
    (:class:`~pastix_tpu_torch.numeric.pipelined.PipeChunk`, its pieces
    included) plus each pair's dst tile."""

    pair_d: torch.Tensor = None
    # K9: whether some dst tile is also an a tile, or a b tile, of the
    # list (K10 reads copies of its operands and needs no such check)
    a_meets_dst: bool = False
    b_meets_dst: bool = False


def _segments(gd, first, last):
    """Segment starts of a dst-sorted list; raises unless the flags mark
    exactly the runs of equal dst and every dst has one run."""
    starts = np.flatnonzero(np.r_[True, gd[1:] != gd[:-1]])
    want = np.zeros(gd.size, bool)
    want[starts] = True
    ends = np.zeros(gd.size, bool)
    ends[np.r_[starts[1:] - 1, gd.size - 1]] = True
    if not (np.array_equal(first != 0, want) and np.array_equal(last != 0, ends)):
        raise ValueError("first/last must mark the runs of equal dst "
                         "(sort_triples' flags)")
    if np.unique(gd[starts]).size != starts.size:
        raise ValueError("each dst tile must form one run: sort the "
                         "triples by dst")
    return starts


def _tens(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)


def _chunk(ga, gb, gd, gk, starts, device, **extra) -> SegChunk:
    tens = lambda a: _tens(a, device)
    return SegChunk(
        n_pairs=int(gd.size), seg_ptr=tens(np.r_[starts, gd.size]),
        seg_dst=tens(gd[starts]), pair_a=tens(ga), pair_b=tens(gb),
        pair_k=None if gk is None else tens(gk), pair_d=tens(gd), **extra)


def fused_plan(ga, gb, gd, first, last, gk=None, device="cpu") -> list:
    """K9's table of :func:`sort_triples` output (host arrays), uploaded
    to ``device``: a list of one :class:`SegChunk` (none when empty),
    with K3's pieces cut for the card (``pipelined.piece_fields``).  The
    flags are checked against the runs of equal dst, not uploaded: the
    segments carry them."""
    ga, gb, gd, first, last = (np.asarray(x) for x in (ga, gb, gd, first,
                                                          last))
    if not gd.size:
        return []
    starts = _segments(gd, first, last)
    tens = lambda a: _tens(a, device)
    return [_chunk(ga, gb, gd, None if gk is None else np.asarray(gk),
                   starts, device,
                   a_meets_dst=bool(np.intersect1d(gd, ga).size),
                   b_meets_dst=bool(np.intersect1d(gd, gb).size),
                   **piece_fields(np.r_[starts, gd.size], gd.size,
                                  piece_ctas(device), tens))]


def _check_disjoint(plan, src_pool) -> None:
    """Segments run concurrently: no pair may read a tile that another
    segment writes."""
    for c in plan:
        if c.a_meets_dst or (src_pool is None and c.b_meets_dst):
            raise ValueError(
                "dst tiles meet operand tiles of the same pool: the "
                "segments of K9/K10 run concurrently and would race")


def _check_t(pool) -> None:
    if pool.shape[1] not in _KERNEL_T:
        raise ValueError(f"K9/K10 are built for T in {_KERNEL_T}, got "
                         f"T={pool.shape[1]}")


def gemm_scatter_fused(pool: torch.Tensor, plan, update_dtype=None, *,
                       d=None, src_pool=None):
    """pool[gd] -= op(a diag(d[gk])) @ op(b)^T over a :func:`fused_plan`,
    in place: a from ``pool``, b from ``src_pool`` when given (LU) else
    from ``pool``; ``op`` rounds to ``update_dtype`` (bf16, or None/fp32
    for fp32 operands) after the scaling; products accumulate in fp32.
    ``d`` (nbc, T) scales a's columns (LDLᵗ; the plan needs ``gk``).
    Raises if a dst tile is an a tile, or a b tile read from ``pool``.

    A pool on a CUDA device goes through K9, one launch of K3's kernel
    per chunk on the pools themselves (``pipelined.launch_chunks``: with
    bf16 updates the tensor-core body, the fp32 tiles rounded as they
    load); a pool on the CPU through :func:`gemm_scatter_fused_ref`."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    _check_disjoint(plan, src_pool)
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_fused_ref(pool, plan, update_dtype, d=d,
                                      src_pool=src_pool)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    _check_t(pool)
    src = pool if src_pool is None else src_pool
    launch_chunks(pool, plan, lambda c: (pool, src, c.pair_a, c.pair_b),
                  bf16, d, gemm_scatter_fused)
    return pool


gemm_scatter_fused.launches = 0  # K9 launches (one per chunk)
gemm_scatter_fused.twin_launches = 0  # calls of the plain twin


def gemm_scatter_fused_ref(pool: torch.Tensor, plan, update_dtype=None, *,
                           d=None, src_pool=None):
    """Plain PyTorch twin of :func:`gemm_scatter_fused`, on any device."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    _check_disjoint(plan, src_pool)
    is_bf16(update_dtype)
    gemm_scatter_fused.twin_launches += 1
    src = pool if src_pool is None else src_pool
    for c in plan:
        pairs_ref(pool, pool, src, c.pair_a, c.pair_b, c.pair_d,
                  update_dtype, d=d, pair_k=c.pair_k)
    return pool


def blockspec_plan(schedule, device) -> list:
    """K10's tables of a ``build_pipeline_schedule`` result (its compact
    form), one :class:`SegChunk` per chunk, uploaded to ``device``, with
    K3's pieces cut for its card (``pipelined.piece_fields``).

    The reference's kernel reads no ``_F_VALID`` bit and its harness
    builds these tables with ``group=1``: a schedule of another group
    raises, as does one built with ``ext_tiles``."""
    ctas = piece_ctas(device)
    tens = lambda a: _tens(a, device)
    out = []
    for t in schedule:
        if t["group"] != 1:
            raise ValueError(
                f"gemm_scatter_blockspec takes group=1 schedules, got "
                f"group={t['group']}")
        if "uniq_a" not in t:
            raise ValueError("gemm_scatter_blockspec takes the compact "
                             "schedule (built without ext_tiles)")
        gd = np.asarray(t["gd"])
        if not gd.size:
            continue
        flags = np.asarray(t["flags"], np.int32)
        starts = _segments(gd, flags & _F_FIRST, flags & _F_LAST)
        ua, ub = np.asarray(t["uniq_a"]), np.asarray(t["uniq_b"])
        ca, cb = np.asarray(t["ga_c"]), np.asarray(t["gb_c"])
        out.append(_chunk(
            ua[ca], ub[cb], gd, t.get("gk"), starts, device,
            uniq_a=tens(ua), uniq_b=tens(ub), cpos_a=tens(ca), cpos_b=tens(cb),
            **piece_fields(np.r_[starts, gd.size], gd.size, ctas, tens)))
    return out


def gemm_scatter_blockspec(pool: torch.Tensor, plan, update_dtype=None, *,
                           d=None, src_pool=None):
    """pool[gd] -= op(a diag(d[gk])) @ op(b)^T over a
    :func:`blockspec_plan`, in place, with :func:`gemm_scatter_fused`'s
    operands and rounding.  Per chunk the distinct a tiles of ``pool`` and
    b tiles of ``src_pool`` (or ``pool``) are gathered into arrays ``Xa``,
    ``Xb``, as the reference does outside its kernel, and each pair reads
    its tiles there.

    A pool on a CUDA device goes through K10, one launch of K3's kernel
    per chunk, in order on the current stream (``pipelined.launch_chunks``);
    with bf16 updates the gathers are rounded to bf16 wherever that is
    where the twin rounds (``Xb`` always, ``Xa`` unless ``d`` scales it
    first).  A pool on the CPU goes through
    :func:`gemm_scatter_blockspec_ref`."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    bf16 = is_bf16(update_dtype)
    if pool.device.type == "cpu":
        return gemm_scatter_blockspec_ref(pool, plan, update_dtype, d=d,
                                          src_pool=src_pool)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    _check_t(pool)
    src = pool if src_pool is None else src_pool
    cast = (lambda x: x.to(torch.bfloat16)) if bf16 else (lambda x: x)

    def operands(c):
        Xa = pool[c.uniq_a]
        return (Xa if d is not None else cast(Xa), cast(src[c.uniq_b]),
                c.cpos_a, c.cpos_b)

    launch_chunks(pool, plan, operands, bf16, d, gemm_scatter_blockspec)
    return pool


gemm_scatter_blockspec.launches = 0  # K10 launches (one per chunk)
gemm_scatter_blockspec.twin_launches = 0  # calls of the plain twin


def gemm_scatter_blockspec_ref(pool: torch.Tensor, plan, update_dtype=None,
                               *, d=None, src_pool=None):
    """Plain PyTorch twin of :func:`gemm_scatter_blockspec`, on any
    device; chunks run in order, as the kernel's launches do."""
    check_pool(pool)
    check_variant(pool, d, src_pool, plan)
    is_bf16(update_dtype)
    gemm_scatter_blockspec.twin_launches += 1
    src = pool if src_pool is None else src_pool
    for c in plan:
        pairs_ref(pool, pool[c.uniq_a], src[c.uniq_b], c.cpos_a, c.cpos_b,
                  c.pair_d, update_dtype, d=d, pair_k=c.pair_k)
    return pool
