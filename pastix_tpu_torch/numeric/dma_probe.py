"""The reference's copy probe (``exp_dma.py`` ``probe`` and ``probe_sub``):
kernel K13.

The probe copies, per step i and copy d, the S consecutive tiles
``view[idx[i, d] : idx[i, d] + S]`` from device memory into on-chip
memory, ``reps`` times over the ``steps`` rows of ``idx``: what it
measures is the copies' time (µs per copy, GB/s) against their size and
the depth in flight.  ``view`` is the pool of (N, 128, T) tiles, or its
(2N, 64, T) or (4N, 32, T) reshape for the sub-tile sizes.

The reference adds only copy 0's row 0 into a (1, T) accumulator that it
never zeroes, so its output is undefined (``exp_dma.py:59``, ``:149``).
Here the accumulator starts at zero and is (2, D, T): every copy adds the
first row of its first tile into ``[0, d]`` and the last row of its last
tile into ``[1, d]``, so the result is exactly :func:`probe_ref`'s
closed form and a kernel that skipped a copy, or its end, would be
caught.  ``[0, 0]`` is the reference's output.

:func:`probe` launches ``csrc/dma_probe.cu`` for a view on a CUDA device
and :func:`probe_ref` for a view on the CPU.
"""

from __future__ import annotations

import math

import torch

from pastix_tpu_torch import _build


MAX_D = 24  # copies a step: K13's ring holds 2 D stages, at most 48
PIECE = 4096  # bytes a bulk copy of K13, at most, by default
RING_BYTES = 196608  # K13's ring of 2 D pieces, at most


def piece_bytes(S: int, rows: int, T: int, piece: int = PIECE) -> int:
    """Bytes of one of K13's bulk copies: the copy of S (rows, T) fp32
    tiles is cut into equal pieces of gcd(copy bytes, ``piece``)."""
    return math.gcd(S * rows * T * 4, piece)


def _check(view: torch.Tensor, idx: torch.Tensor, S: int, reps: int,
           check_idx: bool = True):
    if view.dtype != torch.float32 or view.dim() != 3 or (
        not view.is_contiguous()
    ):
        raise ValueError("view must be a contiguous float32 (N, rows, T) "
                         f"tensor, got {view.dtype} {tuple(view.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or (
        not idx.is_contiguous() or idx.device != view.device
    ):
        raise ValueError("idx must be a contiguous int32 (steps, D) tensor "
                         "on the view's device, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if S < 1 or reps < 1 or idx.numel() == 0:
        raise ValueError(f"need S >= 1, reps >= 1 and steps, D >= 1, got "
                         f"S={S}, reps={reps}, idx {tuple(idx.shape)}")
    if idx.shape[1] > MAX_D:
        raise ValueError(f"at most {MAX_D} copies a step, got D = "
                         f"{idx.shape[1]}")
    if not check_idx:
        return
    lo, hi = (int(x) for x in torch.aminmax(idx))
    if lo < 0 or hi > view.shape[0] - S:
        raise ValueError(f"idx must lie in [0, {view.shape[0] - S}] (S={S} "
                         f"tiles a copy from {view.shape[0]}), got "
                         f"[{lo}, {hi}]")


def probe(view: torch.Tensor, idx: torch.Tensor, S: int, reps: int, *,
          ctas: int = 0, piece: int = PIECE,
          check_idx: bool = True) -> torch.Tensor:
    """Copy ``view[idx[i, d] : +S]`` for every step i and copy d, ``reps``
    times, and return the (2, D, T) fp32 sums of each copy's first row
    (``[0]``) and last row (``[1]``), :func:`probe_ref`'s closed form.

    A view on a CUDA device goes through K13: every copy is streamed into
    shared memory in bulk copies of :func:`piece_bytes` (at most
    ``piece`` bytes), the D copies of a step in flight per CTA, each
    double-buffered, one CTA per SM or ``ctas`` CTAs, CTA b taking steps
    b, b + CTAs, ... (``csrc/dma_probe.cu``); a view on the CPU through
    :func:`probe_ref`.
    ``check_idx=False`` skips the range check of ``idx``, a read back to
    the host, for a caller that checked it."""
    if view.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {view.device}")
    _check(view, idx, S, reps, check_idx)
    if ctas < 0:
        raise ValueError(f"ctas must be >= 0, got {ctas}")
    _, rows, T = view.shape
    nb = piece_bytes(S, rows, T, piece)
    if nb % 16 or nb % (4 * T) or 2 * idx.shape[1] * nb > RING_BYTES:
        raise ValueError(
            f"a piece of {nb} B (gcd of the {S * rows * T * 4} B copy and "
            f"piece={piece}) must be a multiple of 16 B and of a row, and "
            f"2 D pieces must fit in {RING_BYTES} B")
    if view.device.type == "cpu":
        return probe_ref(view, idx, S, reps)
    if view.data_ptr() % 16:
        raise ValueError("view must be 16-byte aligned (bulk copies)")
    steps, D = idx.shape
    out = torch.zeros((2, D, T), dtype=torch.float32, device=view.device)
    err = _build.get_lib().pastix_dma_probe(
        view.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, T, steps, D,
        S, reps, ctas, piece, _build.stream_ptr(view.device))
    _build.check(err, "probe")
    probe.launches += 1
    return out


probe.launches = 0  # K13 launches
probe.twin_launches = 0  # calls of the plain twin


def probe_ref(view: torch.Tensor, idx: torch.Tensor, S: int,
              reps: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`probe`, on any device: the closed form
    ``reps * sum_i view[idx[i, d], 0, :]`` (``[0, d]``) and ``reps *
    sum_i view[idx[i, d] + S - 1, -1, :]`` (``[1, d]``) by indexing,
    summed in fp64, without the copies."""
    _check(view, idx, S, reps)
    probe.twin_launches += 1
    ix = idx.long()
    rows = torch.stack([view[:, 0, :][ix], view[:, -1, :][ix + S - 1]])
    return (rows.double().sum(1) * reps).float()
