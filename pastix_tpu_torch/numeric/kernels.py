"""Batched dense tile operations (PyTorch counterpart of
``pastix_tpu/numeric/kernels.py``, real LLᵗ only).

Every function takes and returns tensors on the caller's device.  fp32
matmuls here run in true fp32 (``_device.pin_precision`` turns TF32 off).
"""

from __future__ import annotations

import torch


def potrf_batch(tiles: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky of (B, T, T) tiles; only the lower triangle
    of each tile is read.

    ``cholesky_ex`` reports a breakdown through ``info`` without a host
    sync; a broken tile becomes NaN, as ``lax.linalg.cholesky`` returns it
    in the reference, so one NaN check after the whole factorization
    finds it (``pastix_tpu/numeric/factorize.py`` ``factorize``)."""
    L, info = torch.linalg.cholesky_ex(tiles)
    return torch.where((info != 0)[:, None, None], torch.nan, L)


def tri_inv_batch(L: torch.Tensor) -> torch.Tensor:
    """Batched inverse of lower-triangular (B, T, T) tiles."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        L, eye.expand_as(L), upper=False
    )


def round_to(x: torch.Tensor, update_dtype) -> torch.Tensor:
    """Round fp32 ``x`` to ``update_dtype`` and back to fp32.

    A product of two bf16 values is exact in fp32, so a fp32 matmul of
    rounded operands is the bf16-operand, fp32-accumulate product of the
    reference (``preferred_element_type=float32``).  A bf16 matmul in
    PyTorch would round its output to bf16 on CUDA instead."""
    if update_dtype is None or update_dtype == torch.float32:
        return x
    return x.to(update_dtype).to(x.dtype)


def check_pool(pool: torch.Tensor) -> None:
    """The E2 kernels take a contiguous float32 (npool, T, T) pool."""
    if pool.dtype != torch.float32 or pool.dim() != 3 or not (
        pool.is_contiguous() and pool.shape[1] == pool.shape[2]
    ):
        raise ValueError(
            "pool must be a contiguous float32 (npool, T, T) tensor, got "
            f"{pool.dtype} {tuple(pool.shape)}"
        )


def is_bf16(update_dtype) -> bool:
    """Whether an E2 kernel rounds its operands to bf16 (``update_dtype``
    bf16) or multiplies them in fp32 (None or float32)."""
    if update_dtype in (None, torch.float32):
        return False
    if update_dtype == torch.bfloat16:
        return True
    raise ValueError(f"unsupported update dtype {update_dtype}")


def gemm_scatter(pool, ga, gb, gd, update_dtype=None):
    """pool[gd] -= op(pool[ga]) @ op(pool[gb])^T, accumulated over
    duplicate targets, in place; op rounds to ``update_dtype``.

    The plain twin of ``pastix_tpu/numeric/kernels.py`` ``gemm_scatter``
    (real, unscaled)."""
    a = round_to(pool[ga], update_dtype)
    b = round_to(pool[gb], update_dtype)
    pool.index_add_(0, gd, torch.bmm(a, b.transpose(1, 2)), alpha=-1.0)
    return pool
