"""Batched dense tile operations (PyTorch counterpart of
``pastix_tpu/numeric/kernels.py``, real dtypes only).

Every function takes and returns tensors on the caller's device.  fp32
matmuls here run in true fp32 inside the ``Pastix`` phases
(``_device.pin_precision`` turns TF32 off around them).
``ldlt_batch`` and ``getrf_batch`` are the plain twins of kernel K4
(``numeric/tile_factor.py``), ``chol_inv_batch`` that of K7 and K8
(``numeric/chol_inv.py``): T-step loops of batched tensor operations, as
the reference's ``lax.fori_loop``s are.
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


def tri_inv_batch(L: torch.Tensor, upper: bool = False,
                  unit: bool = False) -> torch.Tensor:
    """Batched inverse of triangular (B, T, T) tiles: the lower triangle
    (default) or the upper one; ``unit`` takes the diagonal as ones and
    reads only the strict triangle (the unit L of a combined LU tile)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        L, eye.expand_as(L), upper=upper, unitriangular=unit
    )


def chol_inv_batch(tiles: torch.Tensor):
    """Batched lower Cholesky and its inverse of (B, T, T) tiles in one
    T-step loop, reading only the lower triangle of each tile: step j
    forms column j of L (left-looking) and row j of X = L⁻¹.  Returns (L,
    X), both lower triangular with zeros above.  A tile that is not
    positive definite turns NaN, as ``potrf_batch`` makes it.

    The reference's ``chol_inv_batch`` (``pastix_tpu/numeric/kernels.py``,
    real dtypes), and the plain twin of kernels K7 and K8
    (``numeric/chol_inv.py``)."""
    B, T, _ = tiles.shape
    L = torch.zeros_like(tiles)
    X = torch.zeros_like(tiles)
    for j in range(T):
        Lrow = L[:, j, :j]
        col = tiles[:, j:, j] - torch.einsum("bik,bk->bi", L[:, j:, :j], Lrow)
        piv = torch.sqrt(col[:, 0])
        L[:, j, j] = piv
        L[:, j + 1:, j] = col[:, 1:] / piv[:, None]
        s2 = torch.einsum("bk,bkt->bt", Lrow, X[:, :j, :])
        s2[:, j] -= 1.0
        X[:, j, :] = -s2 / piv[:, None]
    return L, X


def clamp_pivot(piv: torch.Tensor, eps: float):
    """Static pivoting: ``|piv| < eps`` is clamped to ``±eps`` by the sign
    of ``piv`` (``+eps`` for 0).  Returns (clamped, small); the reference's
    ``_clamp_pivot`` for real dtypes."""
    small = piv.abs() < eps
    sgn = torch.where(piv >= 0, eps, -eps).to(piv.dtype)
    return torch.where(small, sgn, piv), small


def ldlt_batch(tiles: torch.Tensor, eps: float):
    """Unpivoted LDLᵗ of (B, T, T) tiles with static pivoting, reading the
    lower triangle of each (the reference's ``_sym_lower`` then
    ``ldlt_batch``).  Returns (L unit lower with zeros above, d (B, T),
    number of clamped pivots as a 0-d int32 tensor)."""
    B, T, _ = tiles.shape
    M = torch.tril(tiles) + torch.tril(tiles, -1).transpose(1, 2)
    L = torch.zeros_like(M)
    d = torch.empty((B, T), dtype=M.dtype, device=M.device)
    npiv = torch.zeros((), dtype=torch.int32, device=M.device)
    for j in range(T):
        pivc, small = clamp_pivot(M[:, j, j], eps)
        col = M[:, j + 1:, j] / pivc[:, None]
        M[:, j + 1:, j + 1:] -= col[:, :, None] * M[:, None, j, j + 1:]
        L[:, j, j] = 1.0
        L[:, j + 1:, j] = col
        d[:, j] = pivc
        npiv += small.sum(dtype=torch.int32)
    return L, d, npiv


def getrf_batch(tiles: torch.Tensor, eps: float):
    """Unpivoted LU of (B, T, T) tiles with static pivoting.  Returns
    (the combined tile: unit L strictly below the diagonal, U on and
    above it; number of clamped pivots as a 0-d int32 tensor)."""
    M = tiles.clone()
    T = M.shape[1]
    npiv = torch.zeros((), dtype=torch.int32, device=M.device)
    for j in range(T):
        pivc, small = clamp_pivot(M[:, j, j], eps)
        M[:, j, j] = pivc
        col = M[:, j + 1:, j] / pivc[:, None]
        M[:, j + 1:, j + 1:] -= col[:, :, None] * M[:, None, j, j + 1:]
        M[:, j + 1:, j] = col
        npiv += small.sum(dtype=torch.int32)
    return M, npiv


def round_to(x: torch.Tensor, update_dtype) -> torch.Tensor:
    """Round fp32 ``x`` to ``update_dtype`` and back to fp32.

    A product of two bf16 values is exact in fp32, so a fp32 matmul of
    rounded operands is the bf16-operand, fp32-accumulate product of the
    reference (``preferred_element_type=float32``).  A bf16 matmul in
    PyTorch would round its output to bf16 on CUDA instead."""
    if update_dtype is None or update_dtype == torch.float32:
        return x
    return x.to(update_dtype).to(x.dtype)


def check_pool(pool: torch.Tensor, name: str = "pool") -> None:
    """The E2 kernels take a contiguous float32 (npool, T, T) pool."""
    if pool.dtype != torch.float32 or pool.dim() != 3 or not (
        pool.is_contiguous() and pool.shape[1] == pool.shape[2]
    ):
        raise ValueError(
            f"{name} must be a contiguous float32 (npool, T, T) tensor, got "
            f"{pool.dtype} {tuple(pool.shape)}"
        )


def check_variant(pool: torch.Tensor, d, src_pool, plan) -> None:
    """The scaled (``d``: contiguous float32 (nbc, T) pivots, and a
    ``plan`` whose chunks carry each pair's source column ``pair_k``) and
    cross-pool (``src_pool``: a pool like ``pool``) operands of K1/K3."""
    if src_pool is not None:
        check_pool(src_pool, "src_pool")
        if src_pool.shape != pool.shape or src_pool.device != pool.device:
            raise ValueError("src_pool must match pool in shape and device")
    if d is not None and (
        d.dtype != torch.float32 or d.dim() != 2 or not d.is_contiguous()
        or d.shape[1] != pool.shape[1] or d.device != pool.device
    ):
        raise ValueError(
            "d must be a contiguous float32 (nbc, T) tensor on the pool's "
            f"device, got {d.dtype} {tuple(d.shape)}"
        )
    if d is not None and any(c.pair_k is None for c in plan):
        raise ValueError("the scaled variant (d) needs a plan built with gk")


def is_bf16(update_dtype) -> bool:
    """Whether an E2 kernel rounds its operands to bf16 (``update_dtype``
    bf16) or multiplies them in fp32 (None or float32)."""
    if update_dtype in (None, torch.float32):
        return False
    if update_dtype == torch.bfloat16:
        return True
    raise ValueError(f"unsupported update dtype {update_dtype}")


def gemm_scatter(pool, ga, gb, gd, update_dtype=None, scale_cols=None):
    """pool[gd] -= op(pool[ga] diag(scale_cols)) @ op(pool[gb])^T,
    accumulated over duplicate targets, in place; op rounds to
    ``update_dtype`` (after the scaling, as the reference does).

    The plain twin of ``pastix_tpu/numeric/kernels.py`` ``gemm_scatter``
    (real); ``scale_cols`` (ng, T) is the D of LDLᵗ."""
    return gemm_scatter_ab(pool, pool, pool, ga, gb, gd, update_dtype,
                           scale_cols)


def gemm_scatter_ab(dst_pool, a_pool, b_pool, ga, gb, gd, update_dtype=None,
                    scale_cols=None):
    """dst_pool[gd] -= op(a_pool[ga]) @ op(b_pool[gb])^T in place: the LU
    cross-pool update (reference ``gemm_scatter_ab``)."""
    a = a_pool[ga]
    if scale_cols is not None:
        a = a * scale_cols[:, None, :]
    a = round_to(a, update_dtype)
    b = round_to(b_pool[gb], update_dtype)
    dst_pool.index_add_(0, gd, torch.bmm(a, b.transpose(1, 2)), alpha=-1.0)
    return dst_pool
