"""Fused Cholesky + inverse of diagonal tiles: kernels K7 and K8.

The reference's fused-diagonal LLᵗ path (``PASTIX_FUSED_DIAG``) factors
each diagonal tile and forms L⁻¹ in one T-step loop instead of a
Cholesky and a triangular solve.  Its Pallas kernels:

- ``chol_inv_pool_pallas`` (B4, ``pastix_tpu/numeric/pallas_kernels.py``),
  in place on the tile pool by diagonal index: :func:`chol_inv_pool`
  (K7);
- ``chol_inv_pallas`` (B5), a batch of full symmetric tiles:
  :func:`chol_inv` (K8).

Each launches the hand-written CUDA kernel (``csrc/chol_inv.cu``) for
tensors on a CUDA device and its plain twin (``kernels.chol_inv_batch``)
for tensors on the CPU.  The kernel takes a tile a CTA in 32 x 32 block
steps: one warp factors and inverts the diagonal block in registers, the
other warps form the panel, the trailing update and X's off-diagonal
blocks (288 threads at T = 128, 96 at 64, 32 at 32).
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.kernels import chol_inv_batch, check_pool

# tile sizes K7 and K8 are built for
_KERNEL_T = (32, 64, 128)


def _index(diag, device) -> torch.Tensor:
    """The diagonal index as a contiguous int64 tensor on ``device`` (the
    reference's table is a host int32 array)."""
    if isinstance(diag, np.ndarray):
        diag = torch.as_tensor(diag.astype(np.int64), device=device)
    if diag.dim() != 1 or diag.dtype not in (torch.int32, torch.int64):
        raise ValueError("diag must be a 1-d integer index")
    if diag.device != device:
        raise ValueError("diag must lie on the pool's device")
    return diag.to(torch.int64).contiguous()


def _check_t(T: int) -> None:
    if T not in _KERNEL_T:
        raise ValueError(f"K7/K8 are built for T in {_KERNEL_T}, got T={T}")


def chol_inv_pool(pool: torch.Tensor, diag) -> torch.Tensor:
    """Factor the tiles ``pool[diag]`` in place and return their inverses.

    Each tile's lower triangle is read (the upper holds scatter garbage
    and is ignored) and the tile becomes its lower Cholesky factor L_k,
    zeros above.  Returns ``dinv`` (len(diag), T, T), ``dinv[k] = L_k⁻¹``
    in ``diag`` order.  Entries outside [0, npool) are the reference's
    padding: no tile is read or written and ``dinv[k]`` is zero.  The
    entries must be distinct.  A tile that is not positive definite turns
    NaN.

    On a CUDA device: one launch of K7, a CTA a tile (T in {32, 64,
    128}; another T raises).  On the CPU: :func:`chol_inv_pool_ref`."""
    check_pool(pool)
    diag = _index(diag, pool.device)
    if pool.device.type == "cpu":
        return chol_inv_pool_ref(pool, diag)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    npool, T = pool.shape[0], pool.shape[1]
    _check_t(T)
    B = diag.numel()
    dinv = torch.empty((B, T, T), dtype=pool.dtype, device=pool.device)
    err = _build.get_lib().pastix_chol_inv(
        pool.data_ptr(), diag.data_ptr(), npool, pool.data_ptr(),
        dinv.data_ptr(), B, T, _build.stream_ptr(pool.device))
    _build.check(err, "chol_inv_pool")
    chol_inv_pool.launches += 1
    return dinv


chol_inv_pool.launches = 0  # K7 launches (one per call)
chol_inv_pool.twin_launches = 0  # calls of the plain twin


def chol_inv_pool_ref(pool: torch.Tensor, diag) -> torch.Tensor:
    """Plain PyTorch twin of :func:`chol_inv_pool`, on any device."""
    check_pool(pool)
    diag = _index(diag, pool.device)
    chol_inv_pool.twin_launches += 1
    npool, T = pool.shape[0], pool.shape[1]
    keep = (diag >= 0) & (diag < npool)
    idx = diag[keep]
    L, X = chol_inv_batch(pool[idx])
    pool[idx] = L
    dinv = torch.zeros((diag.numel(), T, T), dtype=pool.dtype,
                       device=pool.device)
    dinv[keep] = X
    return dinv


def _check_tiles(tiles: torch.Tensor) -> None:
    if tiles.dtype != torch.float32 or tiles.dim() != 3 or not (
        tiles.is_contiguous() and tiles.shape[1] == tiles.shape[2]
    ):
        raise ValueError(
            "tiles must be a contiguous float32 (B, T, T) tensor, got "
            f"{tiles.dtype} {tuple(tiles.shape)}")


def chol_inv(tiles: torch.Tensor):
    """(L, X) of a batch of symmetric positive definite (B, T, T) tiles:
    L the lower Cholesky factor of each, X = L⁻¹, both lower triangular
    with zeros above.  The tiles are full symmetric, as the reference's
    B5 takes them; the lower triangle is what is read.

    On a CUDA device: one launch of K8, a CTA a tile (T in {32, 64,
    128}).  On the CPU: :func:`chol_inv_ref`."""
    _check_tiles(tiles)
    if tiles.device.type == "cpu":
        return chol_inv_ref(tiles)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    B, T = tiles.shape[0], tiles.shape[1]
    _check_t(T)
    L = torch.empty_like(tiles)
    X = torch.empty_like(tiles)
    err = _build.get_lib().pastix_chol_inv(
        tiles.data_ptr(), None, 0, L.data_ptr(), X.data_ptr(), B, T,
        _build.stream_ptr(tiles.device))
    _build.check(err, "chol_inv")
    chol_inv.launches += 1
    return L, X


chol_inv.launches = 0  # K8 launches (one per call)
chol_inv.twin_launches = 0  # calls of the plain twin


def chol_inv_ref(tiles: torch.Tensor):
    """Plain PyTorch twin of :func:`chol_inv`, on any device."""
    _check_tiles(tiles)
    chol_inv.twin_launches += 1
    return chol_inv_batch(tiles)
