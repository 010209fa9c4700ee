"""Static-pivot factorization of the diagonal tiles: kernel K4.

LDLᵗ and LU factor each level's diagonal tiles without pivoting and clamp
tiny pivots (``pastix_tpu/numeric/kernels.py`` ``_clamp_pivot``,
``ldlt_inv_batch``, ``getrf_inv_batch``).  The reference runs these as
T-step ``lax.fori_loop``s; PyTorch has no call for them
(``torch.linalg.ldl_factor`` pivots, ``lu_factor_ex(pivot=False)`` does
not clamp), and a plain loop costs about 8 launches per step.

``tile_factor`` launches the hand-written CUDA kernel
(``csrc/tile_factor.cu``) for a pool on a CUDA device and its plain twin
``tile_factor_ref`` (``kernels.ldlt_batch`` / ``kernels.getrf_batch``)
for a pool on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu_torch import _build
from pastix_tpu_torch.numeric.kernels import check_pool, getrf_batch, ldlt_batch

# tile sizes K4 is built for
_KERNEL_T = (32, 64, 128)


def _f32(eps) -> float:
    """The clamp threshold as the reference holds it: a float32."""
    return float(np.float32(eps))


def tile_factor(pool: torch.Tensor, diag: torch.Tensor, eps, npiv, lu: bool):
    """Factor the tiles ``pool[diag]`` in place: LU (``lu``; each becomes
    the combined unit-L / U tile) or LDLᵗ of the symmetric tile whose
    lower triangle is stored (each becomes its unit lower L).  Pivots with
    ``|p| < eps`` are clamped to ``±eps``; their number is added to
    ``npiv``, a 0-d int32 tensor on the pool's device (no host sync).
    Returns the (B, T) pivots for LDLᵗ, None for LU.

    On a CUDA device: one launch of K4 (T in {32, 64, 128}; another T
    raises).  On the CPU: :func:`tile_factor_ref`."""
    check_pool(pool)
    if npiv.dtype != torch.int32 or npiv.dim() != 0 or npiv.device != pool.device:
        raise ValueError("npiv must be a 0-d int32 tensor on the pool's device")
    if pool.device.type == "cpu":
        return tile_factor_ref(pool, diag, eps, npiv, lu)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    T = pool.shape[1]
    if T not in _KERNEL_T:
        raise ValueError(f"K4 is built for T in {_KERNEL_T}, got T={T}")
    if diag.dtype != torch.int64 or diag.device != pool.device:
        raise ValueError("diag must be an int64 tensor on the pool's device")
    diag = diag.contiguous()
    B = diag.numel()
    d = None if lu else torch.empty((B, T), dtype=torch.float32,
                                    device=pool.device)
    lib = _build.get_lib()
    err = lib.pastix_tile_factor(
        pool.data_ptr(), diag.data_ptr(), None if lu else d.data_ptr(),
        npiv.data_ptr(), B, T, int(lu), _f32(eps),
        _build.stream_ptr(pool.device),
    )
    _build.check(err, "tile_factor")
    tile_factor.launches += 1
    return d


tile_factor.launches = 0  # K4 launches (one per call)
tile_factor.twin_launches = 0  # calls of the plain twin


def tile_factor_ref(pool: torch.Tensor, diag: torch.Tensor, eps, npiv,
                    lu: bool):
    """Plain PyTorch twin of :func:`tile_factor`, on any device: the
    batched T-step loops of ``kernels.getrf_batch`` / ``ldlt_batch``."""
    check_pool(pool)
    tile_factor.twin_launches += 1
    eps = _f32(eps)
    if lu:
        M, n = getrf_batch(pool[diag], eps)
        pool[diag] = M
        npiv += n
        return None
    L, d, n = ldlt_batch(pool[diag], eps)
    pool[diag] = L
    npiv += n
    return d
