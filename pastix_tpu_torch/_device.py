"""Device resolution, precision pins and the card query.

The port runs on a CUDA card by default and never drops to the CPU on its
own: the CPU is used only when a caller asks for it (the tests do, to
hold the plain PyTorch twins against the JAX reference).
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pastix_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pin_precision() -> None:
    """Full fp32 for every float32 matmul the port leaves to PyTorch.

    Mapping to the reference: its fp32 matmuls run at
    ``lax.Precision.HIGH`` by default (3-pass bf16, about 1e-6 relative;
    ``pastix_tpu/numeric/kernels.py`` ``_PREC``) and its sweep dots at
    DEFAULT precision (one bf16 pass; ``sweep_kernels._precision``).  TF32
    keeps about three decimal digits, coarser than HIGH, so both TF32
    switches are off: the panel TRSM, the dense tail and the diagonal
    inverses run in true fp32, and the hand kernels accumulate in fp32
    without tensor-core rounding.  The port is therefore at least as
    exact as the reference; parity is held on the refined result.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_name_power() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
