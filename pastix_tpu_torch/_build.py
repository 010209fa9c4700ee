"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface for ``sm_90a``; ``ctypes`` loads it.  The library lands in
``pastix_tpu_torch/_build/``, named by a hash of the sources, and is built
at first use: the first kernel launch of a process pays the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_OUT = os.path.join(_HERE, "_build")
_SOURCES = ("ll_gemm_scatter.cu", "sweep.cu")
_HEADERS = ("common.cuh",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
build_seconds = 0.0  # wall time of this process's build (0: loaded as built)
build_log = ""  # nvcc's output of this process's build (ptxas register use)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _compile(so_path: str) -> None:
    global build_seconds, build_log
    os.makedirs(_OUT, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT)
    os.close(fd)
    cmd = [_nvcc(), *_FLAGS, "-o", tmp,
           *(os.path.join(_CSRC, s) for s in _SOURCES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, so_path)


def get_lib() -> ctypes.CDLL:
    """The kernel library, built from the sources on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = os.path.join(_OUT, f"libpastix_kernels_{_digest()}.so")
    if not os.path.exists(so_path):
        _compile(so_path)
    lib = ctypes.CDLL(so_path)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pastix_ll_gemm_scatter.argtypes = [P] * 8 + [L, I, I, I, P]
    lib.pastix_ll_gemm_scatter.restype = I
    lib.pastix_sweep_diag.argtypes = [P, P, P, L, I, I, I, P]
    lib.pastix_sweep_diag.restype = I
    lib.pastix_sweep_update.argtypes = [P] * 8 + [L, L, I, I, I, P]
    lib.pastix_sweep_update.restype = I
    lib.pastix_cuda_error.argtypes = [I]
    lib.pastix_cuda_error.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = get_lib().pastix_cuda_error(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
