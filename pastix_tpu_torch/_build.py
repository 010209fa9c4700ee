"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source to an object for ``sm_90a``, all sources at
once in parallel processes, and links them into one shared library with a
plain C interface; ``ctypes`` loads it.  The library lands in
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
_SOURCES = ("ll_gemm_scatter.cu", "sweep.cu", "pipelined_gemm_scatter.cu",
            "tile_factor.cu", "slab_gemm_scatter.cu", "chol_inv.cu",
            "segment_gemm_scatter.cu", "cache_gemm_scatter.cu",
            "dma_probe.cu")
_HEADERS = ("common.cuh", "segment_gemm.cuh", "mma_tile.cuh",
            "seg_mma.cuh")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    tmpdir = tempfile.mkdtemp(dir=_OUT)
    try:
        t0 = time.perf_counter()
        nvcc = _nvcc()
        objs = [os.path.join(tmpdir, s + ".o") for s in _SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *_FLAGS, "-c", "-o", o, os.path.join(_CSRC, s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(_SOURCES, objs)
        ]
        logs, failed = [], []
        for s, p in zip(_SOURCES, procs):
            try:
                out, _ = p.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                raise
            logs.append(f"--- {s}\n{out}")
            if p.returncode != 0:
                failed.append(s)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = os.path.join(tmpdir, "lib.so")
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True, timeout=300)
        build_log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, so_path)
        build_seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


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
    lib.pastix_ll_gemm_scatter.argtypes = [P] * 16 + [L, L, I, I, I, I, P]
    lib.pastix_ll_gemm_scatter.restype = I
    lib.pastix_sweep_run.argtypes = [P] * 10 + [L, L, I, I, I, I, I, P]
    lib.pastix_sweep_run.restype = I
    lib.pastix_pipelined_gemm_scatter.argtypes = [P] * 15 + [L, L, I, I, I,
                                                              I, P]
    lib.pastix_pipelined_gemm_scatter.restype = I
    lib.pastix_slab_gemm_scatter.argtypes = [P] * 9 + [L, I, I, P]
    lib.pastix_slab_gemm_scatter.restype = I
    lib.pastix_tile_factor.argtypes = [P] * 4 + [L, I, I, ctypes.c_float, P]
    lib.pastix_tile_factor.restype = I
    lib.pastix_chol_inv.argtypes = [P, P, L, P, P, L, I, P]
    lib.pastix_chol_inv.restype = I
    lib.pastix_segment_gemm_scatter.argtypes = [P] * 9 + [L, I, I, P]
    lib.pastix_segment_gemm_scatter.restype = I
    lib.pastix_mp_gemm_scatter.argtypes = [P] * 6 + [L, I, L, I, I, P]
    lib.pastix_mp_gemm_scatter.restype = I
    lib.pastix_dma_probe.argtypes = [P] * 3 + [I] * 5 + [L, I, I, P]
    lib.pastix_dma_probe.restype = I
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
