"""Kernel performance model (counterpart of ``pastix_tpu/perf.py``, the
reference's machine-model analog).

The reference ships polynomial timing models per platform
(``src/perf/src/perf.h``); here, as in the JAX package, the model is
measured: the three task bodies of the fp32 route are timed at the
layout's tile size on the device they run on, calibrated per (device
kind, T, dtype) into a linear model (a per-call overhead and a per-item
marginal cost) and cached on disk, and the model predicts a
factorization's time for the solve report (``report.predicted_fact_time``)
and the roofline summary.

The task bodies are those of the fp32 route: ``potrf`` the batched
Cholesky (``numeric.kernels.potrf_batch``), ``trsm`` the batched
triangular solve (``numeric.kernels.trsm_llt``) and ``gemm`` the batch's
pairs through kernel K3 (``numeric.pipelined.gemm_scatter_pipelined``;
its plain twin on the CPU and at tile sizes K3 is not built for), in
float32, on the solver's device.  On the card each body is timed by
CUDA events over ``_LOOP_K`` calls after a warm-up, on the CPU by
``time.perf_counter`` a call.  The cache is ``pastix_tpu_torch_perf.json``
under ``PASTIX_PERF_CACHE_DIR`` (default ``~/.cache``), keyed
``<kind>:<T>:<dtype>`` with ``<kind>`` the card's name
(``torch.cuda.get_device_name``) or ``cpu``; the JAX package's file is
never read or written.  A process parses the file again only when it
changed.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from pastix_tpu_torch.config import CARD_TILES


@dataclasses.dataclass
class KernelTiming:
    name: str
    batch: int
    T: int
    seconds: float
    flops: float

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9


_LOOP_K = 8  # calls a timed run


def _device(device=None) -> torch.device:
    """``device``; when None, the card when there is one, else the CPU
    (the device an entry point runs on by default)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")


def device_kind(device=None) -> str:
    """The cache key's device part: the card's name, or ``cpu``."""
    dev = _device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _time_fn(fn, device: torch.device) -> float:
    """Seconds a call of ``fn()`` after one warm-up call: on the card the
    best of 5 runs of ``_LOOP_K`` calls, by CUDA events (the device's
    time, not the enqueue); on the CPU the best of 2 calls, by
    ``time.perf_counter`` (there is no launch latency to average out,
    and a T=128 batch is slow there)."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        for _ in range(5):
            e0.record()
            for _ in range(_LOOP_K):
                fn()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3 / _LOOP_K)
    else:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


@functools.lru_cache(maxsize=64)
def measure_kernels(T: int, batch: int, dtype_str: str = "float32",
                    device=None):
    """Measured seconds of the three task bodies at (batch, T) on
    ``device`` (:func:`_device`): {name: KernelTiming}, cached per
    process (:func:`_time_fn`).  The bodies are the fp32 route's:
    ``dtype_str`` is float32 (K3 takes fp32 pools).  ``gemm`` is K3 on
    the card at the tile sizes it is built for (``CARD_TILES``), and its
    plain twin elsewhere: on the CPU, and on the card at another T,
    where a non-fp32 pool's factorization runs torch ops.  K3's launch
    counters are put back afterwards: they count the factorizations'
    launches, and a factorization's first prediction at a tile size runs
    this measurement."""
    from pastix_tpu_torch.numeric import kernels as K
    from pastix_tpu_torch.numeric.pipelined import (
        build_pipeline_schedule, gemm_scatter_pipelined,
        gemm_scatter_pipelined_ref, pipeline_plan,
    )

    if dtype_str != "float32":
        raise ValueError(f"dtype_str={dtype_str!r}: the cost model times the "
                         "fp32 route's bodies")
    dev = _device(device)
    rng = np.random.default_rng(0)
    spd = np.eye(T) * (T + 1) + rng.standard_normal((T, T))
    tiles = torch.as_tensor(np.broadcast_to(spd, (batch, T, T)).copy(),
                            dtype=torch.float32, device=dev)
    lower = torch.tril(tiles)
    panels = torch.as_tensor(rng.standard_normal((batch, T, T)),
                             dtype=torch.float32, device=dev)
    # the gemm's pool: a = b = tile i, the destination tile batch + i
    # (K3's schedule keeps destinations apart from operands)
    pool = torch.cat([panels, torch.zeros_like(panels)])
    ar = np.arange(batch)
    plan = pipeline_plan(build_pipeline_schedule(
        ar, ar, batch + ar, group=2, chunk=8192), dev)
    k3 = gemm_scatter_pipelined
    gemm = k3 if dev.type == "cuda" and T in CARD_TILES \
        else gemm_scatter_pipelined_ref
    counts = k3.launches, k3.twin_launches
    try:
        gemm_s = _time_fn(lambda: gemm(pool, plan), dev)
    finally:
        k3.launches, k3.twin_launches = counts
    return {
        "potrf": KernelTiming(
            "potrf", batch, T,
            _time_fn(lambda: K.potrf_batch(lower), dev),
            batch * T ** 3 / 3.0),
        "trsm": KernelTiming(
            "trsm", batch, T,
            _time_fn(lambda: K.trsm_llt(panels, lower), dev),
            batch * float(T) ** 3),
        "gemm": KernelTiming("gemm", batch, T, gemm_s,
                             batch * 2.0 * float(T) ** 3),
    }


_DISK_CACHE = os.path.join(
    os.path.expanduser(os.environ.get("PASTIX_PERF_CACHE_DIR", "~/.cache")),
    "pastix_tpu_torch_perf.json",
)


_MEMO: dict = {}  # the file's contents as last parsed, by path


def _load_disk() -> dict:
    """The cache file's contents, parsed again only when its size or
    modification time changed (a factorization reads it each time)."""
    try:
        st = os.stat(_DISK_CACHE)
    except OSError:
        return {}
    stamp = (st.st_ino, st.st_mtime_ns, st.st_size)
    memo = _MEMO.get(_DISK_CACHE)
    if memo is not None and memo[0] == stamp:
        return memo[1]
    try:
        with open(_DISK_CACHE) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {}
    _MEMO[_DISK_CACHE] = stamp, cache
    return cache


def _save_disk(key: str, entry: dict) -> None:
    """Add ``key`` to the file: read again, then written to a temporary
    name and renamed over it, so that processes calibrating at once each
    leave a whole file."""
    cache = dict(_load_disk())
    cache[key] = entry
    d = os.path.dirname(_DISK_CACHE)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".pastix_perf.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f)
        os.replace(tmp, _DISK_CACHE)
    except BaseException:
        os.unlink(tmp)
        raise


def calibrate(T: int, dtype_str: str = "float32", force: bool = False,
              device=None) -> dict:
    """Two-point calibration of the task bodies on ``device``
    (:func:`_device`): a per-call overhead and a per-item marginal in
    seconds for each, from batches of 256 and 1024 (T >= 128) or 4096,
    disk-cached per (device kind, T, dtype)."""
    dev = _device(device)
    key = f"{device_kind(dev)}:{T}:{dtype_str}"
    if not force:
        hit = _load_disk().get(key)
        if hit is not None:
            return hit
    lo, hi = 256, (1024 if T >= 128 else 4096)
    mlo = measure_kernels(T, lo, dtype_str, dev)
    mhi = measure_kernels(T, hi, dtype_str, dev)
    out = {}
    for name in ("potrf", "trsm", "gemm"):
        marg = (mhi[name].seconds - mlo[name].seconds) / (hi - lo)
        marg = max(marg, 1e-12)
        over = max(mlo[name].seconds - lo * marg, 0.0)
        out[name] = {"overhead_s": over, "marginal_s": marg}
    _save_disk(key, out)
    return out


def calibrated_thresholds(T: int, dtype_str: str = "float32",
                          waste_factor: float = 4.0, device=None) -> dict:
    """Unroll-vs-scan thresholds from the calibration (the reference's,
    without its TPU branch): a level is worth its own batch when its
    padded scan waste would cost more than ``waste_factor`` per-call
    overheads, clamped to [512, 8192] pairs and [128, 2048] diagonal
    tiles.  Nothing in the port reads them: it has no scanned levels
    (``numeric/grouping.py`` is not ported)."""
    cal = calibrate(T, dtype_str, device=device)
    g, p = cal["gemm"], cal["potrf"]
    unroll_gemm = int(np.clip(waste_factor * g["overhead_s"]
                              / g["marginal_s"], 512, 8192))
    unroll_diag = int(np.clip(waste_factor * p["overhead_s"]
                              / p["marginal_s"], 128, 2048))
    return {"unroll_gemm": unroll_gemm, "unroll_diag": unroll_diag}


def _level_counts(layout):
    for lv in layout.levels:
        yield (("potrf", lv.diag.size), ("trsm", lv.trsm_panel.size),
               ("gemm", lv.gemm_a.size))


def predict_fact_time(layout, dtype_str: str = "float32",
                      device=None) -> float:
    """Linear-model factorization time on ``device`` (:func:`_device`)
    from the cached calibration (the blend simulator analog): the sum
    over levels of overhead + count * marginal per task body."""
    cal = calibrate(layout.T, dtype_str, device=device)
    total = 0.0
    for counts in _level_counts(layout):
        for name, count in counts:
            if count:
                c = cal[name]
                total += c["overhead_s"] + count * c["marginal_s"]
    return total


def estimate_fact_time(layout, dtype_str: str = "float32",
                       device=None) -> float:
    """Predicted factorization time on ``device`` (:func:`_device`) from
    the bodies measured at each level's batch, rounded up to a power of
    two (at most 4096)."""
    dev = _device(device)
    total = 0.0
    for counts in _level_counts(layout):
        for name, count in counts:
            if count == 0:
                continue
            b = min(1 << max(0, int(np.ceil(np.log2(count)))), 4096)
            t = measure_kernels(layout.T, b, dtype_str, dev)[name]
            total += t.seconds * (count / t.batch)
    return total


def speed_of_light(layout, measured_seconds: float, peak_gflops: float,
                   kind: str = "llt") -> dict:
    """Roofline summary: achieved device rate vs hardware peak and vs the
    measured-kernel prediction."""
    padded = layout.padded_flops(kind)
    achieved = padded / measured_seconds / 1e9
    return {
        "padded_gflops": achieved,
        "peak_fraction": achieved / peak_gflops if peak_gflops else None,
        "predicted_seconds": None,  # fill via estimate_fact_time if wanted
        "measured_seconds": measured_seconds,
    }
