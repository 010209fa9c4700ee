"""The port's cost model (``pastix_tpu_torch/perf.py``) against the
reference's ``tests/test_perf.py`` and ``pastix_tpu/perf.py``, on the
CPU.

- The reference's cases but its grouping one (``numeric/grouping.py`` is
  not ported): the measured bodies, the estimate and the roofline, the
  thresholds derived from a calibration, the prediction in the report.
- With the same fake calibration written into each package's patched
  ``_DISK_CACHE``, ``predict_fact_time`` of the port's layout equals the
  reference's on the same matrix to 1e-12 relative; ``speed_of_light``
  equals the reference's exactly (the same padded flops).
- The key names the device (``cpu``, or the card's name); the file is the
  port's own, never the reference's; processes calibrating at once each
  leave a whole file.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import pastix_tpu.perf as jperf
from pastix_tpu.analyze import build_layout as j_build_layout

from pastix_tpu_torch import perf
from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.pastix import Pastix
from pastix_tpu_torch.perf import (
    estimate_fact_time, measure_kernels, speed_of_light,
)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)


def _fake_cal(overhead, marginal):
    k = {"overhead_s": overhead, "marginal_s": marginal}
    return {"potrf": dict(k), "trsm": dict(k), "gemm": dict(k)}


def _cache(monkeypatch, tmp_path, module, entries):
    """``module``'s disk cache patched to a file of ``entries``."""
    cache = tmp_path / f"{module.__name__}.json"
    monkeypatch.setattr(module, "_DISK_CACHE", str(cache))
    cache.write_text(json.dumps(entries))
    return cache


def _analyzed(A, T):
    s = Pastix(A, PastixConfig(tile_size=T), device="cpu")
    s.analyze()
    return s


def test_measure_kernels_shapes_and_rates():
    t = measure_kernels(16, 8)
    assert set(t) == {"potrf", "trsm", "gemm"}
    for k in t.values():
        assert k.seconds > 0 and k.gflops > 0
    # cached: second call returns the same object
    assert measure_kernels(16, 8) is t


def test_estimate_and_roofline():
    s = _analyzed(laplacian_2d(12), 8)
    est = estimate_fact_time(s.layout)
    assert est > 0
    sol = speed_of_light(s.layout, measured_seconds=1.0, peak_gflops=100.0)
    assert sol["padded_gflops"] > 0
    assert 0 < sol["peak_fraction"] < 100


def test_calibrated_thresholds_follow_measurement(monkeypatch, tmp_path):
    """The unroll/scan cut is derived from the calibration, as the
    reference's (whose consumer, the grouping, is not ported)."""
    cache = _cache(monkeypatch, tmp_path, perf,
                   {"cpu:16:float32": _fake_cal(1e-3, 1e-6)})
    th = perf.calibrated_thresholds(16)
    assert th["unroll_gemm"] == 4000  # 4 x overhead/marginal
    assert th["unroll_diag"] == 2048  # clamped at the program-size cap

    cache.write_text(json.dumps({"cpu:16:float32": _fake_cal(1e-5, 1e-6)}))
    perf._MEMO.clear()  # a rewrite in place may keep size and time stamp
    th2 = perf.calibrated_thresholds(16)
    assert th2["unroll_gemm"] == 512  # clamped at the compile-cost floor
    assert th2["unroll_gemm"] < th["unroll_gemm"]


def test_predicted_vs_measured_in_report(monkeypatch, tmp_path):
    """Pastix.factorize reports the model's prediction next to the
    measured time; PASTIX_MEASURED_PLAN=0 turns it off."""
    _cache(monkeypatch, tmp_path, perf,
           {"cpu:8:float32": _fake_cal(1e-4, 1e-7)})
    s = Pastix(laplacian_2d(12), PastixConfig(tile_size=8), device="cpu")
    s.factorize()
    assert s.report.predicted_fact_time > 0
    assert s.report.predicted_fact_time == perf.predict_fact_time(s.layout)
    monkeypatch.setenv("PASTIX_MEASURED_PLAN", "0")
    s = Pastix(laplacian_2d(12), PastixConfig(tile_size=8), device="cpu")
    s.factorize()
    assert s.report.predicted_fact_time == 0.0


def test_prediction_and_roofline_match_reference(monkeypatch, tmp_path):
    """The same fake calibration in both packages' caches: the port's
    prediction on its layout of poisson_3d(8), T=16 (dense tail on, as
    ``Pastix.factorize`` predicts it) equals the reference's on the
    reference's layout of the same pattern; so does the roofline."""
    cal = _fake_cal(3e-5, 2e-7)
    cal["gemm"]["marginal_s"] = 5e-7
    _cache(monkeypatch, tmp_path, perf, {"cpu:16:float32": cal})
    _cache(monkeypatch, tmp_path, jperf, {"cpu:16:float32": cal})
    s = _analyzed(poisson_3d(8), 16)
    assert s._dense_tail is not None
    ref = j_build_layout(s._pat_perm_ext, 16,
                         densify_tail_frac=s.config.dense_tail_fill)
    got, want = perf.predict_fact_time(s.layout), jperf.predict_fact_time(ref)
    assert want > 0 and abs(got - want) <= 1e-12 * want
    for kind in ("llt", "lu"):
        assert speed_of_light(s.layout, 0.25, 1e3, kind) == \
            jperf.speed_of_light(ref, 0.25, 1e3, kind)


def test_cache_key_names_the_device(monkeypatch, tmp_path):
    """``calibrate`` keys its entry ``<device kind>:<T>:<dtype>``, the kind
    ``cpu`` or the card's name, in the port's own file."""
    assert os.path.basename(perf._DISK_CACHE) == "pastix_tpu_torch_perf.json"
    assert os.path.basename(jperf._DISK_CACHE) == "pastix_tpu_perf.json"
    cache = _cache(monkeypatch, tmp_path, perf, {})
    assert perf.device_kind() == perf.device_kind("cpu") == "cpu"
    cal = perf.calibrate(8, force=True)
    assert json.loads(cache.read_text()) == {"cpu:8:float32": cal}
    assert perf.calibrate(8) == cal  # read back
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert perf.device_kind("cuda:0") == "NVIDIA H100 80GB HBM3"


def test_cpu_solver_predicts_on_the_cpu(monkeypatch, tmp_path):
    """On a machine with a card (stubbed here: the card's calls fail), a
    solver asked for the CPU, at the CPU's tile size for 144 dofs (16,
    which K3 is not built for), factorizes and calibrates on the CPU,
    keyed ``cpu``; the card is not asked."""
    cache = _cache(monkeypatch, tmp_path, perf, {})

    def card(*args, **kwargs):
        raise AssertionError("the card was asked")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", card)
    monkeypatch.setattr(torch.cuda, "get_device_name", card)
    s = Pastix(laplacian_2d(12), PastixConfig(), device="cpu")
    s.factorize()
    assert s.layout.T == 16 and s.report.predicted_fact_time > 0
    assert set(json.loads(cache.read_text())) == {"cpu:16:float32"}
    assert s.report.predicted_fact_time == \
        perf.predict_fact_time(s.layout, device="cpu")


def test_concurrent_writers_leave_a_whole_file(monkeypatch, tmp_path):
    """Sixteen writers at once, with a short switch interval: the file
    always parses and holds only keys that were written (a key lost to a
    writer that read before it is calibrated again later), and no
    temporary file is left."""
    import sys

    cache = _cache(monkeypatch, tmp_path, perf, {})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=perf._save_disk,
                                    args=(f"k{i}", _fake_cal(i, 1.0)))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = json.loads(cache.read_text())
    assert got and set(got) <= {f"k{i}" for i in range(16)}
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".pastix")]
