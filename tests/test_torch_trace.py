"""Phase tracing of the port (``pastix_tpu_torch/trace.py`` and
``Pastix(trace=True)``) against the reference's ``tests/test_trace.py``,
on the CPU.

- A traced solve of laplacian_2d(10) records the reference's spans, in
  the reference's order, on the same matrix and configuration
  (``device_refine=False``: the reference gates its device refinement
  loop to the TPU, the port runs its own on every device, so with it on
  the port's solve converges in the device loop and records no
  ``refine`` span, as the reference's does on a TPU); the dumped Chrome
  trace holds them, every ``dur`` >= 0, and the ``numfact`` span lasts
  ``report.fact_time`` (to 1 ms).
- ``Tracer`` spans, records, summarises and dumps as the reference's
  does: the same recorded events give the same JSON.
- ``dump_trace`` without tracing raises ``ValueError``.
- ``profile_device`` on the CPU writes a Chrome trace with events.
"""

import json

import numpy as np
import pytest
import torch

import pastix_tpu
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import laplacian_2d as j_laplacian_2d
from pastix_tpu.trace import Tracer as JTracer

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.pastix import Pastix
from pastix_tpu_torch.trace import Tracer, profile_device

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

PHASES = ["order", "symbfact", "analyze", "numfact", "solve", "refine"]


def test_phase_trace_dump(tmp_path):
    A = laplacian_2d(10)
    b = A.to_scipy() @ np.ones(A.n)
    ref = pastix_tpu.Pastix(j_laplacian_2d(10), JPastixConfig(
        trace=True, device_refine=False))
    ref.solve(b)
    s = Pastix(A, PastixConfig(trace=True, device_refine=False),
               device="cpu")
    x = s.solve(b)
    assert np.abs(x - 1).max() < 1e-8
    p = str(tmp_path / "trace.json")
    s.dump_trace(p)
    d = json.load(open(p))
    spans = [e for e in d["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == [e.name for e in ref.tracer.events]
    assert [e["name"] for e in spans] == PHASES
    for e in d["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0
    numfact = spans[PHASES.index("numfact")]
    assert abs(numfact["dur"] / 1e6 - s.report.fact_time) <= 1e-3


def test_tracer_span_and_summary():
    t = Tracer()
    with t.span("work", track="kernels", size=7):
        pass
    assert len(t.events) == 1
    assert t.events[0].args == {"size": 7}
    assert "work" in t.summary()


def test_tracer_dumps_the_reference_json(tmp_path):
    """The same records in both tracers dump to the same JSON, track
    metadata included."""
    out = []
    for cls in (Tracer, JTracer):
        t = cls()
        t.record("numfact", 0.5, 1.25, track="phases", level=3)
        t.record("solve", 1.25, 1.5, track="phases")
        t.record("K1", 0.75, 1.0, track="kernels")
        p = tmp_path / f"{cls.__module__}.json"
        t.dump(str(p))
        out.append((json.loads(p.read_text()), t.summary()))
    assert out[0] == out[1]


def test_trace_disabled_raises():
    s = Pastix(laplacian_2d(6), device="cpu")
    with pytest.raises(ValueError, match="tracing not enabled"):
        s.dump_trace("trace.json")


def test_profile_device_writes_a_chrome_trace(tmp_path):
    A = poisson_3d(4)
    s = Pastix(A, PastixConfig(tile_size=16), device="cpu")
    s.analyze()
    with profile_device(str(tmp_path / "prof")) as prof:
        s.factorize()
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    d = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in d["traceEvents"]}
    assert "aten::bmm" in names or "aten::mm" in names
