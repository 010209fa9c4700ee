"""Execution tracing (counterpart of ``pastix_tpu/trace.py``, the
reference's TRACE_SOPALIN analog).

  * :class:`Tracer`: phase spans dumped as Chrome trace-event JSON (open
    in ui.perfetto.dev or chrome://tracing), a copy of the reference's;
  * :func:`profile_device`: ``torch.profiler`` around a region, the CPU
    activity and, with a card, the CUDA activity (kernels by name), its
    Chrome trace written into a directory.

``Pastix(..., PastixConfig(trace=True))`` records its phases on a
``Tracer`` (``Pastix.tracer``; ``Pastix.dump_trace`` writes it).  A
phase's span ends after the device has finished its work.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class TraceEvent:
    name: str
    t0: float  # seconds since tracer epoch
    t1: float
    track: str = "host"
    args: dict = field(default_factory=dict)


class Tracer:
    """Collects phase/kernel spans; dumps perfetto-compatible JSON."""

    def __init__(self):
        self.epoch = time.perf_counter()
        self.events: list[TraceEvent] = []

    @contextlib.contextmanager
    def span(self, name: str, track: str = "host", **args):
        t0 = time.perf_counter() - self.epoch
        try:
            yield
        finally:
            t1 = time.perf_counter() - self.epoch
            self.events.append(TraceEvent(name, t0, t1, track, dict(args)))

    def record(self, name: str, t0: float, t1: float, track="host", **args):
        self.events.append(TraceEvent(name, t0, t1, track, dict(args)))

    def dump(self, path: str) -> None:
        """Write Chrome trace-event format (displayTimeUnit ms)."""
        tracks = {t: i + 1 for i, t in enumerate(
            dict.fromkeys(e.track for e in self.events)
        )}
        out = {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {
                    "name": e.name,
                    "ph": "X",
                    "ts": e.t0 * 1e6,
                    "dur": (e.t1 - e.t0) * 1e6,
                    "pid": 1,
                    "tid": tracks[e.track],
                    "args": e.args,
                }
                for e in self.events
            ]
            + [
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": tname},
                }
                for tname, tid in tracks.items()
            ],
        }
        with open(path, "w") as f:
            json.dump(out, f)

    def summary(self) -> str:
        lines = []
        for e in self.events:
            lines.append(
                f"{e.track:>8} {1e3 * e.t0:10.2f}ms +{1e3 * (e.t1 - e.t0):8.2f}ms  {e.name}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profile_device(logdir: str):
    """``torch.profiler`` over the ``with`` block: CPU activity, and CUDA
    activity when a card is present (the card is synchronised before the
    profile closes).  Yields the profiler (``key_averages()``); on exit
    its Chrome trace goes to ``logdir/trace.json`` (the reference's
    ``jax.profiler`` trace for TensorBoard/XProf)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
