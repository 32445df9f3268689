"""The harness's host spans and the device trace of a traced window.

``Spans`` records (name, start, end) on the host clock around the
harness's own calls into the program; under a trace each span is also a
``torch.profiler.record_function`` range, so the trace places it on the
device's timeline. ``Tracer`` runs ``torch.profiler`` (CPU and CUDA
activities) over the stretch a driver marks, and ``Summary`` reduces its
events: device busy time as the union of kernel, copy and set intervals,
device time by kernel name, and the idle gaps named by the harness span
the host was in.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

SPAN_PREFIX = "kwsbench."


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.traced:
            import torch

            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)


class Summary:
    """Device activity of one traced window: every device interval (kernels,
    copies, sets) with its name, and the harness's host spans."""

    def __init__(self, window_s: float, intervals: List[Tuple[int, int, str]],
                 host_spans: List[Tuple[int, int, str]]):
        self.window_s = window_s
        intervals = sorted(intervals)
        self.names = sorted({n for _, _, n in intervals})
        ids = {n: i for i, n in enumerate(self.names)}
        self.start = np.array([a for a, _, _ in intervals], dtype=np.int64)
        self.end = np.array([b for _, b, _ in intervals], dtype=np.int64)
        self.name_id = np.array([ids[n] for _, _, n in intervals], dtype=np.int64)
        self.busy_s = self.busy_between()
        self.host_spans = sorted(host_spans)

    def _merged(self, lo: int, hi: int):
        """The union of the intervals that start in [lo, hi)."""
        sel = (self.start >= lo) & (self.start < hi)
        merged: List[List[int]] = []
        for a, b in zip(self.start[sel].tolist(), self.end[sel].tolist()):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_between(self, lo: int = -(2**62), hi: int = 2**62) -> float:
        """Device seconds of the union of the intervals that start in [lo, hi)."""
        return sum(b - a for a, b in self._merged(lo, hi)) * 1e-9

    def ids_of(self, *fragments: str) -> np.ndarray:
        return np.array([i for i, n in enumerate(self.names) if any(f in n for f in fragments)], dtype=np.int64)

    def starts_of(self, *fragments: str) -> np.ndarray:
        """Start times (ns) of the intervals whose name holds a fragment."""
        return self.start[np.isin(self.name_id, self.ids_of(*fragments))]

    def kernel_s(self, *fragments: str, lo: int = -(2**62), hi: int = 2**62) -> Optional[float]:
        """Device seconds of the kernels whose name holds any fragment and
        that start in [lo, hi); None if none ran."""
        sel = np.isin(self.name_id, self.ids_of(*fragments)) & (self.start >= lo) & (self.start < hi)
        if not sel.any():
            return None
        return float((self.end[sel] - self.start[sel]).sum()) * 1e-9

    def breakdown(self) -> Dict:
        per = np.bincount(self.name_id, weights=(self.end - self.start).astype(np.float64),
                          minlength=len(self.names)) * 1e-9
        ops = sorted(zip(self.names, per.tolist()), key=lambda kv: -kv[1])[:10]
        merged = self._merged(-(2**62), 2**62)
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])), reverse=True)[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.span_over(lo, hi), g * 1e-9] for g, lo, hi in gaps]}

    def span_over(self, lo: int, hi: int) -> str:
        """The harness span the host spent most of [lo, hi) in."""
        best, name = 0, "outside the harness's spans"
        for a, b, n in self.host_spans:
            overlap = min(b, hi) - max(a, lo)
            if overlap > best:
                best, name = overlap, n
        return name


class Tracer:
    """``start()`` / ``stop()`` around the traced stretch; no-ops unless
    ``enabled``. ``summary`` is set by ``stop()``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[Summary] = None
        self._prof = None
        self._t0 = 0.0

    def start(self):
        if not self.enabled:
            return
        import torch

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if not self.enabled or self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        intervals, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            annotation = name.startswith(SPAN_PREFIX) or getattr(e, "is_user_annotation", lambda: False)()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not annotation:  # a host range mirrored on the device's timeline
                    intervals.append((start, end, name))
            elif name.startswith(SPAN_PREFIX):
                host.append((start, end, name[len(SPAN_PREFIX):]))
        self._prof = None
        self.summary = Summary(window_s, intervals, host)
