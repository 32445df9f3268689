"""Tracing and profiling hooks.

Counterpart of ``multilingual_kws_tpu/utils/profiling.py`` on
``torch.profiler`` (the reference has no profiling beyond timestamps around
jobs, SURVEY.md section 5):

- ``PhaseTimer.phase(name)``: nested wall-clock phase timers, each phase
  also an annotation, with a report;
- ``trace(log_dir)``: a ``torch.profiler`` trace (CPU, and CUDA on a card)
  written as a Chrome trace into ``log_dir`` (Perfetto or chrome://tracing);
- ``annotate(name)``: a named range on the host timeline
  (``record_function``), and an NVTX range on a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class PhaseTimer:
    """Accumulating nested phase timers.

    Usage:
        timers = PhaseTimer()
        with timers.phase("train"):
            with timers.phase("train/step"):
                ...
        print(timers.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                              total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<34} {t:8.3f} {n:7d} {1000 * t / n:9.2f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k]} for k in self.totals}


@contextlib.contextmanager
def trace(log_dir) -> Iterator[Path]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA on
    a card, with the device's kernels and copies) and write it as a Chrome
    trace, ``<pid>.<ns>.pt.trace.json`` in ``log_dir``; yields that path."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: ``record_function`` (the profiler's host timeline)
    and, on a card, an NVTX range."""
    with record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


_GLOBAL = PhaseTimer()


def global_timer() -> PhaseTimer:
    return _GLOBAL
