"""Tracing and profiling hooks: the port's span recorder.

Counterpart of ``multilingual_kws_tpu/utils/profiling.py`` on
``torch.profiler`` (the reference has no profiling beyond timestamps around
jobs, SURVEY.md section 5):

- ``annotate(name)``: a span. With no profiler running
  (``torch.autograd._profiler_enabled()`` false) it costs one flag check and
  returns a shared no-op handle: no ``record_function``, no timestamp, no
  allocation. Under a profiler (``trace``, a ``torch.profiler.profile`` of
  the caller's, ``torch.autograd.profiler.emit_nvtx()``) it records
  ``Span(id, name, start_ns, end_ns, parent, call, counts)`` in memory,
  stamped with ``time.time_ns()`` (the clock of the profiler's events), and
  enters ``record_function(name)``, so the span shows in the Chrome trace
  and, under ``emit_nvtx()``, as an NVTX range. ``parent`` is the enclosing
  span's id (spans of one thread), ``call`` the id of the root span, which
  every span of one call of an entry point shares; the handle's
  ``count(**n)`` adds integer counts to the span.
- ``spanned(name, close_counts)``: a decorator that makes each call of a
  function the span ``name`` (an entry point's root span), with the counts
  ``close_counts()`` gives as the call returns.
- ``recorded()``: the finished spans kept in memory, in the order they
  started; ``clear()`` empties them. At most ``MAX_SPANS`` are kept; the
  spans beyond are counted in ``dropped()``.
- ``trace(log_dir)``: a ``torch.profiler`` trace (CPU, and CUDA on a card)
  written as a Chrome trace into ``log_dir`` (Perfetto or chrome://tracing);
  it clears the recorder on entry and on exit also writes the spans as
  ``<stem>.spans.jsonl`` beside the trace, one JSON object a span.
- ``PhaseTimer.phase(name)``: nested wall-clock phase timers, each phase
  also a span, with a report.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the recorder's cap; later spans are counted, not kept
MAX_SPANS = 1_000_000

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    counts: Dict[str, int]


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.dropped = 0
        self.next_id = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_REC = _Recorder()


class _Off:
    """The handle of a span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **n) -> None:
        pass


_OFF = _Off()


class _On:
    """The handle of a span under a profiler."""

    __slots__ = ("name", "id", "parent", "call", "counts", "start_ns", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        stack = _REC.stack()
        with _REC.lock:
            self.id = _REC.next_id
            _REC.next_id += 1
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        span = Span(self.id, self.name, self.start_ns, end_ns, self.parent, self.call, self.counts)
        with _REC.lock:
            if len(_REC.spans) < MAX_SPANS:
                _REC.spans.append(span)
            else:
                _REC.dropped += 1
        return False

    def count(self, **n: int) -> None:
        for k, v in n.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)


def annotate(name: str):
    """A span named ``name``: ``with annotate("engine.predict") as span:
    ... span.count(batches=1)``. Recorded only while a profiler runs."""
    if not _profiler_enabled():
        return _OFF
    return _On(name)


def spanned(name: str, close_counts: Optional[Callable[[], Dict[str, int]]] = None):
    """Decorator: each call of the function is the span ``name``, and
    ``close_counts()`` is added to its counts as the call returns, after
    the function's locals are gone."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _profiler_enabled():
                return fn(*args, **kw)
            with _On(name) as span:
                try:
                    return fn(*args, **kw)
                finally:
                    if close_counts is not None:
                        span.count(**close_counts())

        return call

    return wrap


def recorded() -> List[Span]:
    """The finished spans kept in memory, in the order they started."""
    with _REC.lock:
        spans = list(_REC.spans)
    return sorted(spans, key=lambda s: s.id)


def dropped() -> int:
    """Spans not kept since the last ``clear()``: the recorder was full."""
    return _REC.dropped


def clear() -> None:
    """Forget the kept spans and the count of dropped ones."""
    with _REC.lock:
        _REC.spans.clear()
        _REC.dropped = 0


def _write_spans(path) -> Path:
    """The kept spans as JSON lines at ``path``."""
    path = Path(path)
    with open(path, "w") as fh:
        for s in recorded():
            fh.write(json.dumps(s._asdict()) + "\n")
    return path


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
    trace, ``<pid>.<ns>.pt.trace.json`` in ``log_dir``, and its spans as
    ``<pid>.<ns>.spans.jsonl``; yields the trace's path."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{os.getpid()}.{time.time_ns()}"
    path = log_dir / f"{stem}.pt.trace.json"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    clear()
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    _write_spans(log_dir / f"{stem}.spans.jsonl")
