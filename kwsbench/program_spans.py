"""The program's own spans laid over a traced window's device intervals.

The port records spans inside its entry points while a profiler runs
(``multilingual_kws_tpu_torch.utils.profiling``: ``recorded()``, each span
with its name, start and end on the profiler's clock, its parent and the
id of its call's root span, and its counts). Here they are cut to the
harness's calls (``Summary.host_spans``, on the same clock), and each
instant of a call at which the device is idle (the complement of the union
of ``Summary``'s device intervals) is given to the innermost program span
the host was in: a ``*.wait`` span (the host waiting on the device, so the
gap is the device's own) or any other (host work). A program without the
recorder, or a window without a trace, gives None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import numpy as np

WAIT = ".wait"


class Cut(NamedTuple):
    """A program span cut to the harness call it lies in (ns)."""

    name: str
    start: int
    end: int
    id: int
    parent: Optional[int]
    call: int
    counts: Dict[str, int]


def recorded():
    """The port's recorded spans, or None where the port has no recorder
    or recorded nothing."""
    try:
        from multilingual_kws_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return (read() or None) if read is not None else None


class Attribution:
    """The program spans of a traced window and the device's idle time
    under them.

    ``spans``: the program spans cut to the harness's calls, in start order.
    ``idle_by_name``: ns of device idle whose innermost program span has
    that name. ``wall(name, root)``: the summed walls (ns) of the spans
    named ``name`` whose call's root is named ``root``. ``roots(name)``: the
    root spans of that name."""

    def __init__(self, trace, spans):
        calls = sorted((a, b) for a, b, _ in trace.host_spans)
        self.spans: List[Cut] = []
        for s in spans:
            for a, b in calls:
                lo, hi = max(a, s.start_ns), min(b, s.end_ns)
                if lo < hi:
                    self.spans.append(Cut(s.name, lo, hi, s.id, s.parent, s.call, dict(s.counts)))
                    break
        self.spans.sort(key=lambda s: (s.start, -s.end))
        self._busy = _busy_union(trace.start, trace.end)
        self.idle_by_name: Dict[str, int] = defaultdict(int)
        names, lo, hi = _innermost(self.spans)
        if names:
            idle = (hi - lo) - (self._busy_to(hi) - self._busy_to(lo))
            for n, t in zip(names, idle.tolist()):
                self.idle_by_name[n] += int(t)
        self._root_name = {s.id: s.name for s in self.spans if s.parent is None}

    def _busy_to(self, t: np.ndarray) -> np.ndarray:
        """Device-busy ns of the union up to each time in ``t``."""
        starts, ends, before = self._busy
        if not len(starts):
            return np.zeros_like(t)
        k = np.searchsorted(starts, t, side="right") - 1
        kc = np.clip(k, 0, None)
        within = np.clip(t - starts[kc], 0, ends[kc] - starts[kc])
        return np.where(k >= 0, before[kc] + within, 0)

    def idle_ns(self, waiting: bool) -> int:
        """Device-idle ns under ``*.wait`` spans (``waiting``) or under the
        others."""
        return sum(t for n, t in self.idle_by_name.items() if n.endswith(WAIT) == waiting)

    def roots(self, name: str) -> List[Cut]:
        return [s for s in self.spans if s.parent is None and s.name == name]

    def wall(self, name: str, root: Optional[str] = None) -> int:
        return sum(s.end - s.start for s in self.spans
                   if s.name == name and (root is None or self._root_name.get(s.call) == root))


def _busy_union(start: np.ndarray, end: np.ndarray):
    """The union of the device intervals (sorted by start) as (starts,
    ends, busy ns before each)."""
    if not len(start):
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, empty
    run_end = np.maximum.accumulate(end)
    first = np.ones(len(start), dtype=bool)
    first[1:] = start[1:] > run_end[:-1]
    idx = np.nonzero(first)[0]
    starts = start[idx]
    ends = run_end[np.r_[idx[1:] - 1, len(start) - 1]]
    before = np.r_[0, np.cumsum(ends - starts)[:-1]].astype(np.int64)
    return starts, ends, before


def _innermost(spans: List[Cut]):
    """(names, starts, ends) of the stretches in which each span is the
    innermost one open (spans nested, sorted by start, longest first)."""
    names, lo, hi = [], [], []

    def emit(a, b, s):
        if b > a:
            names.append(s.name)
            lo.append(a)
            hi.append(b)

    stack: List[Cut] = []
    cursor = 0
    for s in spans:
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            emit(cursor, top.end, top)
            cursor = top.end
        if stack:
            emit(cursor, s.start, stack[-1])
        cursor = s.start
        stack.append(s)
    while stack:
        top = stack.pop()
        emit(cursor, top.end, top)
        cursor = top.end
    return names, np.array(lo, dtype=np.int64), np.array(hi, dtype=np.int64)


_LAST: list = []


def attribution(trace) -> Optional[Attribution]:
    """The window's ``Attribution`` (computed once a trace), or None without
    a trace or without program spans in the harness's calls."""
    if trace is None:
        return None
    if _LAST and _LAST[0] is trace:
        return _LAST[1]
    spans = recorded()
    found = Attribution(trace, spans) if spans else None
    if found is not None and not found.spans:
        found = None
    _LAST[:] = [trace, found]
    return found


def per_root(trace, names, root: str, scale: float, inside: bool = False) -> Optional[float]:
    """The summed walls of the spans ``names`` (those of ``root``'s calls
    alone where ``inside``) over the number of ``root`` calls, times
    ``scale`` (ns to the metric's unit); None without them."""
    found = attribution(trace)
    if found is None or not found.roots(root):
        return None
    wall = sum(found.wall(n, root if inside else None) for n in names)
    return wall / len(found.roots(root)) * scale


def idle_share(trace, waiting: bool) -> Optional[float]:
    """Device idle under ``*.wait`` spans (``waiting``) or under the other
    program spans, as a share of the traced window, %."""
    found = attribution(trace)
    if found is None or trace.window_s <= 0:
        return None
    return found.idle_ns(waiting) * 1e-9 / trace.window_s * 100.0
