"""The traced run's profile and its reduction to device numbers.

``Tracer`` wraps the measured window in ``torch.profiler`` (CPU and CUDA
activities; nothing written to disk) and a ``bench.window`` span. Reduced
from the profiler's events:

- ``window_s``: the length of the ``bench.window`` span;
- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets; not the device-side copies of the host's ``bench.*``
  spans, which the profiler also puts on the device's timeline) inside
  the window;
- ``ops``: device seconds by operation name, inside the window;
- ``idle``: the idle gaps of the device inside the window, each named by
  the innermost ``bench.*`` span the host was in at the gap's middle (any
  thread; ``host outside bench spans`` when none), summed by name.

``span(name)`` is the benchmark's own ``record_function`` around its calls
into a layer; the program itself carries no spans yet.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
OUTSIDE = "host outside bench spans"


def span(name: str):
    from torch.profiler import record_function

    return record_function(name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: Dict[str, float] = field(default_factory=dict)
    idle: Dict[str, float] = field(default_factory=dict)

    def top(self, table: Dict[str, float], n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(table.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def op_seconds(self, needle: str) -> Tuple[float, int]:
        """(device seconds, names matched) of operations whose name holds
        ``needle``."""
        hits = [v for k, v in self.ops.items() if needle in k]
        return sum(hits), len(hits)


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events) -> Optional[TraceSummary]:
    """A ``TraceSummary`` of the profiler's events, or None without a
    ``bench.window`` span."""
    window = None
    spans = []        # (start, end, name) of bench.* spans
    device = []       # (start, end, name)
    for e in events:
        name = e.name()
        if _is_device(e) and not name.startswith("bench."):
            start = _ns(e, "start")
            device.append((start, start + _ns(e, "duration"), name))
        elif name.startswith("bench.") and not _is_device(e):
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if name == WINDOW:
                window = (start, end)
            else:
                spans.append((start, end, name))
    if window is None:
        return None
    w0, w1 = window
    ops: Dict[str, float] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-9
    busy = _merge(clipped)
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))
    # innermost span at a point: the latest-starting span that covers it
    spans.sort()
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = OUTSIDE
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s0, s1, sname = spans[i]
            if s1 >= mid and (best is None or s0 > best):
                best, name = s0, sname
                break
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                        ops=ops, idle=idle)


class Tracer:
    """``with Tracer(on) as tr: ...`` profiles the block when ``on``;
    ``tr.summary`` is its ``TraceSummary`` after the block (None when
    off)."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[TraceSummary] = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(span(WINDOW))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if self.on and exc[0] is None:
            self.summary = reduce(
                self._prof.profiler.kineto_results.events())
        return False
