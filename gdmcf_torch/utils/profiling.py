"""Profiling hooks (the port's counterpart of the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome-trace file of the block's operators (and, on a GPU, its
  kernels and copies) to ``<logdir>/trace.json``; it yields the profiler,
  whose ``key_averages()`` tables the same events.
- ``span(name)``: a named range of host code (``with span("gdmcf.eval.group"):
  ...``), put at the boundaries of the train and eval host loops. It is off
  unless a ``torch.profiler`` is recording: then one flag read returns the
  shared no-op ``NO_SPAN``. While a profiler records, the span is a range
  of the host in the profiler's trace, beside the kernels and on their
  clock, and it adds its count, time and self time (its time less that of
  the spans it encloses on its thread) to ``span_totals()``. A profiler
  records the ranges of the thread that started it only;
  ``span_totals()`` holds every thread's. Spans sit on the host loops
  only, never inside a CUDA graph's captured body, whose replays run no
  host code.

  The range is ``torch._C._profiler._RecordFunctionFast``, an operator's
  kind of range (``cpu_op``), not ``torch.profiler.record_function``: the
  latter is a user annotation, which the profiler also copies onto the
  device's timeline from the first to the last kernel it launched, over
  the device's idle time between them, and which costs about ten times as
  much (18 against 1.8 us on the host of an H100).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"

NO_SPAN = contextlib.nullcontext()

_host_range = torch._C._profiler._RecordFunctionFast
_totals: Dict[str, List[int]] = {}   # name -> [count, total ns, self ns]
_totals_lock = threading.Lock()
_open = threading.local()            # .spans: this thread's open spans


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write ``<logdir>/trace.json`` when it ends (also
    when it raises). Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def span(name: str):
    """The range ``name`` of the host code in the ``with`` block: the
    shared ``NO_SPAN`` unless a ``torch.profiler`` is recording."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return NO_SPAN


class _Span:
    __slots__ = ("name", "_range", "_t0", "_inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "spans", None)
        if stack is None:
            stack = _open.spans = []
        self._range = _host_range(self.name)
        self._range.__enter__()
        self._inner = 0
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter_ns() - self._t0
        stack = _open.spans
        stack.pop()
        if stack:
            stack[-1]._inner += took
        with _totals_lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += took
            t[2] += took - self._inner
        self._range.__exit__(*exc)
        return False


def span_totals() -> Dict[str, Tuple[int, float, float]]:
    """``{name: (count, seconds, self seconds)}`` of the spans closed while
    a profiler recorded, since the process started or ``clear_span_totals``
    last ran."""
    with _totals_lock:
        return {k: (c, ns * 1e-9, self_ns * 1e-9)
                for k, (c, ns, self_ns) in _totals.items()}


def clear_span_totals() -> None:
    with _totals_lock:
        _totals.clear()
