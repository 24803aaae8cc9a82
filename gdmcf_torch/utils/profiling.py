"""Profiling hooks (the port's counterpart of the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome-trace file of the block's operators (and, on a GPU, its
  kernels and copies) to ``<logdir>/trace.json``; it yields the profiler,
  whose ``key_averages()`` tables the same events.
- ``StepTimer``: steady-state steps/s and examples/s with warmup discard.
- ``compiled_cost(fn, *args)``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` from the operators' shapes
  (the JAX function reads the compiler's estimate; PyTorch has no byte
  estimate, so only ``flops`` is reported).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


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


class StepTimer:
    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._count = 0
        self._t0: Optional[float] = None
        self._timed_steps = 0

    def tick(self) -> None:
        # the clock starts as the first tick after the warmup begins: the
        # check comes before the increment, so warmup=0 times from the
        # first tick (a check after it would never fire)
        if self._count == self.warmup and self._t0 is None:
            self._t0 = time.perf_counter()
        self._count += 1
        if self._count > self.warmup:
            self._timed_steps += 1

    def steps_per_s(self) -> float:
        if self._t0 is None or self._timed_steps == 0:
            return 0.0
        return self._timed_steps / (time.perf_counter() - self._t0)

    def examples_per_s(self, batch_size: int) -> float:
        return self.steps_per_s() * batch_size


def compiled_cost(fn, *args, **kwargs) -> dict:
    """``{"flops": n}``: the floating-point operations of ``fn(*args,
    **kwargs)`` (a product [m, k] x [k, n] counts 2 m n k), from one call
    run under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops()}
