"""The program's spans: what the per-layer metrics of source
``program_span`` read, and a traced run that names the device's idle time
by them.

``gdmcf_torch`` opens a span (``gdmcf_torch.utils.profiling.span``) at
each host boundary of its train and eval loops while a ``torch.profiler``
records, as the traced window's ``Tracer`` does: a host range in the
profiler's trace, named ``gdmcf.*``, and a count, time and self time in
the program's tally (``span_totals``). The ranges are host-only (no
device-side copy), so ``tracing.reduce`` reads the same ``busy_s``,
``ops`` and ``idle`` with them as without.

- ``totals()``: the tally, ``{name: (count, seconds, self seconds)}``, or
  None from a program that keeps none.
- ``reduce_events(events)``: from the profiler's events, the window's
  span table and its idle time by program span (``SpanSummary``).
- As a script, a traced run of a cell whose idle time is named by span::

      python3 h100bench/spans.py --workload <cell> --seed <n> --seconds <s>

  prints ``run.py --trace 1``'s result line, then one JSON line: the
  window's span table (``spans``: count, total and self seconds),
  ``idle_spanned`` (the device's idle seconds, each gap named by the
  innermost program span open at its middle on the window's thread, or
  ``OUTSIDE`` when none) and its sum's share of the window
  (``idle_spanned_share``, %), ``window_s`` and ``busy_s``.
"""

from __future__ import annotations

import bisect
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PREFIX = "gdmcf."
OUTSIDE = "host outside program spans"
WINDOW = "bench.window"


def totals() -> Optional[Dict[str, Tuple[int, float, float]]]:
    """The program's span tally, or None without one."""
    from gdmcf_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return None if read is None else read()


def count(t: Optional[dict], name: str) -> int:
    return t[name][0] if t and name in t else 0


@dataclass
class SpanSummary:
    window_s: float
    busy_s: float
    spans: Dict[str, List[float]] = field(default_factory=dict)
    idle_spanned: Dict[str, float] = field(default_factory=dict)

    def idle_spanned_share(self) -> float:
        """The share of the window (%) in which the device was idle while
        the host was inside a program span."""
        named = sum(v for k, v in self.idle_spanned.items() if k != OUTSIDE)
        return 100.0 * named / self.window_s if self.window_s else 0.0


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _thread(e) -> int:
    f = getattr(e, "start_thread_id", None)
    return int(f()) if f is not None else 0


def reduce_events(events) -> Optional[SpanSummary]:
    """The window's program spans and the device's idle time named by them,
    or None without a ``bench.window`` range. Device activity as
    ``tracing.reduce`` counts it; a device-side copy of a host range
    (``bench.*`` or ``gdmcf.*``) is no activity."""
    window, thread = None, 0
    device, spans = [], []
    for e in events:
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if on_device:
            if not name.startswith(("bench.", PREFIX)):
                device.append((start, end))
        elif name == WINDOW:
            window, thread = (start, end), _thread(e)
        elif name.startswith(PREFIX):
            spans.append((start, end, name, _thread(e)))
    if window is None:
        return None
    w0, w1 = window
    busy = []
    for a, b in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))

    # the window's spans, clipped to it; self time by the nesting on each
    # thread (a thread's ranges nest: each lies inside the one open before)
    table: Dict[str, List[float]] = {}
    inner: Dict[int, int] = {}
    clipped = sorted(((max(a, w0), min(b, w1), name, th)
                      for a, b, name, th in spans if min(b, w1) > max(a, w0)),
                     key=lambda s: (s[0], -s[1]))
    stacks: Dict[int, List[int]] = {}
    for i, (a, b, name, th) in enumerate(clipped):
        stack = stacks.setdefault(th, [])
        while stack and clipped[stack[-1]][1] <= a:
            stack.pop()
        if stack:
            inner[stack[-1]] = inner.get(stack[-1], 0) + (b - a)
        stack.append(i)
    for i, (a, b, name, _) in enumerate(clipped):
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (b - a) * 1e-9
        row[2] += (b - a - inner.get(i, 0)) * 1e-9

    # the innermost span at a gap's middle: the latest-starting one of the
    # window's thread that covers it
    mine = [s for s in clipped if s[3] == thread]
    starts = [s[0] for s in mine]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = OUTSIDE
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if mine[i][1] >= mid:
                name = mine[i][2]
                break
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return SpanSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                       spans=table, idle_spanned=idle)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "h100bench"))
    import run as bench_run

    from h100bench import tracing

    kept = []
    reduce = tracing.reduce

    def keep(events):
        kept.append(reduce_events(events))
        return reduce(events)

    tracing.reduce = keep
    try:
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", "1"])
    finally:
        tracing.reduce = reduce
    if rc or not kept or kept[0] is None:
        return rc or 1
    s = kept[0]
    out = {"workload": args.workload, "seed": args.seed,
           "window_s": s.window_s, "busy_s": s.busy_s,
           "idle_spanned_share": s.idle_spanned_share(),
           "idle_spanned": dict(sorted(s.idle_spanned.items(),
                                       key=lambda kv: -kv[1])),
           "spans": dict(sorted(s.spans.items()))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
