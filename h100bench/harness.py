"""What every run shares: finding a cell's files by name, set-up timing,
the checks on the device and on JAX, and the result line.

A cell is ``workloads/<cell>.json`` (its configuration, driver, traffic
and the limits of its checks); its configuration ``configs/<config>.json``;
its driver ``drivers/<driver>.py`` (``run(ctx) -> DriverResult``); each
per-layer metric ``metrics/<metric>.py`` (``read(run) -> float | None``).
``BENCHMARK.json`` at the root names which metrics a cell reports. Later
cells, configurations and metrics are new files and entries: nothing here
names one.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gdmcf_tpu")
FAILED_VALUE = 1e300


def process_start_wall() -> float:
    """Wall-clock time at which this process started (from /proc)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as fh:
        btime = next(int(line.split()[1]) for line in fh
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        name or "h100bench_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def find_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark rooted at ``root`` (the folder
    beside ``BENCHMARK.json``), by its files and ``BENCHMARK.json``'s
    entries."""
    bench = read_json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = read_json(root / "workloads" / f"{name}.json")
    config = read_json(root / "configs" / f"{workload['config']}.json")
    driver = load_module(root / "drivers" / f"{workload['driver']}.py")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, workload, config, driver, e2e, layer,
                int(entry["chips"]))


def metric_reader(name: str, root: Path = HERE) -> ModuleType:
    return load_module(root / "metrics" / f"{name}.py")


class SetupClock:
    """Set-up time by phase, from the process's start."""

    def __init__(self):
        self.start_wall = process_start_wall()
        self.phases: Dict[str, float] = {}
        self._last = time.time()
        self.phases["process start to harness"] = self._last - self.start_wall

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            now = time.time()
            self.phases[name] = self.phases.get(name, 0.0) + (now - t0)
            self._last = now

    def total(self) -> float:
        return time.time() - self.start_wall

    def line(self, total: float) -> str:
        """The set-up breakdown, with what no phase covered."""
        rest = total - sum(self.phases.values())
        return ("setup breakdown s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.phases.items())
            + f", outside these phases {rest:.3f}; total {total:.3f}")


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return (not math.isnan(self.value)) and self.value <= self.limit


@dataclass
class DriverResult:
    """What a driver hands back: the end-to-end metrics it measured (not
    ``setup_s``), the counters per-layer metrics read, the checks, the
    window's work, the peak memory and the trace."""

    e2e: Dict[str, float]
    counters: Dict[str, float]
    checks: Dict[str, Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    setup_s: float
    trace: object = None
    lines: List[str] = field(default_factory=list)


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    clock: SetupClock
    root: Path = HERE

    def limit(self, check: str) -> float:
        return float(self.cell.workload["checks"][check])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}


def power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def result_line(ctx: Context, res: DriverResult, device: dict) -> dict:
    """The contract's last line: the cell's end-to-end metrics (trace 0) or
    its per-layer metrics (trace 1), the device, and the checks last."""
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end}
    metrics = {}
    out = {"correct": all(c.ok for c in res.checks.values()),
           "attempted": int(res.attempted), "failed": int(res.failed)}
    if not ctx.trace:
        values = dict(res.e2e, setup_s=res.setup_s)
        for m in ctx.cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the cell's driver measured no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": units[m["name"]]}
    else:
        tr = res.trace
        run = {"trace": tr, "counters": res.counters, "cell": ctx.cell,
               "config": ctx.cell.config}
        for m in ctx.cell.per_layer:
            value = metric_reader(m["name"], ctx.root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if tr is not None:
            device = dict(device, busy_s=tr.busy_s, window_s=tr.window_s)
            out["breakdown"] = {"device_ops": tr.top(tr.ops),
                                "idle_gaps": tr.top(tr.idle)}
    out["metrics"] = metrics
    out["device"] = dict(device, memory_peak_bytes=int(res.memory_peak_bytes))
    # a check that found no number (a missing answer, a non-finite loss)
    # prints as FAILED_VALUE, which no limit passes
    out["checks"] = {k: {"value": c.value if math.isfinite(c.value)
                         else FAILED_VALUE, "limit": c.limit}
                     for k, c in res.checks.items()}
    return out
