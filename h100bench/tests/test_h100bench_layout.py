"""The harness finds a cell, its configuration, its driver and its
per-layer metrics by name, so that later ones are new files and entries;
and a run's result line keeps to the contract's shape."""

from __future__ import annotations

import json
import sys

import pytest

from h100bench import harness as H
from h100bench import tracing as T


def test_a_dropped_in_cell_config_and_metric_are_found(tmp_path):
    from conftest import make_tiny

    root = make_tiny(tmp_path)
    bench_file = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    conf = json.loads((root / "configs/tiny_flagship.json").read_text())
    conf["name"] = "other_flagship"
    (root / "configs/other_flagship.json").write_text(json.dumps(conf))
    wl = json.loads((root / "workloads/tiny-train.json").read_text())
    wl.update(name="other-train", config="other_flagship")
    (root / "workloads/other-train.json").write_text(json.dumps(wl))
    (root / "metrics/steps_seen.py").write_text(
        "def read(run):\n    return run['counters'].get('steps')\n")
    bench["workloads"].append({"name": "other-train",
                               "config": "other_flagship",
                               "traffic": "train_epochs", "chips": 1,
                               "why": "added"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "device",
                               "moves": "train_examples_per_s",
                               "workloads": ["other-train"]})
    for m in bench["end_to_end"]:
        if "tiny-train" in m.get("workloads", ()):
            m["workloads"].append("other-train")
    bench_file.write_text(json.dumps(bench))

    cell = H.find_cell("other-train", root)
    assert cell.config["name"] == "other_flagship"
    assert cell.driver.__name__.endswith("train")
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "train_examples_per_s"}
    reader = H.metric_reader("steps_seen", root)
    assert reader.read({"counters": {"steps": 7}}) == 7


def test_an_unknown_cell_stops_the_run(tiny_root):
    with pytest.raises(SystemExit):
        H.find_cell("no-such-cell", tiny_root)


def test_the_result_line_puts_the_checks_last(tiny_root):
    cell = H.find_cell("tiny-eval", tiny_root)
    ctx = H.Context(cell=cell, seed=1, seconds=1.0, trace=False,
                    device="cpu", clock=H.SetupClock(), root=tiny_root)
    res = H.DriverResult(
        e2e={"eval_users_per_s": 2.0}, counters={},
        checks={"score_gap": H.Check(float("inf"), 1e-3),
                "metric_gap": H.Check(0.0, 0.0)},
        attempted=10, failed=0, memory_peak_bytes=5, setup_s=1.5)
    out = H.result_line(ctx, res, {"platform": "gpu", "kind": "x",
                                   "count": 1})
    assert list(out)[-1] == "checks"
    assert out["correct"] is False
    assert out["checks"]["score_gap"]["value"] == H.FAILED_VALUE
    assert set(out["metrics"]) == {"setup_s", "eval_users_per_s"}
    json.dumps(out, allow_nan=False)


def test_per_layer_metrics_read_the_trace_and_counters(tiny_root):
    cell = H.find_cell("tiny-train", tiny_root)
    ctx = H.Context(cell=cell, seed=1, seconds=1.0, trace=True,
                    device="cpu", clock=H.SetupClock(), root=tiny_root)
    tr = T.TraceSummary(window_s=2.0, busy_s=1.5,
                        ops={"triton_poi__adamw_kernel_0d1": 0.3,
                             "sm90_gemm": 1.2},
                        idle={"bench.epoch": 0.5})
    res = H.DriverResult(
        e2e={}, counters={"steps": 100, "window_s": 2.0, "params": 1000,
                          "flops_per_step": 1e12},
        checks={}, attempted=100, failed=0, memory_peak_bytes=0,
        setup_s=1.0, trace=tr)
    out = H.result_line(ctx, res, {"platform": "gpu", "kind": "x",
                                   "count": 1})
    m = out["metrics"]
    assert m["device_idle.train"]["value"] == pytest.approx(25.0)
    assert m["train_mfu"]["value"] == pytest.approx(
        100 * 1e12 * 100 / 2.0 / 495e12)
    assert m["k1_adamw_roofline"]["value"] == pytest.approx(
        100 * (20 * 1000 / 3.35e12) / (0.3 / 100))
    assert out["device"]["busy_s"] == 1.5
    assert out["breakdown"]["idle_gaps"] == [["bench.epoch", 0.5]]


def test_a_reader_with_nothing_to_read_is_silent(tiny_root):
    for name in ("train_mfu", "k1_adamw_roofline", "device_idle.train",
                 "device_idle.eval"):
        assert H.metric_reader(name, tiny_root).read(
            {"trace": None, "counters": {}}) is None
    empty = T.TraceSummary(window_s=1.0, busy_s=0.0)
    assert H.metric_reader("k1_adamw_roofline", tiny_root).read(
        {"trace": empty, "counters": {"steps": 3, "params": 5}}) is None


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert H.forbidden_modules() == []
    for harmless in ("jaxtyping", "gdmcf_torch_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, harmless, object())
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gdmcf_tpu.ops.spmm", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert H.forbidden_modules() == ["gdmcf_tpu", "jax"]


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_trace_reduction_busy_ops_and_named_gaps():
    ev = [_Ev("bench.window", False, 0, 1000),
          _Ev("bench.dispatch", False, 100, 400),
          _Ev("gemm", True, 150, 100), _Ev("gemm", True, 200, 100),
          _Ev("sort", True, 400, 50), _Ev("late", True, 1500, 10),
          # the profiler's device-side copy of a host span is no activity
          _Ev("bench.dispatch", True, 100, 400)]
    s = T.reduce(ev)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(200e-9)
    assert s.ops == pytest.approx({"gemm": 200e-9, "sort": 50e-9})
    # gaps: [0,150) outside, [300,400) in the dispatch, [450,1000) outside
    assert s.idle[T.OUTSIDE] == pytest.approx(150e-9 + 550e-9)
    assert s.idle["bench.dispatch"] == pytest.approx(100e-9)
    assert T.reduce([_Ev("gemm", True, 0, 5)]) is None
