"""The program's spans as the benchmark reads them: ``tracing.reduce`` reads
the same numbers with the program's host ranges as without; the span
table and the idle time named by span (``spans.reduce_events``) on a
nested example; each span reader's value on a hand-made tally, and
silence without one; and traced runs of the tiny cells that print them."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from h100bench import harness as H
from h100bench import spans as S
from h100bench import tracing as T


class _Ev:
    def __init__(self, name, dev, start, dur, thread=1):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._t = thread

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def start_thread_id(self):
        return self._t


def base_events():
    return [_Ev("bench.window", False, 0, 1000),
            _Ev("bench.eval_pass", False, 50, 900),
            _Ev("gemm", True, 150, 100), _Ev("gemm", True, 200, 100),
            _Ev("sort", True, 400, 50), _Ev("late", True, 1500, 10),
            _Ev("bench.eval_pass", True, 50, 900)]


def program_events():
    """Program spans of the window's thread: a group [100, 400) holding a
    feed [100, 150) and a replay [150, 300); assembles [300, 360) (inside
    the group's tail) and [460, 700); a span of another thread over the
    idle tail."""
    return [_Ev("gdmcf.eval.group", False, 100, 300),
            _Ev("gdmcf.graphs.eval.feed", False, 100, 50),
            _Ev("gdmcf.graphs.eval.replay", False, 150, 150),
            _Ev("gdmcf.eval.assemble", False, 300, 60),
            _Ev("gdmcf.eval.assemble", False, 460, 240),
            _Ev("gdmcf.other_thread", False, 450, 550, thread=2)]


def test_program_ranges_leave_the_trace_reduction_as_it_was():
    plain = T.reduce(base_events())
    with_spans = T.reduce(base_events() + program_events())
    assert with_spans == plain
    assert plain.busy_s == pytest.approx(200e-9)
    assert plain.idle == pytest.approx({"bench.eval_pass": 800e-9})


def test_span_table_self_times_and_idle_named_by_span():
    s = S.reduce_events(base_events() + program_events())
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(200e-9)
    group = s.spans["gdmcf.eval.group"]
    assert group[0] == 1
    assert group[1] == pytest.approx(300e-9)
    # less the feed, the replay and the first assemble inside it
    assert group[2] == pytest.approx((300 - 50 - 150 - 60) * 1e-9)
    asm = s.spans["gdmcf.eval.assemble"]
    assert asm[0] == 2 and asm[1] == pytest.approx(300e-9) == asm[2]
    # gaps: [0,150) mid 75 in no span; [300,400) mid 350 in the first
    # assemble (inside the group); [450,1000) mid 725 in no span of the
    # window's thread
    assert s.idle_spanned["gdmcf.eval.assemble"] == pytest.approx(100e-9)
    assert s.idle_spanned[S.OUTSIDE] == pytest.approx((150 + 550) * 1e-9)
    assert s.idle_spanned_share() == pytest.approx(10.0)
    assert S.reduce_events([_Ev("gemm", True, 0, 5)]) is None


def test_device_copies_of_host_ranges_are_no_activity():
    ev = base_events() + program_events() + [
        _Ev("gdmcf.eval.group", True, 100, 800)]
    assert S.reduce_events(ev).busy_s == pytest.approx(200e-9)


TALLY = {"gdmcf.prefetch.wait": (1905, 0.381, 0.381),
         "gdmcf.graphs.train.replay": (238, 0.5, 0.5),
         "gdmcf.eval.assemble": (272, 0.272, 0.272),
         "gdmcf.eval.ground_truth": (272, 0.136, 0.136),
         "gdmcf.eval.metrics": (272, 0.544, 0.5),
         "gdmcf.eval.group": (34, 1.7, 0.2),
         "gdmcf.graphs.eval.replay": (34, 0.3, 0.3)}
RECIPE = {"recipe": {"train_steps_per_call": 8, "eval_batches_per_call": 8}}


@pytest.mark.parametrize("name,want", [
    ("batch_wait_ms.train", 1e3 * 0.381 / 1904),
    ("graph_replay_share.train", 100.0),
    ("host_assembly_ms.eval", 1e3 * (0.272 + 0.136 + 0.5) / 272),
    ("group_dispatch_ms.eval", 1e3 * 1.7 / 34),
    ("graph_replay_share.eval", 100.0)])
def test_span_readers_read_the_tally(tiny_root, monkeypatch, name, want):
    reader = H.metric_reader(name, tiny_root)
    run = {"trace": None, "counters": {"steps": 1904}, "config": RECIPE}
    monkeypatch.setattr(S, "totals", lambda: dict(TALLY))
    assert reader.read(run) == pytest.approx(want)
    monkeypatch.setattr(S, "totals", lambda: None)   # a program without
    assert reader.read(run) is None
    monkeypatch.setattr(S, "totals", lambda: {})
    assert reader.read(run) is None


def test_the_program_keeps_its_span_tally():
    assert S.totals() is not None


@pytest.fixture
def bench_run_path(monkeypatch):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))


@pytest.mark.parametrize("cell,names", [
    ("tiny-train", ("batch_wait_ms.train", "graph_replay_share.train")),
    ("tiny-eval", ("host_assembly_ms.eval", "group_dispatch_ms.eval",
                   "graph_replay_share.eval"))])
def test_traced_tiny_runs_print_the_span_metrics(tiny_root, bench_run_path,
                                                 cell, names):
    import run as bench_run
    from gdmcf_torch.utils import profiling

    profiling.clear_span_totals()
    out = bench_run.run_cell(cell, 2 ** 31 + 11, 1.0, True, device="cpu",
                             root=tiny_root)
    json.dumps(out, allow_nan=False)
    got = out["metrics"]
    for n in names:
        assert n in got, n
    # no CUDA graphs on the CPU: every group runs its steps one by one
    share = [n for n in names if n.startswith("graph_replay_share")]
    assert got[share[0]]["value"] == 0.0
    assert all(got[n]["value"] > 0 for n in names if n not in share)
