"""BENCHMARK.json against the benchmark's contract, and every file it names
found where the harness looks for it."""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_keep_to_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert _line(c["source"]) and _line(c["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    for group in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got))
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        # the harness reports a per-layer metric in the cells it names
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in mine
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_files_are_found_by_name():
    for c in BENCH["configs"]:
        f = REPO / c["file"]
        assert f.is_file() and c["file"].startswith("h100bench/")
        conf = json.loads(f.read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    used = set()
    for w in BENCH["workloads"]:
        wl = json.loads(
            (REPO / f"h100bench/workloads/{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert wl["traffic"]["name"] == w["traffic"]
        assert (REPO / f"h100bench/drivers/{wl['driver']}.py").is_file()
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert (REPO / f"h100bench/metrics/{m['name']}.py").is_file()


def test_parameter_counts_follow_from_the_shapes():
    from h100bench.reference import flagship as R

    for c in BENCH["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        shapes = R.param_shapes(conf["n_user"], conf["n_item"],
                                conf["recipe"]["dims"][-1],
                                conf["recipe"]["emb_size"])
        assert R.n_params(shapes) == conf["params"]


def test_a_full_check_fits_its_time_with_24_cells():
    rs = BENCH["run_seconds"]
    total = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_workload_sets_every_check_limit(w):
    wl = json.loads((REPO / f"h100bench/workloads/{w}.json").read_text())
    checks = {"train": {"loss_gap", "grad_gap", "change_gap",
                        "replay_loss_gap", "replay_change_gap"},
              "eval_streaming": {"metric_gap", "score_gap"}}[wl["driver"]]
    assert set(wl["checks"]) == checks
    assert all(math.isfinite(v) and v >= 0 for v in wl["checks"].values())
