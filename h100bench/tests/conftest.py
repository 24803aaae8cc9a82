"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
with a tiny configuration and cells beside the real ones, so that a whole
run goes through on the CPU in seconds.

Run: ``python -m pytest h100bench/tests -q`` from the repository's root
(the repository's own ``pytest tests/`` does not collect these). Tests
that need the card carry the ``gpu`` marker and skip without one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# 12 batches an epoch: one fused group of 8 and 4 single steps
TINY = {"n_user": 96, "n_item": 300, "edges": 2400, "dims": [32],
        "batch": 8}


def make_tiny(dst: Path) -> Path:
    """A copy of ``h100bench``'s cell files under ``dst`` with the tiny
    configuration ``tiny_flagship`` and the cells ``tiny-train`` and
    ``tiny-eval`` added; returns the copy's benchmark folder."""
    bench_dir = dst / "h100bench"
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(REPO / "h100bench" / sub, bench_dir / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads(
        (REPO / "h100bench/configs/amazon_flagship.json").read_text())
    conf.update(name="tiny_flagship", n_user=TINY["n_user"],
                n_item=TINY["n_item"],
                graph={"kind": "power_law", "n_edges": TINY["edges"]})
    conf["recipe"].update(dims=TINY["dims"], batch_size=TINY["batch"],
                          lr=1e-3)
    (bench_dir / "configs/tiny_flagship.json").write_text(json.dumps(conf))
    cells = {
        "tiny-train": json.loads(
            (REPO / "h100bench/workloads/amazon-train.json").read_text()),
        "tiny-eval": json.loads(
            (REPO / "h100bench/workloads/amazon-eval.json").read_text())}
    for name, w in cells.items():
        w = dict(w, name=name, config="tiny_flagship")
        if w["driver"] == "eval_streaming":
            w["traffic"] = dict(w["traffic"], judge_users=24,
                                judge_longest=4, judge_block=8)
        (bench_dir / f"workloads/{name}.json").write_text(json.dumps(w))
        bench["workloads"].append({"name": name, "config": "tiny_flagship",
                                   "traffic": w["traffic"]["name"],
                                   "chips": 1, "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for src, name in (("amazon-train", "tiny-train"),
                          ("amazon-eval", "tiny-eval")):
            if src in m.get("workloads", ()):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """The CUDA device, or a skip without one (decided here, never while a
    module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
