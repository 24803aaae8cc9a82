"""The control of each cell, the reference computed one precision below
the configuration's (bfloat16 products), comes out not correct: at least
one of the cell's numbers lies above its limit. On the CPU at the tiny
size; on the card (``gpu``) at each cell's own size."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from h100bench import control

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _fails_a_limit(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in limits if k in readings)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-eval"])
def test_the_control_breaks_a_limit_at_the_tiny_size(cell, tiny_root):
    limits = json.loads(
        (tiny_root / f"workloads/{cell}.json").read_text())["checks"]
    got = control.readings(cell, 7, "cpu", tiny_root)
    for reading in got.values():   # the control and each planted fault
        assert _fails_a_limit(reading, limits), reading


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_breaks_a_limit_at_the_cells_size(cell, card):
    limits = json.loads(
        (REPO / f"h100bench/workloads/{cell}.json").read_text())["checks"]
    got = control.readings(cell, 3004, card)
    assert _fails_a_limit(got["control"], limits), got["control"]
