"""The benchmark's copied generators draw what their originals draw."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from h100bench import data as D

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` loaded as a module (its top level defines
    functions and constants only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_orig",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_power_law_graph_is_chip_smokes_draw(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "N_USER", 120)
    monkeypatch.setattr(smoke, "N_ITEM", 90)
    monkeypatch.setattr(smoke, "N_EDGES", 2000)
    for seed in (0, 3, 2 ** 31 + 11):
        want = smoke.power_law_graph(seed)
        got = D.power_law_graph(seed, 120, 90, 2000)
        assert (want != got).nnz == 0 and want.shape == got.shape


def test_amazon_splits_are_chip_smokes(smoke):
    g = D.power_law_graph(1, 80, 60, 900)
    for want, got in zip(smoke.amazon_splits(g, 4), D.amazon_splits(g, 4)):
        assert (want != got).nnz == 0


def test_graph_is_canonical_and_the_seeds():
    spec = {"kind": "power_law", "n_edges": 900}
    a = D.graph(spec, 80, 60, 7)
    assert a.has_sorted_indices and (a.data == 1).all()
    assert (a != D.graph(spec, 80, 60, 7)).nnz == 0
    assert (a != D.graph(spec, 80, 60, 8)).nnz > 0
