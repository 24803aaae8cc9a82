"""The plain reference against the port at a tiny size on the CPU (this test
may import both; the reference imports nothing of the port), and whole
runs of the tiny cells, sound and with the timed path broken underneath:
each planted fault must make ``correct`` false."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench.reference import flagship as R
from h100bench.reference import judge

REPO = Path(__file__).resolve().parents[2]
N_USER, N_ITEM, DIM, BATCH = 64, 40, 16, 16


def test_the_reference_imports_nothing_of_the_program_or_jax():
    bad = ("gdmcf_torch", "gdmcf_tpu", "jax", "jaxlib", "flax")
    for f in (REPO / "h100bench/reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            assert not [n for n in names if n.split(".")[0] in bad], f


def test_nothing_in_the_benchmark_imports_jax():
    for f in (REPO / "h100bench").rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not [n for n in names if n.split(".")[0] in
                            ("jax", "jaxlib", "flax", "gdmcf_tpu")], f


def _port(seed):
    from gdmcf_torch.config import load_config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.train.trainer import Trainer
    from h100bench import data as D

    csr = D.graph({"kind": "power_law", "n_edges": 500}, N_USER, N_ITEM, 3)
    cfg = load_config(str(REPO / "configs/amazonOneEmbGcn.yaml"),
                      {"device": "cpu", "dims": [DIM],
                       "batch_size": BATCH, "train_steps_per_call": 2})
    tr = Trainer(cfg, N_USER, N_ITEM, device="cpu")
    with torch.no_grad():
        for k, p in tr.model.named_parameters():
            R.fill_leaf(p.data, seed, k)
    return tr, cfg, csr, NativeCSR.from_scipy(csr)


def test_reference_scores_equal_the_ports_eval_step():
    seed = 2 ** 33 + 1
    tr, cfg, csr, ncsr = _port(seed)
    users = np.arange(BATCH)
    packed = torch.from_numpy(ncsr.gather_packed(users))
    idx, got = tr.eval_step(packed, torch.from_numpy(users), packed,
                            sampling_steps=0, top_k=10,
                            generator=torch.Generator().manual_seed(1),
                            return_scores=True)
    P = R.weights(seed, R.param_shapes(N_USER, N_ITEM, DIM, 10), "cpu")
    tables = R.Tables(cfg.steps, cfg.noise_scale, cfg.noise_min,
                      cfg.noise_max, "cpu")
    x = R.dense_rows(csr.indptr, csr.indices, users, N_ITEM, "cpu")
    with R.precision(False, "cpu"):
        want = R.scores(P, tables, x, torch.from_numpy(users), 10,
                        mask=x > 0)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    assert torch.equal(idx, R.top_ids(want, 10))
    for j in range(BATCH):
        assert judge.served_gap(want[j], idx[j].tolist(), 10) == 0.0


def test_reference_train_steps_equal_the_ports():
    from h100bench import program
    from h100bench.drivers import train as drv

    seed = 11
    tr, cfg, csr, ncsr = _port(seed)
    hp = drv.recipe_numbers(lambda k: getattr(cfg, k))
    draw_seed = R.derive_seed(seed, "train draws")
    state = tr.init_state()
    state.generator.manual_seed(draw_seed)
    probe = drv.FirstSteps(tr, seed)
    tr.train_epoch(state, ncsr, program.epoch_rng(seed, 0))
    assert "_update" not in vars(tr) and "loss_and_grads" not in vars(tr)
    ref = drv.reference_steps(hp, csr, seed, drv.epoch_batches(
        seed, 0, N_USER, BATCH, 0, 3), "cpu")
    assert judge.rel_gap(probe.losses, ref.losses) < 1e-6
    keep = judge.kept_leaves(ref.first_grad)
    assert judge.leaf_gap(probe.first_grad, ref.first_grad, keep)[0] < 1e-6
    assert judge.leaf_gap(probe.change, ref.change(seed), keep)[0] < 1e-6

    # the same state put back to the seed's start: the next epoch's first
    # fused group is the reference's first K steps on that epoch's batches
    drv.restart(state, seed, draw_seed)
    group = drv.ReplayProbe(tr, seed)
    tr.train_epoch(state, ncsr, program.epoch_rng(seed, 1))
    assert "_train_group" not in vars(tr)
    losses, change, _ = group.read()
    ref = drv.reference_steps(hp, csr, seed, drv.epoch_batches(
        seed, 1, N_USER, BATCH, 0, hp["k"]), "cpu")
    assert len(losses) == hp["k"] == 2
    assert judge.rel_gap(losses, ref.losses) < 1e-6
    keep = judge.kept_leaves(ref.first_grad)
    assert judge.leaf_gap(change, ref.change(seed), keep)[0] < 1e-6


def test_judge_served_gap_reads_wrong_lists():
    row = torch.tensor([0.9, 0.5, float("-inf"), 0.7, 0.1])
    assert judge.served_gap(row, [0, 3], 2) == 0.0
    assert judge.served_gap(row, [0, 1], 2) == pytest.approx(0.2)
    assert judge.served_gap(row, [0, 2], 2) == float("inf")    # history
    assert judge.served_gap(row, [0, 0], 2) == float("inf")    # repeated
    assert judge.served_gap(row, [0, 9], 2) == float("inf")    # range
    assert judge.served_gap(row, [0], 2) == float("inf")       # length


def _run(tiny_root, cell, seed=2 ** 31 + 9, seconds=2.0):
    import run as bench_run

    return bench_run.run_cell(cell, seed, seconds, False, device="cpu",
                              root=tiny_root)


@pytest.fixture
def bench_run_path(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "h100bench"))


def test_sound_runs_are_correct(tiny_root, bench_run_path):
    for cell in ("tiny-train", "tiny-eval"):
        out = _run(tiny_root, cell)
        assert out["correct"] is True, out["checks"]
        assert out["failed"] == 0 and out["attempted"] > 0


def _no_update(self, state, grads, new_lt, lr):
    """A step that returns its state unchanged."""


def _half_batch(orig):
    def loss_and_grads(self, state, x, index, draws=None):
        """Half of the batch left out, the mean taken over the rest."""
        h = x.shape[0] // 2
        return orig(self, state, x[:h], index[:h], draws)
    return loss_and_grads


def _group_fault(orig, kind):
    """``steps_body``, the K steps of a fused group (what a CUDA graph
    captures), sound at its first call and broken at every later one, as
    a replay would be: the group run on its first call's batches (a stale
    batch buffer), or at learning rate 0 (a dropped lr scalar)."""
    first = []

    def steps_body(self, state, xs, idxs, lr, draws=None):
        if not first:
            first.append((xs, idxs))
        elif kind == "stale_batches":
            xs, idxs = first[0]
        else:
            lr = torch.zeros_like(lr)
        return orig(self, state, xs, idxs, lr, draws)
    return steps_body


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "group_stale_batches", "group_lr_dropped"])
def test_train_faults_make_the_run_incorrect(fault, tiny_root,
                                             bench_run_path, monkeypatch):
    from gdmcf_torch.train.trainer import Trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(Trainer, "_update", _no_update)
    elif fault == "half_batch":
        monkeypatch.setattr(Trainer, "loss_and_grads",
                            _half_batch(Trainer.loss_and_grads))
    else:
        monkeypatch.setattr(Trainer, "steps_body", _group_fault(
            Trainer.steps_body, fault[len("group_"):]))
    out = _run(tiny_root, "tiny-train")
    assert out["correct"] is False, out["checks"]
    if fault.startswith("group_"):   # only the fused group is broken
        assert out["checks"]["loss_gap"]["value"] < 1e-6, out["checks"]


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch_sums"])
def test_eval_faults_make_the_run_incorrect(fault, tiny_root,
                                            bench_run_path, monkeypatch):
    from gdmcf_torch.ops import metrics
    from gdmcf_torch.train.trainer import Trainer

    if fault == "altered_answer":
        orig = Trainer.eval_step

        def eval_step(self, *a, **k):
            idx = orig(self, *a, **k)
            return torch.cat([(idx[:, :1] + 1) % self.n_item, idx[:, 1:]], 1)

        monkeypatch.setattr(Trainer, "eval_step", eval_step)
    else:
        orig = metrics.packed_batch_metric_sums

        def sums(gt, idx, n_item, topn):
            """Half of the batch left out of the sums."""
            h = idx.shape[-2] // 2
            return orig(gt[..., :h, :], idx[..., :h, :], n_item, topn)

        monkeypatch.setattr(metrics, "packed_batch_metric_sums", sums)
    out = _run(tiny_root, "tiny-eval")
    assert out["correct"] is False, out["checks"]
