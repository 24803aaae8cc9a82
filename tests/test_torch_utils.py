"""The port's host utilities against the JAX package's: the prefetch
thread (the cases of ``tests/test_prefetch.py``, and a ``train_epoch``
with prefetch on and off), the profiling hooks, the graph converters and
``NativeCSR.from_edge_list``. Converters and CSR builds are held bitwise;
losses with prefetch on and off too.
"""

import json
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gdmcf_torch.data import graph_convert as TGC  # noqa: E402
from gdmcf_torch.data.native import NativeCSR as TNative  # noqa: E402
from gdmcf_torch.data.prefetch import prefetched  # noqa: E402
from gdmcf_torch.utils import profiling as TP  # noqa: E402
from gdmcf_tpu.data import graph_convert as JGC  # noqa: E402
from gdmcf_tpu.data.native import NativeCSR as JNative  # noqa: E402


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def test_order_preserved():
    items = [(np.full((2, 2), i), np.array([i])) for i in range(50)]
    out = list(prefetched(iter(items), depth=3))
    assert len(out) == 50
    for i, (x, idx) in enumerate(out):
        assert x[0, 0] == i and idx[0] == i


def test_depth_zero_passthrough():
    it = iter([1, 2, 3])
    assert prefetched(it, depth=0) is it


def test_producer_exception_reraises():
    def gen():
        yield 1
        raise RuntimeError("boom")

    out = prefetched(gen(), depth=2)
    assert next(out) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(out)


def test_slow_consumer_bounded():
    """The producer blocks at the queue's bound instead of buffering
    everything."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    out = prefetched(gen(), depth=2)
    next(out)
    time.sleep(0.1)
    # 1 consumed + 2 queued + at most a couple in flight
    assert len(produced) <= 6


def test_abandoned_consumer_stops_producer():
    """Leaving the loop mid-epoch releases the producer thread."""
    started = threading.active_count()
    alive = {"n": 0}

    def gen():
        for i in range(1000):
            alive["n"] = i
            yield np.zeros((64, 64))

    it = prefetched(gen(), depth=2)
    next(it)
    it.close()   # the consumer walks away (as on an exception or break)
    time.sleep(1.0)
    produced_at_close = alive["n"]
    time.sleep(0.5)
    assert alive["n"] == produced_at_close
    # the thread has exited, not parked on a full queue
    assert threading.active_count() <= started


@pytest.mark.parametrize("backbone", ["DNN", "DNNOneHotEmbeddingGCN"])
def test_train_epoch_losses_equal_with_prefetch_on_and_off(tmp_path,
                                                           backbone):
    """Prefetch moves the host's batch assembly to a thread; the epoch's
    losses and parameters are bitwise those without it."""
    from gdmcf_torch.config import Config
    from gdmcf_torch.data.loader import data_load_dir, \
        generate_synthetic_dataset
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.train.trainer import Trainer

    generate_synthetic_dataset(str(tmp_path / "d"), n_user=48, n_item=30,
                               avg_degree=8, seed=3)
    train, _, _, n_user, n_item = data_load_dir(str(tmp_path / "d"))
    out = {}
    for depth in (0, 2):
        cfg = Config(device="cpu", backbone=backbone, dims=[16],
                     emb_size=10, steps=5, batch_size=16, lr=1e-3,
                     sampling_steps=0, noise_scale=1e-4,
                     prefetch_batches=depth)
        trainer = Trainer(cfg, n_user, n_item)
        state = trainer.init_state()
        losses = []
        step = trainer.train_step

        def spy(*a, **k):
            s, loss = step(*a, **k)
            losses.append(loss.item())
            return s, loss
        trainer.train_step = spy
        state, total = trainer.train_epoch(state, NativeCSR.from_scipy(train),
                                           np.random.default_rng(11))
        out[depth] = (losses, total, {k: p.detach().clone()
                                      for k, p in state.params.items()})
    assert len(out[0][0]) == 3 and out[0][0] == out[2][0]
    assert out[0][1] == out[2][1]
    for k, p in out[0][2].items():
        assert torch.equal(p, out[2][2][k]), k


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_trace_file(tmp_path):
    a = torch.randn(32, 32)
    with TP.trace(str(tmp_path / "t")) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a)
    path = tmp_path / "t" / TP.TRACE_FILE
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# graph converters and the CSR build
# ---------------------------------------------------------------------------

def batch(seed=0, bs=6, n=9):
    rng = np.random.default_rng(seed)
    x = (rng.random((bs, n)) < 0.3).astype(np.float32)
    index = rng.choice(40, bs, replace=False)
    return x, index


def test_graph_converters_match_jax_bitwise():
    x, index = batch()
    a, n, bs = 40, x.shape[1], x.shape[0]
    edge = TGC.adjacency_to_edge(x, index, a)
    np.testing.assert_array_equal(edge, JGC.adjacency_to_edge(x, index, a))
    got = TGC.edge_to_adjacency(edge, index, a, n, bs)
    np.testing.assert_array_equal(got, JGC.edge_to_adjacency(edge, index,
                                                             a, n, bs))
    np.testing.assert_array_equal(got, x)
    pred = np.random.default_rng(1).integers(0, 2, edge.shape[1])
    np.testing.assert_array_equal(
        TGC.pred_to_adjacency(edge, index, a, n, bs, pred),
        JGC.pred_to_adjacency(edge, index, a, n, bs, pred))
    with pytest.raises(ValueError, match="pred"):
        TGC.pred_to_adjacency(edge, index, a, n, bs)
    y = TGC.adjacency_to_one_hot(bs, n, x)
    np.testing.assert_array_equal(y, JGC.adjacency_to_one_hot(bs, n, x))
    np.testing.assert_array_equal(TGC.one_hot_to_adjacency(bs, n, y), x)
    np.testing.assert_array_equal(TGC.one_hot_to_adjacency(bs, n, y),
                                  JGC.one_hot_to_adjacency(bs, n, y))


@pytest.mark.parametrize("k", [0, 1, 7, 54])
def test_top_k_binarizers_match_jax_bitwise(k):
    s = np.random.default_rng(k).standard_normal((6, 9)).astype(np.float32)
    np.testing.assert_array_equal(TGC.top_k_indices(s, k),
                                  JGC.top_k_indices(s, k))
    np.testing.assert_array_equal(TGC.set_top_k_to_one(s, k),
                                  JGC.set_top_k_to_one(s, k))
    kr = min(k, 9)
    np.testing.assert_array_equal(TGC.topk_set(s, kr), JGC.topk_set(s, kr))


@pytest.mark.parametrize("nnz", [0, 1, 300])
def test_from_edge_list_matches_jax_bitwise(nnz):
    rng = np.random.default_rng(nnz)
    n_user, n_item = 17, 23
    edges = np.stack([rng.integers(0, n_user, nnz),
                      rng.integers(0, n_item, nnz)], axis=1)
    if nnz:
        edges = np.concatenate([edges, edges[:5]])   # repeated pairs kept
    ours = TNative.from_edge_list(edges, n_user, n_item)
    theirs = JNative.from_edge_list(edges, n_user, n_item)
    np.testing.assert_array_equal(ours.indptr, theirs.indptr)
    np.testing.assert_array_equal(ours.indices, theirs.indices)
    assert ours.indptr.dtype == np.int64 and ours.indices.dtype == np.int32
    assert (ours.n_user, ours.n_item) == (n_user, n_item)
    rows = np.arange(n_user)
    np.testing.assert_array_equal(ours.gather(rows), theirs.gather(rows))
    if nnz:
        csr = sp.csr_matrix((np.ones(len(edges), np.float32),
                             (edges[:, 0], edges[:, 1])),
                            shape=(n_user, n_item))
        np.testing.assert_array_equal(ours.gather(rows) > 0,
                                      csr.toarray() > 0)


# ---------------------------------------------------------------------------
# the parity runner
# ---------------------------------------------------------------------------

def test_parity_run_writes_runs_the_judge_reads(tmp_path):
    """``python -m gdmcf_torch.parity_run`` on the CPU: one run per seed in
    the JSON shape ``benchmarks/golden_parity.py`` reads, with its tail
    loss (the mean of the last quarter of the epochs, rounded down)."""
    import subprocess
    import sys
    from pathlib import Path

    from gdmcf_torch import parity_run
    from gdmcf_torch.data.loader import generate_synthetic_dataset

    root = Path(__file__).resolve().parents[1]
    # the recipe's topN reaches 100: a catalog of 120 items
    generate_synthetic_dataset(str(tmp_path / "d"), n_user=40, n_item=120,
                               avg_degree=6, seed=1)
    out = tmp_path / "runs.json"
    parity_run.main(["--device", "cpu", "--data-dir", str(tmp_path / "d"),
                     "--backbone", "DNN", "--OneHotMatrix", "0", "--dims",
                     "16", "--batch", "16", "--epochs", "5", "--seeds", "3",
                     "4", "--out", str(out)])
    runs = json.loads(out.read_text())["runs"]
    assert [r["seed"] for r in runs] == [3, 4]
    for r in runs:
        assert len(r["losses"]) == 5 and [e["epoch"] for e in r["evals"]] \
            == [5]
        assert r["tail_loss"] == pytest.approx(r["losses"][-1])
    refs = []   # the judge reads a reference run per file
    for r in runs:
        refs.append(str(tmp_path / f"ref_s{r['seed']}.json"))
        Path(refs[-1]).write_text(json.dumps(r))
    judge = subprocess.run(
        [sys.executable, str(root / "benchmarks" / "golden_parity.py"),
         "--ref", *refs, "--ours", str(out)], capture_output=True,
        text=True, check=True)
    verdict = json.loads(judge.stdout)
    assert verdict["gdmcf_tpu"]["tail_loss"] == pytest.approx(
        [r["tail_loss"] for r in runs])
