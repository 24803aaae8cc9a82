"""``Trainer._lr_at``, ``evaluate``, ``evaluate_streaming`` and ``fit`` in the
port against the JAX ``Trainer``, at small sizes.

Tolerances:
- learning rates: rtol 1e-6 (both compute in float32; ``cos`` may differ
  by an ulp);
- evaluation at equal weights: the metric tuples exactly (4-decimal
  rounding of float32 sums; at sampling_steps 0 the flagship's scores do
  not depend on ``p_sample``'s draws, so the two RNG streams do not
  matter);
- ``fit``'s control flow with scripted epoch results: exactly (the same
  calls, log lines, selections, saves and early exit).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.data.native import NativeCSR as TNative  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.data.native import NativeCSR as JNative  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

N_USER, N_ITEM = 90, 70
BASE = dict(backbone="DNNOneHotEmbeddingGCN", OneHotMatrix=2, steps=5,
            emb_size=10, mean_type="x0", sampling_steps=0, dims=[32],
            batch_size=32, noise_scale=0.01, lr=1e-3, topN=[5, 20, 10],
            random_seed=4)


def splits(seed=0):
    rng = np.random.default_rng(seed)
    train = (rng.random((N_USER, N_ITEM)) < 0.2).astype(np.float32)
    held = rng.random((N_USER, N_ITEM))
    valid = ((held < 0.05) & (train == 0)).astype(np.float32)
    test = ((held > 0.92) & (train == 0)).astype(np.float32)
    valid[7] = 0.0   # a user with empty ground truth
    return train, valid, test


# ---------------------------------------------------------------------------
# lr schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,warmup,total", [
    ("cosine", 0, 50), ("linear", 0, 50), ("constant", 7, 0),
    ("cosine", 10, 40), ("linear", 5, 33), ("cosine", 0, 0)])
def test_lr_at_matches_jax(schedule, warmup, total):
    kw = dict(dims=[8], lr=3e-4, lr_schedule=schedule,
              lr_warmup_steps=warmup, lr_total_steps=total)
    tt = TTrainer(TConfig(device="cpu", **kw), 4, 5)
    jt = JTrainer(JConfig(**kw), 4, 5)
    for step in list(range(0, 60, 3)) + [total - 1, total, total + 5]:
        want = float(jt._lr_at(step))
        assert np.isclose(tt._lr_at(step), want, rtol=1e-6, atol=0), step
    if schedule == "constant" and not warmup:
        assert tt._lr_at(17) == 3e-4


# ---------------------------------------------------------------------------
# evaluation at equal weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_pair():
    jt = JTrainer(JConfig(**BASE), N_USER, N_ITEM)
    jstate = jt.init_state()
    tt = TTrainer(TConfig(device="cpu", **BASE), N_USER, N_ITEM)
    sd = compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    tt.model.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()})
    return jt, jstate, tt, tt.init_state()


@pytest.mark.parametrize("split", ["valid", "test", "tst_w_val"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_evaluate_matches_jax(eval_pair, split, drop_last):
    jt, jstate, tt, tstate = eval_pair
    train, valid, test = splits()
    mask_tv = np.clip(train + valid, 0, 1)
    rows, gt, mask, drop = {
        "valid": (train, valid, train, None),
        "test": (train, test, mask_tv, None),
        "tst_w_val": (mask_tv, test, mask_tv, False)}[split]
    for t in (jt, tt):
        t.cfg.drop_last = drop_last
        t._eval_cache, t._gt_cache = [], []
    topn = BASE["topN"]
    want = jt.evaluate(jstate, rows, gt, mask, topn, drop_last=drop)
    got = tt.evaluate(tstate, rows, gt, mask, topn, drop_last=drop)
    assert got == tuple(want)
    # the streaming path of the port gives the same tuple
    t_csr = lambda a: TNative.from_scipy(sp.csr_matrix(a))  # noqa: E731
    j_csr = lambda a: JNative.from_scipy(sp.csr_matrix(a))  # noqa: E731
    ins = [train, valid] if split == "tst_w_val" else [train]
    masks = [train] if split == "valid" else [train, valid]
    t_ins, t_masks = [t_csr(a) for a in ins], [t_csr(a) for a in masks]
    if split == "valid":
        t_masks = t_ins
    got_s = tt.evaluate_streaming(tstate, t_ins, t_csr(gt), t_masks, topn,
                                  drop_last=drop)
    want_s = jt.evaluate_streaming(jstate, [j_csr(a) for a in ins],
                                   j_csr(gt), [j_csr(a) for a in masks],
                                   topn, drop_last=drop)
    assert got_s == tuple(want_s) == got


def test_evaluate_caches_device_batches_and_counts_partial_batches(
        eval_pair):
    _, _, tt, tstate = eval_pair
    train, valid, _ = splits()
    tt.cfg.drop_last = True
    tt._eval_cache, tt._gt_cache = [], []
    first = tt.evaluate(tstate, train, valid, train, [5])
    batches = tt._eval_cache[0][4]
    assert len(batches) == N_USER // 32 and len(tt._gt_cache) == 1
    # mask is the input array: the rows are reused, not uploaded twice
    assert all(b[1] is b[3] for b in batches)
    assert batches[0][1].dtype == torch.uint8   # bit-packed
    assert tt.evaluate(tstate, train, valid, train, [5]) == first
    assert len(tt._eval_cache) == 1 and len(tt._gt_cache) == 1
    # bounded at 4 entries, matched by identity
    for _ in range(5):
        tt.evaluate(tstate, train.copy(), valid, train, [5])
    assert len(tt._eval_cache) == 4 and len(tt._gt_cache) == 4
    # the non-binary ground truth takes the host path, same metrics
    counts = valid * 2.0
    assert tt.evaluate(tstate, train, counts, train, [5]) == first


def test_multi_process_eval_names_its_roadmap_item():
    # multi-process evaluation is ported (ROADMAP.md §A item 9, done; the
    # checks are tests/test_torch_parallel_mesh.py): a mesh config without
    # its world of ranks raises before anything runs on one process
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        TTrainer(TConfig(device="cpu", dims=[8], mesh_dp=2), 4, 5)


# ---------------------------------------------------------------------------
# fit's control flow with scripted epochs
# ---------------------------------------------------------------------------

class Recorder:
    """Checkpointer and metric-logger stand-in that records calls."""

    directory = "/nonexistent"

    def __init__(self):
        self.calls = []

    def save(self, state, step=None, extra=None, block=True):
        self.calls.append(("save", extra, block))

    def wait(self):
        self.calls.append(("wait",))

    def latest_step(self):
        return None

    def metrics(self, step, **values):
        values.pop("epoch_s", None)
        self.calls.append(("metrics", step, values))

    def eval_results(self, epoch, split, topn, results):
        self.calls.append(("eval", epoch, split, list(topn),
                           [list(r) for r in results]))


def scripted(trainer, ndcg_valid, ndcg_test, losses):
    """Replace train_epoch and both evaluations with scripts; record the
    calls (with a draw of each epoch's shuffle generator)."""
    calls = []
    evals = iter(range(10_000))

    def train_epoch(state, dataset, rng):
        e = len([c for c in calls if c[0] == "train"])
        calls.append(("train", len(dataset), int(rng.integers(1 << 30))))
        return state, losses[e]

    def evaluate(state, *a, drop_last=None, **kw):
        i = next(evals)
        epoch_i, split = divmod(i, 2)
        v = (ndcg_valid if split == 0 else ndcg_test)[epoch_i]
        calls.append(("eval", split, drop_last))
        return ([0.1, 0.2], [0.3, v / 2], [v / 3, v], [0.5, 0.6])

    trainer.train_epoch = train_epoch
    trainer.evaluate = evaluate
    trainer.evaluate_streaming = evaluate
    return calls


@pytest.mark.parametrize("fidelity", [True, False])
@pytest.mark.parametrize("host_dense,tst_w_val", [(True, False),
                                                  (True, True),
                                                  (False, True)])
def test_fit_control_flow_matches_jax(capsys, fidelity, host_dense,
                                      tst_w_val):
    train, valid, test = (sp.csr_matrix(a) for a in splits(1))
    kw = dict(BASE, dims=[8], topN=[10, 20], epochs=30, eval_every=2,
              early_stop_patience=7, fidelity=fidelity,
              host_dense=host_dense, tst_w_val=tst_w_val, n_user_cap=80,
              lr_schedule="cosine", drop_last=False)
    # valid NDCG@20 climbs, dips, beats the (test) best, then plateaus
    ndcg_valid = [0.30, 0.32, 0.31, 0.40, 0.39, 0.38, 0.37, 0.36, 0.35,
                  0.34, 0.33, 0.32, 0.31, 0.30, 0.29]
    ndcg_test = [0.35, 0.31, 0.45, 0.41, 0.30, 0.29, 0.28, 0.27, 0.26,
                 0.25, 0.24, 0.23, 0.22, 0.21, 0.20]
    losses = [100.0 - e for e in range(30)]
    out = {}
    for name, cls, ccls in (("jax", JTrainer, JConfig),
                            ("torch", TTrainer, TConfig)):
        cfg = ccls(**kw, **({"device": "cpu"} if name == "torch" else {}))
        t = cls(cfg, N_USER, N_ITEM)
        calls = scripted(t, ndcg_valid, ndcg_test, losses)
        rec, logs = Recorder(), []
        _, best = t.fit(train, valid, test, log=logs.append,
                        checkpointer=rec, metric_logger=rec)
        out[name] = (calls, rec.calls,
                     [ln.split(" costs ")[0] for ln in logs],
                     capsys.readouterr().out, best, t._lr_total_steps)
    assert out["torch"] == out["jax"]
    calls, saves, logs, printed, best, total = out["torch"]
    assert total == 30 * 3   # 80 capped rows, batch 32, partial batch kept
    assert "Exiting from training early" in logs
    assert logs[-1].startswith("End. Best Epoch")
    assert [c[1]["best_epoch"] for c in saves if c[0] == "save"] == (
        [2, 8] if fidelity else [2, 4, 8])
    assert all(c[2] is False for c in saves if c[0] == "save")
    if tst_w_val:
        assert ("eval", 1, False) in calls
    assert best is not None and "[Test]" in printed
