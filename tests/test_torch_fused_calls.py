"""The fused calls: ``train_steps_per_call`` K train steps and
``eval_batches_per_call`` K eval batches (the JAX package's ``_train_multi``
and ``_eval_multi``; CUDA graphs on the card, ``gdmcf_torch/train/graphs.py``),
on the CPU, where a group runs as its single steps through the same
grouping code.

- ``Trainer.train_steps`` at K = 3 against the JAX Trainer's
  ``_train_multi`` at equal weights with the JAX draws injected, for the
  flagship and DNN, at the tolerances of the three-step tests
  (``test_torch_train.py``, ``test_torch_onehot_modes.py``): losses rtol
  1e-5; the Lt ring rtol 1e-5 / atol 1e-6, its counts exactly; every
  parameter within rtol 1e-4 and an atol of 1e-3 x lr; every moment within
  one ulp of its storage type (of its value and of its decayed previous
  one) plus the gradient's float32 error.
- The grouping rules the JAX package's tests pin, one case each, and the
  edge cases of ``equal_shape_runs``.
- K against 1 in the port: exactly (the same steps, draws and sums).
- Steps one at a time on a (1, 2) gloo mesh and under ``debug_nans``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.data.loader import DiffusionDataset  # noqa: E402
from gdmcf_torch.data.native import NativeCSR  # noqa: E402
from gdmcf_torch.ops import fused_adamw as TA  # noqa: E402
from gdmcf_torch.ops import metrics as TM  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_torch.train.trainer import equal_shape_runs  # noqa: E402
from gdmcf_tpu.ops import fused_adamw as JA  # noqa: E402
import test_torch_onehot_modes as OH  # noqa: E402
import test_torch_train as TR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
FWD = dict(rtol=1e-5, atol=1e-6)


def t_(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the K-step body against the JAX package's _train_multi
# ---------------------------------------------------------------------------

def flagship_case():
    jt, jstate, tt = TR.trainer_pair("amazon", opt_impl="fused",
                                     opt_moment_dtype="bfloat16")
    b = TR.RECIPES["amazon"]["batch_size"]
    batches = [TR.batch(20 + s, b) for s in range(3)]

    def draws(jd, lt, key):
        return TR.jax_train_draws(jd, lt, key, b, TR.N_ITEM)
    return jt, jstate, tt, batches, draws


def dnn_case():
    jt, jstate, tt = OH.trainer_pair("DNN", 0, opt_impl="fused",
                                     opt_moment_dtype="float32")
    batches = [OH.rows(30 + s, OH.B) for s in range(3)]

    def draws(jd, lt, key):
        return OH.jax_train_draws(jd, lt, key, OH.B, OH.N_ITEM, "DNN")
    return jt, jstate, tt, batches, draws


@pytest.mark.parametrize("case", ["flagship", "DNN"])
def test_train_steps_match_the_jax_train_multi(monkeypatch, case):
    # every 2-D leaf of 256 elements or more takes the Pallas kernel (in
    # interpret mode) on the JAX side, as the large leaves do at full size
    monkeypatch.setattr(JA, "_MIN_KERNEL_ELEMS", 256)
    jt, jstate0, tt, batches, make_draws = {
        "flagship": flagship_case, "DNN": dnn_case}[case]()
    assert_train_multi_matches(jt, jstate0, tt, batches, make_draws)


def assert_train_multi_matches(jt, jstate0, tt, batches, make_draws,
                               excuse=None):
    """``tt.train_steps`` over ``batches`` [(x, idx)] against the JAX
    Trainer ``jt``'s ``_train_multi`` from its init ``jstate0`` (the port
    holds the same parameters), with the JAX draws injected: the losses,
    the Lt ring, the parameters and the moments at the tolerances above.
    ``excuse``: called as ``excuse(name, past, draws, moments)`` for a
    parameter, or a moment of it, with elements past its tolerance
    (``past``, a mask), with the injected draws and the JAX single steps'
    moments after each step ([{"mu", "nu"}]); returns the mask of the
    elements it accounts for, and no other element may be past. Returns
    the JAX state after the steps."""
    k = len(batches)
    assert jt._opt_impl == "kernel" and jt._fused_interpret
    # the JAX draws of each step: the single steps' key chain, which
    # _train_multi's scan repeats (a step donates its state: the moments
    # before the last step are kept as numpy)
    draws, seq, moments = [], jstate0, []
    for x, idx in batches:
        _, step_key = jax.random.split(seq.key)
        draws.append(make_draws(jt.diffusion, seq.lt, step_key))
        before = {w: OH.bridged(getattr(seq.opt_state, w))
                  for w in ("mu", "nu")}
        seq, _ = jt._train_step(seq, jnp.asarray(x), jnp.asarray(idx))
        if excuse is not None:
            moments.append({w: OH.bridged(getattr(seq.opt_state, w))
                             for w in ("mu", "nu")})
    xs = np.stack([b[0] for b in batches])
    idxs = np.stack([b[1] for b in batches])
    # a fresh init: the same seeded parameters the port was given
    jstate, jlosses = jt._train_multi(jt.init_state(), jnp.asarray(xs),
                                      jnp.asarray(idxs))
    tstate = tt.init_state()
    tstate, tlosses = tt.train_steps(tstate, t_(xs), t_(idxs), draws=draws)
    assert tstate.step == k and int(jstate.step) == k
    assert int(tstate.opt_state.count) == k
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_array_equal(tstate.lt.count.numpy(), jstate.lt.count)
    np.testing.assert_allclose(tstate.lt.history.numpy(), jstate.lt.history,
                               **FWD)
    lr = tt.cfg.lr
    want_p = OH.bridged(jstate.params)
    for name, p in tstate.params.items():
        if excuse is None:
            np.testing.assert_allclose(p.detach().numpy(), want_p[name],
                                       rtol=1e-4, atol=1e-3 * lr,
                                       err_msg=name)
            continue
        w = np.asarray(want_p[name])
        past = ~(np.abs(p.detach().numpy() - w)
                 <= 1e-3 * lr + 1e-4 * np.abs(w))
        if past.any():
            left = past & ~excuse(name, past, draws, moments)
            assert not left.any(), (name, int(left.sum()))
    for which, beta in (("mu", 0.9), ("nu", 0.999)):
        want_m = OH.bridged(getattr(jstate.opt_state, which))
        for name, m in getattr(tstate.opt_state, which).items():
            w = np.asarray(want_m[name], np.float32)
            scale = np.abs(w).max() if w.size else 0.0
            bound = (float(torch.finfo(m.dtype).eps)
                     * (np.abs(w) + beta * np.abs(
                         np.asarray(before[which][name], np.float32)))
                     + 1e-4 * np.abs(w) + 1e-5 * scale)
            past = np.abs(m.float().numpy() - w) > bound
            if excuse is not None and past.any():
                past &= ~excuse(name, past, draws, moments)
            assert not past.any(), (which, name)
    return jstate


# ---------------------------------------------------------------------------
# the grouping rules of the JAX package's tests, one case each
# ---------------------------------------------------------------------------

def small_cfg(**kw):
    base = dict(device="cpu", backbone="DNNOneHotEmbeddingGCN", dims=[12],
                emb_size=10, steps=5, noise_scale=0.01, sampling_steps=0,
                lr=1e-3)
    base.update(kw)
    return TConfig(**base)


def binary(seed, n_user, n_item, p):
    rng = np.random.default_rng(seed)
    return (rng.random((n_user, n_item)) < p).astype(np.float32)


def partial_batch_steps():
    """tests/test_round5_fixes.py:12: drop_last false at K 2, a trailing
    partial batch runs as a single step; 6 rows at batch 4 make 2 steps,
    18 rows 5."""
    cfg = small_cfg(backbone="DNN", dims=[8], batch_size=4, drop_last=False,
                    train_steps_per_call=2)
    tr = TTrainer(cfg, 18, 16)
    for n_rows, seed, steps in ((6, 1, 2), (18, 2, 5)):
        state = tr.init_state()
        rows = binary(n_rows, n_rows, 16, 0.3)
        state, loss = tr.train_epoch(state, DiffusionDataset.from_rows(rows),
                                     np.random.default_rng(seed))
        assert np.isfinite(loss) and state.step == steps


def eval_equal(k, streaming):
    """tests/test_round2_fixes.py:239 (``evaluate``, K 4) and :257
    (``evaluate_streaming``, K 3): exactly the metrics of K 1."""
    n_user, n_item = 40, 20
    train, gt = binary(0, n_user, n_item, 0.3), binary(5, n_user, n_item, 0.1)
    kw = dict(batch_size=8, topN=[5, 10], drop_last=False)
    seq = TTrainer(small_cfg(eval_batches_per_call=1, **kw), n_user, n_item)
    fused = TTrainer(small_cfg(eval_batches_per_call=k, **kw), n_user,
                     n_item)
    fused.model.load_state_dict(seq.model.state_dict())
    state = seq.init_state()
    if streaming:
        tn = NativeCSR.from_scipy(sp.csr_matrix(train))
        gn = NativeCSR.from_scipy(sp.csr_matrix(gt))
        got = [t.evaluate_streaming(state, [tn], gn, [tn], [5, 10])
               for t in (seq, fused)]
    else:
        got = [t.evaluate(state, train, gt, train, [5, 10])
               for t in (seq, fused)]
    assert got[0] == got[1]


def prefix_fuses(monkeypatch, k=8, want_groups=(5,)):
    """tests/test_round2_fixes.py:279: 5 full batches and a partial one at
    K 8 make one fused group of 5, then one single batch (at K 1, six
    single batches)."""
    n_user, n_item = 44, 20
    train, gt = binary(1, n_user, n_item, 0.3), binary(6, n_user, n_item, 0.1)
    kw = dict(batch_size=8, topN=[5, 10], drop_last=False)
    seq = TTrainer(small_cfg(eval_batches_per_call=1, **kw), n_user, n_item)
    fused = TTrainer(small_cfg(eval_batches_per_call=k, **kw), n_user,
                     n_item)
    fused.model.load_state_dict(seq.model.state_dict())
    groups, steps = [], []
    group, step = fused._eval_group, fused.eval_step

    def count_group(rows, *a, **k):
        groups.append(len(rows))
        return group(rows, *a, **k)

    def count_step(*a, **k):
        steps.append(a[0].shape[0])
        return step(*a, **k)

    monkeypatch.setattr(fused, "_eval_group", count_group)
    monkeypatch.setattr(fused, "eval_step", count_step)
    state = seq.init_state()
    got = fused.evaluate(state, train, gt, train, [5, 10])
    # the groups of the full batches, then the partial batch alone
    assert groups == list(want_groups) and steps == [8] * 5 + [4]
    assert got == seq.evaluate(state, train, gt, train, [5, 10])


def steps_per_call_epoch():
    """tests/test_train_smoke.py:172: 80 users at batch 16 and K 2, two
    fused pairs and one remainder step, the steps and loss of K 1."""
    n_user, n_item = 80, 32
    rows = binary(42, n_user, n_item, 0.25)
    out = []
    for k in (1, 2):
        tr = TTrainer(small_cfg(batch_size=16, train_steps_per_call=k),
                      n_user, n_item)
        state = tr.init_state()
        state, loss = tr.train_epoch(state, DiffusionDataset.from_rows(rows),
                                     np.random.default_rng(0))
        out.append((state.step, loss))
    assert out[0] == out[1] == (5, out[0][1])


def runs_of(keys, k):
    """The batch numbers of ``equal_shape_runs``' runs over ``keys``."""
    return [[i for i, _ in run]
            for run in equal_shape_runs(enumerate(keys), k, lambda e: e[1])]


def runs_k_past_the_batches():
    """K above the number of batches: one run of them all, a trailing
    partial batch alone; both evaluations at K 16 over 5 batches give K
    1's metrics."""
    assert runs_of("aaaaa", 16) == [[0, 1, 2, 3, 4]]
    assert runs_of("aaap", 16) == [[0, 1, 2], [3]]
    eval_equal(16, streaming=False)
    eval_equal(16, streaming=True)


def runs_partial_in_the_middle():
    """A batch of another shape in the middle ends the run before it and
    runs alone; a run is yielded once complete, before the next batch is
    taken when it is full (the streaming evaluation assembles a batch
    only then)."""
    assert runs_of("aaabaa", 2) == [[0, 1], [2], [3], [4, 5]]
    assert runs_of("aaabaa", 8) == [[0, 1, 2], [3], [4, 5]]
    taken = []

    def batches():
        for i, key in enumerate("aabaa"):
            taken.append(i)
            yield key
    runs = equal_shape_runs(batches(), 2, lambda key: key)
    assert next(runs) == ["a", "a"] and taken == [0, 1]
    assert next(runs) == ["b"] and taken == [0, 1, 2, 3]
    assert list(runs) == [["a", "a"]] and taken == [0, 1, 2, 3, 4]


def runs_all_alone(monkeypatch):
    """K 1, or every batch of its own shape: every run is one batch, and
    the evaluation at K 1 calls no group."""
    assert runs_of("aaaa", 1) == [[0], [1], [2], [3]]
    assert runs_of("abcd", 8) == [[0], [1], [2], [3]]
    assert runs_of("", 8) == []
    prefix_fuses(monkeypatch, k=1, want_groups=())


@pytest.mark.parametrize("case", [
    "round5_partial_batch", "round2_evaluate_k4", "round2_streaming_k3",
    "round2_prefix_fuses", "train_smoke_steps_per_call",
    "runs_k_past_the_batches", "runs_partial_in_the_middle",
    "runs_all_alone"])
def test_grouping_rules_of_the_jax_tests(monkeypatch, case):
    {"round5_partial_batch": partial_batch_steps,
     "round2_evaluate_k4": lambda: eval_equal(4, streaming=False),
     "round2_streaming_k3": lambda: eval_equal(3, streaming=True),
     "round2_prefix_fuses": lambda: prefix_fuses(monkeypatch),
     "train_smoke_steps_per_call": steps_per_call_epoch,
     "runs_k_past_the_batches": runs_k_past_the_batches,
     "runs_partial_in_the_middle": runs_partial_in_the_middle,
     "runs_all_alone": lambda: runs_all_alone(monkeypatch)}[case]()


# ---------------------------------------------------------------------------
# K against 1 in the port, bitwise
# ---------------------------------------------------------------------------

def snapshot(state):
    opt = state.opt_state
    out = {f"p.{k}": p.detach().clone() for k, p in state.params.items()}
    out.update({f"mu.{k}": m.clone() for k, m in opt.mu.items()})
    out.update({f"nu.{k}": m.clone() for k, m in opt.nu.items()})
    out.update({f"master.{k}": m.clone()
                for k, m in (opt.master or {}).items()})
    out.update(count=opt.count.clone(), lt_history=state.lt.history.clone(),
               lt_count=state.lt.count.clone(),
               generator=state.generator.get_state())
    return out


def assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


KCASES = {
    "flagship": dict(),
    "DNN_bf16_master": dict(backbone="DNN", OneHotMatrix=0,
                            param_dtype="bfloat16", grad_clip_norm=1.0,
                            lr_schedule="cosine", lr_warmup_steps=3),
    "DNN_onehot1": dict(backbone="DNN", OneHotMatrix=1),
}
# OneHotMatrix 1 refuses drop_last false (its model's width is n_item +
# batch_size)
DROP_LAST = {"DNN_onehot1": True}


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("case", list(KCASES))
def test_train_epoch_at_k_is_bitwise_k1(case, k):
    """Two epochs (so a group crosses no epoch and the Lt rows fill): the
    parameters, moments, masters, Lt, step count, the losses' sum and the
    generator's state equal K = 1's."""
    n_user, n_item = 90, 30
    rows = binary(3, n_user, n_item, 0.25)
    out = []
    for kk in (1, k):
        tr = TTrainer(small_cfg(batch_size=8, train_steps_per_call=kk,
                                drop_last=DROP_LAST.get(case, False),
                                **KCASES[case]),
                      n_user, n_item)
        state = tr.init_state()
        totals = []
        for epoch in range(2):
            state, total = tr.train_epoch(
                state, DiffusionDataset.from_rows(rows),
                np.random.default_rng(epoch))
            totals.append(total)
        out.append((snapshot(state), totals, state.step))
    assert_bitwise(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def recorded_eval(monkeypatch, trainer, run):
    """The ids each batch hands the accumulator, and the accumulator's
    unrounded sums, of ``run()``."""
    ids, sums = [], []
    add, result = TM.MetricAccumulator.add_packed, TM.MetricAccumulator.result

    def add_packed(self, gt, pred, n):
        ids.append(pred.clone())
        return add(self, gt, pred, n)

    def res(self):
        out = result(self)
        sums.append((self.sums.copy(), self.n_users))
        return out

    monkeypatch.setattr(TM.MetricAccumulator, "add_packed", add_packed)
    monkeypatch.setattr(TM.MetricAccumulator, "result", res)
    got = run()
    monkeypatch.undo()
    return got, ids, sums


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("kind", ["evaluate", "streaming", "streaming_tv"])
def test_evaluations_at_k_are_bitwise_k1(monkeypatch, kind, k):
    """sampling_steps 2 and sampling_noise: every batch draws from the eval
    generator, which the fused groups use up in batch order; the ids, the
    unrounded sums and the results equal K = 1's."""
    n_user, n_item = 70, 24
    train = binary(8, n_user, n_item, 0.3)
    valid, test = binary(9, n_user, n_item, 0.1), binary(10, n_user, n_item,
                                                         0.1)
    kw = dict(batch_size=8, topN=[5, 10], drop_last=False, sampling_steps=2,
              sampling_noise=True)
    base = TTrainer(small_cfg(**kw), n_user, n_item)
    state = base.init_state()
    got = []
    for kk in (1, k):
        tr = TTrainer(small_cfg(eval_batches_per_call=kk, **kw), n_user,
                      n_item)
        tr.model.load_state_dict(base.model.state_dict())
        tn, vn, gn = (NativeCSR.from_scipy(sp.csr_matrix(a))
                      for a in (train, valid, test))

        def run():
            if kind == "evaluate":
                return [tr.evaluate(state, train, test,
                                    np.clip(train + valid, 0, 1), [5, 10])
                        for _ in range(2)]
            if kind == "streaming":
                return [tr.evaluate_streaming(state, [tn], vn, [tn],
                                              [5, 10]) for _ in range(2)]
            return [tr.evaluate_streaming(state, [tn, vn], gn, [tn, vn],
                                          [5, 10], drop_last=False)]
        got.append(recorded_eval(monkeypatch, tr, run))
    (r1, ids1, s1), (rk, idsk, sk) = got
    assert r1 == rk
    assert len(ids1) == len(idsk) > 0
    for a, b in zip(ids1, idsk):
        assert torch.equal(a, b)
    for (a, n), (b, m) in zip(s1, sk):
        assert n == m and np.array_equal(a, b)


@pytest.mark.parametrize("k", [2, 8])
def test_fit_at_k_is_bitwise_k1(tmp_path, k):
    """``fit`` (train, evaluate, select, checkpoint) at K against K = 1:
    the final state bitwise, the best results and the checkpoints'
    tensors equal."""
    n_user, n_item = 60, 24
    train = sp.csr_matrix(binary(11, n_user, n_item, 0.3))
    held = binary(12, n_user, n_item, 0.15)
    valid = sp.csr_matrix(held * (train.toarray() == 0))
    test = sp.csr_matrix(binary(13, n_user, n_item, 0.1)
                         * (train.toarray() == 0))
    out = []
    for kk in (1, k):
        cfg = small_cfg(batch_size=8, epochs=3, eval_every=1, topN=[5, 10],
                        train_steps_per_call=kk, eval_batches_per_call=kk,
                        host_dense=k == 2, sampling_steps=1,
                        ckpt_dir=str(tmp_path / f"k{kk}"), ckpt_every=1)
        tr = TTrainer(cfg, n_user, n_item)
        logs = []
        state, best = tr.fit(train, valid, test, log=logs.append)
        out.append((snapshot(state), best, state.step,
                    [ln.split(" costs ")[0] for ln in logs]))
    assert_bitwise(out[0][0], out[1][0])
    assert out[0][1:3] == out[1][1:3]
    saved = [torch.load(tmp_path / f"k{kk}" / "periodic"
                        / f"ckpt_{out[0][2]}.pt", weights_only=True)
             for kk in (1, k)]
    for key in ("params", "mu", "nu"):
        for name in saved[0][key]:
            assert torch.equal(saved[0][key][name], saved[1][key][name])
    assert torch.equal(saved[0]["generator"], saved[1]["generator"])


# ---------------------------------------------------------------------------
# the plain version and the launch accounting
# ---------------------------------------------------------------------------

def test_lr_as_a_device_scalar_equals_the_float():
    count = torch.tensor(4, dtype=torch.int32)
    for lr in (1e-3, 3.3e-5):
        lr32 = float(np.float32(lr))
        a = TA.step_scalars(count, lr32)
        b = TA.step_scalars(count, torch.tensor([lr32, 0.5])[0])
        assert torch.equal(a, b)


def test_replays_add_their_captured_launches():
    TA.reset_launch_counts()
    TA.add_replays({"fused_adamw": 104, "fused_adamw_master": 0}, 33)
    TA.add_replays({"fused_adamw": 13, "fused_adamw_master": 3})
    assert TA.LAUNCHES == {"fused_adamw": 3445, "fused_adamw_master": 3}
    # a CPU update runs the plain version and counts nothing
    p = torch.nn.Parameter(torch.ones(4))
    st = TA.fused_adamw_init({"p": p}, torch.float32)
    TA.fused_adamw_apply({"p": p}, {"p": torch.ones(4)}, st, lr=0.1)
    assert TA.LAUNCHES["fused_adamw"] == 3445 and not any(
        TA.CAPTURED.values())
    TA.reset_launch_counts()


def test_a_train_step_keeps_the_state_tensors():
    """The carry a graph captures: a step writes K1's count and the Lt
    ring into the state's own tensors."""
    tr = TTrainer(small_cfg(batch_size=8), 16, 20)
    state = tr.init_state()
    held = (state.opt_state.count, state.lt.history, state.lt.count)
    x = binary(4, 8, 20, 0.3)
    for _ in range(2):
        state, _ = tr.train_step(state, t_(x), torch.arange(8))
    now = (state.opt_state.count, state.lt.history, state.lt.count)
    assert all(a is b for a, b in zip(held, now))
    assert int(state.opt_state.count) == 2 and int(state.lt.count.sum()) == 16


# ---------------------------------------------------------------------------
# one step at a time: a mesh and debug_nans
# ---------------------------------------------------------------------------

def test_debug_nans_runs_steps_one_at_a_time(monkeypatch):
    cfg = small_cfg(batch_size=4, debug_nans=True, train_steps_per_call=4,
                    eval_batches_per_call=4)
    tr = TTrainer(cfg, 16, 12)
    assert tr.fused_k("train")[0] == 1 and tr.fused_k("eval")[0] == 1
    assert "debug_nans" in tr.unfused_line()

    def refuse(*a, **k):
        raise AssertionError("a fused group under debug_nans")

    monkeypatch.setattr(tr, "_train_group", refuse)
    monkeypatch.setattr(tr, "_eval_group", refuse)
    rows = binary(5, 16, 12, 0.3)
    train = sp.csr_matrix(rows)
    logs = []
    tr.cfg.epochs, tr.cfg.eval_every, tr.cfg.topN = 1, 1, [5]
    state, _ = tr.fit(train, train, train, log=logs.append)
    assert state.step == 4
    assert ("train_steps_per_call 4 and eval_batches_per_call 4 run one "
            "step at a time: debug_nans") in logs[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_mesh_runs_steps_one_at_a_time(tmp_path):
    """A (1, 2) world of gloo ranks (``MODE=fused``) at K 4 never groups
    (each rank refuses ``_train_group`` and ``_eval_group``), logs why, and
    equals its own K 1 run: the same world's parameters, moments and loss
    sums bitwise."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank), MODE="fused",
                   WORK_DIR=str(tmp_path), PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (rank, out[-3000:])
        got = json.loads((tmp_path / f"fused_rank{rank}.json").read_text())
        assert got["bitwise"] and got["steps"] == [6, 6]
        assert got["totals"][0] == got["totals"][1]
        assert got["log"] == ("train_steps_per_call 4 and "
                              "eval_batches_per_call 4 run one step at a "
                              "time: a mesh: gloo collectives cannot be "
                              "captured")
