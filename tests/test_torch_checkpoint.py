"""The port's checkpoints: save -> restore -> bit-exact resume, mirroring
``tests/test_checkpoint.py`` of the JAX package.

Tolerance: none. A restored state equals the saved one bitwise in every
tensor, the Lt ring, the step and the generator state, and a resumed
``fit`` ends bitwise where an uninterrupted one does (CPU: every draw comes
from the checkpointed generator and the per-epoch shuffle seeds).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gdmcf_torch.config import Config  # noqa: E402
from gdmcf_torch.train.checkpoint import Checkpointer  # noqa: E402
from gdmcf_torch.train.trainer import Trainer  # noqa: E402

N_USER, N_ITEM, B = 24, 20, 8


def make_trainer(**kw):
    base = dict(device="cpu", backbone="DNNOneHotEmbeddingGCN", dims=[12],
                emb_size=10, steps=5, noise_scale=0.01, batch_size=B,
                sampling_steps=0, history_num_per_term=2)
    base.update(kw)
    return Trainer(Config(**base), N_USER, N_ITEM)


def batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand((B, N_ITEM), generator=g) < 0.3).float(),
            torch.arange(B, dtype=torch.int32))


def flat(state):
    """Every piece of a TrainState as (name, tensor) pairs."""
    opt = state.opt_state
    out = [("step", torch.tensor(state.step)), ("count", opt.count),
           ("lt.history", state.lt.history), ("lt.count", state.lt.count),
           ("generator", state.generator.get_state())]
    for key, d in (("p", state.params), ("mu", opt.mu), ("nu", opt.nu)):
        out += [(f"{key}.{k}", v.detach()) for k, v in sorted(d.items())]
    return out


def assert_states_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    trainer = make_trainer()
    state = trainer.init_state()
    x, idx = batch()
    for _ in range(3):
        state, _ = trainer.train_step(state, x, idx)
    assert int(state.lt.count.sum()) > 0
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(state)
    assert ckpt.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_3.pt"]
    saved = [(n, t.clone()) for n, t in flat(state)]
    state_a, loss_a = trainer.train_step(state, x, idx)

    # restore into a fresh trainer's template and take the same step
    other = make_trainer(random_seed=9)
    template = other.init_state()
    live = {k: p for k, p in other.model.named_parameters()}
    restored = ckpt.restore(template)
    assert restored is template and restored.step == 3
    for (name, want), (_, got) in zip(saved, flat(restored)):
        assert torch.equal(want, got), name
    # restored in place: the module's parameters are the state's tensors
    for k, p in restored.params.items():
        assert p is live[k]
    state_b, loss_b = other.train_step(restored, x, idx)
    assert torch.equal(loss_a, loss_b)
    assert_states_equal(state_a, state_b)


def test_async_save_snapshots_before_returning(tmp_path):
    """save(block=False) copies to host memory before it returns: the next
    steps update the parameters and moments in place while the file is
    written, and restore must return the values at the save."""
    trainer = make_trainer()
    state = trainer.init_state()
    x, idx = batch()
    for _ in range(2):
        state, _ = trainer.train_step(state, x, idx)
    snapshot = [(n, t.clone()) for n, t in flat(state)]
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(state, extra={"best_metric": 0.5}, block=False)
    for _ in range(3):
        state, _ = trainer.train_step(state, x, idx)
    ckpt.wait()
    restored = ckpt.restore(make_trainer().init_state())
    assert restored.step == 2
    for (name, want), (_, got) in zip(snapshot, flat(restored)):
        assert torch.equal(want, got), name
    assert ckpt.load_extra() == {"best_metric": 0.5}


def test_rotation_atomic_names_and_refusals(tmp_path):
    trainer = make_trainer()
    state = trainer.init_state()
    ckpt = Checkpointer(str(tmp_path / "r"), max_to_keep=2)
    for step in (1, 5, 3, 7):
        ckpt.save(state, step=step, block=step != 7)
    ckpt.wait()
    assert ckpt.steps() == [5, 7] and ckpt.latest_step() == 7
    # a temporary file of an interrupted write is invisible
    (tmp_path / "r" / "ckpt_9.pt.tmp-123").write_bytes(b"partial")
    assert ckpt.latest_step() == 7
    assert ckpt.restore(trainer.init_state(), step=5).step == 5
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Checkpointer(str(tmp_path / "empty")).restore(trainer.init_state())
    with pytest.raises(ValueError, match="different geometry"):
        ckpt.restore(make_trainer(dims=[16]).init_state())


def test_blocking_save_flushes_prior_async_sidecar(tmp_path):
    t = make_trainer(dims=[8])
    s = t.init_state()
    ck = Checkpointer(str(tmp_path / "a"))
    ck.save(s, step=1, extra={"best_metric": 0.5}, block=False)
    ck.save(s, step=2, block=True)   # no extra of its own
    assert ck.load_extra() == {"best_metric": 0.5}

    ck2 = Checkpointer(str(tmp_path / "b"))
    ck2.save(s, step=1, extra={"best_metric": 0.7}, block=False)
    ck2.close()   # close() flushes too
    assert ck2.load_extra() == {"best_metric": 0.7}


def splits(n_user=N_USER, n_item=N_ITEM):
    rng = np.random.default_rng(0)
    return [sp.csr_matrix((rng.random((n_user, n_item)) < p
                           ).astype(np.float32)) for p in (0.3, 0.1, 0.1)]


@pytest.mark.parametrize("stream", ["best", "periodic"])
def test_fit_resume_is_bit_exact(tmp_path, stream):
    """fit for 4 epochs against fit for 2 with checkpoints, then resume to
    4: the same final state, bitwise. ``best``: the best-eval stream (an
    eval every epoch); ``periodic``: ``ckpt_every`` 1 with no eval at all,
    so no best checkpoint exists."""
    mats = splits()
    n_user = mats[0].shape[0]
    kw = (dict(eval_every=1) if stream == "best"
          else dict(eval_every=100, ckpt_every=1))

    def fit(epochs, ckpt_dir=None, logs=None):
        t = make_trainer(epochs=epochs, topN=[5], lr=1e-3, random_seed=3,
                         ckpt_dir=ckpt_dir, resume=ckpt_dir is not None,
                         **kw)
        return t.fit(*mats, log=(logs.append if logs is not None
                                 else lambda *a: None))

    ref_state, ref_best = fit(4)
    ck = str(tmp_path / "ck")
    s2, _ = fit(2, ck)
    assert s2.step == 2 * (n_user // B)
    best = Checkpointer(ck)
    per = Checkpointer(os.path.join(ck, "periodic"))
    if stream == "best":
        assert best.latest_step() is not None and per.latest_step() is None
        assert best.load_extra()["best_epoch"] in (1, 2)
    else:
        assert best.latest_step() is None
        assert per.latest_step() == 2 * (n_user // B)
        assert per.steps() == [n_user // B, 2 * (n_user // B)]
    logs = []
    s4, best4 = fit(4, ck, logs)
    assert any(ln.startswith("resumed from checkpoint") for ln in logs)
    assert s4.step == 4 * (n_user // B)
    assert_states_equal(ref_state, s4)
    if stream == "best":
        # a best restored from the sidecar comes back as JSON lists
        assert list(best4) == list(ref_best)
        # no epochs left: the sidecar's best results still come back
        _, best_again = fit(4, ck)
        assert list(best_again) == list(ref_best)


def test_fit_resume_without_sidecar_does_not_stop_at_once(tmp_path):
    mats = splits()
    t = make_trainer(epochs=2, eval_every=100, topN=[5], ckpt_every=1,
                     ckpt_dir=str(tmp_path / "ck"), resume=True,
                     early_stop_patience=3)
    t.fit(*mats, log=lambda *a: None)
    os.remove(tmp_path / "ck" / "periodic" / "train_meta.json")
    logs = []
    t2 = make_trainer(epochs=4, eval_every=100, topN=[5], ckpt_every=1,
                      ckpt_dir=str(tmp_path / "ck"), resume=True,
                      early_stop_patience=3)
    s, _ = t2.fit(*mats, log=logs.append)
    assert "resumed from checkpoint at step 6 (epoch 3)" in logs
    # best_epoch falls back to 2, so epochs 3 and 4 train (from best_epoch
    # 0, patience 3 would exit before epoch 3)
    assert s.step == 12 and "Exiting from training early" not in logs
