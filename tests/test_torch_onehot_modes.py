"""OneHotMatrix 0, 1 and 2 through the port's Trainer and serving, against
the JAX package: whole train steps of the new backbones, the eval step's
top-k ids (OneHotMatrix 1: the block input, the <= 0.1 threshold and the
block's upper-right part), evaluate, the config's and the server's
OneHotMatrix 1 refusals, and serving every backbone.

Randomness: the test replays the JAX package's key splits and hands the
port JAX's own draws, so both packages sample the same cells.

Tolerances, as in ``test_torch_train.py``: losses rtol 1e-5; the Lt ring
rtol 1e-5 / atol 1e-6; three whole train steps: every parameter within
rtol 1e-4 and an atol of 1e-3 x lr (AdamW normalizes the gradient, so an
entry near zero can move its update by a fraction of lr), every moment
within one ulp of its storage type (of its value and of its decayed
previous one) plus the gradient's float32 error. One exception, in the
transformer: the attention's key bias (the middle third of each ``qkv``
bias) has a zero gradient in exact arithmetic (a row's softmax does not
change when q . b_k is added to all its logits), so both packages' float32
gradients there are rounding noise, whose sign Adam's normalized update
turns into a step of +-lr; those elements are held to moving at most lr a
step apart and to moments at the noise level. Top-k ids exactly (both
break ties toward the lowest index).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: few intra-op threads
# each keep the machine from being oversubscribed
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.models.registry import BACKBONES  # noqa: E402
from gdmcf_torch.serve import Recommender, build_recommender  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.ops import fused_adamw as JA  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from test_torch_backbones import dropout_uniforms  # noqa: E402
from test_torch_layers_diffusion import jax_draws  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)
N_USER, N_ITEM, B = 24, 20, 8
DIMS = [16]


def t_(a):
    return torch.from_numpy(np.array(a))


def bridged(tree):
    return compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree))


def recipe(backbone, ohm, **kw):
    base = dict(backbone=backbone, OneHotMatrix=ohm, dims=DIMS, emb_size=10,
                steps=5, noise_scale=0.01, mean_type="x0", sampling_steps=0,
                batch_size=B, lr=1e-3, random_seed=0)
    base.update(kw)
    return base


def trainer_pair(backbone, ohm, **kw):
    cfg = recipe(backbone, ohm, **kw)
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM)
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM)
    jstate = jt.init_state()
    tt.model.load_state_dict({k: t_(v) for k, v in
                              bridged(jstate.params).items()})
    return jt, jstate, tt


def rows(seed, b, p=0.3):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, N_ITEM)) < p).astype(np.float32)
    return x, rng.choice(N_USER, b, replace=False).astype(np.int32)


def rounding_noise(name, shape):
    """The elements whose gradient is zero in exact arithmetic: the key
    bias of an encoder layer's ``qkv``."""
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        d = shape[0] // 3
        mask[d:2 * d] = True
    return mask


def jax_train_draws(jd, lt, step_key, b, n, backbone):
    """The draws of the JAX training_losses under ``step_key``, in its
    order; each timestep draw fills both branches with JAX's pick. The
    one-hot channel's draws exist under OneHotMatrix 2 only."""
    k_ts_u, k_noise_u, k_ts, k_noise, k_drop = jax.random.split(step_key, 5)

    def ts(k):
        t, _ = jd.sample_timesteps(k, lt, b)
        return TE.TimestepDraws(t_(t), t_(t))

    onehot = jd.cat_one_hot
    return TE.TrainDraws(
        ts_u=ts(k_ts_u) if onehot else None,
        corrupt_u=t_(jax.random.uniform(k_noise_u, (b, n))) if onehot
        else None,
        ts=ts(k_ts),
        noise=t_(jax.random.normal(k_noise, (b, n))),
        dropout=dropout_uniforms(backbone, k_drop, b, n, DIMS[-1]))


# ---------------------------------------------------------------------------
# whole train steps against the JAX Trainer (K1 in interpret mode)
# ---------------------------------------------------------------------------

STEP_CASES = [("DNN", 0, "float32"), ("DNN", 1, "bfloat16"),
              ("DNNCat", 2, "bfloat16"), ("DNNOneHot", 2, "float32"),
              ("DNNOneHotEmbedding", 2, "bfloat16"),
              ("DNNOneHotTransformer", 2, "float32")]


@pytest.mark.parametrize("backbone,ohm,moments", STEP_CASES)
def test_three_train_steps_match_the_jax_trainer(monkeypatch, backbone, ohm,
                                                 moments):
    # every 2-D leaf of 256 elements or more takes the Pallas kernel (in
    # interpret mode) on the JAX side, as the large leaves do at full size
    monkeypatch.setattr(JA, "_MIN_KERNEL_ELEMS", 256)
    jt, jstate, tt = trainer_pair(backbone, ohm, opt_impl="fused",
                                  opt_moment_dtype=moments)
    assert jt._opt_impl == "kernel" and jt._fused_interpret
    assert any(p.ndim == 2 and p.size >= 256
               for p in jax.tree_util.tree_leaves(jstate.params))
    tstate = tt.init_state()
    lr = tt.cfg.lr
    # OneHotMatrix 1 trains on the [B + n, B + n] block
    b, n = (B + N_ITEM, B + N_ITEM) if ohm == 1 else (B, N_ITEM)
    prev_m = {}
    for step in range(3):
        x, idx = rows(10 + step, B)
        _, step_key = jax.random.split(jstate.key)
        draws = jax_train_draws(jt.diffusion, jstate.lt, step_key, b, n,
                                backbone)
        jstate, jloss = jt._train_step(jstate, jnp.asarray(x),
                                       jnp.asarray(idx))
        tstate, tloss = tt.train_step(tstate, t_(x), t_(idx), draws=draws)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_array_equal(tstate.lt.count.numpy(),
                                      jstate.lt.count)
        np.testing.assert_allclose(tstate.lt.history.numpy(),
                                   jstate.lt.history, **FWD)
        want_p = bridged(jstate.params)
        for name, p in tstate.params.items():
            got, want = p.detach().numpy(), want_p[name]
            noise = rounding_noise(name, got.shape)
            np.testing.assert_allclose(got[~noise], want[~noise],
                                       err_msg=f"step {step} {name}",
                                       rtol=1e-4, atol=1e-3 * lr)
            assert (np.abs(got - want)[noise]
                    <= 2 * lr * (step + 1) * 1.0001).all(), name
        for which, beta in (("mu", 0.9), ("nu", 0.999)):
            want_m = bridged(getattr(jstate.opt_state, which))
            for name, m in getattr(tstate.opt_state, which).items():
                w = np.asarray(want_m[name], np.float32)
                prev = beta * np.abs(prev_m.get((which, name), 0.0))
                scale = np.abs(w).max() if w.size else 0.0
                bound = (float(torch.finfo(m.dtype).eps) * (np.abs(w) + prev)
                         + 1e-4 * np.abs(w) + 1e-5 * scale)
                noise = rounding_noise(name, w.shape)
                bound[noise] = 1e-5 * scale
                bad = np.abs(m.float().numpy() - w) > bound
                assert not bad.any(), f"step {step} {which} {name}"
                prev_m[(which, name)] = w
    assert tstate.step == 3 and int(jstate.step) == 3


def test_block_onehot_matches_jax_and_a_preblocked_batch_trains_alike():
    x, idx = rows(3, B)
    block = TTrainer._to_block_onehot(t_(x))
    np.testing.assert_array_equal(
        block.numpy(), np.asarray(JTrainer._to_block_onehot(jnp.asarray(x))))
    assert block.shape == (B + N_ITEM, B + N_ITEM) and not block[B:].any()
    losses = []
    for inp in (t_(x), block):
        tt = TTrainer(TConfig(device="cpu", **recipe("DNN", 1)), N_USER,
                      N_ITEM)
        state = tt.init_state()
        _, loss = tt.train_step(state, inp, t_(idx))
        losses.append(loss.item())
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# the eval step
# ---------------------------------------------------------------------------

EVAL_CASES = [("DNN", 0, 0), ("DNN", 0, 2), ("DNN", 1, 0), ("DNN", 1, 3),
              ("DNNCat", 2, 0), ("DNNOneHot", 2, 2),
              ("DNNOneHotEmbedding", 2, 0),
              ("DNNOneHotTransformer", 2, 2)]


@pytest.mark.parametrize("backbone,ohm,ss", EVAL_CASES)
def test_eval_step_topk_matches_jax(backbone, ohm, ss):
    jt, jstate, tt = trainer_pair(backbone, ohm, sampling_steps=ss)
    x, idx = rows(21, B, p=0.25)
    mask = x.copy()
    key = jax.random.PRNGKey(3)
    k = 12
    want = np.asarray(jt._eval_step(
        jstate.params, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(mask),
        key, sampling_steps=ss, top_k=k))
    side = B + N_ITEM if ohm == 1 else None
    draws = jax_draws(key, side or B, side or N_ITEM, 5, ss)
    got, scores = tt.eval_step(t_(x), t_(idx), t_(mask), sampling_steps=ss,
                               top_k=k, draws=draws, return_scores=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert scores.shape == (B, N_ITEM)
    assert torch.isinf(scores[t_(mask) > 0]).all()
    if ohm == 1:
        # the threshold zeroed every unmasked score at or under 0.1
        live = scores[t_(mask) == 0]
        assert ((live == 0) | (live > 0.1)).all() and (live == 0).any()


@pytest.mark.parametrize("ohm", [0, 1])
def test_evaluate_matches_jax(ohm):
    """evaluate at equal weights; 30 rows in batches of 8 drop the partial
    batch (drop_last, as OneHotMatrix 1 requires). The DNN reads no graph,
    so the sampler's draws cannot move its scores."""
    jt, jstate, tt = trainer_pair("DNN", ohm)
    rng = np.random.default_rng(4)
    n_rows = 30
    train = (rng.random((n_rows, N_ITEM)) < 0.3).astype(np.float32)
    gt = (rng.random((n_rows, N_ITEM)) < 0.15).astype(np.float32)
    topn = [5, 10]
    want = jt.evaluate(jstate, train, gt, train, topn)
    tstate = tt.init_state()
    got = tt.evaluate(tstate, train, gt, train, topn)
    assert list(map(list, got)) == list(map(list, want))
    from gdmcf_torch.data.native import NativeCSR
    train_n = NativeCSR.from_scipy(sp.csr_matrix(train))
    gt_n = NativeCSR.from_scipy(sp.csr_matrix(gt), strict=False)
    streamed = tt.evaluate_streaming(tstate, [train_n], gt_n, [train_n],
                                     topn)
    assert list(map(list, streamed)) == list(map(list, want))


@pytest.mark.parametrize("ohm", [0, 1])
def test_fit_trains_and_evaluates(ohm, capsys):
    rng = np.random.default_rng(5)
    csr = [sp.csr_matrix((rng.random((N_USER, N_ITEM)) < p).astype(
        np.float32)) for p in (0.3, 0.1, 0.1)]
    cfg = TConfig(device="cpu", **recipe("DNN", ohm, epochs=2, eval_every=1,
                                         tst_w_val=True, topN=[5, 10]))
    tt = TTrainer(cfg, N_USER, N_ITEM)
    lines = []
    state, best = tt.fit(*csr, log=lines.append)
    assert state.step == 2 * (N_USER // B)
    assert best is not None and len(best) == 4
    assert any(ln.startswith("End. Best Epoch") for ln in lines)
    assert all(np.isfinite(v) for group in best for v in group)


# ---------------------------------------------------------------------------
# refusals and serving
# ---------------------------------------------------------------------------

def test_config_refuses_onehot_block_without_drop_last():
    for cls in (JConfig, TConfig):
        with pytest.raises(ValueError, match="drop_last"):
            cls(OneHotMatrix=1, drop_last=False)
    cfg = TConfig(OneHotMatrix=1, dims=[16], batch_size=B)
    assert cfg.out_dims(N_ITEM) == [16, N_ITEM + B]
    assert cfg.in_dims(N_ITEM) == [N_ITEM + B, 16]
    assert TConfig(OneHotMatrix=0, drop_last=False).out_dims(N_ITEM) == \
        [1000, N_ITEM]


def interactions(seed=0, n_user=N_USER):
    m = np.random.default_rng(seed).random((n_user, N_ITEM)) < 0.25
    return sp.csr_matrix(m.astype(np.float32))


def test_serving_a_onehot_block_model_needs_serve_batch_equal_batch_size():
    cfg = TConfig(device="cpu", **recipe("DNN", 1))
    train = interactions()
    trainer = TTrainer(cfg, N_USER, N_ITEM)
    with pytest.raises(ValueError, match="serve_batch"):
        Recommender.from_state(trainer, None, train, serve_batch=B + 1)
    with pytest.raises(ValueError, match="serve_batch"):
        build_recommender(cfg, None, train, N_USER, N_ITEM, trainer=trainer,
                          serve_batch=4)
    rec = build_recommender(cfg, None, train, N_USER, N_ITEM,
                            trainer=trainer, serve_batch=B, k_max=6)
    users = [0, 5, 23, 7, 1, 2, 3, 9, 11, 12]   # two dispatches
    items, _ = rec.recommend(users, k=6)
    hist = train.toarray() > 0
    for u, row in zip(users, items):
        assert len(set(row.tolist())) == 6 and not hist[u, row].any()


def test_serving_a_dnn_from_a_checkpoint_gives_the_trainers_ids(tmp_path):
    cfg = TConfig(device="cpu", **recipe("DNN", 0))
    train = interactions(1)
    trainer = TTrainer(cfg, N_USER, N_ITEM)
    state = trainer.init_state()
    x, idx = rows(2, B)
    state, _ = trainer.train_step(state, t_(x), t_(idx))
    from gdmcf_torch.train.checkpoint import Checkpointer
    Checkpointer(str(tmp_path / "ck")).save(state)
    live = build_recommender(cfg, None, train, N_USER, N_ITEM,
                             trainer=trainer, serve_batch=B, k_max=5)
    restored = build_recommender(cfg, str(tmp_path / "ck"), train, N_USER,
                                 N_ITEM, serve_batch=B, k_max=5)
    users = np.arange(N_USER)
    np.testing.assert_array_equal(restored.recommend(users, k=5)[0],
                                  live.recommend(users, k=5)[0])


@pytest.mark.parametrize("backbone", BACKBONES)
def test_serve_cli_serves_every_backbone(backbone, tmp_path, capsys):
    from gdmcf_torch.serve import main

    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 12, 60), rng.integers(0, 10, 60)], 1)
    edges[0] = [11, 9]
    for name in ("train", "valid", "test"):
        np.save(tmp_path / f"{name}_list.npy", edges)
    main(["--backbone", backbone, "--dims", "[8]", "--steps", "5",
          "--noise_scale", "1e-4", "--sampling_steps", "0", "--device", "cpu",
          "--data_path", str(tmp_path), "--users", "0,3,5", "--k", "4",
          "--serve_batch", "2", "--k_max", "5"])
    out = capsys.readouterr().out
    assert "user 5: top-4" in out and "on cpu" in out
