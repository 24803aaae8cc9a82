"""Training in the port against the JAX package: the importance sampler,
``training_losses``, the single-pass AdamW and whole train steps of the
flagship, at small sizes with both recipes' settings.

Randomness: the test replays the JAX package's key splits and hands the
port JAX's own draws (timesteps, uniforms, normals), so both packages
sample the same cells.

Tolerances:
- Lt history and importance weights: rtol 1e-6 / atol 1e-7 (float32
  elementwise); timesteps and counts exactly.
- Per-example losses: rtol 1e-5 / atol 1e-6 (the forward's tolerance).
- AdamW, one step from the same inputs: ``fused_adamw.update_bounds``
  (one ulp of a moment's storage type plus a few float32 ulps of its
  terms; p within the update error that allows).
- Three whole train steps: every parameter and moment within rtol 1e-4
  and an atol of 1e-3 times the step's largest update, lr (AdamW
  normalizes the gradient, so a gradient entry near zero, where the two
  packages' float32 sums differ most in relative terms, can move its
  update by a fraction of lr); a moment within one ulp of its storage
  type, of its value and of its decayed previous value (a bfloat16
  moment may round the other way at each step), plus the gradient's
  float32 error.
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
from gdmcf_torch.data import loader as TLoad  # noqa: E402
from gdmcf_torch.data.native import NativeCSR  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.ops import fused_adamw as TA  # noqa: E402
from gdmcf_torch.serve import build_recommender  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.data import loader as JLoad  # noqa: E402
from gdmcf_tpu.diffusion import engine as JE  # noqa: E402
from gdmcf_tpu.ops import fused_adamw as JA  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

EW = dict(rtol=1e-6, atol=1e-7)
FWD = dict(rtol=1e-5, atol=1e-6)
N_USER, N_ITEM = 24, 20
# both recipes at small widths: dims 48 and 44 put the GCN convs (d_item
# x 512) over the JAX package's 65,536-element kernel threshold, so its
# train step runs K1 (in interpret mode on the CPU) for them
RECIPES = {
    "amazon": dict(dims=[48], batch_size=8, lr=5e-5, noise_scale=1e-4,
                   random_seed=0),
    "yelp": dict(dims=[44], batch_size=12, lr=1e-5, noise_scale=0.01,
                 random_seed=1),
}
COMMON = dict(backbone="DNNOneHotEmbeddingGCN", OneHotMatrix=2, steps=5,
              emb_size=10, mean_type="x0", sampling_steps=0)


def t_(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bridged(tree):
    return compat.state_dict_from_jax_params(np_tree(tree))


def engines(**kw):
    base = dict(steps=5, noise_scale=1e-2, noise_schedule="linear-var",
                history_num_per_term=4)
    base.update(kw)
    return (TE.Diffusion.create(TConfig(device="cpu", **base)),
            JE.Diffusion.create(JConfig(**base)))


def lt_pair(seed, steps=5, h=4, fill=None):
    rng = np.random.default_rng(seed)
    hist = rng.random((steps, h)).astype(np.float32)
    count = (rng.integers(0, h + 1, steps) if fill is None
             else np.full(steps, fill)).astype(np.int32)
    hist[np.arange(h)[None, :] >= count[:, None]] = 0.0
    return (TE.LtState(t_(hist), t_(count)),
            JE.LtState(jnp.asarray(hist), jnp.asarray(count)))


# ---------------------------------------------------------------------------
# importance sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill,b", [(0, 6), (None, 9), (4, 3), (None, 23)])
def test_update_lt_matches_both_jax_forms(fill, b):
    td, jd = engines()
    t_lt, j_lt = lt_pair(b, fill=fill)
    rng = np.random.default_rng(b + 1)
    ts = rng.integers(0, 5, b).astype(np.int32)
    losses = rng.random(b).astype(np.float32)
    got = td.update_lt(t_lt, t_(ts).long(), t_(losses))
    seq = td.update_lt_sequential(t_lt, t_(ts).long(), t_(losses))
    jts, jl = jnp.asarray(ts), jnp.asarray(losses)
    for want in (jd.update_lt(j_lt, jts, jl),
                 jd.update_lt_sequential(j_lt, jts, jl)):
        np.testing.assert_array_equal(got.count.numpy(), want.count)
        np.testing.assert_array_equal(seq.count.numpy(), want.count)
        np.testing.assert_allclose(got.history.numpy(), want.history, **EW)
        np.testing.assert_allclose(seq.history.numpy(), want.history, **EW)
    assert got.count.dtype == torch.int32


@pytest.mark.parametrize("full", [False, True])
def test_sample_timesteps_pt_matches_jax(full):
    td, jd = engines()
    t_lt, j_lt = lt_pair(3, fill=4 if full else None)
    if not full:
        t_lt.count[0] = 1   # at least one row not full
        j_lt = j_lt._replace(count=jnp.asarray(t_lt.count.numpy()))
    key = jax.random.PRNGKey(2)
    want_t, want_pt = jd.sample_timesteps(key, j_lt, 64)
    other = (want_t + 1) % 5   # the branch not taken must not be picked
    draws = (TE.TimestepDraws(t_(want_t), t_(other)) if not full
             else TE.TimestepDraws(t_(other), t_(want_t)))
    got_t, got_pt = td.sample_timesteps(t_lt, 64, draws=draws)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_pt.numpy(), want_pt, **EW)
    if not full:
        assert (got_pt == 1).all()


def test_sample_timesteps_own_draws_follow_the_weights():
    td, _ = engines()
    g = torch.Generator().manual_seed(0)
    empty, _ = lt_pair(0, fill=0)
    t, pt = td.sample_timesteps(empty, 5000, generator=g)
    assert (pt == 1).all() and set(t.unique().tolist()) == set(range(5))
    hist = torch.tensor([[1.0] * 4, [2.0] * 4, [0.0] * 4, [4.0] * 4,
                         [1.0] * 4])
    full = TE.LtState(hist, torch.full((5,), 4, dtype=torch.int32))
    t, pt = td.sample_timesteps(full, 20000, generator=g)
    w = np.array([1, 2, 0, 4, 1], np.float64) / 8 * 0.999 + 0.001 / 5
    freq = np.bincount(t.numpy(), minlength=5) / 20000
    np.testing.assert_allclose(freq, w, atol=0.012)
    np.testing.assert_allclose(pt.numpy(), w[t.numpy()] * 5, rtol=1e-6)


# ---------------------------------------------------------------------------
# training_losses
# ---------------------------------------------------------------------------

def jax_train_draws(jd, lt, step_key, b, n):
    """The draws of the JAX training_losses under ``step_key``, in its
    order; each timestep draw fills both branches with JAX's pick."""
    k_ts_u, k_noise_u, k_ts, k_noise, k_drop = jax.random.split(step_key, 5)

    def ts(k):
        t, _ = jd.sample_timesteps(k, lt, b)
        return TE.TimestepDraws(t_(t), t_(t))

    k1, k2 = jax.random.split(k_drop, 2)
    return TE.TrainDraws(
        ts_u=ts(k_ts_u),
        corrupt_u=t_(jax.random.uniform(k_noise_u, (b, n))),
        ts=ts(k_ts),
        noise=t_(jax.random.normal(k_noise, (b, n))),
        dropout=(t_(jax.random.uniform(k1, (b, n))),
                 t_(jax.random.uniform(k2, (b, 2 * n)))))


def trainer_pair(recipe="amazon", **kw):
    cfg = dict(COMMON, **RECIPES[recipe])
    cfg.update(kw)
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM)
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM)
    jstate = jt.init_state()
    tt.model.load_state_dict({k: t_(v) for k, v in
                              bridged(jstate.params).items()})
    return jt, jstate, tt


def batch(seed, b):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, N_ITEM)) < 0.3).astype(np.float32)
    return x, rng.choice(N_USER, b, replace=False).astype(np.int32)


@pytest.mark.parametrize("mean_type,reweight,filled", [
    ("x0", True, False), ("x0", True, True), ("eps", True, True),
    ("x0", False, False)])
def test_training_losses_match_jax(mean_type, reweight, filled):
    jt, jstate, tt = trainer_pair(mean_type=mean_type, reweight=reweight,
                                  history_num_per_term=4)
    jd, td = jt.diffusion, tt.diffusion
    t_lt, j_lt = lt_pair(7, fill=4 if filled else None)
    x, idx = batch(1, 8)
    key = jax.random.PRNGKey(5)
    want, want_lt, want_aux = jd.training_losses(
        jt.model.apply, jstate.params, jnp.asarray(x), jnp.asarray(idx), key,
        j_lt, reweight=reweight, train=True)
    tt.model.train()
    draws = jax_train_draws(jd, j_lt, key, 8, N_ITEM)
    with torch.no_grad():
        got, got_lt, aux = td.training_losses(
            tt.model, t_(x), t_(idx).long(), t_lt, reweight=reweight,
            draws=draws)
    np.testing.assert_array_equal(aux["ts"].numpy(), want_aux["ts"])
    np.testing.assert_allclose(aux["pt"].numpy(), want_aux["pt"], **EW)
    np.testing.assert_allclose(aux["mse"].numpy(), want_aux["mse"], **FWD)
    np.testing.assert_allclose(aux["closs"].numpy(), want_aux["closs"], **FWD)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    np.testing.assert_array_equal(got_lt.count.numpy(), want_lt.count)
    np.testing.assert_allclose(got_lt.history.numpy(), want_lt.history, **FWD)


def test_training_losses_refuses_noise_scale_zero_with_reweight():
    td, _ = engines(noise_scale=0.0)
    lt = TE.LtState.create(5, 4)
    with pytest.raises(ValueError, match="reweight=False"):
        td.training_losses(None, torch.zeros(2, 3), torch.zeros(2).long(),
                           lt, reweight=True)


def test_trainer_refuses_noise_scale_zero_for_the_graph_backbone():
    with pytest.raises(ValueError, match="noise_scale=0"):
        TTrainer(TConfig(device="cpu", dims=[8], noise_scale=0.0), 4, 5)


@pytest.mark.parametrize("field,value", [
    ("param_dtype", "bfloat16"), ("bf16_weights", ("in_layers",)),
    ("opt_impl", "optax")])
def test_unported_optimizer_options_raise(field, value):
    """The options once refused here are ported: each builds its state
    (bfloat16 storage with float32 masters where it selects any) and
    trains a step; ``tests/test_torch_bf16.py`` holds them to the JAX
    package."""
    t = TTrainer(TConfig(device="cpu", dims=[8], **{field: value}), 4, 5)
    state = t.init_state()
    bf16 = {k for k, p in state.params.items() if p.dtype == torch.bfloat16}
    assert set(state.opt_state.master) == bf16
    assert bool(bf16) == (field != "opt_impl")
    x = (np.random.default_rng(0).random((4, 5)) < 0.5).astype(np.float32)
    state, loss = t.train_step(state, t_(x), t_(np.arange(4, dtype=np.int32)))
    assert np.isfinite(loss.item()) and state.step == 1


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def assert_within_bounds(got, want, bounds, what):
    over = (got.float() - want.float()).abs() > bounds
    assert not over.any(), f"{what}: {int(over.sum())} elements over bound"


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("shape", [(300, 260), (37, 5)])
def test_adamw_reference_matches_the_pallas_kernel(moment_dtype, wd, shape):
    """Three successive steps (count 1 to 3), each from the same inputs in
    both packages."""
    rng = np.random.default_rng(0)
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]
    p = rng.standard_normal(shape).astype(np.float32)
    mu = np.zeros(shape, np.float32)
    nu = np.zeros(shape, np.float32)
    lr = 1e-3
    for count in (1, 2, 3):
        g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        jmu = jnp.asarray(mu).astype(jnp.dtype(moment_dtype))
        jnu = jnp.asarray(nu).astype(jnp.dtype(moment_dtype))
        cf = jnp.float32(count)
        jc = jnp.stack([1.0 - 0.9 ** cf, 1.0 - 0.999 ** cf])
        wp, wmu, wnu = JA._adamw_leaf_kernel(
            jnp.asarray(p), jnp.asarray(g), jmu, jnu, jc, b1=0.9, b2=0.999,
            eps=1e-8, lr=lr, wd=wd, interpret=True)
        c = TA.step_scalars(torch.tensor(count, dtype=torch.int32), lr)
        np.testing.assert_array_equal(c[1:].numpy(), np.asarray(jc))
        tmu, tnu = t_(mu).to(mdt), t_(nu).to(mdt)
        gp, gmu, gnu = TA.adamw_reference(t_(p), t_(g), tmu, tnu, c, wd=wd)
        assert gmu.dtype == mdt and gp.dtype == torch.float32
        bp, bmu, bnu = TA.update_bounds(t_(p), t_(g), tmu, tnu, c, wd=wd)
        assert_within_bounds(gp, t_(wp), bp, "p")
        assert_within_bounds(gmu, t_(np.asarray(wmu, np.float32)), bmu, "mu")
        assert_within_bounds(gnu, t_(np.asarray(wnu, np.float32)), bnu, "nu")
        p = np.asarray(wp)
        mu = np.asarray(wmu, np.float32)
        nu = np.asarray(wnu, np.float32)


def test_fused_adamw_apply_on_cpu_updates_in_place_without_the_kernel():
    params = {"w": torch.nn.Parameter(torch.ones(3, 4)),
              "s": torch.nn.Parameter(torch.tensor(1.0))}
    state = TA.fused_adamw_init(params, torch.bfloat16)
    assert state.mu["w"].dtype == torch.bfloat16 and state.mu["s"].shape == ()
    grads = {"w": torch.full((3, 4), 0.5), "s": torch.tensor(-2.0)}
    TA.reset_launch_counts()
    ptr = params["w"].data_ptr()
    state = TA.fused_adamw_apply(params, grads, state, lr=0.1)
    assert TA.LAUNCHES == {"fused_adamw": 0, "fused_adamw_master": 0}
    assert int(state.count) == 1 and params["w"].data_ptr() == ptr
    # step 1 of Adam moves every element by lr against its gradient's sign
    torch.testing.assert_close(params["w"].detach(), torch.full((3, 4), 0.9))
    torch.testing.assert_close(params["s"].detach(), torch.tensor(1.1))


# ---------------------------------------------------------------------------
# whole train steps against the JAX Trainer (K1 in interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", ["amazon", "yelp"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_the_jax_trainer(recipe, moment_dtype):
    extra = {"grad_clip_norm": 1.0} if recipe == "yelp" else {}
    jt, jstate, tt = trainer_pair(recipe, opt_impl="fused",
                                  opt_moment_dtype=moment_dtype, **extra)
    assert jt._opt_impl == "kernel" and jt._fused_interpret
    tstate = tt.init_state()
    b = RECIPES[recipe]["batch_size"]
    lr = RECIPES[recipe]["lr"]
    prev_m = {}
    for step in range(3):
        x, idx = batch(10 + step, b)
        _, step_key = jax.random.split(jstate.key)
        draws = jax_train_draws(jt.diffusion, jstate.lt, step_key, b,
                                N_ITEM)
        jstate, jloss = jt._train_step(jstate, jnp.asarray(x),
                                       jnp.asarray(idx))
        tstate, tloss = tt.train_step(tstate, t_(x), t_(idx), draws=draws)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_array_equal(tstate.lt.count.numpy(),
                                      jstate.lt.count)
        np.testing.assert_allclose(tstate.lt.history.numpy(),
                                   jstate.lt.history, **FWD)
        assert int(tstate.opt_state.count) == int(jstate.opt_state.count)
        tol = dict(rtol=1e-4, atol=1e-3 * lr)
        want_p = bridged(jstate.params)
        for name, p in tstate.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_p[name],
                                       err_msg=f"step {step} {name}", **tol)
        for which, beta in (("mu", 0.9), ("nu", 0.999)):
            want_m = bridged(getattr(jstate.opt_state, which))
            for name, m in getattr(tstate.opt_state, which).items():
                w = np.asarray(want_m[name], np.float32)
                prev = beta * np.abs(prev_m.get((which, name), 0.0))
                # one storage ulp of this step's value and of the decayed
                # previous one (each step may round the other way), plus
                # the gradient's float32 error
                scale = np.abs(w).max() if w.size else 0.0
                bound = (float(torch.finfo(m.dtype).eps) * (np.abs(w) + prev)
                         + 1e-4 * np.abs(w) + 1e-5 * scale)
                bad = np.abs(m.float().numpy() - w) > bound
                assert not bad.any(), f"step {step} {which} {name}"
                prev_m[(which, name)] = w
    assert tstate.step == 3 and int(jstate.step) == 3


@pytest.mark.parametrize("schedule,warmup", [("cosine", 0), ("linear", 2),
                                             ("constant", 3)])
def test_three_train_steps_under_an_lr_schedule_match_the_jax_trainer(
        schedule, warmup):
    """The JAX package runs schedules with its inline AdamW; the port's K1
    reads the scheduled lr from its device scalar. Horizon 4 steps, so the
    three steps see three different learning rates. Tolerances as above."""
    jt, jstate, tt = trainer_pair("yelp", opt_impl="inline",
                                  lr_schedule=schedule, lr_warmup_steps=warmup,
                                  lr_total_steps=4)
    assert jt._opt_impl == "inline" and tt._lr_scheduled
    tstate = tt.init_state()
    b = RECIPES["yelp"]["batch_size"]
    for step in range(3):
        np.testing.assert_allclose(tt._lr_at(step), float(jt._lr_at(step)),
                                   rtol=1e-6)
        x, idx = batch(10 + step, b)
        _, step_key = jax.random.split(jstate.key)
        draws = jax_train_draws(jt.diffusion, jstate.lt, step_key, b,
                                N_ITEM)
        jstate, jloss = jt._train_step(jstate, jnp.asarray(x),
                                       jnp.asarray(idx))
        tstate, tloss = tt.train_step(tstate, t_(x), t_(idx), draws=draws)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        want_p = bridged(jstate.params)
        for name, p in tstate.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_p[name],
                                       err_msg=f"step {step} {name}",
                                       rtol=1e-4,
                                       atol=1e-3 * RECIPES["yelp"]["lr"])


# ---------------------------------------------------------------------------
# epochs, data and serving from a trained Trainer
# ---------------------------------------------------------------------------

def interactions(seed=0, n_user=N_USER):
    m = np.random.default_rng(seed).random((n_user, N_ITEM)) < 0.25
    return sp.csr_matrix(m.astype(np.float32))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_epoch_batches_match_jax(drop_last, packed):
    csr = interactions(1, 30)
    tds, jds = TLoad.DiffusionDataset(csr), JLoad.DiffusionDataset(csr)
    assert tds.binary and len(tds) == 30
    np.testing.assert_array_equal(tds.rows, jds.rows)
    for src in (tds, NativeCSR.from_scipy(csr)):
        got = list(TLoad.epoch_batches(src, 8, np.random.default_rng(3),
                                       drop_last=drop_last, packed=packed))
        want = list(JLoad.epoch_batches(jds, 8, np.random.default_rng(3),
                                        drop_last=drop_last, packed=packed))
        assert len(got) == len(want) == (3 if drop_last else 4)
        for (gx, gi), (wx, wi) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gi, wi)
            assert gi.dtype == np.int32
    for n, bs, dl in ((30, 8, True), (30, 8, False), (5, 8, True)):
        assert TLoad.epoch_stop(n, bs, dl) == JLoad.epoch_stop(n, bs, dl)
    counts = sp.csr_matrix(np.array([[0, 2.0], [1, 0]]))
    assert not TLoad.DiffusionDataset(counts).binary


def test_train_epoch_trains_and_serves():
    csr = interactions(2, 40)
    cfg = TConfig(device="cpu", **dict(COMMON, dims=[16], batch_size=8,
                                       lr=1e-3, noise_scale=1e-4))
    trainer = TTrainer(cfg, 40, N_ITEM)
    state = trainer.init_state()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    TA.reset_launch_counts()
    state, total = trainer.train_epoch(state, NativeCSR.from_scipy(csr),
                                       np.random.default_rng(0))
    assert np.isfinite(total) and state.step == 5
    # CPU tensors: the plain version
    assert TA.LAUNCHES == {"fused_adamw": 0, "fused_adamw_master": 0}
    for k, p in state.params.items():
        assert not torch.equal(p.detach(), before[k]), f"{k} did not move"
    # 5 steps x 8 timesteps into rings of 10
    assert int(state.lt.count.max()) <= 10
    assert 30 <= int(state.lt.count.sum()) <= 40
    assert int(state.opt_state.count) == 5
    rec = build_recommender(cfg, None, csr, 40, N_ITEM, trainer=trainer,
                            serve_batch=8, k_max=6)
    assert rec.trainer is trainer and not trainer.model.training
    items, _ = rec.recommend([0, 5, 39], k=6)
    hist = csr.toarray() > 0
    for u, row in zip([0, 5, 39], items):
        assert len(set(row.tolist())) == 6 and not hist[u, row].any()
