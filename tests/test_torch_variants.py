"""The legacy and ablation diffusion variants and the noise_scale=0 reverse
path of the port against the JAX package: ``mix_tensors``, ``normal_kl``,
``absorbing_qt_bar`` and ``legacy_apply_noise``; ``training_losses`` under
legacy (with and without CatOneHot, the one-hot channel's own timestep
draw) and ablation; ``p_sample``'s legacy loop, ablation step and
noise_scale=0 scan; whole train steps and the eval step of the Trainer
under each variant; the graph-backbone refusal at noise_scale 0.

Randomness: where the JAX function draws, the test replays its key splits
and hands the port JAX's own uniforms, normals and integers, and the
results must be equal (elementwise functions exactly; losses and scores to
rtol 1e-5 / atol 1e-6, float32 products in another order). Where the port
draws from its own generator, its results are held to the statistics the
JAX package's tests pin. Whole train steps take the tolerances of
``test_torch_onehot_modes.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.models.registry import build_model as t_build  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.diffusion import engine as JE  # noqa: E402
from gdmcf_tpu.models.registry import build_model as j_build  # noqa: E402
from gdmcf_tpu.ops import fused_adamw as JA  # noqa: E402
from test_torch_backbones import dropout_uniforms  # noqa: E402
from test_torch_layers_diffusion import jax_draws  # noqa: E402
from test_torch_onehot_modes import (B, DIMS, FWD, N_ITEM, N_USER,  # noqa: E402
                                     bridged, rows, t_, trainer_pair)

SCORES = dict(rtol=1e-5, atol=1e-6)


def engines(variant, **kw):
    base = dict(dims=[8], steps=10, noise_scale=0.01, batch_size=10,
                fidelity=True)
    base.update(kw)
    td = TE.Diffusion.create(TConfig(device="cpu", **base), variant=variant)
    jd = JE.Diffusion.create(JConfig(**base), variant=variant)
    return td, jd


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.5, 0.8, 0.99])
def test_mix_tensors_matches_jax_at_its_draws(p):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 30)).astype(np.float32)
    b = rng.standard_normal((7, 30)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JE.mix_tensors(key, jnp.asarray(a), jnp.asarray(b), p)
    got = TE.mix_tensors(t_(a), t_(b), p,
                         u=t_(jax.random.uniform(key, a.shape)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mix_tensors_statistics_on_own_draws():
    g = torch.Generator().manual_seed(0)
    mixed = TE.mix_tensors(torch.ones(100, 100), torch.zeros(100, 100), 0.8,
                           generator=g)
    assert abs(mixed.mean().item() - 0.8) < 0.02
    assert set(mixed.unique().tolist()) <= {0.0, 1.0}


def test_normal_kl_matches_jax():
    rng = np.random.default_rng(1)
    m1, l1, m2, l2 = (rng.standard_normal((5, 6)).astype(np.float32)
                      for _ in range(4))
    want = JE.normal_kl(m1, l1, m2, l2)
    got = TE.normal_kl(t_(m1), t_(l1), t_(m2), t_(l2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    # zero for identical Gaussians, positive otherwise, floats accepted
    assert TE.normal_kl(1.0, 0.0, 1.0, 0.0).item() == 0.0
    assert TE.normal_kl(torch.zeros(4), 0.0, torch.ones(4), 0.0).sum() > 0


def test_absorbing_qt_bar_matches_jax():
    a = np.array([0.0, 0.3, 1.0], np.float32)
    got = TE.absorbing_qt_bar(t_(a), 4)
    want = JE.absorbing_qt_bar(jnp.asarray(a), num_classes=4)
    assert got.shape == (3, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # rows sum to a + (1 - a) C: the reference helper is unnormalized
    np.testing.assert_allclose(got.sum(-1)[1].numpy(), 0.3 + 0.7 * 4,
                               rtol=1e-6)


def legacy_draws(key, x_shape, n):
    """The draws of the JAX ``legacy_apply_noise`` under ``key``."""
    k_pick, k_unif, k_thresh, k_mix = jax.random.split(key, 4)
    return TE.LegacyNoiseDraws(
        pick=t_(jax.random.uniform(k_pick, x_shape)),
        uniform_j=t_(jax.random.randint(k_unif, x_shape, 0, n)),
        thresh=t_(jax.random.randint(k_thresh, (), int(n * 0.8), n + 1)),
        mix=t_(jax.random.uniform(k_mix, x_shape)))


LEGACY_CASES = {
    "ones": (np.ones((10, 20), np.float32), np.full(10, 5), None, None),
    "blend": (np.ones((20, 50), np.float32), np.full(20, 2), None, None),
    "zero_rows": (np.zeros((6, 12), np.float32), np.arange(6), None, None),
    "x_base": (np.ones((10, 30), np.float32), np.full(10, 3),
               np.zeros((10, 30), np.float32), None),
    "mixed_num_nodes": ((np.random.default_rng(2).random((10, 16)) < 0.4)
                        .astype(np.float32), np.arange(10) % 10, None, 40),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_apply_noise_matches_jax_at_its_draws(case):
    x, ts, base, num_nodes = LEGACY_CASES[case]
    td, jd = engines("legacy")
    n = x.shape[1] if num_nodes is None else num_nodes
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jd.legacy_apply_noise(
            key, jnp.asarray(ts, jnp.int32), jnp.asarray(x), num_nodes,
            None if base is None else jnp.asarray(base))
        got = td.legacy_apply_noise(
            t_(ts), t_(x), num_nodes, None if base is None else t_(base),
            draws=legacy_draws(key, x.shape, n))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_legacy_apply_noise_runs_and_is_binary():
    td, _ = engines("legacy")
    x = torch.ones(10, 20)
    ts = torch.full((10,), 5)
    out = td.legacy_apply_noise(ts, x, generator=torch.Generator()
                                .manual_seed(0))
    assert out.shape == x.shape
    assert set(out.unique().tolist()) <= {0.0, 1.0}
    # deterministic under the same seed
    again = td.legacy_apply_noise(ts, x, generator=torch.Generator()
                                  .manual_seed(0))
    assert torch.equal(out, again)


def test_legacy_apply_noise_blend_keeps_most_of_x():
    """mix_tensors(x, x_t, 0.8): about 80% of cells come from x."""
    td, _ = engines("legacy")
    x = torch.ones(20, 50)
    ts = torch.full((20,), 2)
    fracs = [td.legacy_apply_noise(
        ts, x, generator=torch.Generator().manual_seed(s)).mean().item()
        for s in range(5)]
    assert 0.75 < np.mean(fracs) <= 1.0


def test_legacy_apply_noise_zero_rows_do_not_crash():
    td, _ = engines("legacy")
    out = td.legacy_apply_noise(torch.arange(6), torch.zeros(6, 12),
                                generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out).all()


def test_legacy_apply_noise_x_base_blend():
    td, _ = engines("legacy")
    out = td.legacy_apply_noise(torch.full((10,), 3), torch.ones(10, 30),
                                x_base=torch.zeros(10, 30),
                                generator=torch.Generator().manual_seed(2))
    # 99% of cells come from x_base (= 0)
    assert out.mean().item() < 0.05


def test_create_takes_every_variant_and_refuses_others():
    for variant in ("discrete", "legacy", "ablation"):
        assert TE.Diffusion.create(TConfig(device="cpu"),
                                   variant=variant).variant == variant
    with pytest.raises(ValueError, match="variant"):
        TE.Diffusion.create(TConfig(device="cpu"), variant="bogus")


# ---------------------------------------------------------------------------
# training_losses at JAX's draws
# ---------------------------------------------------------------------------

def model_pair(backbone, ohm, variant, **kw):
    base = dict(backbone=backbone, OneHotMatrix=ohm, dims=[12], emb_size=10,
                steps=5, noise_scale=0.01, diffusion_variant=variant)
    base.update(kw)
    jcfg, tcfg = JConfig(**base), TConfig(device="cpu", **base)
    jm = j_build(jcfg, N_USER, N_ITEM)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = t_build(tcfg, N_USER, N_ITEM,
                 generator=torch.Generator().manual_seed(0), device="cpu")
    tm.load_state_dict({k: t_(v) for k, v in bridged(params).items()})
    tm.eval()
    jd = JE.Diffusion.create(jcfg, index_in=jm.needs_index, variant=variant)
    td = TE.Diffusion.create(tcfg, variant=variant,
                             index_in=tm.needs_index)
    return jm, params, jd, tm, td


def loss_draws(jd, lt, key, b, n, variant):
    """The draws of the JAX training_losses under ``key`` (eval mode: no
    dropout), each timestep draw filling both branches with JAX's pick."""
    k_ts_u, k_noise_u, k_ts, k_noise, _ = jax.random.split(key, 5)

    def ts(k):
        t, _ = jd.sample_timesteps(k, lt, b)
        return TE.TimestepDraws(t_(t), t_(t))

    onehot = jd.cat_one_hot
    legacy = variant == "legacy"
    return TE.TrainDraws(
        ts_u=ts(k_ts_u) if onehot else None,
        corrupt_u=(t_(jax.random.uniform(k_noise_u, (b, n)))
                   if onehot and not legacy else None),
        noise_u=(t_(jax.random.normal(k_noise_u, (b, n, 2)))
                 if onehot and legacy else None),
        ts=ts(k_ts), noise=t_(jax.random.normal(k_noise, (b, n))))


LOSS_CASES = [("DNN", 0, "legacy"), ("DNNOneHot", 2, "legacy"),
              ("DNNOneHotEmbedding", 2, "legacy"), ("DNN", 0, "ablation"),
              ("DNNOneHotEmbeddingGCN", 2, "ablation"),
              ("DNNOneHot", 2, "ablation")]


@pytest.mark.parametrize("backbone,ohm,variant", LOSS_CASES)
def test_training_losses_match_jax_at_its_draws(backbone, ohm, variant):
    jm, params, jd, tm, td = model_pair(backbone, ohm, variant)
    x, idx = rows(5, B)
    lt_j = JE.LtState.create(5)
    lt_t = TE.LtState.create(5)
    losses = jax.jit(lambda p, xx, ii, k, lt: jd.training_losses(
        jm.apply, p, xx, ii, k, lt, train=False))
    for step in range(3):
        key = jax.random.PRNGKey(40 + step)
        draws = loss_draws(jd, lt_j, key, B, N_ITEM, variant)
        want, lt_j, waux = losses(params, jnp.asarray(x), jnp.asarray(idx),
                                  key, lt_j)
        with torch.no_grad():
            got, lt_t, gaux = td.training_losses(tm, t_(x), t_(idx).long(),
                                                 lt_t, draws=draws)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORES)
        np.testing.assert_allclose(gaux["closs"].numpy(),
                                   np.asarray(waux["closs"]), **SCORES)
        np.testing.assert_array_equal(lt_t.count.numpy(), lt_j.count)
        np.testing.assert_allclose(lt_t.history.numpy(), lt_j.history, **FWD)
    if variant == "legacy":
        # no contrastive term, not even on an indexIn backbone
        assert gaux["closs"].item() == 0.0


class Probe(torch.nn.Module):
    """Records what the diffusion hands the model; returns zeros."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def forward(self, x, t, x_U=None, index=None, graph=None, rcloss=False,
                **_):
        self.seen = dict(x=x, t=t, x_U=x_U, graph=graph, rcloss=rcloss)
        out = torch.zeros_like(x)
        return (out, torch.zeros(())) if rcloss else (out, None)


def test_legacy_one_hot_channel_has_its_own_timestep_draw():
    """Legacy CatOneHot: x_tU is q_sample(one-hot, ts_u, noise_u) at the
    first draw, the model's t the second one; no contrastive loss."""
    td, _ = engines("legacy", OneHotMatrix=2, steps=5)
    td = dataclasses.replace(td, index_in=True)
    x, idx = rows(6, B)
    lt = TE.LtState.create(5)
    ts_u = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    ts = torch.tensor([4, 3, 2, 1, 0, 4, 3, 2])
    rng = np.random.default_rng(7)
    noise_u = t_(rng.standard_normal((B, N_ITEM, 2)).astype(np.float32))
    noise = t_(rng.standard_normal((B, N_ITEM)).astype(np.float32))
    probe = Probe()
    td.training_losses(probe, t_(x), t_(idx).long(), lt, draws=TE.TrainDraws(
        ts_u=TE.TimestepDraws(ts_u, ts_u), ts=TE.TimestepDraws(ts, ts),
        noise=noise, noise_u=noise_u))
    onehot = torch.stack([1.0 - t_(x), t_(x)], dim=-1)
    assert torch.equal(probe.seen["t"], ts)
    torch.testing.assert_close(probe.seen["x_U"],
                               td.q_sample(onehot, ts_u, noise_u))
    torch.testing.assert_close(probe.seen["x"], td.q_sample(t_(x), ts, noise))
    assert probe.seen["graph"] is probe.seen["x_U"]
    assert probe.seen["rcloss"] is False


def test_ablation_model_sees_clean_input():
    """The ablation model receives x_start and the clean one-hot, whatever
    the corruption; only the graph is the corrupted one-hot."""
    td, _ = engines("ablation", OneHotMatrix=2, steps=5)
    x, idx = rows(8, B)
    probe = Probe()
    td.training_losses(probe, t_(x), t_(idx).long(), TE.LtState.create(5),
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(probe.seen["x"], t_(x))
    assert torch.equal(probe.seen["x_U"],
                       torch.stack([1.0 - t_(x), t_(x)], dim=-1))
    graph = probe.seen["graph"]
    assert graph.shape == (B, N_ITEM, 2)
    # delete-only corruption of the one-hot: a (0, 0) cell somewhere
    assert (graph.sum(-1) == 0).any() and not torch.equal(
        graph, probe.seen["x_U"])


# ---------------------------------------------------------------------------
# p_sample against JAX at equal weights
# ---------------------------------------------------------------------------

class TorchToy:
    """A denoiser that reads every input it is given; no graph is no term."""

    def __call__(self, x, t, x_U=None, index=None, graph=None):
        out = 0.6 * x + 0.01 * t[:, None].float() + 0.05 * index[:, None]
        if x_U is not None:
            out = out + 0.2 * x_U[..., 1]
        if graph is not None:
            out = out + 0.3 * graph[..., 1]
        return out, None


def jax_toy(params, x, t, x_U=None, index=None, graph=None, **_):
    out = 0.6 * x + 0.01 * t[:, None].astype(jnp.float32) \
        + 0.05 * index[:, None]
    if x_U is not None:
        out = out + 0.2 * x_U[..., 1]
    if graph is not None:
        out = out + 0.3 * graph[..., 1]
    return out, None


def legacy_sample_draws(key, b, n, steps, sampling_steps):
    """The draws of the JAX legacy reverse loop under ``key``."""
    k_init_u, k_init_c, k = jax.random.split(key, 3)
    noise = []
    for _ in range(steps):
        k, k_n = jax.random.split(k)
        noise.append(t_(jax.random.normal(k_n, (b, n))))
    init_c = init_noise_u = None
    if sampling_steps > 0:
        init_noise_u = t_(jax.random.normal(k_init_u, (b, n, 2)))
        init_c = t_(jax.random.normal(k_init_c, (b, n)))
    return TE.PSampleDraws(init_c=init_c, noise=noise,
                           init_noise_u=init_noise_u)


SAMPLE_CASES = [
    ("legacy", 0, False, "x0", 2), ("legacy", 3, True, "x0", 2),
    ("legacy", 5, True, "eps", 0), ("legacy", 2, False, "eps", 2),
    ("ablation", 0, False, "x0", 2), ("ablation", 3, True, "x0", 2),
    ("ablation", 4, True, "eps", 0), ("ablation", 2, False, "x0", 0),
]


@pytest.mark.parametrize("variant,ss,noise,mean_type,ohm", SAMPLE_CASES)
def test_p_sample_matches_jax(variant, ss, noise, mean_type, ohm):
    # user_guided 0: the ablation class applies the degree gate anyway
    td, jd = engines(variant, steps=5, mean_type=mean_type, OneHotMatrix=ohm,
                     user_guided=0)
    b, n = 6, 30
    rng = np.random.default_rng(4)
    x = (rng.random((b, n)) < 0.25).astype(np.float32)
    index = np.arange(b, dtype=np.int32)
    key = jax.random.PRNGKey(11)
    want = jd.p_sample(jax_toy, None, jnp.asarray(x), jnp.asarray(index),
                       key, ss, noise)
    draws = (legacy_sample_draws if variant == "legacy" else jax_draws)(
        key, b, n, 5, ss)
    got = td.p_sample(TorchToy(), t_(x), t_(index).long(), ss, noise,
                      draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORES)


def test_ablation_gate_is_always_on():
    """Under user_guided 0, the discrete class grows the graph without the
    degree gate and the ablation class with it: a gate uniform of 1 (never
    under the gate probability) grows nothing under ablation only."""
    b, n = 4, 12
    x = torch.zeros(b, n)
    x[:, :3] = 1.0
    draws = TE.PSampleDraws(sprinkle=[torch.zeros(b, n)] * 5,
                            gate=[torch.ones(b)] * 5)
    seen = {}

    def model(x_in, t, x_U=None, index=None, graph=None):
        seen.setdefault("graphs", []).append(graph)
        return x_in, None

    for variant, grows in (("discrete", True), ("ablation", False)):
        td, _ = engines(variant, steps=5, user_guided=0, OneHotMatrix=0)
        seen.clear()
        td.p_sample(model, x, torch.arange(b), 0, draws=draws)
        assert bool(seen["graphs"][-1][..., 1].any()) is grows, variant


@pytest.mark.parametrize("variant", ["discrete", "legacy", "ablation"])
@pytest.mark.parametrize("ohm", [0, 2])
def test_noise_scale_zero_scan_matches_jax(variant, ohm):
    td, jd = engines(variant, steps=5, noise_scale=0.0, OneHotMatrix=ohm)
    assert td.coeffs is None and jd.coeffs is None
    b, n = 5, 16
    rng = np.random.default_rng(9)
    x = (rng.random((b, n)) < 0.3).astype(np.float32)
    index = np.arange(b, dtype=np.int32)
    want = jd.p_sample(jax_toy, None, jnp.asarray(x), jnp.asarray(index),
                       jax.random.PRNGKey(0), 0)
    seen = []

    def model(*a, **kw):
        seen.append(kw["graph"])
        return TorchToy()(*a, **kw)

    got = td.p_sample(model, t_(x), t_(index).long(), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORES)
    assert len(seen) == 5 and all(g is None for g in seen)
    with pytest.raises(ValueError, match="sampling_steps=0"):
        td.p_sample(model, t_(x), t_(index).long(), 2)


# ---------------------------------------------------------------------------
# the Trainer under each variant
# ---------------------------------------------------------------------------

def trainer_draws(jd, lt, step_key, b, n, backbone, variant):
    k_drop = jax.random.split(step_key, 5)[4]
    return loss_draws(jd, lt, step_key, b, n, variant)._replace(
        dropout=dropout_uniforms(backbone, k_drop, b, n, DIMS[-1]))


STEP_CASES = [("DNN", 0, "legacy"), ("DNN", 0, "ablation"),
              ("DNNOneHot", 2, "legacy"), ("DNNOneHotEmbedding", 2,
                                           "ablation")]


@pytest.mark.parametrize("backbone,ohm,variant", STEP_CASES)
def test_three_train_steps_match_the_jax_trainer(monkeypatch, backbone, ohm,
                                                 variant):
    """As ``test_torch_onehot_modes.py``: K1 in interpret mode on the JAX
    side for every 2-D leaf of 256 elements or more."""
    monkeypatch.setattr(JA, "_MIN_KERNEL_ELEMS", 256)
    jt, jstate, tt = trainer_pair(backbone, ohm, opt_impl="fused",
                                  opt_moment_dtype="float32",
                                  diffusion_variant=variant)
    assert jt._opt_impl == "kernel" and jt._fused_interpret
    assert tt.diffusion.variant == variant == jt.diffusion.variant
    tstate = tt.init_state()
    lr = tt.cfg.lr
    for step in range(3):
        x, idx = rows(30 + step, B)
        _, step_key = jax.random.split(jstate.key)
        draws = trainer_draws(jt.diffusion, jstate.lt, step_key, B, N_ITEM,
                              backbone, variant)
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
            np.testing.assert_allclose(p.detach().numpy(), want_p[name],
                                       err_msg=f"step {step} {name}",
                                       rtol=1e-4, atol=1e-3 * lr)
        for which in ("mu", "nu"):
            want_m = bridged(getattr(jstate.opt_state, which))
            for name, m in getattr(tstate.opt_state, which).items():
                w = np.asarray(want_m[name], np.float32)
                scale = np.abs(w).max() if w.size else 0.0
                np.testing.assert_allclose(
                    m.numpy(), w, rtol=1e-4, atol=1e-5 * scale + 1e-30,
                    err_msg=f"step {step} {which} {name}")
    assert tstate.step == 3 and int(jstate.step) == 3


@pytest.mark.parametrize("variant,noise_scale,ss", [
    ("legacy", 0.01, 0), ("legacy", 0.01, 2), ("ablation", 0.01, 0),
    ("ablation", 0.01, 3), ("discrete", 0.0, 0), ("legacy", 0.0, 0)])
def test_eval_step_topk_matches_jax(variant, noise_scale, ss):
    """The DNN reads no graph, so only the draws of the starting point
    (sampling_steps > 0) can move its scores; they are JAX's."""
    kw = dict(diffusion_variant=variant, noise_scale=noise_scale,
              sampling_steps=ss)
    if noise_scale == 0.0:
        kw["reweight"] = False
    jt, jstate, tt = trainer_pair("DNN", 0, **kw)
    x, idx = rows(21, B, p=0.25)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jt._eval_step(
        jstate.params, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(x),
        key, sampling_steps=ss, top_k=12))
    draws = (legacy_sample_draws if variant == "legacy" else jax_draws)(
        key, B, N_ITEM, 5, ss)
    got = tt.eval_step(t_(x), t_(idx), t_(x), sampling_steps=ss, top_k=12,
                       draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)


def test_noise_scale_zero_refuses_graph_backbone():
    """noise_scale=0's reverse path has no synthetic graph; a backbone that
    reads one (the GCN family) is refused at construction, as the JAX
    Trainer refuses it. Graph-free backbones train and serve."""
    kw = dict(dims=[32], emb_size=10, steps=5, noise_scale=0.0,
              reweight=False, batch_size=16, sampling_steps=0)
    with pytest.raises(ValueError, match="noise_scale=0 cannot serve"):
        TTrainer(TConfig(backbone="DNNOneHotEmbeddingGCN", device="cpu",
                         **kw), 64, 48)
    tt = TTrainer(TConfig(backbone="DNN", device="cpu", **kw), 64, 48)
    state = tt.init_state()
    x = (torch.rand(16, 48, generator=torch.Generator().manual_seed(0))
         < 0.2).float()
    state, loss = tt.train_step(state, x, torch.arange(16))
    assert torch.isfinite(loss)
    ids = tt.eval_step(x, torch.arange(16), x, sampling_steps=0, top_k=5)
    assert ids.shape == (16, 5)
