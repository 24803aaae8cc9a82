"""Layers, schedules and the discrete diffusion engine of the port against
the JAX package, on inputs made from a seed with numpy.

Stochastic functions take JAX's own draws: the test replays the JAX
package's key splits and hands the resulting uniforms and normals to the
port, so both sample the same cells. Elementwise results are held to
rtol 1e-6 / atol 1e-7 (float32 arithmetic in another order); the reverse
sampler, which runs small matrix products, to rtol 1e-5 / atol 1e-6.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.diffusion import schedules as TS  # noqa: E402
from gdmcf_torch.models import layers as TL  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.diffusion import engine as JE  # noqa: E402
from gdmcf_tpu.diffusion import schedules as JS  # noqa: E402
from gdmcf_tpu.models import layers as JL  # noqa: E402

EW = dict(rtol=1e-6, atol=1e-7)


def t_(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_mlp_applies_match_jax_with_bridged_weights():
    dims_in, dims_out = [23, 16, 12], [12, 9, 30]
    jp = {"in_layers": JL.mlp_init(jax.random.PRNGKey(0), dims_in),
          "out_layers": JL.mlp_init(jax.random.PRNGKey(1), dims_out)}
    jp = jax.tree_util.tree_map(np.asarray, jp)
    g = torch.Generator().manual_seed(0)
    holder = torch.nn.Module()
    holder.in_layers = TL.mlp_init(dims_in, g)
    holder.out_layers = TL.mlp_init(dims_out, g)
    holder.load_state_dict({k: t_(v) for k, v in
                            compat.state_dict_from_jax_params(jp).items()})
    h = np.random.default_rng(0).standard_normal((5, 23)).astype(np.float32)
    with torch.no_grad():
        got = TL.mlp_out(holder.out_layers,
                         TL.mlp_tanh(holder.in_layers, t_(h)))
        one = TL.linear(holder.in_layers[0], t_(h))
    want = JL.mlp_out(jp["out_layers"], JL.mlp_tanh(jp["in_layers"], h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(one.numpy(),
                               np.asarray(JL.linear(jp["in_layers"][0], h)),
                               rtol=1e-5, atol=1e-6)


def test_inits_follow_the_reference_distributions():
    g = torch.Generator().manual_seed(3)
    lin = TL.linear_init(400, 300, g)
    assert lin.weight.shape == (300, 400)
    std = math.sqrt(2.0 / 700)
    assert abs(lin.weight.std().item() / std - 1) < 0.02
    assert abs(lin.bias.std().item() / 0.001 - 1) < 0.2
    table = TL.xavier_uniform((500, 64), g)
    limit = math.sqrt(6.0 / 564)
    assert table.abs().max().item() <= limit
    assert abs(table.std().item() / (limit / math.sqrt(3)) - 1) < 0.02
    # the same generator seed gives the same parameters
    again = TL.linear_init(400, 300, torch.Generator().manual_seed(3))
    torch.testing.assert_close(again.weight, lin.weight, rtol=0, atol=0)


@pytest.mark.parametrize("dim", [10, 7])
def test_timestep_embedding_matches_jax(dim):
    # atol 1e-5: sin/cos of float32 arguments near 1e3 differ between the
    # two math libraries by a few 1e-6
    ts = np.array([0, 1, 4, 99, 999], np.int64)
    np.testing.assert_allclose(
        TL.timestep_embedding(t_(ts), dim).numpy(),
        np.asarray(JL.timestep_embedding(jnp.asarray(ts), dim)),
        rtol=1e-6, atol=1e-5)


def test_l2_normalize_and_dropout():
    x = np.random.default_rng(1).standard_normal((4, 9)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(TL.l2_normalize(t_(x)).numpy(),
                               np.asarray(JL.l2_normalize(x)), **EW)
    xt = torch.ones(200, 50)
    assert TL.dropout(xt, 0.5, train=False) is xt
    out = TL.dropout(xt, 0.5, train=True,
                     generator=torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    assert abs((out > 0).float().mean().item() - 0.5) < 0.02


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["linear", "linear-var", "cosine",
                                      "binomial"])
@pytest.mark.parametrize("beta_fixed", [True, False])
def test_betas_and_coeffs_match_jax(schedule, beta_fixed):
    args = (schedule, 12, 0.3, 0.001, 0.02, beta_fixed)
    betas = TS.get_betas(*args)
    np.testing.assert_allclose(betas, JS.get_betas(*args), rtol=1e-15,
                               atol=0)
    tc, jc = TS.compute_coeffs(betas), JS.compute_coeffs(betas)
    for name in JS.DiffusionCoeffs._fields:
        got = getattr(tc, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), getattr(jc, name),
                                   rtol=1e-7, atol=0, err_msg=name)
    t = np.array([0, 3, 11, -1])
    np.testing.assert_array_equal(
        TS.extract(tc.betas, t_(t), 3).numpy(),
        np.asarray(JS.extract(jc.betas, jnp.asarray(t), 3)))


# ---------------------------------------------------------------------------
# diffusion engine
# ---------------------------------------------------------------------------

def engines(**kw):
    base = dict(steps=5, noise_scale=1.0, noise_min=0.001, noise_max=0.02,
                noise_schedule="linear-var")
    base.update(kw)
    return (TE.Diffusion.create(TConfig(device="cpu", **base)),
            JE.Diffusion.create(JConfig(**base)))


def test_continuous_channel_matches_jax():
    td, jd = engines(mean_type="eps")
    rng = np.random.default_rng(2)
    x0, xt, noise = (rng.standard_normal((6, 11)).astype(np.float32)
                     for _ in range(3))
    t = rng.integers(0, 5, 6)
    for got, want in (
            (td.q_sample(t_(x0), t_(t), t_(noise)),
             jd.q_sample(x0, jnp.asarray(t), noise)),
            (td.q_posterior_mean(t_(x0), t_(xt), t_(t)),
             jd.q_posterior_mean(x0, xt, jnp.asarray(t))),
            (td.predict_xstart_from_eps(t_(xt), t_(t), t_(noise)),
             jd.predict_xstart_from_eps(xt, jnp.asarray(t), noise))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EW)


@pytest.mark.parametrize("fidelity", [True, False])
def test_discrete_channel_matches_jax(fidelity):
    td, jd = engines(fidelity=fidelity)
    rng = np.random.default_rng(3)
    x = (rng.random((3, 40)) < 0.3).astype(np.float32)
    ts = np.array([0, 2, 4])
    # B=3 < steps=5: the reference's ts / B overshoots 1 and is clipped
    a_t = td._alpha_bar_discrete(t_(ts), 3)
    a_j = jd._alpha_bar_discrete(jnp.asarray(ts), 3)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **EW)
    assert a_t.max().item() <= 1.0
    np.testing.assert_allclose(td.discrete_p_one(a_t, t_(x)).numpy(),
                               np.asarray(jd.discrete_p_one(a_j, x)), **EW)
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, x.shape)
    np.testing.assert_array_equal(
        td.corrupt_discrete(t_(ts), t_(x), u=t_(u)).numpy(),
        np.asarray(jd.corrupt_discrete(key, jnp.asarray(ts), x)))


class _TorchToy:
    """A denoiser that reads every input, graph included."""

    def __call__(self, x, t, x_U=None, index=None, graph=None):
        out = 0.6 * x + 0.01 * t[:, None].float() + 0.05 * index[:, None]
        if x_U is not None:
            out = out + 0.2 * x_U[..., 1]
        return out + 0.3 * graph[..., 1], None


def _jax_toy(params, x, t, x_U=None, index=None, graph=None, **_):
    out = 0.6 * x + 0.01 * t[:, None].astype(jnp.float32) \
        + 0.05 * index[:, None]
    if x_U is not None:
        out = out + 0.2 * x_U[..., 1]
    return out + 0.3 * graph[..., 1], None


def jax_draws(key, b, n, steps, sampling_steps):
    """The uniforms and normals the JAX sampler draws, in its key order."""
    k_init_u, k_init_c, k = jax.random.split(key, 3)
    sprinkle, gate, noise = [], [], []
    for _ in range(steps):
        k, k_s, k_g, k_n = jax.random.split(k, 4)
        sprinkle.append(t_(jax.random.uniform(k_s, (b, n))))
        gate.append(t_(jax.random.uniform(k_g, (b,))))
        noise.append(t_(jax.random.normal(k_n, (b, n))))
    init_u = init_c = None
    if sampling_steps > 0:
        init_u = t_(jax.random.uniform(k_init_u, (b, n)))
        init_c = t_(jax.random.normal(k_init_c, (b, n)))
    return TE.PSampleDraws(init_u, init_c, sprinkle, gate, noise)


@pytest.mark.parametrize("sampling_steps,sampling_noise,mean_type,guided", [
    (0, False, "x0", 1),
    (3, True, "x0", 1),
    (5, True, "eps", 0),
    (2, False, "eps", 1),
])
def test_p_sample_with_jax_draws_matches_jax(sampling_steps, sampling_noise,
                                             mean_type, guided):
    td, jd = engines(mean_type=mean_type, user_guided=guided)
    b, n = 6, 30
    rng = np.random.default_rng(4)
    x = (rng.random((b, n)) < 0.25).astype(np.float32)
    index = np.arange(b, dtype=np.int32)
    key = jax.random.PRNGKey(11)
    want = jd.p_sample(_jax_toy, None, jnp.asarray(x), jnp.asarray(index),
                       key, sampling_steps, sampling_noise)
    got = td.p_sample(_TorchToy(), t_(x), t_(index).long(), sampling_steps,
                      sampling_noise,
                      draws=jax_draws(key, b, n, 5, sampling_steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_p_sample_all_zero_batch_keeps_the_degree_gate_floor():
    """An all-zero batch would divide by zero; the floor turns the gate
    off instead (the JAX package's always-on repair)."""
    td, jd = engines()
    x = np.zeros((4, 12), np.float32)
    index = np.arange(4, dtype=np.int32)
    key = jax.random.PRNGKey(2)
    want = jd.p_sample(_jax_toy, None, jnp.asarray(x), jnp.asarray(index),
                       key, 0)
    got = td.p_sample(_TorchToy(), t_(x), t_(index).long(), 0,
                      draws=jax_draws(key, 4, 12, 5, 0))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_unported_variants_raise():
    """The legacy and ablation variants, once refused, are ported
    (``test_torch_variants.py``); a variant name the JAX package does not
    know raises."""
    cfg = TConfig(device="cpu", steps=5, noise_scale=0.1)
    for variant in ("legacy", "ablation"):
        assert TE.Diffusion.create(cfg, variant=variant).variant == variant
    with pytest.raises(ValueError, match="variant"):
        TE.Diffusion.create(cfg, variant="continuous")
