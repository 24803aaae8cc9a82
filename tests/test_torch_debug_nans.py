"""``debug_nans`` in the port against ``jax_debug_nans`` in the JAX Trainer.

The same weights (carried across by ``gdmcf_torch.compat``), the same
batch and, where both steps must agree, the JAX step's own draws. A NaN is
planted in the loss path (a full Lt history with one NaN, which reaches
only the importance weights that divide the loss), in a gradient (an
identity on the output layer's weight whose backward returns NaN) and in a
parameter. With the flag on both Trainers raise ``FloatingPointError``;
with it off neither raises and their steps agree (rtol 1e-5 on the loss,
rtol 1e-4 / atol 1e-3 lr on the parameters, NaN where the other has NaN).
The port also checks the parameters and moments after an update that
made them non-finite, on both K1 forms (``opt_impl`` fused and optax), and
the scores of ``evaluate``, ``evaluate_streaming`` and
``Recommender.recommend_batch``.

The JAX Trainer sets ``jax_debug_nans`` for the whole process, so a
fixture sets it back after each case.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.data.native import NativeCSR  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.serve import Recommender  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.diffusion import engine as JE  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

N_USER, N_ITEM, B = 24, 20, 8
CFG = dict(backbone="DNN", OneHotMatrix=0, dims=[16], emb_size=10, steps=5,
           batch_size=B, lr=1e-3, sampling_steps=0, history_num_per_term=2,
           topN=[5])
PLANTS = ("loss", "gradient", "parameter")


@pytest.fixture(autouse=True)
def _jax_debug_nans_off():
    yield
    jax.config.update("jax_debug_nans", False)


def t_(a):
    return torch.from_numpy(np.array(a))


def batch(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
    return x, rng.choice(N_USER, B, replace=False).astype(np.int32)


def pair(debug: bool, **kw):
    cfg = dict(CFG, debug_nans=debug, **kw)
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM)
    jstate = jt.init_state()
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM)
    tt.model.load_state_dict({
        k: t_(np.asarray(v, np.float32)) for k, v in
        compat.state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate.params)).items()})
    return jt, jstate, tt, tt.init_state()


class _NanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, float("nan"))


@jax.custom_vjp
def _nan_grad(w):
    return w


_nan_grad.defvjp(lambda w: (w, None),
                 lambda _, g: (jnp.full_like(g, jnp.nan),))


def plant(which, jt, jstate, tt, tstate):
    """The NaN ``which`` in both Trainers; returns the JAX state. Made
    with the JAX check off (putting a NaN into an array trips it)."""
    on = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", False)
    try:
        return _plant(which, jt, jstate, tt, tstate)
    finally:
        jax.config.update("jax_debug_nans", on)


def _plant(which, jt, jstate, tt, tstate):
    if which == "loss":
        hist = np.ones((CFG["steps"], 2), np.float32)
        hist[2, 1] = np.nan
        count = np.full(CFG["steps"], 2, np.int32)
        tstate.lt = TE.LtState(t_(hist), t_(count))
        return jstate._replace(lt=JE.LtState(jnp.asarray(hist),
                                             jnp.asarray(count)))
    if which == "gradient":
        layer = tt.model.out_layers[-1]
        layer.forward = lambda x: torch.nn.functional.linear(
            x, _NanGrad.apply(layer.weight), layer.bias)
        apply = jt.model.apply

        def nan_apply(p, *a, **k):
            outs = list(p["out_layers"])
            outs[-1] = dict(outs[-1], w=_nan_grad(outs[-1]["w"]))
            return apply(dict(p, out_layers=outs), *a, **k)
        jt.model = jt.model._replace(apply=nan_apply)
        return jstate
    with torch.no_grad():
        tt.model.in_layers[0].weight[3, 5] = float("nan")
    params = dict(jstate.params)
    layer = dict(params["in_layers"][0])
    layer["w"] = layer["w"].at[5, 3].set(jnp.nan)
    params["in_layers"] = [layer]
    return jstate._replace(params=params)


def jax_draws(jt, jstate):
    """The draws of the JAX step under its state's key (DNN at OneHotMatrix
    0: the timesteps, the noise and one dropout mask)."""
    _, step_key = jax.random.split(jstate.key)
    _, _, k_ts, k_noise, k_drop = jax.random.split(step_key, 5)
    t, _ = jt.diffusion.sample_timesteps(k_ts, jstate.lt, B)
    (k,) = jax.random.split(k_drop, 1)
    return TE.TrainDraws(
        ts=TE.TimestepDraws(t_(t), t_(t)),
        noise=t_(jax.random.normal(k_noise, (B, N_ITEM))),
        dropout=(t_(jax.random.uniform(k, (B, N_ITEM))),))


@pytest.mark.parametrize("which", PLANTS)
def test_both_trainers_raise_at_a_planted_nan(which):
    jt, jstate, tt, tstate = pair(True)
    jstate = plant(which, jt, jstate, tt, tstate)
    x, idx = batch()
    with pytest.raises(FloatingPointError):
        jt._train_step(jstate, jnp.asarray(x), jnp.asarray(idx))
    jax.config.update("jax_debug_nans", False)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        tt.train_step(tstate, t_(x), t_(idx))


@pytest.mark.parametrize("which", PLANTS)
def test_with_the_flag_off_neither_raises_and_the_steps_agree(which):
    jt, jstate, tt, tstate = pair(False)
    jstate = plant(which, jt, jstate, tt, tstate)
    x, idx = batch()
    draws = jax_draws(jt, jstate)
    jstate, jloss = jt._train_step(jstate, jnp.asarray(x), jnp.asarray(idx))
    tstate, tloss = tt.train_step(tstate, t_(x), t_(idx), draws=draws)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    if which != "loss":   # NaN timestep weights pick no same timestep
        want = compat.state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jstate.params))
        for name, p in tstate.params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), want[name], rtol=1e-4,
                atol=1e-3 * CFG["lr"], equal_nan=True, err_msg=name)
    if which == "gradient":
        assert torch.isnan(tstate.params["out_layers.0.weight"]).all()


@pytest.mark.parametrize("opt_impl,param_dtype", [
    ("fused", "float32"), ("optax", "float32"), ("optax", "bfloat16")])
def test_the_update_check_names_the_tensor(opt_impl, param_dtype):
    # an infinite gradient (not NaN: the backward check passes it) makes
    # the moments and the parameter non-finite in the update
    _, _, tt, tstate = pair(True, opt_impl=opt_impl,
                            param_dtype=param_dtype)
    x, idx = batch()
    _, grads, new_lt = tt.loss_and_grads(tstate, t_(x), t_(idx))
    grads["emb_layer.bias"][0] = float("inf")
    with pytest.raises(FloatingPointError,
                       match=r"\['emb_layer\.bias'\] after the AdamW"):
        tt.apply_grads(tstate, grads, new_lt)


def test_a_clean_step_is_the_same_with_the_flag_on_and_off():
    x, idx = batch(3)
    out = []
    for debug in (False, True):
        _, _, tt, tstate = pair(debug)
        tstate, loss = tt.train_step(tstate, t_(x), t_(idx))
        out.append((loss.item(), {k: p.detach().clone()
                                  for k, p in tstate.params.items()}))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_the_eval_paths_raise_on_non_finite_scores():
    _, _, tt, tstate = pair(True)
    rng = np.random.default_rng(1)
    rows = (rng.random((N_USER, N_ITEM)) < 0.3).astype(np.float32)
    gt = (rng.random((N_USER, N_ITEM)) < 0.2).astype(np.float32)
    assert len(tt.evaluate(tstate, rows, gt, rows, [5])) == 4
    with torch.no_grad():
        tt.model.out_layers[0].bias[7] = float("nan")
    with pytest.raises(FloatingPointError, match="sampled scores"):
        tt.evaluate(tstate, rows, gt, rows, [5])
    nat = [NativeCSR.from_scipy(sp.csr_matrix(rows))]
    with pytest.raises(FloatingPointError, match="sampled scores"):
        tt.evaluate_streaming(tstate, nat, NativeCSR.from_scipy(
            sp.csr_matrix(gt), strict=False), nat, [5])
    rec = Recommender.from_state(tt, None, sp.csr_matrix(rows), serve_batch=8,
                                 k_max=5)
    with pytest.raises(FloatingPointError, match="sampled scores"):
        rec.recommend_batch([0, 1], np.ones(2, bool))
