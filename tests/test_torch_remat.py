"""The NT-Xent ``remat`` form: the softmax form under
``torch.utils.checkpoint``, its [B, B] softmax recomputed in the backward
instead of stored (the JAX package's ``jax.checkpoint`` of the core).

Tolerances: against the softmax form, the loss and its gradients exactly
(the recomputation repeats the same operations on the same inputs);
against JAX's remat, the forward's rtol 1e-5 / atol 1e-6, and the
gradients rtol 2e-3 with an atol of 1e-5 of the largest gradient: the
gradient divides by the off-diagonal softmax mass, a float32 sum near 1
minus the diagonal, so the two packages' roundings of that sum are
amplified where the positive dominates (at seed 1 the port's softmax-form
gradient is 7.9e-4 from float64 at its largest, 1.67, JAX's 6.1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.models import layers as TL  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.models import layers as JL  # noqa: E402


def latents(seed, b=9, d=7):
    rng = np.random.default_rng(seed)
    return [np.tanh(rng.standard_normal((b, d))).astype(np.float32)
            for _ in range(2)]


def port_loss_and_grads(z1, z2):
    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z2, requires_grad=True)
    loss = TL.nt_xent_loss(a, b)
    ga, gb = torch.autograd.grad(loss, [a, b])
    return loss.detach(), ga, gb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remat_equals_the_softmax_form_and_jax_remat(monkeypatch, seed):
    z1, z2 = latents(seed)
    monkeypatch.setattr(TL, "_NT_XENT_IMPL", "softmax")
    soft = port_loss_and_grads(z1, z2)
    monkeypatch.setattr(TL, "_NT_XENT_IMPL", "remat")
    remat = port_loss_and_grads(z1, z2)
    for a, b in zip(remat, soft):
        assert torch.equal(a, b)
    monkeypatch.setattr(JL, "_NT_XENT_IMPL", "remat")
    want, (w1, w2) = jax.value_and_grad(JL.nt_xent_loss, argnums=(0, 1))(
        z1, z2)
    np.testing.assert_allclose(remat[0].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for got, w in zip(remat[1:], (w1, w2)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-3,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_a_flagship_step_under_remat_equals_the_softmax_form(monkeypatch):
    """One flagship train step: the loss and every gradient of the remat
    form equal the softmax form's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((8, 20)) < 0.3).astype(np.float32))
    idx = torch.arange(8, dtype=torch.int32)
    out = {}
    for form in ("softmax", "remat"):
        monkeypatch.setattr(TL, "_NT_XENT_IMPL", form)
        cfg = TConfig(device="cpu", dims=[16], batch_size=8, steps=5,
                      noise_scale=1e-4, sampling_steps=0)
        t = TTrainer(cfg, 12, 20)
        state = t.init_state()
        out[form] = t.loss_and_grads(state, x, idx)
    (l1, g1, _), (l2, g2, _) = out["softmax"], out["remat"]
    assert torch.equal(l1, l2)
    assert set(g1) == set(g2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_remat_keeps_no_rng_state_and_equals_the_form_that_did():
    """The remat form checkpoints without keeping the RNG state (reading
    the CUDA RNG state is not allowed while a CUDA graph captures the
    step; the core draws nothing): at seed 1 its loss and gradients equal,
    bitwise, the same checkpoint made with the RNG state kept."""
    from torch.utils.checkpoint import checkpoint

    z1, z2 = latents(1)
    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z2, requires_grad=True)
    kept = checkpoint(TL.nt_xent_softmax_core, a, b, 0.1, 1e-5,
                      use_reentrant=False, preserve_rng_state=True)
    want = (kept.detach(), *torch.autograd.grad(kept, [a, b]))
    old = TL._NT_XENT_IMPL
    TL._NT_XENT_IMPL = "remat"
    try:
        got = port_loss_and_grads(z1, z2)
    finally:
        TL._NT_XENT_IMPL = old
    for g, w in zip(got, want):
        assert torch.equal(g, w)
