"""Every denoiser backbone of the port against the JAX package: forward in
eval and train mode, gradients, the parameter inventory through the weight
bridge, the registry's flags, the transformer's inits, the aggregation
helpers of ``models/gcn.py`` and the contrastive-loss request.

Weights are the JAX init carried across by ``compat``; inputs come from
numpy seeds; dropout takes JAX's own uniforms, in JAX's key-split order.

Tolerances: forward rtol 1e-5 / atol 1e-6 (float32 products of a few
hundred terms summed in another order, through tanh, softmax and
LayerNorm); gradients rtol 1e-4 and an atol of 1e-5 times the tensor's
largest gradient (at least 1e-6), since an entry that is a sum of
cancelling terms keeps an absolute error of the size of its largest terms.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: few intra-op threads
# each keep the machine from being oversubscribed
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.models import gcn as TG  # noqa: E402
from gdmcf_torch.models import layers as TL  # noqa: E402
from gdmcf_torch.models.registry import BACKBONES, build_model  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.models import gcn as JG  # noqa: E402
from gdmcf_tpu.models.registry import BACKBONES as J_BACKBONES  # noqa: E402
from gdmcf_tpu.models.registry import build_model as j_build_model  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)
N_USER, N_ITEM, B = 12, 20, 6
EMB, NHEAD, LAYERS = 10, 2, 2
# the backbones this slice ports (the flagship and lightGCN have their own
# test files)
NEW = ("DNN", "DNN_conti", "DNNCat", "DNNCat2", "DNNOneHot",
       "DNNOneHotEmbedding", "DNNOneHotEmbedding_conti",
       "DNNOneHotTransformer")
TWO_TOWERS = ("DNNOneHot", "DNNOneHotEmbedding", "DNNOneHotEmbedding_conti",
              "DNNOneHotEmbeddingGCN", "DNNOneHotEmbeddingGCN_conti")


def grad_tol(want):
    return dict(rtol=1e-4, atol=max(1e-6, 1e-5 * float(np.abs(want).max())))


def t_(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def dropout_uniforms(backbone, key, b, n, d_ff=16):
    """The uniforms the JAX apply of ``backbone`` draws its dropout masks
    from under ``key`` (``bernoulli(p)`` is ``uniform < p``), in its
    key-split order: one [b, n] for the DNN family, x's and x_U's for the
    two-tower family, and for the transformer those two and then, per
    encoder layer, the attention output, the FFN output, the attention
    weights and the FFN inner activation."""
    def u(k, shape):
        return t_(jax.random.uniform(k, shape))

    if backbone in TWO_TOWERS:
        k1, k2 = jax.random.split(key, 2)
        return (u(k1, (b, n)), u(k2, (b, 2 * n)))
    if backbone == "DNNOneHotTransformer":
        ks = jax.random.split(key, 2 + 2 * LAYERS)
        out = [u(ks[0], (b, n)), u(ks[1], (b, 2 * n))]
        for i in range(2 * LAYERS):
            d = n + EMB if i < LAYERS else 2 * n + EMB
            k1, k2, k_att, k_ff = jax.random.split(ks[2 + i], 4)
            out += [u(k1, (b, d)), u(k2, (b, d)), u(k_att, (NHEAD, b, b)),
                    u(k_ff, (b, d_ff))]
        return tuple(out)
    (k,) = jax.random.split(key, 1)
    return (u(k, (b, n)),)


def pair(backbone, **kw):
    base = dict(backbone=backbone, dims=[16], emb_size=EMB, steps=5,
                noise_scale=1e-4, OneHotMatrix=2)
    base.update(kw)
    jm = j_build_model(JConfig(**base), N_USER, N_ITEM)
    jp = np_tree(jm.init(jax.random.PRNGKey(7)))
    tm = build_model(TConfig(device="cpu", **base), N_USER, N_ITEM,
                     generator=torch.Generator().manual_seed(0))
    tm.load_state_dict({k: t_(v) for k, v in
                        compat.state_dict_from_jax_params(jp).items()})
    return jm, jp, tm


def inputs(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N_ITEM)).astype(np.float32)
    c1 = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
    c0 = (1.0 - c1) * (rng.random((B, N_ITEM)) < 0.9)
    x_u = np.stack([c0, c1], axis=-1).astype(np.float32)
    t = rng.integers(0, 5, B)
    index = rng.choice(N_USER, B, replace=False).astype(np.int32)
    return x, t, x_u, index


def run_both(backbone, jm, jp, tm, train, d_ff=16, seed=5):
    x, t, x_u, index = inputs(seed)
    key = jax.random.PRNGKey(9)
    want, wcl = jm.apply(jp, x, jnp.asarray(t), x_u, index=index, graph=x_u,
                         rcloss=True, train=train, rng=key)
    tm.train(train)
    got, gcl = tm(t_(x), t_(t), t_(x_u), index=t_(index).long(),
                  graph=t_(x_u), rcloss=True,
                  dropout_u=dropout_uniforms(backbone, key, B, N_ITEM, d_ff))
    return (got, gcl), (want, wcl)


def assert_same(got_pair, want_pair):
    (got, gcl), (want, wcl) = got_pair, want_pair
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    assert (gcl is None) == (wcl is None)
    if gcl is not None:
        np.testing.assert_allclose(gcl.detach().numpy(), np.asarray(wcl),
                                   **FWD)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("backbone", NEW)
def test_forward_matches_jax(backbone, train):
    jm, jp, tm = pair(backbone)
    got, want = run_both(backbone, jm, jp, tm, train)
    assert_same(got, want)
    if train:   # dropout is on: the masks came from JAX's uniforms
        tm.eval()
        with torch.no_grad():
            x, t, x_u, index = inputs()
            plain, _ = tm(t_(x), t_(t), t_(x_u), index=t_(index).long())
        assert not torch.allclose(plain, got[0])


VARIANTS = [("DNN", dict(norm=True)), ("DNN", dict(dims=[16, 8])),
            ("DNNCat", dict(norm=True, dims=[16, 8])),
            ("DNNCat2", dict(norm=True)), ("DNNOneHot", dict(norm=True)),
            ("DNNOneHot", dict(dims=[16, 8])),
            ("DNNOneHotEmbedding", dict(fidelity=False, norm=True)),
            ("DNNOneHotEmbedding_conti", dict(dims=[16, 8])),
            ("DNNOneHotTransformer", dict(norm=True)),
            ("DNNOneHotTransformer", dict(dims=[16, 8], dropout=0.2))]


@pytest.mark.parametrize("backbone,kw", VARIANTS, ids=lambda v: (
    v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items())))
def test_forward_variants_match_jax(backbone, kw):
    jm, jp, tm = pair(backbone, **kw)
    for train in (False, True):
        assert_same(*run_both(backbone, jm, jp, tm, train))


@pytest.mark.parametrize("backbone", NEW)
def test_gradients_match_jax(backbone):
    jm, jp, tm = pair(backbone)
    x, t, x_u, index = inputs(6)
    w = np.random.default_rng(8).standard_normal((B, N_ITEM)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)

    def j_loss(p):
        s, cl = jm.apply(p, x, jnp.asarray(t), x_u, index=index, graph=x_u,
                         rcloss=True, train=True, rng=key)
        return jnp.sum(s * w) + (cl if cl is not None else 0.0)

    jg = compat.state_dict_from_jax_params(np_tree(jax.grad(j_loss)(jp)))
    tm.train()
    s, cl = tm(t_(x), t_(t), t_(x_u), index=t_(index).long(), graph=t_(x_u),
               rcloss=True,
               dropout_u=dropout_uniforms(backbone, key, B, N_ITEM))
    loss = (s * t_(w)).sum() + (cl if cl is not None else 0.0)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    assert set(names) == set(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], err_msg=name,
                                   **grad_tol(jg[name]))
    if backbone == "DNN_conti":   # the tables are off the forward path
        assert not any(g.any() for n, g in zip(names, grads)
                       if n.startswith("embedding_"))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_bridge_roundtrip_covers_every_backbone_tree(backbone):
    """The port's parameters (and lightGCN's buffers), names and shapes,
    are the JAX init tree through the bridge, and the bridge carries the
    port's state_dict back to that tree leaf for leaf."""
    _, jp, tm = pair(backbone)
    sd = tm.state_dict()
    want = compat.state_dict_from_jax_params(jp)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: v.shape for k, v in want.items()}
    back = compat.jax_params_from_state_dict(sd)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        got = back
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(got, leaf)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jp))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_registry_builds_every_name_with_the_jax_flags(backbone):
    assert BACKBONES == J_BACKBONES
    cfg = dict(backbone=backbone, dims=[8], steps=5, noise_scale=1e-4)
    jm = j_build_model(JConfig(**cfg), 4, 6)
    tm = build_model(TConfig(device="cpu", **cfg), 4, 6,
                     generator=torch.Generator().manual_seed(0))
    assert (tm.needs_onehot, tm.needs_index, tm.needs_graph) == \
        (jm.needs_onehot, jm.needs_index, jm.needs_graph)
    if hasattr(tm, "cosine_eps"):
        assert tm.cosine_eps == 0.0
        assert build_model(TConfig(device="cpu", fidelity=False, **cfg), 4, 6,
                           generator=torch.Generator()).cosine_eps == 1e-8
    assert getattr(tm, "conti", backbone.endswith("_conti")) == \
        backbone.endswith("_conti")


def test_registry_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="not implemented backbone"):
        build_model(TConfig(backbone="nope", device="cpu"), 4, 5,
                    generator=torch.Generator())


# ---------------------------------------------------------------------------
# inits
# ---------------------------------------------------------------------------

def uniform_bound_ok(w, bound, n_min=2000):
    """Within [-bound, bound] and, with enough draws, the std of
    U(-bound, bound) within 5%."""
    assert w.abs().max().item() <= bound
    if w.numel() >= n_min:
        assert abs(w.std().item() / (bound / math.sqrt(3)) - 1) < 0.05


def test_torch_linear_default_draws_torch_bounds():
    layer = TL.torch_linear_default(400, 300, torch.Generator().manual_seed(0))
    bound = 1 / math.sqrt(400)
    uniform_bound_ok(layer.weight, bound)
    uniform_bound_ok(layer.bias, bound, n_min=300)
    assert layer.weight.shape == (300, 400) and layer.bias.abs().min() > 0
    # the bound nn.Linear's own reset_parameters uses
    ref = torch.nn.Linear(400, 300)
    assert ref.weight.abs().max().item() <= bound


@pytest.mark.parametrize("enc", ["enc1", "enc2"])
def test_transformer_encoder_inits_are_torch_defaults(enc):
    n, dims = 40, [64]
    tm = build_model(TConfig(backbone="DNNOneHotTransformer", dims=dims,
                             device="cpu"), N_USER, n,
                     generator=torch.Generator().manual_seed(1))
    d = n + EMB if enc == "enc1" else 2 * n + EMB
    d_ff = dims[-1]
    layers = getattr(tm, enc)
    assert len(layers) == LAYERS
    for layer in layers:
        assert layer.nhead == NHEAD and layer.dropout_rate == 0.5
        assert layer.qkv.weight.shape == (3 * d, d)
        uniform_bound_ok(layer.qkv.weight, math.sqrt(6 / (4 * d)))
        uniform_bound_ok(layer.out.weight, 1 / math.sqrt(d))
        uniform_bound_ok(layer.ff1.weight, 1 / math.sqrt(d))
        uniform_bound_ok(layer.ff1.bias, 1 / math.sqrt(d), n_min=10 ** 9)
        uniform_bound_ok(layer.ff2.weight, 1 / math.sqrt(d_ff))
        uniform_bound_ok(layer.ff2.bias, 1 / math.sqrt(d_ff), n_min=10 ** 9)
        assert layer.ff1.weight.shape == (d_ff, d)
        assert not layer.qkv.bias.any() and not layer.out.bias.any()
        assert layer.ff1.bias.any() and layer.ff2.bias.any()
        for ln in (layer.ln1, layer.ln2):
            assert ln.eps == 1e-5 and (ln.weight == 1).all()
            assert not ln.bias.any()
    # the reference's MLP inits stay Xavier-normal
    assert tm.out_layers[0].weight.shape == (n, 3 * n + 2 * EMB)


def test_transformer_attention_mixes_batch_rows():
    """seq_len = B: changing one row moves every row's output."""
    _, _, tm = pair("DNNOneHotTransformer")
    tm.eval()
    x, t, x_u, index = inputs()
    x2 = x.copy()
    x2[0] += 1.0
    with torch.no_grad():
        a, _ = tm(t_(x), t_(t), t_(x_u))
        b, _ = tm(t_(x2), t_(t), t_(x_u))
    assert (a[1:] != b[1:]).any(dim=1).all()


# ---------------------------------------------------------------------------
# aggregation helpers
# ---------------------------------------------------------------------------

def test_mean_aggregation_matches_jax():
    rng = np.random.default_rng(3)
    hu = rng.standard_normal((B, 8)).astype(np.float32)
    hi = rng.standard_normal((N_ITEM, 8)).astype(np.float32)
    g = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
    got = TG.mean_aggregation(t_(hu), t_(hi), t_(g))
    want = JG.mean_aggregation(hu, hi, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **FWD)
    assert not got[0].any() and got[1].shape == (N_ITEM, 8)


def test_mini_lightgcn_is_degenerate_as_in_jax():
    rng = np.random.default_rng(4)
    hu = rng.standard_normal((B, 8)).astype(np.float32)
    hi = rng.standard_normal((N_ITEM, 8)).astype(np.float32)
    g = (rng.random((B, N_ITEM)) < 0.5).astype(np.float32)
    got = TG.mini_lightgcn_apply(t_(hu), t_(hi), t_(g))
    want = JG.mini_lightgcn_apply(hu, hi, g)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        assert not a.any()
    assert got[0].shape == (B, 8) and got[1].shape == (N_ITEM, 8)


# ---------------------------------------------------------------------------
# the contrastive loss is asked of the indexIn models only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["DNN", "DNNCat", "DNNOneHot",
                                      "DNNOneHotTransformer",
                                      "DNNOneHotEmbedding",
                                      "DNNOneHotEmbeddingGCN"])
def test_rcloss_follows_needs_index(backbone):
    ohm = 0 if backbone == "DNN" else 2
    cfg = dict(backbone=backbone, dims=[16], steps=5, noise_scale=1e-4,
               sampling_steps=0, OneHotMatrix=ohm, batch_size=B)
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM)
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM)
    assert tt.diffusion.index_in == jt.diffusion.index_in == \
        tt.model.needs_index
    seen = []
    model = tt.model

    def spy(*a, rcloss=False, **kw):
        seen.append(rcloss)
        return model(*a, rcloss=rcloss, **kw)

    x, _, _, index = inputs()
    state = tt.init_state()
    loss, _, aux = tt.diffusion.training_losses(
        spy, (t_(x) > 0).float(), t_(index).long(), state.lt,
        generator=torch.Generator().manual_seed(0))
    assert seen == [model.needs_index and ohm == 2]
    assert (aux["closs"] != 0).item() == model.needs_index
    assert torch.isfinite(loss).all()
