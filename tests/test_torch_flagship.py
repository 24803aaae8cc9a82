"""The flagship backbone of the port (DNNOneHotEmbeddingGCN and its parts)
against the JAX package, with the JAX weights carried across by the
weight bridge and inputs made from a seed with numpy.

Tolerances: forward rtol 1e-5 / atol 1e-6 (float32 products of a few
hundred terms summed in another order, through tanh layers and a softmax);
gradients rtol 1e-4 and an atol of 1e-5 times the tensor's largest
gradient (at least 1e-6), because a gradient entry that is a sum of
cancelling terms keeps an absolute error of the size of its largest
terms. Dropout takes JAX's own uniforms.
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
from gdmcf_torch.models import gcn as TG  # noqa: E402
from gdmcf_torch.models import layers as TL  # noqa: E402
from gdmcf_torch.models.registry import build_model  # noqa: E402
from gdmcf_torch.serve import Recommender as TRecommender  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.models import gcn as JG  # noqa: E402
from gdmcf_tpu.models import layers as JL  # noqa: E402
from gdmcf_tpu.models.registry import build_model as j_build_model  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)


def grad_tol(want):
    return dict(rtol=1e-4, atol=max(1e-6, 1e-5 * float(np.abs(want).max())))
N_USER, N_ITEM, B = 12, 20, 6


def t_(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_bridged(module, jax_params):
    module.load_state_dict({k: t_(v) for k, v in
                            compat.state_dict_from_jax_params(
                                np_tree(jax_params)).items()})
    return module


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 1e-8])
def test_cosine_scores_matches_jax(eps):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((5, 16)).astype(np.float32)
    items = rng.standard_normal((30, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TL.cosine_scores(t_(u), t_(items), eps).numpy(),
        np.asarray(JL.cosine_scores(u, items, eps)), **FWD)


def test_cosine_scores_zero_row_follows_eps():
    u = np.zeros((2, 4), np.float32)
    items = np.ones((3, 4), np.float32)
    assert torch.isnan(TL.cosine_scores(t_(u), t_(items), 0.0)).all()
    assert (TL.cosine_scores(t_(u), t_(items), 1e-8) == 0).all()


@pytest.mark.parametrize("impl", ["softmax", "lse"])
@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_nt_xent_forms_match_jax(monkeypatch, impl, scale):
    """scale 40 saturates the positive: the denominator-eps repair keeps
    the loss finite in both packages."""
    monkeypatch.setattr(TL, "_NT_XENT_IMPL", impl)
    monkeypatch.setattr(JL, "_NT_XENT_IMPL", impl)
    rng = np.random.default_rng(1)
    z1 = np.tanh(scale * rng.standard_normal((7, 9))).astype(np.float32)
    z2 = z1 if scale > 1 else np.tanh(rng.standard_normal((7, 9))).astype(
        np.float32)
    got = TL.nt_xent_loss(t_(z1), t_(z2))
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(JL.nt_xent_loss(z1, z2)),
                               **FWD)


def test_nt_xent_auto_routing_and_forms_agree(monkeypatch):
    assert TL._resolve_ntxent_impl(4095) == "softmax"
    assert TL._resolve_ntxent_impl(4096) == "lse"
    rng = np.random.default_rng(2)
    z1, z2 = (t_(rng.standard_normal((6, 5)).astype(np.float32))
              for _ in range(2))
    monkeypatch.setattr(TL, "_NT_XENT_IMPL", "lse")
    lse = TL.nt_xent_loss(z1, z2)
    torch.testing.assert_close(lse, TL.nt_xent_softmax_core(z1, z2), **FWD)
    # the remat form (once refused) is the softmax form, recomputed in
    # the backward
    monkeypatch.setattr(TL, "_NT_XENT_IMPL", "remat")
    torch.testing.assert_close(TL.nt_xent_loss(z1, z2),
                               TL.nt_xent_softmax_core(z1, z2), **FWD)


def test_gcn_conv_init_is_glorot_with_zero_bias():
    conv = TL.gcn_conv_init(300, 200, torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / 500)
    assert conv.weight.shape == (200, 300)
    assert conv.weight.abs().max().item() <= limit
    assert abs(conv.weight.std().item() / (limit / np.sqrt(3)) - 1) < 0.02
    assert not conv.bias.any()


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def gcn_inputs(seed=3, d=8):
    rng = np.random.default_rng(seed)
    hu = rng.standard_normal((B, d)).astype(np.float32)
    hi = rng.standard_normal((N_ITEM, d)).astype(np.float32)
    g = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
    return hu, hi, g


@pytest.mark.parametrize("symmetric", [False, True])
def test_gcn_conv_bipartite_matches_jax(symmetric):
    hu, hi, g = gcn_inputs()
    p = np_tree(JL.gcn_conv_init(jax.random.PRNGKey(0), 8, 5))
    p["b"] = np.linspace(-1, 1, 5).astype(np.float32)   # a nonzero bias
    conv = torch.nn.Linear(8, 5)
    load_bridged(conv, p)
    with torch.no_grad():
        got = TG.gcn_conv_bipartite(conv, t_(hu), t_(hi), t_(g), symmetric)
    want = JG.gcn_conv_bipartite(p, hu, hi, g, symmetric)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("symmetric", [False, True])
def test_layer_gcn_matches_jax(num_layers, symmetric):
    hu, hi, g = gcn_inputs(4, d=8)
    p = np_tree(JG.layer_gcn_init(jax.random.PRNGKey(1), 8, 16, 8,
                                  num_layers))
    gcn = TG.LayerGCN(8, 16, 8, num_layers, torch.Generator().manual_seed(0))
    load_bridged(gcn, p)
    with torch.no_grad():
        got = gcn(t_(hu), t_(hi), t_(g), symmetric=symmetric)
        rows = TG.layer_gcn_user_rows(gcn, t_(hu))
    want = JG.layer_gcn_apply(p, hu, hi, g, num_layers, symmetric=symmetric)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
    np.testing.assert_allclose(
        rows.numpy(), np.asarray(JG.layer_gcn_user_rows(p, hu, num_layers)),
        **FWD)
    if not symmetric:
        torch.testing.assert_close(rows, got[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------

def flagship_pair(backbone="DNNOneHotEmbeddingGCN", **kw):
    base = dict(backbone=backbone, dims=[16], emb_size=10, steps=5,
                noise_scale=1e-4, OneHotMatrix=2)
    base.update(kw)
    jm = j_build_model(JConfig(**base), N_USER, N_ITEM)
    jp = np_tree(jm.init(jax.random.PRNGKey(7)))
    tm = build_model(TConfig(device="cpu", **base), N_USER, N_ITEM,
                     generator=torch.Generator().manual_seed(0))
    return jm, jp, load_bridged(tm, jp)


def batch_inputs(seed=5, symmetric_graph=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N_ITEM)).astype(np.float32)
    c1 = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
    c0 = (1.0 - c1) * (rng.random((B, N_ITEM)) < 0.9)
    x_u = np.stack([c0, c1], axis=-1).astype(np.float32)
    graph = x_u
    t = rng.integers(0, 5, B)
    index = rng.choice(N_USER, B, replace=False).astype(np.int32)
    return x, t, x_u, index, graph


def run_both(jm, jp, tm, train, rcloss=True, seed=5):
    x, t, x_u, index, graph = batch_inputs(seed)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key, 2)
    u = (t_(jax.random.uniform(k1, x.shape)),
         t_(jax.random.uniform(k2, (B, 2 * N_ITEM))))
    want, wcl = jm.apply(jp, x, jnp.asarray(t), x_u, index=index,
                         graph=graph, rcloss=rcloss, train=train, rng=key)
    tm.train(train)
    got, gcl = tm(t_(x), t_(t), t_(x_u), index=t_(index).long(),
                  graph=t_(graph), rcloss=rcloss, dropout_u=u)
    return (got, gcl), (want, wcl)


CASES = [dict(noise_type=n, **extra)
         for n in (0, 1, 2)
         for extra in ({}, {"backbone": "DNNOneHotEmbeddingGCN_conti"})] + [
    dict(gcnLayerNum=0), dict(gcnLayerNum=1),
    dict(gcnLayerNum=1, symmetric_gcn=True),
    dict(gcnLayerNum=2, symmetric_gcn=True),
    dict(norm=True), dict(fidelity=False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_flagship_forward_matches_jax(case):
    case = dict(case)
    backbone = case.pop("backbone", "DNNOneHotEmbeddingGCN")
    jm, jp, tm = flagship_pair(backbone, **case)
    for train in (True, False):
        (got, gcl), (want, wcl) = run_both(jm, jp, tm, train)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)
        np.testing.assert_allclose(gcl.detach().numpy(), np.asarray(wcl),
                                   **FWD)
        if case.get("noise_type", 0) and not backbone.endswith("_conti"):
            assert gcl.item() == 0.0


GRAD_CASES = [dict(), dict(noise_type=1), dict(symmetric_gcn=True),
              dict(gcnLayerNum=0), dict(backbone="DNNOneHotEmbeddingGCN_conti")]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_flagship_gradients_match_jax(case):
    case = dict(case)
    jm, jp, tm = flagship_pair(case.pop("backbone", "DNNOneHotEmbeddingGCN"),
                               **case)
    x, t, x_u, index, graph = batch_inputs(6)
    w = np.random.default_rng(8).standard_normal((B, N_ITEM)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key, 2)
    u = (t_(jax.random.uniform(k1, x.shape)),
         t_(jax.random.uniform(k2, (B, 2 * N_ITEM))))

    def j_loss(p):
        s, cl = jm.apply(p, x, jnp.asarray(t), x_u, index=index, graph=graph,
                         rcloss=True, train=True, rng=key)
        return jnp.sum(s * w) + cl

    jg = compat.state_dict_from_jax_params(np_tree(jax.grad(j_loss)(jp)))
    tm.train()
    s, cl = tm(t_(x), t_(t), t_(x_u), index=t_(index).long(),
               graph=t_(graph), rcloss=True, dropout_u=u)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad((s * t_(w)).sum() + cl,
                                [p for _, p in tm.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    assert set(names) == set(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], err_msg=name,
                                   **grad_tol(jg[name]))


def test_bridge_roundtrip_covers_the_flagship_tree():
    _, jp, tm = flagship_pair()
    sd = tm.state_dict()
    want = compat.state_dict_from_jax_params(jp)
    assert set(sd) == set(want)
    assert sd["sumW"].shape == () and float(sd["sumW"]) == 1.0
    assert sd["gcn.conv1.weight"].shape == jp["gcn"]["conv1"]["w"].shape[::-1]
    assert sd["embedding_item"].shape == jp["embedding_item"].shape
    back = compat.jax_params_from_state_dict(sd)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) == 13
    for path, leaf in leaves:
        got = back
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(got, leaf)


def test_registry_builds_the_flagship_and_names_the_rest():
    g = torch.Generator().manual_seed(0)
    for b, conti in (("DNNOneHotEmbeddingGCN", False),
                     ("DNNOneHotEmbeddingGCN_conti", True)):
        m = build_model(TConfig(backbone=b, dims=[8], device="cpu"), 4, 5,
                        generator=g, device="cpu")
        assert m.conti is conti and m.needs_graph
        assert m.GCN_HIDDEN == 512 and m.gcn.conv1.weight.shape == (512, 24)
        assert m.cosine_eps == 0.0
    corrected = build_model(TConfig(dims=[8], fidelity=False, device="cpu"),
                            4, 5, generator=g, device="cpu")
    assert corrected.cosine_eps == 1e-8


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def interactions(seed=0):
    rng = np.random.default_rng(seed)
    m = rng.random((N_USER, N_ITEM)) < 0.25
    return sp.csr_matrix(m.astype(np.float32))


@pytest.mark.parametrize("symmetric", [False, True])
def test_flagship_serving_topk_matches_jax_eval_step(symmetric):
    recipe = dict(backbone="DNNOneHotEmbeddingGCN", dims=[16], emb_size=10,
                  steps=5, noise_scale=1e-4, sampling_steps=0,
                  OneHotMatrix=2, symmetric_gcn=symmetric, random_seed=3)
    train = interactions()
    jt = JTrainer(JConfig(**recipe), N_USER, N_ITEM)
    jstate = jt.init_state()
    tt = TTrainer(TConfig(device="cpu", **recipe), N_USER, N_ITEM)
    rec = TRecommender.from_state(
        tt, compat.state_dict_from_jax_params(np_tree(jstate.params)), train,
        serve_batch=8, k_max=7)
    users = np.array([0, 3, 5, 7, 8, 10, 11, 2], np.int64)
    x = train[users].toarray().astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jt._eval_step(jstate.params, jnp.asarray(x),
                                    jnp.asarray(users, jnp.int32),
                                    jnp.asarray(x), key, sampling_steps=0,
                                    top_k=7))
    draws = None
    if symmetric:
        # the symmetric GCN reads the grown graph: hand over JAX's draws
        from test_torch_layers_diffusion import jax_draws
        draws = jax_draws(key, len(users), N_ITEM, 5, 0)
    got = tt.eval_step(t_(x), t_(users), t_(x), sampling_steps=0, top_k=7,
                       draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)
    if not symmetric:
        items, _ = rec.recommend(users, k=7)
        np.testing.assert_array_equal(items, want)


def test_serve_cli_serves_the_recipe_backbone(tmp_path, capsys):
    from pathlib import Path

    from gdmcf_torch.serve import main

    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 12, 60), rng.integers(0, 9, 60)], 1)
    edges[0] = [11, 8]
    for name in ("train", "valid", "test"):
        np.save(tmp_path / f"{name}_list.npy", edges)
    recipe = Path(__file__).resolve().parents[1] / "configs" / \
        "amazonOneEmbGcn.yaml"
    main(["-c", str(recipe), "--dims", "[8]", "--device", "cpu",
          "--data_path", str(tmp_path), "--users", "0,3", "--k", "4",
          "--serve_batch", "2", "--k_max", "5"])
    out = capsys.readouterr().out
    assert "user 3: top-4" in out and "on cpu" in out
