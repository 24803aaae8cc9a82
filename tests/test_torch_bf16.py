"""bfloat16 parameter storage with float32 masters in the port against the
JAX package: ``param_dtype=bfloat16`` (every parameter and the ``frozen_*``
tables stored bfloat16) and ``bf16_weights`` (the selected trainable
tensors only), on both resolved optimizer paths (``inline``, the JAX
package's single pass, and ``optax``, its chain with f32 masters), the
bridge of bfloat16 leaves, checkpoints and serving.

Randomness: the test replays the JAX package's key splits and hands the
port JAX's own draws, so both packages sample the same cells.

Tolerances: a bfloat16 tensor enters the forward through products and
norms whose float32 sums the two packages order differently; where such a
sum lands near a bfloat16 rounding boundary (a norm of a bfloat16 table, a
product of two bfloat16 operands, a bfloat16 gradient that is the sum of
cancelling terms) it rounds the other way. So:
- Losses rtol 3e-4 (one bfloat16 ulp at a few elements, diluted in the
  mean; the largest seen is 6.1e-5).
- Moments within 4 bfloat16 ulps of their tensor's largest moment: a
  gradient that meets a bfloat16 operand carries bfloat16 roundings of its
  terms, which are at most that large (the largest seen is 2 ulps).
- Masters and float32 tensors: at most 2% of a tensor's elements (or
  one) past
  rtol 1e-4 / atol 2e-2 x lr, and every element within 2 x lr a step
  (an element whose gradient straddles zero may take Adam's +-lr steps the
  other way in each package; the largest share seen is 0.63%, the
  largest distance 1.48 lr, in the GCN weights).
- Stored bfloat16 tensors: the same, plus one bfloat16 ulp of the value
  (the stored tensor is its master's rounding; the JAX chain's
  ``p + (master' - p)`` may round to the neighbour too).
- Top-k ids: exactly, away from near ties (the port's scores of the two
  ids within the loss tolerance).
"""

import os

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
from gdmcf_torch.serve import build_recommender  # noqa: E402
from gdmcf_torch.train.checkpoint import Checkpointer  # noqa: E402
from gdmcf_torch.train.state import bf16_weight_names  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.train.state import bf16_weight_mask, path_str  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from test_torch_backbones import dropout_uniforms  # noqa: E402
from test_torch_layers_diffusion import jax_draws  # noqa: E402

SEL = ("in_layers/", "embedding_item")
N_USER, N_ITEM, B = 24, 20, 8
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
LOSS_RTOL = 3e-4
SHARE = 0.02        # of a tensor's elements past the tight tolerance
MOMENT_ULPS = 4     # bfloat16 ulps of a moment tensor's largest element


def graph(seed=0, n_user=N_USER):
    m = np.random.default_rng(seed).random((n_user, N_ITEM)) < 0.25
    return sp.csr_matrix(m.astype(np.float32))


def recipe(**kw):
    base = dict(backbone="DNNOneHotEmbeddingGCN", OneHotMatrix=2, dims=[32],
                emb_size=10, steps=5, noise_scale=1e-4, mean_type="x0",
                sampling_steps=0, batch_size=B, lr=1e-3, random_seed=0)
    base.update(kw)
    return base


def bridged(tree):
    return compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree))


def trainer_pair(**kw):
    cfg = recipe(**kw)
    csr = graph() if cfg["backbone"] == "lightGCN" else None
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM, train_csr=csr)
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM,
                  train_csr=csr)
    jstate = jt.init_state()
    tt.model.load_state_dict({k: compat.to_tensor(v) for k, v in
                              bridged(jstate.params).items()},
                             strict=False)
    return jt, jstate, tt


def jax_masters(jt, jstate):
    """{JAX path: master} of the JAX state on either optimizer path."""
    if jt.tx is None:
        return dict(jstate.opt_state.master)
    # with_selective_f32_master keeps {path: master}, with_f32_master the
    # whole tree: flattened, both give {path: master}
    _inner, masters = jstate.opt_state
    return {path_str(p): m for p, m in
            jax.tree_util.tree_flatten_with_path(masters)[0]}


def jax_moments(jt, jstate, which):
    """The JAX state's moments as the port's names."""
    if jt.tx is None:
        return bridged(getattr(jstate.opt_state, which))
    inner = jstate.opt_state[0]
    found = []

    def visit(node):
        if hasattr(node, which) and hasattr(node, "count"):
            found.append(getattr(node, which))
        elif isinstance(node, (tuple, list)):
            for n in node:
                visit(n)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)
    visit(inner)
    assert len(found) == 1, found
    return bridged(found[0])


def batch(seed, b=B):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, N_ITEM)) < 0.3).astype(np.float32)
    return x, rng.choice(N_USER, b, replace=False).astype(np.int32)


def jax_train_draws(jd, lt, step_key, b, n, backbone):
    """The draws of the JAX training_losses under ``step_key``, in its
    order; each timestep draw fills both branches with JAX's pick."""
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
        dropout=dropout_uniforms(backbone, k_drop, b, n))


def t_(a):
    return torch.from_numpy(np.array(a))


def as_port(name, ndim, a):
    """A JAX leaf of the port's tensor ``name`` in the port's layout (a
    ``w`` transposed), float32."""
    a = f32(a)
    return a.T if compat.tree_path(name, ndim).endswith("/w") else a


def f32(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# selection and the config
# ---------------------------------------------------------------------------

SELECTIONS = [
    ("DNNOneHotEmbeddingGCN", SEL), ("DNNOneHotEmbeddingGCN", ("in_layers",)),
    ("DNNOneHotEmbeddingGCN", ("gcn/conv1/w", "sumW")),
    ("DNNOneHotEmbeddingGCN", ("item", "/b")),
    ("lightGCN", ("item",)), ("lightGCN", ("frozen_lgn",)),
    ("lightGCN", ("lgn", "out_layers/0/w")),
    ("DNNOneHotTransformer", ("ln1/g", "qkv")),
]


@pytest.mark.parametrize("backbone,patterns", SELECTIONS)
def test_bf16_patterns_select_the_same_tensors_in_both_packages(backbone,
                                                                patterns):
    """One config string selects the same tensors in both packages: the
    port matches each parameter's JAX path; a ``frozen_*`` table never
    matches, even a pattern naming it."""
    jt, jstate, tt = trainer_pair(backbone=backbone, dims=[16])
    mask = bf16_weight_mask(jstate.params, patterns)
    want = {path_str(p) for p, m in
            jax.tree_util.tree_flatten_with_path(mask)[0] if m}
    got = {compat.tree_path(n, p.dim()) for n, p in tt.model.named_parameters()
           if n in bf16_weight_names(tt.model, patterns)}
    assert got == want
    assert not any("frozen" in k for k in got)
    if patterns == SEL:
        assert {"in_layers/0/w", "in_layers/0/b",
                "embedding_item"} <= got


def test_bare_string_is_one_pattern_and_the_refusals_match_jax():
    for cfg in (TConfig(device="cpu", bf16_weights="embedding_item"),
                JConfig(bf16_weights="embedding_item")):
        assert cfg.bf16_weights == ("embedding_item",)
    tt = TTrainer(TConfig(device="cpu", **recipe(
        bf16_weights="embedding_item")), N_USER, N_ITEM)
    dts = {k: p.dtype for k, p in tt.init_state().params.items()}
    assert dts.pop("embedding_item") == torch.bfloat16
    assert set(dts.values()) == {torch.float32}
    for kw in (dict(bf16_weights=SEL, param_dtype="bfloat16"),
               dict(bf16_weights=(1,)), dict(bf16_weights=("",)),
               dict(opt_impl="inline", param_dtype="bfloat16"),
               dict(opt_impl="nope")):
        with pytest.raises(ValueError) as ours:
            TConfig(device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            JConfig(**kw)
        assert str(ours.value).split(" (")[0] == \
            str(theirs.value).split(" (")[0]


@pytest.mark.parametrize("opt_impl,param_dtype,mesh", [
    ("auto", "float32", (1, 1)), ("auto", "bfloat16", (1, 1)),
    ("auto", "float32", (2, 1)), ("optax", "float32", (1, 1)),
    ("inline", "float32", (1, 1)), ("fused", "float32", (1, 1)),
    ("optax", "bfloat16", (1, 2))])
def test_resolved_opt_impl_matches_jax(opt_impl, param_dtype, mesh):
    kw = dict(opt_impl=opt_impl, param_dtype=param_dtype, mesh_dp=mesh[0],
              mesh_mp=mesh[1])
    ours, theirs = TConfig(device="cpu", **kw), JConfig(**kw)
    assert ours.resolved_opt_impl == theirs.resolved_opt_impl
    assert ours.use_fused_opt == theirs.use_fused_opt


@pytest.mark.parametrize("opt_impl", ["inline", "optax"])
def test_selected_tensors_bf16_with_f32_masters(opt_impl):
    jt, jstate, tt = trainer_pair(bf16_weights=SEL, opt_impl=opt_impl)
    state = tt.init_state()
    sel = set(bf16_weight_names(tt.model, SEL))
    assert sel
    for name, p in state.params.items():
        assert p.dtype == (torch.bfloat16 if name in sel else torch.float32)
    masters = state.opt_state.master
    assert set(masters) == sel
    assert all(m.dtype == torch.float32 for m in masters.values())
    # the JAX package's masters on the same path: the same tensors, equal
    want = jax_masters(jt, jstate)
    assert {compat.tree_path(n, masters[n].dim()) for n in masters} == \
        set(want)
    for name, m in masters.items():
        w = as_port(name, m.dim(), want[compat.tree_path(name, m.dim())])
        np.testing.assert_array_equal(m.numpy(), w)


@pytest.mark.parametrize("opt_impl", ["inline", "optax"])
def test_master_preserves_tiny_updates(opt_impl):
    """At lr 1e-5 a bfloat16 weight of about 1e-2 cannot hold one update;
    the master accumulates them and the stored tensor is its rounding."""
    tt = TTrainer(TConfig(device="cpu", **recipe(
        bf16_weights=SEL, opt_impl=opt_impl, lr=1e-5)), N_USER, N_ITEM)
    state = tt.init_state()
    m0 = {k: m.clone() for k, m in state.opt_state.master.items()}
    x, idx = batch(0)
    for _ in range(10):
        state, loss = tt.train_step(state, t_(x), t_(idx))
    assert np.isfinite(loss.item())
    for k, m in state.opt_state.master.items():
        assert (m - m0[k]).abs().max() > 0, k
        assert torch.equal(state.params[k].detach(), m.to(torch.bfloat16))


def test_param_dtype_casts_every_tensor_and_the_frozen_tables():
    """param_dtype=bfloat16 stores every parameter and the frozen LightGCN
    tables in bfloat16, as the JAX package's cast of its whole tree; each
    parameter gets a master, no frozen table does."""
    jt, jstate, tt = trainer_pair(backbone="lightGCN",
                                  param_dtype="bfloat16")
    state = tt.init_state()
    want = bridged(jstate.params)
    for name, t in tt.model.state_dict().items():
        assert t.dtype == torch.bfloat16, name
        assert str(want[name].dtype) == "bfloat16", name
    np.testing.assert_array_equal(
        f32(tt.model.frozen_lgn_item.float()), f32(want["frozen_lgn_item"]))
    assert set(state.opt_state.master) == set(state.params)
    frozen = [n for n, _ in tt.model.named_buffers()]
    assert frozen and not set(frozen) & set(state.opt_state.master)


def test_frozen_tables_stay_float32_under_a_broad_pattern():
    jt, jstate, tt = trainer_pair(backbone="lightGCN", bf16_weights=("item",
                                                                     "lgn"))
    assert tt.model.frozen_lgn_item.dtype == torch.float32
    assert tt.model.frozen_lgn_user.dtype == torch.float32
    assert str(bridged(jstate.params)["frozen_lgn_item"].dtype) == "float32"


def test_the_bridge_carries_bfloat16_both_ways():
    jt, jstate, tt = trainer_pair(param_dtype="bfloat16")
    jp = bridged(jstate.params)
    sd = tt.model.state_dict()
    back = compat.jax_params_from_state_dict(sd)
    for p, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        node = back
        for k in p:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert node.dtype == leaf.dtype
        np.testing.assert_array_equal(node.view(np.int16),
                                      np.asarray(leaf).view(np.int16))
    for name, t in sd.items():
        assert compat.to_tensor(jp[name]).dtype == torch.bfloat16
        assert torch.equal(compat.to_tensor(jp[name]), t)


# ---------------------------------------------------------------------------
# train steps against the JAX Trainer
# ---------------------------------------------------------------------------

def within(got, want, tight, loose, share, what):
    """Every element within ``loose``; at most ``share`` of them, or one,
    past ``tight``."""
    d = np.abs(got - want)
    assert (d <= loose).all(), f"{what}: {float((d - loose).max())} over"
    past = int((d > tight).sum())
    assert past <= max(1, share * d.size), f"{what}: {past} of {d.size} past"


def compare_steps(jt, jstate, tt, steps=3, b=B):
    """``steps`` train steps in both packages from the same draws; holds
    losses, stored tensors, masters and moments to the stated tolerances."""
    backbone = tt.cfg.backbone
    state = tt.init_state()
    lr = tt.cfg.lr
    for step in range(steps):
        x, idx = batch(10 + step, b)
        _, step_key = jax.random.split(jstate.key)
        draws = jax_train_draws(jt.diffusion, jstate.lt, step_key, b,
                                N_ITEM, backbone)
        jstate, jloss = jt._train_step(jstate, jnp.asarray(x),
                                       jnp.asarray(idx))
        state, loss = tt.train_step(state, t_(x), t_(idx), draws=draws)
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(state.lt.count.numpy(),
                                      jstate.lt.count)
        want_p = bridged(jstate.params)
        want_m = jax_masters(jt, jstate)
        # an element whose gradient straddles zero may take Adam's +-lr
        # steps the other way in each package
        apart = 2 * lr * (step + 1)
        for name, p in state.params.items():
            what = f"step {step} {name}"
            got, want = f32(p.detach().float()), f32(want_p[name])
            assert str(want_p[name].dtype) == str(p.dtype)[6:], what
            if p.dtype == torch.bfloat16:
                ulp = BF16_EPS * np.abs(want)
                within(got, want, ulp + 2e-2 * lr, ulp + apart, SHARE,
                       what)
                got = state.opt_state.master[name].numpy()
                want = as_port(name, p.dim(),
                               want_m[compat.tree_path(name, p.dim())])
                what += " master"
            within(got, want, 1e-4 * np.abs(want) + 2e-2 * lr,
                   1e-4 * np.abs(want) + apart, SHARE, what)
        for which in ("mu", "nu"):
            want_mom = jax_moments(jt, jstate, which)
            for name, m in getattr(state.opt_state, which).items():
                w = f32(want_mom[name])
                scale = np.abs(w).max() if w.size else 0.0
                np.testing.assert_allclose(
                    m.float().numpy(), w, rtol=0,
                    atol=MOMENT_ULPS * BF16_EPS * scale,
                    err_msg=f"step {step} {which} {name}")
    assert state.step == steps and int(jstate.step) == steps
    assert set(state.opt_state.master) == {
        k for k, p in state.params.items() if p.dtype == torch.bfloat16}
    return state, jstate


PRECISIONS = [
    dict(bf16_weights=SEL, opt_impl="inline"),
    dict(bf16_weights=SEL, opt_impl="optax"),
    dict(param_dtype="bfloat16"),
    dict(param_dtype="bfloat16", opt_moment_dtype="float32"),
]


@pytest.mark.parametrize("kw", PRECISIONS,
                         ids=["weights-inline", "weights-optax",
                              "param_dtype", "param_dtype-f32-moments"])
def test_three_flagship_steps_match_the_jax_trainer(kw):
    jt, jstate, tt = trainer_pair(**kw)
    assert (jt.tx is None) == (kw.get("opt_impl") == "inline")
    compare_steps(jt, jstate, tt)


@pytest.mark.parametrize("backbone,ohm", [("DNN", 0), ("lightGCN", 2)])
def test_three_steps_of_other_backbones_under_bf16_params(backbone, ohm):
    """DNN at OneHotMatrix 0, and DNNlightGCN, whose frozen tables are
    bfloat16 too: its link filter is a bfloat16 product."""
    jt, jstate, tt = trainer_pair(backbone=backbone, OneHotMatrix=ohm,
                                  param_dtype="bfloat16", dims=[16])
    compare_steps(jt, jstate, tt)


@pytest.mark.parametrize("kw", [dict(param_dtype="bfloat16"),
                                dict(bf16_weights=SEL)],
                         ids=["param_dtype", "weights"])
@pytest.mark.parametrize("backbone,ss", [("DNNOneHotEmbeddingGCN", 0),
                                         ("DNNOneHotEmbeddingGCN", 2),
                                         ("DNN", 0)])
def test_eval_step_topk_under_bf16_params_matches_jax(kw, backbone, ss):
    jt, jstate, tt = trainer_pair(backbone=backbone, sampling_steps=ss,
                                  OneHotMatrix=0 if backbone == "DNN" else 2,
                                  **kw)
    x, idx = batch(21)
    mask = x.copy()
    key = jax.random.PRNGKey(3)
    k = 12
    want_ids, want_scores = jt._eval_step(
        jstate.params, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(mask),
        key, sampling_steps=ss, top_k=k), None
    want_ids = np.asarray(want_ids)
    draws = jax_draws(key, B, N_ITEM, 5, ss)
    got, scores = tt.eval_step(t_(x), t_(idx), t_(mask), sampling_steps=ss,
                               top_k=k, draws=draws, return_scores=True)
    got = got.numpy()
    # ids agree but where the port's scores of the two ids lie within the
    # loss tolerance of each other (a near tie)
    s = scores.numpy()
    rows = np.arange(B)[:, None]
    gap = np.abs(s[rows, got] - s[rows, want_ids])
    tie = gap <= LOSS_RTOL * np.abs(s[rows, got])
    assert ((got == want_ids) | tie).all()
    assert (got == want_ids).mean() > 0.9


# ---------------------------------------------------------------------------
# checkpoints and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(param_dtype="bfloat16"),
                                dict(bf16_weights=SEL)],
                         ids=["param_dtype", "weights"])
def test_checkpoint_round_trip_with_masters(tmp_path, kw):
    cfg = TConfig(device="cpu", **recipe(**kw))
    tt = TTrainer(cfg, N_USER, N_ITEM)
    state = tt.init_state()
    x, idx = batch(0)
    state, _ = tt.train_step(state, t_(x), t_(idx))
    ck = Checkpointer(str(tmp_path))
    ck.save(state)
    other = TTrainer(cfg, N_USER, N_ITEM)
    restored = ck.restore(other.init_state())
    opt, ropt = state.opt_state, restored.opt_state
    assert set(ropt.master) == set(opt.master) and opt.master
    for part, rpart in ((state.params, restored.params), (opt.mu, ropt.mu),
                        (opt.nu, ropt.nu), (opt.master, ropt.master)):
        for k, v in part.items():
            assert rpart[k].dtype == v.dtype
            assert torch.equal(rpart[k].detach(), v.detach()), k
    # training goes on from the restored state as from the live one
    s1, l1 = tt.train_step(state, t_(x), t_(idx))
    s2, l2 = other.train_step(restored, t_(x), t_(idx))
    assert l1.item() == l2.item()
    # a float32 run refuses the checkpoint (its tensors and masters differ)
    f32_run = TTrainer(TConfig(device="cpu", **recipe()), N_USER, N_ITEM)
    with pytest.raises(ValueError):
        ck.restore(f32_run.init_state())


def test_serving_from_a_bf16_checkpoint(tmp_path):
    csr = graph(1)
    cfg = TConfig(device="cpu", **recipe(param_dtype="bfloat16", lr=1e-2))
    tt = TTrainer(cfg, N_USER, N_ITEM)
    from gdmcf_torch.data.native import NativeCSR
    state, _ = tt.train_epoch(tt.init_state(), NativeCSR.from_scipy(csr),
                              np.random.default_rng(0))
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(state)
    users = list(range(N_USER))
    live = build_recommender(cfg, None, csr, N_USER, N_ITEM, trainer=tt,
                             serve_batch=8, k_max=6)
    want, _ = live.recommend(users, k=6)
    rec = build_recommender(cfg, str(tmp_path / "ck"), csr, N_USER, N_ITEM,
                            serve_batch=8, k_max=6)
    assert all(p.dtype == torch.bfloat16
               for p in rec.trainer.model.parameters())
    got, _ = rec.recommend(users, k=6)
    np.testing.assert_array_equal(got, want)
    assert rec.reload_params()["reloaded"]
    np.testing.assert_array_equal(rec.recommend(users, k=6)[0], want)
    # a float32 checkpoint cannot be swapped into the bfloat16 server
    f32_tt = TTrainer(TConfig(device="cpu", **recipe()), N_USER, N_ITEM)
    Checkpointer(str(tmp_path / "f32")).save(f32_tt.init_state())
    with pytest.raises(ValueError, match="dtype|float32"):
        rec.reload_params(str(tmp_path / "f32"))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_takes_several_bf16_patterns_and_trains(tmp_path):
    """``--bf16_weights in_layers/ embedding_item`` is two patterns (the
    JAX package's CLI takes one; its config normalizes a bare string the
    same way); the CLI trains and checkpoints under them and under
    ``--param_dtype bfloat16``."""
    from gdmcf_torch import cli
    from gdmcf_torch.config import parse_args
    from gdmcf_torch.data.loader import generate_synthetic_dataset
    from gdmcf_tpu.config import parse_args as j_parse_args

    assert parse_args(["--bf16_weights", "in_layers/"]).bf16_weights == \
        j_parse_args(["--bf16_weights", "in_layers/"]).bf16_weights
    generate_synthetic_dataset(str(tmp_path / "data"), n_user=40, n_item=30,
                               avg_degree=6, seed=2)
    base = ["--device", "cpu", "--dims", "[8]", "--batch_size", "16",
            "--steps", "5", "--noise_scale", "0.01", "--sampling_steps",
            "0", "--topN", "[5]", "--epochs", "1", "--eval_every", "1",
            "--dataset", "tiny", "--data_path", str(tmp_path / "data"),
            "--debug", "true"]
    for i, flags in enumerate((["--bf16_weights", "in_layers/",
                                "embedding_item"],
                               ["--param_dtype", "bfloat16"])):
        cfg = parse_args(base + flags + [
            "--log_name", str(tmp_path / f"log{i}"),
            "--ckpt_dir", str(tmp_path / f"ck{i}")])
        if i == 0:
            assert cfg.bf16_weights == SEL
        cli.main(cfg)
        ck = Checkpointer(str(tmp_path / f"ck{i}"))
        data = torch.load(os.path.join(ck.directory,
                                       f"ckpt_{ck.latest_step()}.pt"),
                          weights_only=True)
        masters = set(data["master"])
        bf16 = {k for k, v in data["params"].items()
                if v.dtype == torch.bfloat16}
        assert masters == bf16 and bf16
        if i == 0:
            assert bf16 == {"embedding_item", "in_layers.0.weight",
                            "in_layers.0.bias"}
        else:
            assert bf16 == set(data["params"])
