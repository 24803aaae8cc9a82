"""The scale geometries of ``chip_smoke.py`` phase 24, composed on the CPU
at a small size against the JAX package.

- ``chip_smoke.synthetic_csr`` draws ``benchmarks/scale_smoke.py``'s graph
  bit for bit at a seed (the generator of phase 24 and of
  ``benchmarks/lightgcn_scale_pretrain.py``).
- (a) and (b): the flagship with ``scale_smoke.py``'s Config at 600 users x
  4,096 items, dims [16], batch 64, ``host_dense`` false, parameters
  carried from the JAX Trainer through ``compat``: 8 packed steps at K 8
  (``Trainer.train_steps``) against the JAX ``_train_multi`` with the JAX
  draws injected, at the flagship tolerances of
  ``test_torch_fused_calls.py``, with bfloat16 moments (the Config's; an
  element past them only where a moment was one bfloat16 ulp from the
  JAX one at some step) and with float32 moments; then, at the JAX state
  after the steps, ``evaluate_streaming`` against the JAX
  ``evaluate_streaming`` and against the port's dense ``evaluate``, and
  ``scale_smoke.py``'s live leg (GT = the input rows, no history mask),
  within its 1.01e-4 and nonzero.
- (b)'s mesh check (``chip_smoke.scale_mesh_world``) at 2,000 x 20,000 on
  a (1, 2) gloo world: each step from the single process's state, the
  held steps within phase 19's rule, and failing it under planted faults.
- (c): ``pretrain`` on a degree-sorted power-law graph (3,000 x 1,024,
  alpha 1.6) with tiles of 8 x 128 on the block and hybrid operands, 3
  BPR steps from one initial table, against the JAX ``pretrain`` with
  Pallas in interpret mode, at ``test_torch_pretrain.py``'s tolerances;
  the two formats' tables equal each other.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.data.loader import epoch_batches  # noqa: E402
from gdmcf_torch.data.native import NativeCSR as TNative  # noqa: E402
from gdmcf_torch.models import lightgcn as TG  # noqa: E402
from gdmcf_torch.ops import spmm as TS  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.data.native import NativeCSR as JNative  # noqa: E402
from gdmcf_tpu.models import lightgcn as JG  # noqa: E402
from gdmcf_tpu.models.layers import xavier_uniform  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
import test_torch_fused_calls as FC  # noqa: E402
import test_torch_pretrain as PT  # noqa: E402
import test_torch_train as TR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CLOSE = 1.01e-4          # scale_smoke.py's streaming = dense gate
N_USER, N_ITEM, DIMS, BATCH, K = 600, 4096, 16, 64, 8


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return load("chip_smoke_for_scale", ROOT / "chip_smoke.py")


@pytest.mark.parametrize("alpha", [1.05, 1.6])
def test_synthetic_csr_draws_scale_smokes_graph(chip_smoke, alpha):
    smoke = load("scale_smoke_for_scale", ROOT / "benchmarks" /
                 "scale_smoke.py")
    got = chip_smoke.synthetic_csr(np.random.default_rng(0), 2000, 4096,
                                   alpha=alpha)
    want = smoke.synthetic_csr(np.random.default_rng(0), 2000, 4096,
                               alpha=alpha)
    assert got.shape == want.shape and got.nnz == want.nnz > 0
    for a in ("indptr", "indices", "data"):
        x, y = getattr(got, a), getattr(want, a)
        assert x.dtype == y.dtype and np.array_equal(x, y), a


# ---------------------------------------------------------------------------
# (a) and (b): the flagship at scale_smoke.py's Config
# ---------------------------------------------------------------------------

SCALE_KW = dict(backbone="DNNOneHotEmbeddingGCN", dims=[DIMS], emb_size=10,
                steps=5, noise_scale=0.01, batch_size=BATCH, topN=[10, 20],
                lr=1e-4, debug=True, sampling_steps=0, host_dense=False,
                train_steps_per_call=K, eval_batches_per_call=K,
                # the JAX Trainer's K1 path (Pallas in interpret mode on the
                # CPU), which "auto" takes on the chip
                opt_impl="fused")


def trainers(**kw):
    """The JAX Trainer, its init and a port Trainer holding the same
    parameters."""
    cfg = dict(SCALE_KW, **kw)
    jt = JTrainer(JConfig(**cfg), N_USER, N_ITEM)
    jstate = jt.init_state()
    tt = TTrainer(TConfig(device="cpu", **cfg), N_USER, N_ITEM)
    tt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                              TR.bridged(jstate.params).items()})
    return jt, jstate, tt


@pytest.fixture(scope="module")
def flagship(chip_smoke):
    """``trainers`` at phase 24's Config (bfloat16 moments) and (a)'s
    splits drawn as phase 24 draws them."""
    rng = np.random.default_rng(0)
    splits = [chip_smoke.synthetic_csr(rng, N_USER, N_ITEM, avg_degree=d)
              for d in (12, 2, 3)]
    return (*trainers(), splits)


_TRAINED = {}   # the JAX state after the steps, for the evaluation test


def jax_after_steps(jt, batches):
    if "state" not in _TRAINED:
        xs = np.stack([b[0] for b in batches])
        idxs = np.stack([b[1] for b in batches])
        _TRAINED["state"], _ = jt._train_multi(
            jt.init_state(), jnp.asarray(xs), jnp.asarray(idxs))
    return _TRAINED["state"]


def packed_batches(train):
    """K packed batches of the train split, as train_epoch draws them."""
    data = TNative.from_scipy(train)
    return list(epoch_batches(data, BATCH, np.random.default_rng(0),
                              packed=True))[:K]


def one_ulp_apart(tt, batches, seen):
    """The ``excuse`` of ``assert_train_multi_matches`` for bfloat16
    moments: the port's single steps at the injected draws (a second
    Trainer from ``tt``'s parameters as they are now; their final
    parameters go into ``seen``), and an element past its tolerance is
    accounted for when, at some step, one of its moments is one bfloat16
    ulp from the JAX single steps' (bit patterns one apart). Both packages
    round each moment to bfloat16 on their own, so float32 sums a few
    roundings apart may land one ulp apart; AdamW carries that to the
    parameter over the steps that follow."""
    init = {k: v.clone() for k, v in tt.model.state_dict().items()}

    def excuse(name, past, draws, moments):
        if "moments" not in seen:
            t2 = TTrainer(tt.cfg, N_USER, N_ITEM)
            t2.model.load_state_dict(init)
            state, seen["moments"] = t2.init_state(), []
            for (x, idx), d in zip(batches, draws):
                state, _ = t2.train_step(state, torch.from_numpy(x),
                                         torch.from_numpy(idx), draws=d)
                seen["moments"].append({
                    w: {k: m.view(torch.int16).numpy().astype(np.int32)
                        for k, m in getattr(state.opt_state, w).items()}
                    for w in ("mu", "nu")})
            seen["params"] = {k: p.detach().clone()
                              for k, p in state.params.items()}
        ok = np.zeros(past.shape, bool)
        for ours, theirs in zip(seen["moments"], moments):
            for w in ("mu", "nu"):
                bits = np.asarray(theirs[w][name]).view(np.int16)
                ok |= np.abs(ours[w][name] - bits.astype(np.int32)) == 1
        return ok

    return excuse


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_scale_train_steps_match_the_jax_train_multi(flagship, moments):
    """bfloat16 (phase 24's Config): the parameters at the tolerance but
    for elements with a moment one ulp apart at some step
    (``one_ulp_apart``); float32: every element at the tolerance."""
    if moments == "bfloat16":
        jt, jstate0, tt, (train, _, _) = flagship
    else:
        jt, jstate0, tt = trainers(opt_moment_dtype=moments)
        train = flagship[3][0]
    batches = packed_batches(train)
    assert len(batches) == K and batches[0][0].dtype == np.uint8
    assert tt.fused_k("train") == (K, None)

    def draws(jd, lt, key):
        return TR.jax_train_draws(jd, lt, key, BATCH, N_ITEM)

    seen = {}
    excuse = (one_ulp_apart(tt, batches, seen)
              if moments == "bfloat16" else None)
    jstate = FC.assert_train_multi_matches(jt, jstate0, tt, batches, draws,
                                           excuse=excuse)
    if moments == "bfloat16":
        _TRAINED["state"] = jstate
        # the single steps that explained the moments are the K-step call's
        for k, p in tt.model.named_parameters():
            assert k not in seen.get("params", {}) or torch.equal(
                p.detach(), seen["params"][k]), k


def test_scale_streaming_eval_matches_jax_dense_and_the_live_leg(flagship):
    jt, _, tt, (train, valid, _) = flagship
    jstate = jax_after_steps(jt, packed_batches(train))
    tt.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                              TR.bridged(jstate.params).items()})
    topn = SCALE_KW["topN"]
    t_in, t_gt = TNative.from_scipy(train), TNative.from_scipy(
        valid, strict=False)
    j_in, j_gt = JNative.from_scipy(train), JNative.from_scipy(
        valid, strict=False)
    assert tt.fused_k("eval") == (K, None)
    got = tt.evaluate_streaming(None, [t_in], t_gt, [t_in], topn,
                                drop_last=False)
    want = jt.evaluate_streaming(jstate, [j_in], j_gt, [j_in], topn,
                                 drop_last=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=CLOSE)
    rows = train.toarray().astype(np.float32)
    dense = tt.evaluate(None, rows, valid.toarray().astype(np.float32), rows,
                        topn, drop_last=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(dense), atol=CLOSE)
    # the live leg: GT = the input rows, no history mask
    live = [min(max(N_ITEM // 128, 100), 8192)]
    empty = TNative.from_scipy(sp.csr_matrix((N_USER, N_ITEM),
                                             dtype=np.float32))
    got2 = tt.evaluate_streaming(None, [t_in], t_in, [empty], live,
                                 drop_last=False)
    dense2 = tt.evaluate(None, rows, rows, np.zeros_like(rows), live,
                         drop_last=False)
    want2 = jt.evaluate_streaming(
        jstate, [j_in], j_in,
        [JNative.from_scipy(sp.csr_matrix((N_USER, N_ITEM),
                                          dtype=np.float32))],
        live, drop_last=False)
    for other in (dense2, want2):
        np.testing.assert_allclose(np.asarray(got2), np.asarray(other),
                                   atol=CLOSE)
    assert max(v for grp in got2 for v in grp) > 0.0, got2


# ---------------------------------------------------------------------------
# (b)'s mesh check: each step from the single process's state, and faults
# ---------------------------------------------------------------------------

M_USERS, M_ITEMS, M_DIMS, M_BATCH = 2000, 20000, 16, 16


@pytest.mark.parametrize("fault", ["", "item", "shift", "lookup"])
def test_scale_mesh_steps_hold_phase_19s_rule_and_fail_planted_faults(
        chip_smoke, monkeypatch, tmp_path, fault):
    """``chip_smoke.scale_mesh_world`` on the CPU at a small size: the
    single process's steps of the pool with a checkpoint after each, then
    a (1, 2) gloo world whose steps each start from them. Without a fault
    the held steps (all but AdamW's first from zero moments) pass phase
    19's rule, as phase 24 (b) holds them on the card; with a fault
    planted on a rank (the item table's gradient dropped on rank 1, the
    one-hot tower's first-layer gradient moved one input column over, the
    user table's gradient dropped) the rule fails on the parameters, since
    each step's loss comes from the single process's state."""
    cs = chip_smoke
    for name, v in (("SCALE_B_USERS", M_USERS), ("SCALE_B_ITEMS", M_ITEMS),
                    ("SCALE_B_BATCH", M_BATCH)):
        monkeypatch.setattr(cs, name, v)
    pool = cs.scale_pool(np.random.default_rng(0))
    steps = 1 + cs.SCALE_B_MESH_STEPS
    ref, ranks, _, _ = cs.scale_mesh_world(
        torch, pool, str(tmp_path), M_USERS, M_ITEMS, M_DIMS, M_BATCH,
        steps, "cpu", fault)
    assert len(ref) == steps and all(
        len(r["step_reports"]) == steps for r in ranks)

    def held():
        for r in ranks:
            cs.assert_mesh_rule("cpu", r, ref, reports=r["step_reports"][1:],
                                launches=False)

    if not fault:
        held()
        return
    with pytest.raises(AssertionError, match="past, not at the floor"):
        held()


# ---------------------------------------------------------------------------
# (c): LightGCN pretraining on the degree-sorted power-law graph
# ---------------------------------------------------------------------------

C_USERS, C_ITEMS, C_DIM = 3000, 1024, 16
C_KW = dict(n_layers=2, latent_dim=C_DIM, epochs=1, batch_size=1000, seed=0,
            block_size=128, block_rows=8, evaluate=False, steps_per_epoch=3)


@pytest.fixture(scope="module")
def sorted_graph(chip_smoke):
    m = chip_smoke.synthetic_csr(np.random.default_rng(0), C_USERS, C_ITEMS,
                                 avg_degree=10, alpha=1.6)
    rp, cp = TS.degree_sort_permutation(m)
    return m.tocsr()[rp][:, cp].tocsr()


@pytest.mark.parametrize("sparse", [True, "hybrid"])
def test_scale_pretrain_matches_jax_on_the_sorted_graph(sorted_graph,
                                                        sparse):
    PT.native_lib()   # the JAX pretrain samples with the C++ engine
    m = sorted_graph
    init = np.asarray(xavier_uniform(jax.random.PRNGKey(0),
                                     (C_USERS + C_ITEMS, C_DIM)))
    jlog, tlog = [], []
    want = JG.pretrain(m, m, sparse=sparse, log=jlog.append,
                       spmm_interpret=True, **C_KW)
    got = TG.pretrain(m, m, sparse=sparse, log=tlog.append, device="cpu",
                      init_table=init, **C_KW)
    assert tlog == jlog and len(tlog) == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **PT.TABLE_TOL)
    assert not np.allclose(got.initial_user, init[:C_USERS])
    # the other format runs the same nonzeros: the same tables
    other = TG.pretrain(m, m, sparse="hybrid" if sparse is True else True,
                        log=lambda _: None, device="cpu", init_table=init,
                        **C_KW)
    for g, o in zip(got, other):
        np.testing.assert_array_equal(g, o)


# ---------------------------------------------------------------------------
# repairs the card forced at these sizes
# ---------------------------------------------------------------------------

def test_a_later_epoch_replays_its_first_group(monkeypatch):
    """At the 1M-item catalog, dims [500], a second ``train_epoch`` ran out
    of the card's memory: its first group ran eagerly beside the graphs'
    pool, which holds a step's gradients and activations (33.48 GiB).
    Once a graph is bound, every group replays, an epoch's first too. Here
    the CUDA graph is a stand-in that runs its group's steps, so the
    routing of ``train_epoch`` -> ``TrainerGraphs.train`` runs on the CPU:
    one eager group (before the capture) in two epochs, then replays, and
    the same state as K 1."""
    from types import SimpleNamespace

    from gdmcf_torch.train import graphs as G

    kw = dict(device="cpu", backbone="DNNOneHotEmbeddingGCN", dims=[8],
              emb_size=10, steps=5, noise_scale=0.01, sampling_steps=0,
              batch_size=8, lr=1e-3)
    rows = (np.random.default_rng(3).random((32, 20)) < 0.3).astype(
        np.float32)
    data = TNative.from_scipy(sp.csr_matrix(rows))
    ref = TTrainer(TConfig(train_steps_per_call=1, **kw), 32, 20)
    tr = TTrainer(TConfig(train_steps_per_call=2, **kw), 32, 20)
    tr.model.load_state_dict(ref.model.state_dict())
    cpu, card = tr.device, SimpleNamespace(type="cuda")
    steps, eager, graph = tr.train_steps, [], []

    def on_cpu(fn, *a):
        tr.device = cpu
        try:
            return fn(*a)
        finally:
            tr.device = card

    def train_steps(state, xs, idxs, draws=None):
        eager.append(xs.shape[0])
        return on_cpu(steps, state, xs, idxs, draws)

    class Graph:   # the captured graph: replays run the group's steps
        def __init__(self, trainer, state, xs, idxs, pool):
            self.state, self.capture_s, self.replays = state, 0.0, 0
            graph.append(self)

        def binds(self, state):
            return state is self.state

        def run(self, trainer, state, xs, idxs):
            self.replays += 1
            return on_cpu(steps, state, torch.from_numpy(xs),
                          torch.from_numpy(idxs))

    class Pinned:
        def __init__(self, a):
            self.t = torch.from_numpy(np.ascontiguousarray(a))

        def to(self, *a, **k):
            return self.t

    monkeypatch.setattr(G, "TrainGraph", Graph)
    monkeypatch.setattr(G, "_pinned", Pinned)
    graphs = G.TrainerGraphs.__new__(G.TrainerGraphs)
    graphs.__dict__.update(_trainer=lambda: tr, pool=None, train_graphs={},
                           eval_graphs={}, capture_s=0.0, captures=0)
    state = tr.init_state()
    tr.graphs, tr.train_steps, tr.device = (lambda: graphs), train_steps, card
    ref_state = ref.init_state()
    for epoch in range(2):
        state, total = tr.train_epoch(state, data,
                                      np.random.default_rng(epoch))
        ref_state, want = ref.train_epoch(ref_state, data,
                                          np.random.default_rng(epoch))
        assert total == want
    assert eager == [2] and len(graph) == 1 and graph[0].replays == 3
    assert state.step == ref_state.step == 8
    for k, p in state.params.items():
        assert torch.equal(p, ref_state.params[k]), k
