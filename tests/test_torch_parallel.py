"""The port's parallel layer in one process, against the JAX package where it
has a counterpart: the sharding rules leaf by leaf (every ``w`` transposed),
``compatible_spec``, the row shards and ``RowSlice``, the merge of the
sharded top-k (ties and all--inf rows), the draws a dp block cuts from
the whole batch's (equal to the draws the engine makes itself), and the
refusals: a mesh config without its world, ``opt_impl`` fused or inline on
a mesh (the JAX package's words), a coordinator without a process count,
a DTensor handed to a kernel wrapper, a peer that dies (the survivor
raises within the heartbeat timeout instead of hanging).

Exact comparisons throughout: specs, ranges, ids and draws are discrete.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.data.loader import DiffusionDataset, RowSlice  # noqa: E402
from gdmcf_torch.models.registry import BACKBONES, build_model  # noqa: E402
from gdmcf_torch.ops import topk as TK  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.parallel import multihost  # noqa: E402
from gdmcf_torch.parallel.rows import RowBlock  # noqa: E402
from gdmcf_torch.parallel import sharding as TS  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.data.loader import DiffusionDataset as JDataset  # noqa: E402
from gdmcf_tpu.data.loader import RowSlice as JRowSlice  # noqa: E402
from gdmcf_tpu.models.registry import build_model as j_build  # noqa: E402
from gdmcf_tpu.ops.topk import sharded_topk as j_sharded_topk  # noqa: E402
from gdmcf_tpu.parallel import multihost as JM  # noqa: E402
from gdmcf_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from gdmcf_tpu.parallel.sharding import compatible_spec as j_compat  # noqa: E402,E501
from gdmcf_tpu.parallel.sharding import param_specs as j_param_specs  # noqa: E402,E501
from gdmcf_tpu.train.state import path_str  # noqa: E402

CPU = jax.devices("cpu")
ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_parallel_worker.py")


def t_(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the rules against the JAX package's, leaf by leaf
# ---------------------------------------------------------------------------

def port_name(path: str) -> str:
    """compat's one-for-one name of a JAX leaf path."""
    head, _, leaf = path.rpartition("/")
    leaf = {"w": "weight", "b": "bias", "g": "weight"}.get(leaf, leaf) \
        if head else leaf
    return ".".join([p for p in head.split("/") if p] + [leaf])


def port_spec(jspec, jax_path: str, ndim: int):
    """A JAX PartitionSpec as the port's (dp, mp) placements: a ``w`` is
    stored transposed in the port, so its mp dimension flips."""
    mp = Replicate()
    for dim, axis in enumerate(tuple(jspec)):
        if axis == "mp":
            flip = jax_path.endswith("/w") and ndim == 2
            mp = Shard(ndim - 1 - dim if flip else dim)
        assert axis in (None, "mp"), jspec
    return (Replicate(), mp)


def models(backbone, n_user, n_item):
    kw = dict(backbone=backbone, dims=[16], emb_size=10, steps=5,
              batch_size=8)
    graph = sp.csr_matrix((np.random.default_rng(0).random(
        (n_user, n_item)) < 0.3).astype(np.float32))
    jm = j_build(JConfig(**kw), n_user, n_item, train_csr=graph)
    tm = build_model(TConfig(device="cpu", **kw), n_user, n_item,
                     train_csr=graph, generator=torch.Generator())
    return jm.init(jax.random.PRNGKey(0)), tm


@pytest.mark.parametrize("shape", [(32, 32), (31, 33)])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_rules_match_the_jax_param_specs_leaf_by_leaf(backbone, shape):
    n_user, n_item = shape
    jparams, tmodel = models(backbone, n_user, n_item)
    mesh = j_make_mesh(dp=4, mp=2, devices=CPU)
    port_names = dict(tmodel.state_dict())
    for with_mesh in (False, True):
        jspecs = j_param_specs(jparams, mesh=mesh if with_mesh else None)
        got = TS.param_specs(tmodel, mesh={"dp": 4, "mp": 2}
                             if with_mesh else None)
        leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
        specs = jax.tree_util.tree_leaves(
            jspecs, is_leaf=lambda s: isinstance(s, P))
        assert len(leaves) == len(specs) == len(got)
        for (path, leaf), jspec in zip(leaves, specs):
            name = port_name(path_str(path))
            assert name in port_names, name
            want = port_spec(jspec, path_str(path), np.ndim(leaf))
            assert got[name] == want, (name, jspec, got[name])


@pytest.mark.parametrize("spec,shape,mesh,want", [
    (P("mp", None), (32, 8), {"mp": 2}, (Replicate(), Shard(0))),
    (P("mp", None), (31, 8), {"mp": 2}, (Replicate(), Replicate())),
    (P(None, "mp"), (8, 30), {"mp": 3}, (Replicate(), Shard(1))),
    (P(None, "mp"), (8, 31), {"mp": 3}, (Replicate(), Replicate())),
    (P("mp", None), (8,), {"mp": 2}, (Replicate(), Replicate())),
    (P(None, "mp"), (8,), {"mp": 2}, (Replicate(), Replicate())),
    (P("mp", None), (32, 8), {"mp": 1}, (Replicate(), Shard(0))),
])
def test_compatible_spec_drops_what_does_not_divide(spec, shape, mesh, want):
    port = port_spec(spec, "x", 2)   # every rule's spec is for a matrix
    assert TS.compatible_spec(port, shape, dict(mesh, dp=2)) == want
    jmesh = j_make_mesh(dp=2, mp=mesh["mp"], devices=CPU)
    jgot = j_compat(spec, shape, jmesh)
    assert port_spec(jgot, "x", len(shape)) == want


def test_batch_and_index_specs():
    assert TS.batch_spec() == (Shard(0), Replicate())
    assert TS.index_spec() == (Shard(0), Replicate())
    assert TS.describe((Replicate(), Shard(1))) == \
        "dp:Replicate() mp:Shard(1)"


# ---------------------------------------------------------------------------
# row shards and RowSlice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards", [(41, 2), (8, 8), (100, 3), (5, 1)])
def test_row_range_is_equal_shards_with_the_remainder_dropped(n, shards):
    got = [multihost.row_range(n, shards, i) for i in range(shards)]
    base = n // shards
    assert got == [range(i * base, (i + 1) * base) for i in range(shards)]


def test_row_range_refuses_empty_shards():
    with pytest.raises(ValueError, match="empty shard"):
        multihost.row_range(3, 4, 0)
    with pytest.raises(ValueError, match="empty shard"):
        multihost.local_row_range(0)
    with pytest.raises(ValueError, match="empty shard"):
        JM.local_row_range(0)


def test_local_row_range_without_a_world_is_everything():
    assert multihost.local_row_range(17) == range(0, 17)
    assert JM.local_row_range(17) == range(0, 17)


@pytest.mark.parametrize("packed", [False, True])
def test_row_slice_matches_the_jax_row_slice(packed):
    rows_ = (np.random.default_rng(1).random((20, 13)) < 0.4).astype(
        np.float32)
    ours = RowSlice(DiffusionDataset.from_rows(rows_), range(6, 16))
    theirs = JRowSlice(JDataset.from_rows(rows_), range(6, 16))
    idx = np.array([0, 9, 3, 3])
    assert len(ours) == len(theirs) == 10 and ours.offset == 6
    assert ours.binary == theirs.binary
    if packed:
        np.testing.assert_array_equal(ours.gather_packed(idx),
                                      theirs.gather_packed(idx))
    else:
        np.testing.assert_array_equal(ours.gather(idx), theirs.gather(idx))


# ---------------------------------------------------------------------------
# the sharded top-k's merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards,n,k", [(2, 2202, 7), (4, 64, 5),
                                        (3, 1536, 100)])
def test_shard_merge_matches_chunked_and_jax(shards, n, k):
    rng = np.random.default_rng(n)
    scores = np.round(rng.standard_normal((8, n)), 1).astype(np.float32)
    scores[2] = -np.inf
    scores[4, n // 2 - 3:] = 5.0     # ties across a shard boundary
    width = n // shards
    cands = [TK.chunked_topk(t_(scores[:, i * width:(i + 1) * width]), k)
             for i in range(shards)]
    vals, idx = TK.merge_shards([c[0] for c in cands],
                                [c[1] + i * width
                                 for i, c in enumerate(cands)], k)
    want_v, want_i = TK.chunked_topk(t_(scores), k)
    assert torch.equal(idx, want_i) and torch.equal(vals, want_v)
    mesh = j_make_mesh(dp=2, mp=shards, devices=CPU)
    _, jidx = j_sharded_topk(mesh, jax.device_put(
        jnp.asarray(scores), NamedSharding(mesh, P("dp", "mp"))), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ---------------------------------------------------------------------------
# the draws a dp block cuts from the whole batch's
# ---------------------------------------------------------------------------

def draw_trainer(backbone, variant, **kw):
    cfg = TConfig(device="cpu", backbone=backbone, diffusion_variant=variant,
                  dims=[16], emb_size=10, steps=5, noise_scale=0.01,
                  batch_size=8, **kw)
    return TTrainer(cfg, 12, 20)


def full_ring(steps=5, h=10, seed=0):
    """An Lt ring whose rows are full: the importance branch is taken."""
    g = torch.Generator().manual_seed(seed)
    return TE.LtState(torch.rand((steps, h), generator=g) + 0.1,
                      torch.full((steps,), h, dtype=torch.int32))


def rows_x(b=8, n=20, seed=1):
    return t_((np.random.default_rng(seed).random((b, n)) < 0.3).astype(
        np.float32))


@pytest.mark.parametrize("backbone,variant", [
    ("DNN", "discrete"), ("DNNOneHotEmbeddingGCN", "discrete"),
    ("DNNOneHot", "legacy"), ("DNNOneHotEmbedding", "ablation"),
    ("DNNOneHotTransformer", "discrete")])
@pytest.mark.parametrize("filled", [False, True])
def test_train_draws_are_the_draws_training_losses_makes(backbone, variant,
                                                         filled):
    t = draw_trainer(backbone, variant)
    d, model = t.diffusion, t.model
    model.train()
    lt = full_ring() if filled else TE.LtState.create(5)
    x, idx = rows_x(), torch.arange(8)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    want, want_lt, _ = d.training_losses(model, x, idx, lt, generator=g1)
    draws = d.train_draws(lt, 8, 20, g2, model=model)
    got, got_lt, _ = d.training_losses(model, x, idx, lt, draws=draws)
    assert torch.equal(got, want)
    assert torch.equal(got_lt.history, want_lt.history)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("variant,steps,noise,guided", [
    ("discrete", 0, False, 1), ("discrete", 3, True, 0),
    ("legacy", 2, True, 1), ("ablation", 2, False, 0)])
def test_p_sample_draws_are_the_draws_p_sample_makes(variant, steps, noise,
                                                     guided):
    t = draw_trainer("DNNOneHotEmbeddingGCN", variant, sampling_noise=noise,
                     user_guided=guided)
    d, model = t.diffusion, t.model
    model.eval()
    x, idx = rows_x(), torch.arange(8)
    g1, g2 = (torch.Generator().manual_seed(11) for _ in range(2))
    with torch.no_grad():
        want = d.p_sample(model, x, idx, steps, noise, generator=g1)
        draws = d.p_sample_draws(8, 20, steps, noise, g2)
        got = d.p_sample(model, x, idx, steps, noise, draws=draws)
    assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_a_row_block_keeps_its_rows_of_the_whole_batch_draws():
    t = draw_trainer("DNNOneHotEmbedding", "discrete")
    d, model = t.diffusion, t.model
    model.train()
    block = RowBlock(4, 8, 12, None)
    lt = full_ring()
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    whole = d.train_draws(lt, 12, 20, g1, model=model)
    part = d.train_draws(lt, 12, 20, g2, model=model, keep=block.cut)
    flat_w = [whole.ts_u.uniform, whole.ts_u.importance, whole.corrupt_u,
              whole.ts.uniform, whole.ts.importance, whole.noise,
              *whole.dropout]
    flat_p = [part.ts_u.uniform, part.ts_u.importance, part.corrupt_u,
              part.ts.uniform, part.ts.importance, part.noise, *part.dropout]
    assert [p.shape[0] for p in flat_p] == [4] * 8
    for w, p in zip(flat_w, flat_p):
        assert torch.equal(p, w[4:8])
    whole = d.p_sample_draws(12, 20, 2, True, g1)
    part = d.p_sample_draws(12, 20, 2, True, g2, keep=block.cut)
    for w, p in zip([whole.init_u, whole.init_c, *whole.sprinkle,
                     *whole.gate, *whole.noise],
                    [part.init_u, part.init_c, *part.sprinkle, *part.gate,
                     *part.noise]):
        assert torch.equal(p, w[4:8])


def test_a_block_without_its_draws_is_refused():
    t = draw_trainer("DNNOneHotEmbedding", "discrete")
    block = RowBlock(0, 4, 8, None)
    x, idx = rows_x(4), torch.arange(4)
    with pytest.raises(ValueError, match="train_draws"):
        t.diffusion.training_losses(t.model, x, idx, TE.LtState.create(5),
                                    block=block)
    with pytest.raises(ValueError, match="p_sample_draws"):
        t.diffusion.p_sample(t.model, x, idx, 0, block=block)
    # the transformer's draws, once refused for a block, are cut like any
    # model's; a block without them is refused like any model's
    tr = draw_trainer("DNNOneHotTransformer", "discrete")
    tr.model.train()
    assert len(tr.model.dropout_draws(8, 20, torch.Generator(),
                                      keep=block.cut)) == 2 + 4 * 4
    with pytest.raises(ValueError, match="train_draws"):
        tr.diffusion.training_losses(tr.model, x, idx, TE.LtState.create(5),
                                     block=block)


def test_a_transformer_block_keeps_the_query_rows_of_the_attention_draws():
    """Of the [nhead, B, B] attention-weight uniforms a dp block keeps its
    query rows and every key column; every other draw its batch rows; the
    whole draws are those the forward makes itself, in its order."""
    t = draw_trainer("DNNOneHotTransformer", "discrete")
    model = t.model
    model.train()
    block = RowBlock(4, 8, 12, None)
    g1, g2, g3 = (torch.Generator().manual_seed(5) for _ in range(3))
    whole = model.dropout_draws(12, 20, g1)
    part = model.dropout_draws(12, 20, g2, keep=block.cut)
    for i, (w, p) in enumerate(zip(whole, part)):
        if w.ndim == 3:   # (ctx, ff, att, inner) per layer: att is 4 + 4k
            assert i % 4 == 0 and p.shape == (2, 4, 12)
            assert torch.equal(p, w[:, 4:8])
        else:
            assert torch.equal(p, w[4:8])
    x = rows_x(12)
    xu = torch.stack([1.0 - x, x], dim=-1)
    ts = torch.arange(12) % 5
    with torch.no_grad():
        want, _ = model(x, ts, xu, generator=g3)
        got, _ = model(x, ts, xu, dropout_u=whole)
    assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g3.get_state())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------



@pytest.mark.parametrize("opt_impl", ["fused", "inline"])
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_mesh_refuses_fused_and_inline_as_the_jax_config_does(opt_impl,
                                                               mesh):
    kw = dict(mesh_dp=mesh[0], mesh_mp=mesh[1], opt_impl=opt_impl)
    with pytest.raises(ValueError) as ours:
        TConfig(device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        JConfig(**kw)
    # the JAX package's words but for its optimizer library's name, which
    # the port's sources do not name
    head = f"opt_impl={opt_impl!r} requires param_dtype=float32 and a " \
        "single-device mesh ("
    tail = "); use opt_impl='auto' to fall back automatically"
    for said in (str(ours.value), str(theirs.value)):
        assert said.startswith(head) and said.endswith(tail)
    # "auto" is valid in both: the per-shard kernel here
    assert TConfig(device="cpu", mesh_dp=mesh[0], mesh_mp=mesh[1])
    assert JConfig(mesh_dp=mesh[0], mesh_mp=mesh[1])


def test_coordinator_without_process_count_raises(monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="NUM_PROCESSES is not"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="NUM_PROCESSES is not"):
        JM.initialize()


def test_without_a_coordinator_initialize_is_a_no_op(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.process_count() == 1 and multihost.is_main_process()
    v = np.arange(3.0)
    np.testing.assert_array_equal(multihost.allgather_host_vectors(v), v[None])
    multihost.sync_hosts()


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_a_mesh_config_without_its_world_raises(mesh):
    with pytest.raises(ValueError, match="needs a world of"):
        TTrainer(TConfig(device="cpu", dims=[8], mesh_dp=mesh[0],
                         mesh_mp=mesh[1]), 4, 6)


@pytest.mark.parametrize("kw", [dict(OneHotMatrix=1, backbone="DNN"),
                                dict(symmetric_gcn=True),
                                dict(backbone="DNNOneHotTransformer")])
def test_mesh_options_that_wait_name_their_roadmap_item(kw, tmp_path):
    """The three options that once waited for ROADMAP.md §A item 9 (each
    reads across batch rows) now run on a mesh: two train steps of a
    (2, 1) world of gloo ranks (``MODE=option``) on their own draws equal
    two single-process steps from the same seed, under the own-draws rule
    of tests/test_torch_serve_mesh.py (the loss within rtol 1e-5, every
    parameter within rtol 1e-4 / atol 1e-6 but for elements whose
    gradient is rounding noise or whose bfloat16 moments rounded apart)."""
    cfg = dict(dims=[16], emb_size=10, steps=5, noise_scale=0.01,
               batch_size=8, lr=1e-3, random_seed=2, **kw)
    n_user, n_item = 24, 20
    rng = np.random.default_rng(6)
    inp = {}
    for s in range(2):
        inp[f"x{s}"] = (rng.random((8, n_item)) < 0.3).astype(np.float32)
        inp[f"i{s}"] = rng.choice(n_user, 8, replace=False).astype(np.int64)
    np.savez(tmp_path / "inputs.npz", **inp)
    (tmp_path / "inputs.json").write_text(json.dumps(dict(
        mesh=[2, 1], cfg=cfg, steps=2, n_user=n_user, n_item=n_item)))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank), MODE="option",
                   WORK_DIR=str(tmp_path), PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (rank, out[-3000:])
    from test_torch_serve_mesh import assert_own_steps

    assert_own_steps(
        TTrainer(TConfig(device="cpu", **cfg), n_user, n_item),
        [(inp[f"x{s}"], inp[f"i{s}"]) for s in range(2)],
        json.loads((tmp_path / "rank0.json").read_text())["losses"],
        dict(np.load(tmp_path / "rank0.npz")), f"{kw} on (2, 1)")


def test_kernel_wrappers_refuse_a_dtensor():
    from torch.distributed.tensor import DTensor

    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S

    class Fake(DTensor):   # isinstance is all the wrappers look at
        def __new__(cls):
            return torch.Tensor._make_subclass(cls, torch.zeros(3))

    fake = Fake()
    p = torch.zeros(3)
    c = torch.zeros(3)
    with pytest.raises(TypeError, match="DTensor"):
        FA.adamw_update_(p, fake, p.clone(), p.clone(), c)
    op = S.row_operand(sp.csr_matrix(np.eye(3, dtype=np.float32)), False)
    with pytest.raises(TypeError, match="DTensor"):
        S.spmm_rows(op, fake)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_dead_peer_makes_the_survivor_raise(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank),
                   HEARTBEAT_TIMEOUT_S="10", MODE="dead_peer",
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        out = procs[0].communicate(timeout=90)[0]
        procs[1].communicate(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    line = [s for s in out.splitlines() if s.startswith("DEAD_PEER")]
    assert line and line[0].startswith("DEAD_PEER raised"), out[-2000:]
    assert float(line[0].split("after ")[1].split(" s")[0]) <= 10.0 + 5.0


def test_single_device_mesh_is_one_by_one():
    import torch.distributed as dist

    from gdmcf_torch.parallel.mesh import (axis_index, mesh_shape,
                                           single_device_mesh)

    assert not dist.is_initialized()
    try:
        mesh = single_device_mesh("cpu")
        assert mesh_shape(mesh) == {"dp": 1, "mp": 1}
        assert axis_index(mesh, "dp") == axis_index(mesh, "mp") == 0
        assert tuple(mesh.mesh_dim_names) == ("dp", "mp")
    finally:
        dist.destroy_process_group()


def test_the_cli_trains_on_a_mesh_and_the_main_rank_writes(tmp_path):
    from gdmcf_torch.data.loader import generate_synthetic_dataset

    data = tmp_path / "data"
    generate_synthetic_dataset(str(data) + "/", n_user=40, n_item=30,
                               avg_degree=6, seed=3)
    port = _free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES="4", PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gdmcf_torch.cli", "--device", "cpu",
             "--mesh_dp", "2", "--mesh_mp", "2", "--data_path",
             str(data), "--dims", "[16]", "--batch_size", "8",
             "--epochs", "2", "--eval_every", "1", "--topN", "[5, 10]",
             "--log_name", str(tmp_path / "log"), "--dataset", "mesh"],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (rank, out[-3000:])
    run_dirs = list((tmp_path / "log" / "mesh").glob("*/GDMCF"))
    assert len(run_dirs) == 1
    text = (run_dirs[0] / "output_NDCG.txt").read_text()
    assert "End. Best Epoch" in text and "mesh_dp': 2" in text
    epochs = [line for line in (run_dirs[0] / "metrics.jsonl").read_text()
              .splitlines() if '"train_loss"' in line]
    assert len(epochs) == 2   # one writer: the main rank
