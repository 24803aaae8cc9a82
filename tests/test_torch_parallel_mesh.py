"""The port's (dp, mp) mesh against the JAX package's, in a world of 4 gloo
ranks on the CPU (mesh (2, 2)), launched under the env contract of
``gdmcf_torch.parallel.multihost.initialize`` as tests/test_multihost.py
launches the JAX workers. One world runs every check
(tests/torch_parallel_worker.py); the JAX side runs here, on the 8
virtual CPU devices of the conftest.

Tolerances:
- the flagship forward on (2, 2) against the JAX (4, 2) mesh forward:
  rtol 2e-5 / atol 1e-5;
- one train step on (2, 2) against the JAX (4, 2) mesh step at the same
  weights (through ``compat``) and the same draws: the loss within rtol
  2e-4, every parameter within rtol 5e-3 / atol 1e-5
  (tests/test_sharding.py's tolerance; the JAX mesh runs its optax chain,
  the port the single-pass AdamW on each rank's blocks);
- two steps that draw their own randomness on (2, 2) against two
  single-device steps from the same seed: the loss within rtol 1e-5, the
  parameters within rtol 1e-4 / atol 1e-6 (the same float32 terms summed
  in another order);
- the sharded lookup's values exactly, the table gradient against a dense
  gather's within rtol 1e-6 / atol 1e-7 (float32 sums of the same terms);
- sharded top-k: ids and values exactly (ties to the lowest index);
- evaluations: metric means within 1.01e-4 (one unit of the 4-decimal
  rounding), as tests/multihost_worker.py compares them;
- checkpoints: bitwise;
- ``bf16_weights`` on (2, 2) against the single process at the same
  weights and draws: the loss within rtol 1e-5; stored tensors, masters
  and float32 tensors as in tests/test_torch_bf16.py (at most 2% of a
  tensor, or one element, past rtol 1e-4 / atol 2e-2 x lr, plus one
  bfloat16 ulp for a stored tensor; every element within 2 x lr): the
  mesh sums a bfloat16 gradient over dp from each block's rounding.
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

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.diffusion import engine as TE  # noqa: E402
from gdmcf_torch.train.checkpoint import Checkpointer  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.models.registry import build_model as j_build  # noqa: E402
from gdmcf_tpu.ops.topk import sharded_topk as j_sharded_topk  # noqa: E402
from gdmcf_tpu.parallel.embed import sharded_embedding_lookup as j_lookup  # noqa: E402,E501
from gdmcf_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from gdmcf_tpu.parallel.sharding import shard_params as j_shard  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
CPU = jax.devices("cpu")
pytestmark = pytest.mark.skipif(len(CPU) < 8,
                                reason="needs 8 virtual cpu devices")

DP, MP = 2, 2
N_USER, N_ITEM, B = 32, 32, 16
CFG = dict(backbone="DNNOneHotEmbeddingGCN", dims=[16], emb_size=10,
           steps=5, noise_scale=0.01, batch_size=B, lr=1e-3,
           sampling_steps=0, random_seed=0)
CAT2_CFG = dict(dims=[16], emb_size=10, steps=5, noise_scale=0.01,
                batch_size=B, random_seed=4)
CLOSE = 1.01e-4
FWD = dict(rtol=2e-5, atol=1e-5)
STEP_LOSS = dict(rtol=2e-4)
STEP_PARAMS = dict(rtol=5e-3, atol=1e-5)
CLIP = 0.05
K = 5
BF16 = ("in_layers/", "embedding_item")


def t_(a):
    return torch.from_numpy(np.array(a))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, work: str, timeout: float = 300, **env_extra):
    """Run the worker in ``world`` ranks; returns each rank's output. Every
    rank is killed at ``timeout``."""
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(world), PROCESS_ID=str(rank),
                   WORK_DIR=work, PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="1", **env_extra)
        logs.append(open(os.path.join(work, f"log{rank}.txt"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=ROOT,
            stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for fh in logs:
        fh.seek(0)
        outs.append(fh.read())
        fh.close()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n" + "\n".join(
            f"--- rank {r}\n{x[-3000:]}" for r, x in enumerate(outs))
    return outs


def jax_train_draws(jd, lt, step_key, b, n):
    """The JAX training_losses draws under ``step_key``, in its order."""
    k_ts_u, k_noise_u, k_ts, k_noise, k_drop = jax.random.split(step_key, 5)

    def ts(k):
        t, _ = jd.sample_timesteps(k, lt, b)
        return np.asarray(t)

    k1, k2 = jax.random.split(k_drop, 2)
    return dict(d_tsu=ts(k_ts_u),
                d_corrupt=np.asarray(jax.random.uniform(k_noise_u, (b, n))),
                d_ts=ts(k_ts),
                d_noise=np.asarray(jax.random.normal(k_noise, (b, n))),
                d_drop0=np.asarray(jax.random.uniform(k1, (b, n))),
                d_drop1=np.asarray(jax.random.uniform(k2, (b, 2 * n))))


def synthetic(seed, n_user, n_item, p):
    rng = np.random.default_rng(seed)
    return (rng.random((n_user, n_item)) < p).astype(np.float32)


class World:
    """Inputs, the JAX side, and the 4-rank world's results."""

    def __init__(self, work: str):
        self.work = work
        self.jmesh = j_make_mesh(dp=4, mp=2, devices=CPU)
        jt = JTrainer(JConfig(mesh_dp=4, mesh_mp=2, **CFG), N_USER, N_ITEM)
        jstate = jt.init_state()
        self.jt, self.jstate0 = jt, jstate
        host = jax.tree_util.tree_map(np.asarray, jstate.params)
        self.weights = compat.state_dict_from_jax_params(host)
        rng = np.random.default_rng(0)
        inp = {f"w.{k}": v for k, v in self.weights.items()}
        # forward inputs
        f_x = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
        inp.update(f_x=f_x, f_t=rng.integers(0, 5, B).astype(np.int64),
                   f_xu=np.stack([1.0 - f_x, f_x], -1).astype(np.float32),
                   f_idx=rng.choice(N_USER, B, replace=False).astype(
                       np.int64))
        # one train step: the batch and the JAX mesh step's own draws
        s_x = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
        s_idx = rng.choice(N_USER, B, replace=False).astype(np.int32)
        _, step_key = jax.random.split(jstate.key)
        inp.update(s_x=s_x, s_idx=s_idx.astype(np.int64),
                   **jax_train_draws(jt.diffusion, jstate.lt, step_key, B,
                                     N_ITEM))
        # two steps that draw their own randomness
        inp.update({f"o_x{s}": synthetic(5 + s, B, N_ITEM, 0.3)
                    for s in range(2)})
        # the sharded lookup
        inp.update(l_table=rng.standard_normal((N_USER, 6)).astype(
            np.float32), l_ids=rng.integers(0, N_USER, B).astype(np.int64),
            l_w=rng.standard_normal((B, 6)).astype(np.float32))
        # top-k with ties and an all--inf row; 2201 columns: odd (padded)
        # and wider than a chunk on each shard
        scores = np.round(rng.standard_normal((B, 2201)), 1).astype(
            np.float32)
        scores[3] = -np.inf
        scores[5, :40] = 9.0
        inp["k_scores"] = scores
        # host vectors of float64 edge values, one per rank
        vec = rng.standard_normal((4, 6))
        vec[:, 0] = [5e-324, -0.0, np.inf, 1.0 / 3.0]
        inp["h_vec"] = vec
        # fit / eval data: 43 users (a trailing partial batch that dp
        # does not divide) and a lightGCN graph the mesh shards
        inp["e_train"] = synthetic(1, 43, 30, 0.2)
        inp["e_valid"] = synthetic(2, 43, 30, 0.05)
        inp["e_test"] = synthetic(3, 43, 30, 0.05)
        inp["g_train"] = synthetic(4, 40, 30, 0.2)
        # DNNCat2 at the single-device port's seeded init
        cat2 = TTrainer(TConfig(device="cpu", backbone="DNNCat2",
                                **CAT2_CFG), N_USER, N_ITEM)
        self.cat2 = cat2
        inp.update({f"c2.{k}": v.numpy()
                    for k, v in cat2.model.state_dict().items()})
        self.inp = inp
        self.meta = dict(cat2_cfg=CAT2_CFG,
            mesh=[DP, MP], batch=B, n_user=N_USER, n_item=N_ITEM,
            cfg={k: v for k, v in CFG.items()}, clip=CLIP, k=K, rows_n=41,
            fit=dict(epochs=2, eval_every=1, batch_size=8, topN=[5, 10],
                     history_num_per_term=2, drop_last=True),
            lgn_cfg=dict(dims=[16], emb_size=10, steps=5, noise_scale=0.01,
                         batch_size=B, sampling_steps=0, random_seed=3),
            single_step=1, bf16_weights=list(BF16))
        self._single_checkpoint()
        np.savez(os.path.join(work, "inputs.npz"), **inp)
        with open(os.path.join(work, "inputs.json"), "w") as fh:
            json.dump(self.meta, fh)
        launch(DP * MP, work)
        self.res = [json.load(open(os.path.join(work, f"rank{r}.json")))
                    for r in range(DP * MP)]
        self.out = dict(np.load(os.path.join(work, "rank0.npz")))

    def _single_checkpoint(self):
        """A single-device checkpoint after one step, for the mesh to
        restore."""
        t = TTrainer(TConfig(device="cpu", **CFG), N_USER, N_ITEM)
        state = t.init_state()
        rng = np.random.default_rng(9)
        x = (rng.random((B, N_ITEM)) < 0.3).astype(np.float32)
        state, _ = t.train_step(state, t_(x), torch.arange(B))
        Checkpointer(os.path.join(self.work, "single_ckpt")).save(state)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("mesh")))


def ok(world, name):
    for r, res in enumerate(world.res):
        assert not str(res[name]).startswith("ERROR"), (r, res[name])
    return [res[name] for res in world.res]


# ---------------------------------------------------------------------------

def test_placements_follow_the_rules_on_the_mesh(world):
    place = ok(world, "placements")[0]
    assert place["embedding_item"] == "dp:Replicate() mp:Shard(0)"
    assert place["embedding_user"] == "dp:Replicate() mp:Shard(0)"
    assert place["in_layers.0.weight"] == "dp:Replicate() mp:Shard(1)"
    assert place["in_layers2.0.weight"] == "dp:Replicate() mp:Shard(1)"
    assert place["sumW"] == "dp:Replicate() mp:Replicate()"
    shapes = world.res[0]["local_shapes"]
    assert shapes["embedding_user"] == [N_USER // MP, 16]
    assert shapes["in_layers.0.weight"] == [16, (N_ITEM + 10) // MP]
    assert shapes["gcn.conv1.weight"] == list(
        world.weights["gcn.conv1.weight"].shape)


def test_flagship_forward_matches_the_jax_mesh_forward(world):
    ok(world, "forward")
    inp = world.inp
    jcfg = JConfig(**CFG)
    model = j_build(jcfg, N_USER, N_ITEM, mesh=world.jmesh)
    sp_params = j_shard(world.jstate0.params, world.jmesh)
    xs = jax.device_put(jnp.asarray(inp["f_x"]),
                        NamedSharding(world.jmesh, P("dp", "mp")))
    want, _ = jax.jit(lambda p, x, t, xu, i: model.apply(
        p, x, t, xu, index=i, graph=xu, train=False, rng=None))(
        sp_params, xs, jnp.asarray(inp["f_t"], jnp.int32),
        jnp.asarray(inp["f_xu"]), jnp.asarray(inp["f_idx"], jnp.int32))
    np.testing.assert_allclose(world.out["forward"], np.asarray(want), **FWD)


def test_train_step_matches_the_jax_mesh_step(world):
    losses = ok(world, "step_loss")
    assert len(set(losses)) == 1   # every rank reports the global loss
    inp = world.inp
    jt = world.jt
    state = jt.init_state()
    xs, idxs = jt._put_batch(jnp.asarray(inp["s_x"]),
                             jnp.asarray(inp["s_idx"], jnp.int32))
    state, loss = jt._train_step(state, xs, idxs)
    np.testing.assert_allclose(losses[0], float(loss), **STEP_LOSS)
    want = compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params))
    for k, v in want.items():
        np.testing.assert_allclose(world.out[f"step.{k}"], v,
                                   err_msg=k, **STEP_PARAMS)
    np.testing.assert_array_equal(world.out["step.lt_count"],
                                  np.asarray(state.lt.count))
    np.testing.assert_allclose(world.out["step.lt_history"],
                               np.asarray(state.lt.history), rtol=1e-4)


def test_clipped_step_matches_the_single_device_step(world):
    """grad_clip_norm takes the global norm: the squares of a sharded
    tensor sum over mp, not over the dp replicas."""
    loss = ok(world, "clip_loss")[0]
    inp = world.inp
    t = TTrainer(TConfig(device="cpu", grad_clip_norm=CLIP, **CFG),
                 N_USER, N_ITEM)
    t.model.load_state_dict({k: t_(v) for k, v in world.weights.items()})
    state = t.init_state()
    draws = TE.TrainDraws(
        ts_u=TE.TimestepDraws(t_(inp["d_tsu"]), t_(inp["d_tsu"])),
        corrupt_u=t_(inp["d_corrupt"]),
        ts=TE.TimestepDraws(t_(inp["d_ts"]), t_(inp["d_ts"])),
        noise=t_(inp["d_noise"]),
        dropout=(t_(inp["d_drop0"]), t_(inp["d_drop1"])))
    state, want = t.train_step(state, t_(inp["s_x"]), t_(inp["s_idx"]),
                               draws=draws)
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    for k, p in state.params.items():
        np.testing.assert_allclose(world.out[f"clip.{k}"],
                                   p.detach().numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-6)


def test_steps_drawing_their_own_randomness_match_the_single_device(world):
    """With no draws given, each rank draws the whole batch's from the
    shared generator and keeps its rows: two mesh steps equal two
    single-device steps from the same seed (float32 sums in another
    order: the loss within rtol 1e-5, parameters within rtol 1e-4 / atol
    1e-6)."""
    losses = ok(world, "own_draws")
    assert all(ls == losses[0] for ls in losses)
    inp = world.inp
    t = TTrainer(TConfig(device="cpu", **CFG), N_USER, N_ITEM)
    t.model.load_state_dict({k: t_(v) for k, v in world.weights.items()})
    state = t.init_state()
    for s in range(2):
        state, loss = t.train_step(state, t_(inp[f"o_x{s}"]),
                                   t_(inp["s_idx"]))
        np.testing.assert_allclose(losses[0][s], float(loss), rtol=1e-5)
    for k, p in state.params.items():
        np.testing.assert_allclose(world.out[f"own.{k}"],
                                   p.detach().numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(world.out["own.lt_history"],
                               state.lt.history.numpy(), rtol=1e-5)


def test_sharded_lookup_values_and_gradient(world):
    ok(world, "lookup")
    inp = world.inp
    table, ids, w = inp["l_table"], inp["l_ids"], inp["l_w"]
    np.testing.assert_array_equal(world.out["lookup_vals"], table[ids])
    dense = np.zeros_like(table)
    np.add.at(dense, ids, w)
    np.testing.assert_allclose(world.out["lookup_grad"], dense,
                               rtol=1e-6, atol=1e-7)
    # the JAX package's lookup on its (4, 2) mesh
    jt = jax.device_put(jnp.asarray(table),
                        NamedSharding(world.jmesh, P("mp", None)))
    jv = j_lookup(world.jmesh, jt, jnp.asarray(ids, jnp.int32),
                  batch_axis="dp")   # the port's ids are each dp block's
    np.testing.assert_array_equal(world.out["lookup_vals"], np.asarray(jv))
    jg = jax.grad(lambda tb: (j_lookup(world.jmesh, tb, jnp.asarray(
        ids, jnp.int32), batch_axis="dp") * jnp.asarray(w)).sum())(jt)
    np.testing.assert_allclose(world.out["lookup_grad"], np.asarray(jg),
                               rtol=1e-6, atol=1e-7)


def test_sharded_topk_matches_chunked_and_jax(world):
    assert all(ok(world, "topk_equals_chunked"))
    scores = world.inp["k_scores"]
    n = scores.shape[1]
    padded = np.pad(scores, ((0, 0), (0, (-n) % 2)),
                    constant_values=-np.inf)
    _, jidx = j_sharded_topk(world.jmesh, jax.device_put(
        jnp.asarray(padded), NamedSharding(world.jmesh, P("dp", "mp"))), K)
    np.testing.assert_array_equal(world.out["topk_idx"],
                                  np.minimum(np.asarray(jidx), n - 1))
    # ties: the forty 9.0s of row 5 give its five lowest indices
    np.testing.assert_array_equal(world.out["topk_idx"][5], np.arange(5))


def test_allgather_host_vectors_is_bit_exact(world):
    assert all(ok(world, "allgather_host_vectors"))


def test_local_row_range_is_the_dp_groups_shard(world):
    got = ok(world, "local_row_range")
    # 41 rows over dp 2: 20 each, the remainder dropped; the mp ranks of
    # a dp group share a shard
    assert got == [[0, 20, 20], [0, 20, 20], [20, 40, 20], [20, 40, 20]]


def test_dp_sharded_evaluation_equals_replicated(world):
    ev = ok(world, "eval")
    for r in ev:   # every rank reports the reduced, global metrics
        assert r == ev[0]
    ref = ev[0]["replicated"]
    for key in ("sharded", "stream_sharded", "stream_replicated"):
        np.testing.assert_allclose(np.asarray(ev[0][key]), np.asarray(ref),
                                   atol=CLOSE, err_msg=key)


def test_mesh_evaluation_equals_the_single_device_evaluation(world):
    ok(world, "fit_eval")
    inp, meta = world.inp, world.meta
    ecfg = dict(meta["cfg"], **meta["fit"])
    t = TTrainer(TConfig(device="cpu", **ecfg), 43, 30)
    t.model.load_state_dict({k[4:]: t_(v) for k, v in world.out.items()
                             if k.startswith("fit.")})
    rows = inp["e_train"]
    want = t.evaluate(None, rows, inp["e_valid"], rows, ecfg["topN"],
                      drop_last=False)
    np.testing.assert_allclose(np.asarray(world.res[0]["eval"]["sharded"]),
                               np.asarray(want), atol=CLOSE)


def test_fit_on_the_mesh_logs_once_and_checkpoints(world):
    lines = ok(world, "fit_lines")
    assert any("End. Best Epoch" in s for s in lines[0])
    assert all(not ls for ls in lines[1:])   # only the main rank speaks
    assert world.res[0]["fit_best"] == world.res[3]["fit_best"]
    ck = Checkpointer(os.path.join(world.work, "fit_ckpt"))
    assert ck.latest_step() is not None


def test_mesh_checkpoint_restores_bitwise_into_a_single_device_trainer(
        world):
    ok(world, "checkpoint_single_into_mesh")
    t = TTrainer(TConfig(device="cpu", **CFG), N_USER, N_ITEM)
    state = Checkpointer(os.path.join(world.work, "mesh_ckpt")).restore(
        t.init_state())
    for k, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      world.out[f"ck.param.{k}"], err_msg=k)
        np.testing.assert_array_equal(state.opt_state.mu[k].float().numpy(),
                                      world.out[f"ck.mu.{k}"], err_msg=k)
        np.testing.assert_array_equal(state.opt_state.nu[k].float().numpy(),
                                      world.out[f"ck.nu.{k}"], err_msg=k)


def test_single_device_checkpoint_restores_bitwise_into_the_mesh(world):
    assert all(ok(world, "checkpoint_single_into_mesh"))


def test_lightgcn_frozen_tables_shard_and_match(world):
    ok(world, "lightgcn")
    assert world.res[0]["lgn_local_user"] == [40 // MP, 64]
    g = sp.csr_matrix(world.inp["g_train"])
    cfg = TConfig(device="cpu", backbone="lightGCN", **world.meta["lgn_cfg"])
    t = TTrainer(cfg, 40, 30, train_csr=g)
    for k, v in t.model.state_dict().items():
        np.testing.assert_array_equal(world.out[f"lgn.{k}"], v.numpy(),
                                      err_msg=k)
    t.model.eval()
    with torch.no_grad():
        want, _ = t.model(t_(world.inp["g_train"][:B]),
                          torch.zeros(B, dtype=torch.long), None,
                          index=torch.arange(B))
    np.testing.assert_allclose(world.out["lgn_forward"], want.numpy(),
                               **FWD)


def test_refusals_in_a_world(world):
    said = ok(world, "refusals")[0]
    assert "needs a world of 1 ranks" in said["world"]
    assert "must divide evenly over mesh dp=2" in said["dp"]


def test_dnncat2_fuse_sharded_by_output_matches_one_device(world):
    ok(world, "cat2")
    assert world.res[0]["cat2_placement"] == "dp:Replicate() mp:Shard(0)"
    inp = world.inp
    model = world.cat2.model
    model.eval()
    with torch.no_grad():
        want, _ = model(t_(inp["f_x"]), t_(inp["f_t"]).long(),
                        t_(inp["f_xu"]))
    np.testing.assert_allclose(world.out["cat2_forward"], want.numpy(),
                               **FWD)


def test_global_mesh_coordinates_follow_the_rank(world):
    got = ok(world, "mesh_api")
    for rank, (shape, dp_i, mp_i, whole, main) in enumerate(got):
        assert shape == {"dp": DP, "mp": MP}
        assert (dp_i, mp_i) == (rank // MP, rank % MP)
        assert whole == {"dp": 1, "mp": DP * MP}
        assert main == (rank == 0)


def test_bf16_weights_on_the_mesh_match_the_single_process(world):
    """bf16_weights on (2, 2): the selected tensors stored bfloat16 on
    every rank, each master a float32 block of its tensor's shape (sharded
    as the tensor is), one step against the single process, and the mesh's
    checkpoint restored bitwise into a single-device trainer."""
    from test_torch_bf16 import within

    got = ok(world, "bf16_mesh")
    for r in got:
        assert r["loss"] == got[0]["loss"]
        assert set(r["local"]) == {"embedding_item", "in_layers.0.weight",
                                   "in_layers.0.bias"}
        for k, (m_shape, p_shape, p_dtype, m_dtype) in r["local"].items():
            assert m_shape == p_shape, k
            assert (p_dtype, m_dtype) == ("torch.bfloat16", "torch.float32")
        assert r["local"]["embedding_item"][0][0] == N_ITEM // MP
        assert r["local"]["in_layers.0.weight"][0] == [16,
                                                       (N_ITEM + 10) // MP]
    inp = world.inp
    t = TTrainer(TConfig(device="cpu", bf16_weights=BF16, **CFG), N_USER,
                 N_ITEM)
    t.model.load_state_dict({k: t_(v) for k, v in world.weights.items()})
    state = t.init_state()
    draws = TE.TrainDraws(
        ts_u=TE.TimestepDraws(t_(inp["d_tsu"]), t_(inp["d_tsu"])),
        corrupt_u=t_(inp["d_corrupt"]),
        ts=TE.TimestepDraws(t_(inp["d_ts"]), t_(inp["d_ts"])),
        noise=t_(inp["d_noise"]),
        dropout=(t_(inp["d_drop0"]), t_(inp["d_drop1"])))
    state, loss = t.train_step(state, t_(inp["s_x"]), t_(inp["s_idx"]),
                               draws=draws)
    np.testing.assert_allclose(got[0]["loss"], float(loss), rtol=1e-5)
    lr = CFG["lr"]
    for k, p in state.params.items():
        want = p.detach().float().numpy()
        mesh = world.out[f"bf16.param.{k}"]
        extra = 0.0
        if p.dtype == torch.bfloat16:
            extra = float(torch.finfo(torch.bfloat16).eps) * np.abs(want)
            within(world.out[f"bf16.master.{k}"],
                   state.opt_state.master[k].numpy(),
                   1e-4 * np.abs(want) + 2e-2 * lr, 2 * lr, 0.02,
                   f"{k} master")
        within(mesh, want, extra + 1e-4 * np.abs(want) + 2e-2 * lr,
               extra + 2 * lr, 0.02, k)
    # the mesh's checkpoint: bitwise into a single-device trainer
    t2 = TTrainer(TConfig(device="cpu", bf16_weights=BF16, **CFG), N_USER,
                  N_ITEM)
    restored = Checkpointer(os.path.join(world.work, "bf16_ckpt")).restore(
        t2.init_state())
    assert set(restored.opt_state.master) == set(got[0]["local"])
    for k, p in restored.params.items():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      world.out[f"bf16.param.{k}"],
                                      err_msg=k)
    for k, m in restored.opt_state.master.items():
        np.testing.assert_array_equal(m.numpy(),
                                      world.out[f"bf16.master.{k}"],
                                      err_msg=k)
