"""Serving on a (dp, mp) mesh of gloo ranks on the CPU, and the options that
read across batch rows (OneHotMatrix 1, ``symmetric_gcn``, the transformer
at dp 2) on a mesh, against the single-process port and the JAX package
on the 8 virtual CPU devices of the conftest.

Worlds (tests/torch_parallel_worker.py, ``MODE=serve``), launched under
the env contract of ``multihost.initialize`` as
tests/test_torch_parallel_mesh.py launches its world: (2, 2) first (it
writes the mesh checkpoint), then (1, 2) and (2, 1) side by side. Each
serves the flagship from a whole state (three dispatches around two
reloads, on every rank), from a checkpoint written on one device and from
one written on (2, 2), and at sampling_steps 0 against the JAX
``Recommender`` on its (4, 2) mesh; (1, 2) serves lightGCN; (2, 1) runs the
three options. ``serve_http.main`` runs as a (1, 2) world of its own.

Tolerances:
- mesh ids against the single process: equal except tie pairs, positions
  whose two ids the single process scored within 1e-5 (``chip_smoke``'s
  ``compare_ids`` rule); scores rtol 1e-4 / atol 1e-5;
- against the JAX recommender: ids equal, scores rtol 1e-4 / atol 1e-5
  (tests/test_torch_serve.py's);
- three train steps of each option, as tests/test_torch_parallel_mesh.py
  holds the flagship: at the JAX mesh's weights and draws the loss within
  rtol 2e-4 and every parameter within rtol 5e-3 / atol 1e-5; on the
  mesh's own draws against the single process from the same seed, the
  loss within rtol 1e-5 and every parameter within rtol 1e-4 / atol
  1e-6. Two exceptions, held to moving at most lr a step apart. The
  transformer's attention key bias (the middle third of each ``qkv``
  bias, tests/test_torch_onehot_modes.py's): its gradient is zero in exact
  arithmetic, so its float32 gradient is rounding noise that Adam's
  normalized step turns into +-lr. And on own draws, an element whose
  single-process gradient was under AdamW's eps (1e-8) at one of the
  steps (``chip_smoke``'s rounding floor): Adam moves it in proportion to
  a gradient that float32 sums in another order round apart (the GCN's
  tensors, whose gradient is scaled by 1 - sumW, start at the floor).
  On own draws, too, the bfloat16 moments are held as
  tests/test_torch_onehot_modes.py holds them (within one ulp of their
  storage type, of their value and of their decayed previous one, plus
  the gradient's float32 error: 1e-4 of the value and 1e-5 of the
  tensor's largest), and an element whose stored moments differ (a sum
  rounded apart in its last bits that lands on either side of a bfloat16
  rounding boundary) to moving at most 2^-7 lr a step apart (a one-ulp
  change of nu moves Adam's step by about 2^-9 of it);
- the eval step of each option: ids as above, and equal to the JAX
  mesh's.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gdmcf_torch import compat  # noqa: E402
from gdmcf_torch.config import Config as TConfig  # noqa: E402
from gdmcf_torch.data.loader import (data_load,  # noqa: E402
                                     generate_synthetic_dataset)
from gdmcf_torch.serve import Recommender  # noqa: E402
from gdmcf_torch.train.checkpoint import Checkpointer  # noqa: E402
from gdmcf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from gdmcf_tpu.config import Config as JConfig  # noqa: E402
from gdmcf_tpu.serve import Recommender as JRecommender  # noqa: E402
from gdmcf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from test_torch_layers_diffusion import jax_draws  # noqa: E402
from test_torch_onehot_modes import jax_train_draws  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
CPU = jax.devices("cpu")
pytestmark = pytest.mark.skipif(len(CPU) < 8,
                                reason="needs 8 virtual cpu devices")

N_USER, N_ITEM = 32, 30
SERVE_BATCH, K_MAX = 8, 10
CFG = dict(backbone="DNNOneHotEmbeddingGCN", dims=[16], emb_size=10,
           steps=5, noise_scale=0.01, batch_size=16, lr=1e-3,
           sampling_steps=2, random_seed=0)
LGN = dict(backbone="lightGCN", random_seed=3)
OPTIONS = {"oh1": dict(backbone="DNN", OneHotMatrix=1, sampling_steps=0),
           "sym": dict(symmetric_gcn=True, sampling_steps=0),
           "tr": dict(backbone="DNNOneHotTransformer", sampling_steps=0)}
MESHES = ((2, 2), (1, 2), (2, 1))
TIE = 1e-5
SCORES = dict(rtol=1e-4, atol=1e-5)
JAX_STEP_LOSS, JAX_STEP_PARAMS = 2e-4, dict(rtol=5e-3, atol=1e-5)
OWN_LOSS, OWN_PARAMS = 1e-5, dict(rtol=1e-4, atol=1e-6)

D0 = ("dispatch", list(range(7)), [True] * 7)
D1 = ("dispatch", list(range(7, 15)), [bool(i % 2) for i in range(8)])
D2 = ("dispatch", [20, 21, 22, 23, 31], [False] * 5)
PLAN_A = [D0, D1, ("reload", "single_ckpt"), D2, ("reload", "mesh_ckpt"), D0]
PLAN_B = [D0, D1, D2]


def t_(a):
    return torch.from_numpy(np.array(a))


def bridged(tree):
    return compat.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree))


def fixed_port() -> int:
    """A free port below the kernel's ephemeral range, where the sockets a
    world's ranks open while a server starts (gloo's pairs, the store's
    clients) cannot land on it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            low = int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = np.random.default_rng()
    for _ in range(200):
        port = int(rng.integers(max(1024, low - 8000), low))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def start_world(work, mesh, **env_extra):
    """The ranks of a worker world; returns (processes, log files)."""
    port = fixed_port()
    world = mesh[0] * mesh[1]
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(world), PROCESS_ID=str(rank),
                   WORK_DIR=work, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MODE="serve", MESH=f"{mesh[0]},{mesh[1]}", **env_extra)
        logs.append(open(os.path.join(
            work, f"log_{mesh[0]}x{mesh[1]}_{rank}.txt"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, cwd=ROOT,
            stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    return procs, logs


def finish_world(procs, logs, timeout=300):
    deadline = time.time() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    outs = []
    for fh in logs:
        fh.seek(0)
        outs.append(fh.read())
        fh.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} failed:\n" + "\n".join(
            f"--- rank {r}\n{x[-3000:]}" for r, x in enumerate(outs))


def compare_ids(ids, ref_ids, ref_scores):
    """(tie pairs, other differences): a differing position is a tie pair
    when the single process scored its two ids within TIE."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    ties = bad = 0
    for r, j in zip(*np.nonzero(ids != ref_ids)):
        gap = abs(float(ref_scores[r, ids[r, j]])
                  - float(ref_scores[r, ref_ids[r, j]]))
        ties, bad = (ties + 1, bad) if gap < TIE else (ties, bad + 1)
    return ties, bad


def dispatch_scores(rec, users, excl, gen_state):
    """The single process's scores of one dispatch, from the generator
    state it started from."""
    pad = rec.serve_batch - len(users)
    padded = np.concatenate([np.asarray(users, np.int64),
                             np.zeros(pad, np.int64)])
    flags = np.concatenate([np.asarray(excl, bool), np.zeros(pad, bool)])
    rows, mask = rec._rows(padded, flags)
    gen = torch.Generator().set_state(gen_state)
    _, scores = rec.trainer.eval_step(
        t_(rows), t_(padded), t_(mask),
        sampling_steps=rec.trainer.cfg.sampling_steps, top_k=rec.k_max,
        generator=gen, return_scores=True)
    return scores.numpy()


def run_plan(rec, plan, work):
    """The single process's answers to a plan: per dispatch (ids, scores),
    per reload the params version."""
    got = []
    for step in plan:
        if step[0] == "reload":
            got.append(rec.reload_params(os.path.join(work, step[1]))[
                "params_version"])
            continue
        state = rec._generator.get_state()
        ids = rec.recommend_batch(np.asarray(step[1]), np.asarray(step[2]))
        got.append((ids, dispatch_scores(rec, step[1], step[2],
                                         state)[:len(step[1])]))
    return got


def rounding_noise(name, shape):
    """The transformer's attention key bias: zero gradient in exact
    arithmetic (tests/test_torch_onehot_modes.py)."""
    mask = np.zeros(shape, bool)
    if name.endswith("qkv.bias"):
        d = shape[0] // 3
        mask[d:2 * d] = True
    return mask


def assert_params(got, want, steps, lr, tol, label, floor=None,
                  flipped=None):
    """``floor``: {name: elements at the rounding floor}, excused as the
    key bias is; ``flipped``: {name: elements whose stored moments differ},
    held to 2^-7 lr a step."""
    for name, w in want.items():
        g = got[name]
        noise = rounding_noise(name, w.shape)
        if floor is not None:
            noise = noise | floor[name]
        flip = (np.zeros(w.shape, bool) if flipped is None
                else flipped[name] & ~noise)
        keep = ~noise & ~flip
        np.testing.assert_allclose(g[keep], w[keep],
                                   err_msg=f"{label} {name}", **tol)
        assert (np.abs(g - w)[noise] <= 2 * lr * steps * 1.0001).all(), \
            (label, name)
        assert (np.abs(g - w)[flip] <= 2.0 ** -7 * lr * steps).all(), \
            (label, name, "moments rounded apart")


def assert_own_steps(t, batches, losses, got, label):
    """A mesh's steps on its own draws (its ``losses`` and ``got``: whole
    parameters, "mu.<name>" and "nu.<name>") against the single-process
    trainer ``t`` stepped from its seeded init over the same ``batches``,
    under the own-draws rule of the module docstring."""
    state = t.init_state()
    want_losses, floor, prev = [], {}, {}
    for x, i in batches:
        loss, grads, lt = t.loss_and_grads(state, t_(x),
                                           t_(np.asarray(i, np.int64)))
        for k, g in grads.items():
            floor[k] = floor.get(k, False) | (g.abs() < 1e-8).numpy()
        prev = {(w, k): m.float().numpy().copy() for w in ("mu", "nu")
                for k, m in getattr(state.opt_state, w).items()}
        state = t.apply_grads(state, grads, lt)
        want_losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=OWN_LOSS)
    want = {k: p.detach().numpy() for k, p in state.params.items()}
    flipped = {k: np.zeros(w.shape, bool) for k, w in want.items()}
    ulp = float(torch.finfo(torch.bfloat16).eps)
    for which, beta in (("mu", 0.9), ("nu", 0.999)):
        for k, m in getattr(state.opt_state, which).items():
            m = m.float().numpy()
            g = got[f"{which}.{k}"]
            bound = (ulp * (np.abs(m) + beta * np.abs(prev[(which, k)]))
                     + 1e-4 * np.abs(m) + 1e-5 * np.abs(m).max())
            assert (np.abs(g - m) <= bound).all(), (label, which, k)
            flipped[k] |= g != m
    assert_params({k: got[k] for k in want}, want, len(batches), t.cfg.lr,
                  OWN_PARAMS, label, floor, flipped)


class World:
    """The inputs, the JAX side, the worlds' results and the single
    process's answers."""

    def __init__(self, work: str):
        self.work = work
        rng = np.random.default_rng(0)
        train = (rng.random((N_USER, N_ITEM)) < 0.2).astype(np.float32)
        self.train = sp.csr_matrix(train)
        jmesh_kw = dict(mesh_dp=4, mesh_mp=2)
        jkw = dict(CFG, sampling_steps=0)
        jt = JTrainer(JConfig(**jmesh_kw, **jkw), N_USER, N_ITEM)
        jstate = jt.init_state()
        self.weights = bridged(jstate.params)
        self.jrec = JRecommender.from_state(jt, jstate, self.train,
                                            serve_batch=SERVE_BATCH,
                                            k_max=K_MAX)
        inp = {f"w.{k}": v for k, v in self.weights.items()}
        inp.update(train=train,
                   ck_x=(rng.random((16, N_ITEM)) < 0.3).astype(np.float32),
                   ck_i=rng.choice(N_USER, 16, replace=False).astype(
                       np.int64))
        self._single_checkpoint()
        self._options(inp, rng)
        meta = dict(n_user=N_USER, n_item=N_ITEM, serve_batch=SERVE_BATCH,
                    k_max=K_MAX, cfg=CFG, lgn_cfg=LGN, plan_a=PLAN_A,
                    plan_b=PLAN_B, options=OPTIONS)
        np.savez(os.path.join(work, "inputs.npz"), **inp)
        with open(os.path.join(work, "inputs.json"), "w") as fh:
            json.dump(meta, fh)
        self.inp = inp
        t0 = time.time()
        finish_world(*start_world(work, (2, 2)))
        later = [start_world(work, m) for m in MESHES[1:]]
        for w in later:
            finish_world(*w)
        self.seconds = time.time() - t0
        self.res, self.out = {}, {}
        for dp, mp in MESHES:
            self.res[(dp, mp)] = [json.load(open(os.path.join(
                work, f"serve_{dp}x{mp}_rank{r}.json")))
                for r in range(dp * mp)]
            self.out[(dp, mp)] = dict(np.load(os.path.join(
                work, f"serve_{dp}x{mp}.npz")))
        self._references()

    def _single_checkpoint(self):
        t = TTrainer(TConfig(device="cpu", **dict(CFG, random_seed=5)),
                     N_USER, N_ITEM)
        state = t.init_state()
        with torch.no_grad():
            for p in state.params.values():
                p.add_(0.01)
        state.step = 4
        Checkpointer(os.path.join(self.work, "single_ckpt")).save(state)

    def _options(self, inp, rng):
        """Each option's JAX mesh: weights, three steps with their draws,
        the eval step's ids."""
        self.jax_opt = {}
        batches = []
        for s in range(3):
            x = (rng.random((16, N_ITEM)) < 0.3).astype(np.float32)
            i = rng.choice(N_USER, 16, replace=False).astype(np.int32)
            inp[f"ox{s}"], inp[f"oi{s}"] = x, i.astype(np.int64)
            batches.append((x, i))
        ex = (rng.random((16, N_ITEM)) < 0.25).astype(np.float32)
        ei = rng.choice(N_USER, 16, replace=False).astype(np.int32)
        inp["ex"], inp["ei"] = ex, ei.astype(np.int64)
        for name, kw in OPTIONS.items():
            okw = dict(CFG, **kw)
            jt = JTrainer(JConfig(mesh_dp=4, mesh_mp=2, **okw), N_USER,
                          N_ITEM)
            jstate = jt.init_state()
            w0 = bridged(jstate.params)
            inp.update({f"o.{name}.{k}": v for k, v in w0.items()})
            key = jax.random.PRNGKey(17)
            jids = np.asarray(jt._eval_step(
                jstate.params, jnp.asarray(ex), jnp.asarray(ei),
                jnp.asarray(ex), key, sampling_steps=0, top_k=K_MAX))
            eval_draws = None
            if name == "sym":   # the flagship reads the grown graph
                eval_draws = jax_draws(key, 16, N_ITEM, okw["steps"], 0)
                for j in range(okw["steps"]):
                    inp[f"oe.{name}.sprinkle{j}"] = \
                        eval_draws.sprinkle[j].numpy()
                    inp[f"oe.{name}.gate{j}"] = eval_draws.gate[j].numpy()
            side = 16 + N_ITEM if kw.get("OneHotMatrix") == 1 else None
            losses = []
            for s, (x, i) in enumerate(batches):
                _, step_key = jax.random.split(jstate.key)
                d = jax_train_draws(jt.diffusion, jstate.lt, step_key,
                                    side or 16, side or N_ITEM,
                                    okw["backbone"])
                arrays = {"d_ts": d.ts.uniform, "d_noise": d.noise}
                if d.ts_u is not None:
                    arrays.update(d_tsu=d.ts_u.uniform,
                                  d_corrupt=d.corrupt_u)
                arrays.update({f"d_drop{j}": u
                               for j, u in enumerate(d.dropout)})
                inp.update({f"od.{name}.{s}.{k}": v.numpy()
                            for k, v in arrays.items()})
                xs, idxs = jt._put_batch(jnp.asarray(x), jnp.asarray(i))
                jstate, loss = jt._train_step(jstate, xs, idxs)
                losses.append(float(loss))
            self.jax_opt[name] = dict(
                weights=w0, ids=jids, losses=losses, eval_draws=eval_draws,
                params=bridged(jstate.params), batches=batches)

    def _references(self):
        """The single-process port's answers to the same plans."""
        def cfg(**kw):
            return TConfig(device="cpu", **dict(CFG, **kw))

        tr, w = self.train, self.weights
        ref = {}
        rec = Recommender.from_state(TTrainer(cfg(), N_USER, N_ITEM), w, tr,
                                     serve_batch=SERVE_BATCH, k_max=K_MAX)
        ref["fresh"] = run_plan(rec, PLAN_A, self.work)
        for tag in ("single_ckpt", "mesh_ckpt"):
            rec = Recommender.from_checkpoint(
                cfg(), os.path.join(self.work, tag), tr,
                serve_batch=SERVE_BATCH, k_max=K_MAX)
            ref[tag] = run_plan(rec, PLAN_B, self.work)
        rec = Recommender.from_state(
            TTrainer(cfg(sampling_steps=0), N_USER, N_ITEM), w, tr,
            serve_batch=SERVE_BATCH, k_max=K_MAX)
        ref["jax"] = run_plan(rec, PLAN_B, self.work)
        t = TTrainer(cfg(**LGN), N_USER, N_ITEM, train_csr=tr)
        ref["lgn"] = run_plan(Recommender.from_state(
            t, None, tr, serve_batch=SERVE_BATCH, k_max=K_MAX), PLAN_B,
            self.work)
        self.ref = ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("serve_mesh")))


def answers(world, mesh, tag):
    res = world.res[mesh]
    for r in res:
        for k, v in r.items():
            assert not str(v).startswith("ERROR"), (mesh, k, v)
    return res[0][tag]


def assert_plan(world, mesh, tag):
    """A mesh's answers to a plan against the single process's."""
    got, want = answers(world, mesh, tag), world.ref[tag]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, int):   # a reload: the params version
            assert g == w
            continue
        ties, bad = compare_ids(g, *w)
        assert bad == 0, (mesh, tag, g, w[0].tolist())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_recommender_from_a_state_reloads_between_dispatches(world,
                                                                  mesh):
    """From a whole state at sampling_steps 2 (the draws move the ids):
    three dispatches around two reloads, a checkpoint of one device, then
    one of (2, 2). Every rank swapped at the same point (each rank's
    params version), and every dispatch equals the single process's,
    whose generator advanced alike."""
    assert_plan(world, mesh, "fresh")
    for r in world.res[mesh]:
        assert r["fresh_version"] == 2
    np.testing.assert_allclose(
        world.out[mesh]["fresh_scores"][:len(D0[1])],
        world.ref["fresh"][0][1], **SCORES)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tag", ["single_ckpt", "mesh_ckpt"])
def test_mesh_recommender_from_a_checkpoint(world, mesh, tag):
    """``from_checkpoint`` on a mesh reads each rank's blocks of a
    checkpoint written on one device or on (2, 2)."""
    assert_plan(world, mesh, tag)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_recommender_matches_the_jax_mesh_recommender(world, mesh):
    got = answers(world, mesh, "jax")
    for step, g in zip(PLAN_B, got):
        want = world.jrec.recommend_batch(np.asarray(step[1], np.int32),
                                          np.asarray(step[2]))
        np.testing.assert_array_equal(np.asarray(g), want)
    # the first dispatch's scores against the JAX sampler's at equal
    # weights (the directed flagship ignores the grown graph)
    users = np.zeros(SERVE_BATCH, np.int32)
    users[:len(D0[1])] = D0[1]
    jt = world.jrec.trainer
    x = jnp.asarray(world.train[users].toarray(), jnp.float32)
    scores = np.asarray(jt.diffusion.p_sample(
        jt.model.apply, world.jrec.params, x, jnp.asarray(users),
        jax.random.PRNGKey(0), 0))
    excl = np.zeros(SERVE_BATCH, bool)
    excl[:len(D0[2])] = D0[2]
    scores = np.where(excl[:, None] & (np.asarray(x) > 0), -np.inf, scores)
    np.testing.assert_allclose(world.out[mesh]["jax_scores"], scores,
                               **SCORES)


def test_lightgcn_serves_on_a_mesh(world):
    """lightGCN on (1, 2): each rank propagates the whole graph at start-up
    and keeps its blocks of the frozen tables; its answers equal the
    single process's."""
    assert answers(world, (1, 2), "lgn_local_user") == [N_USER // 2, 64]
    assert_plan(world, (1, 2), "lgn")


def test_only_the_main_rank_takes_requests(world):
    """A follower's results hold no answers: it ran ``follow`` for every
    plan (its params versions still moved with the main rank's)."""
    for mesh in MESHES:
        for r in world.res[mesh][1:]:
            assert "fresh" not in r and r["fresh_version"] == 2


# ---------------------------------------------------------------------------
# the options that read across batch rows, at dp 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_steps_match_the_jax_mesh(world, name):
    """Three steps on (2, 1) at the JAX mesh's weights and draws (each
    rank its rows: under OneHotMatrix 1 of the block adjacency, for the
    transformer's attention weights the query rows)."""
    answers(world, (2, 1), "options")
    j = world.jax_opt[name]
    res = world.res[(2, 1)][0]
    np.testing.assert_allclose(res[f"{name}.jax_losses"], j["losses"],
                               rtol=JAX_STEP_LOSS)
    out = world.out[(2, 1)]
    got = {k: out[f"{name}.jax.{k}"] for k in j["params"]}
    assert_params(got, j["params"], 3, CFG["lr"], JAX_STEP_PARAMS,
                  f"{name} against JAX")


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_steps_on_own_draws_match_the_single_process(world, name):
    """Three steps on (2, 1) drawing the whole batch's randomness, against
    three single-process steps from the same seed."""
    answers(world, (2, 1), "options")
    t = TTrainer(TConfig(device="cpu", **dict(CFG, **OPTIONS[name])),
                 N_USER, N_ITEM)
    out = world.out[(2, 1)]
    got = {k[len(name) + 5:]: v for k, v in out.items()
           if k.startswith(f"{name}.own.")}
    assert_own_steps(t, world.jax_opt[name]["batches"],
                     world.res[(2, 1)][0][f"{name}.own_losses"], got,
                     f"{name} against the single process")


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_eval_step_matches_single_process_and_jax(world, name):
    """One eval step of a batch sharded over dp 2 at the JAX weights: the
    ids of the single process (tie pairs aside) and of the JAX mesh, the
    scores of the single process."""
    answers(world, (2, 1), "options")
    j = world.jax_opt[name]
    t = TTrainer(TConfig(device="cpu", **dict(CFG, **OPTIONS[name])),
                 N_USER, N_ITEM)
    t.model.load_state_dict({k: t_(v) for k, v in j["weights"].items()})
    x, i = world.inp["ex"], world.inp["ei"]
    ids, scores = t.eval_step(
        t_(x), t_(i), t_(x), sampling_steps=0, top_k=K_MAX,
        generator=torch.Generator().manual_seed(11), draws=j["eval_draws"],
        return_scores=True)
    out = world.out[(2, 1)]
    ties, bad = compare_ids(out[f"{name}.eval_ids"], ids.numpy(),
                            scores.numpy())
    assert bad == 0
    np.testing.assert_allclose(out[f"{name}.eval_scores"], scores.numpy(),
                               **SCORES)
    np.testing.assert_array_equal(out[f"{name}.eval_ids"], j["ids"])


# ---------------------------------------------------------------------------
# serve_http.main on a (1, 2) world
# ---------------------------------------------------------------------------

HTTP_CFG = dict(backbone="DNNOneHotEmbeddingGCN", dims=[16], emb_size=10,
                steps=5, batch_size=8, sampling_steps=0, device="cpu")
HEARTBEAT_TIMEOUT_S = 5


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _wait_up(base, procs, limit=120.0):
    deadline = time.time() + limit
    while time.time() < deadline:
        for p in procs:
            assert p.poll() is None, "a rank died during start-up"
        try:
            return _get(base + "/healthz")[1]
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"{base} never came up")


def _http_checkpoint(directory, seed, step, shift):
    trainer = TTrainer(TConfig(**dict(HTTP_CFG, random_seed=seed)), 40, 32)
    state = trainer.init_state()
    with torch.no_grad():
        for p in state.params.values():
            p.add_(shift)
    state.step = step
    ck = Checkpointer(directory)
    ck.save(state)
    ck.close()


def _mesh_cli(tmp_path, module, ckpt_dir, *extra):
    """The two ranks of ``module``'s ``main`` on (1, 2) serving
    ``ckpt_dir`` (rank 0 leads); returns ([(process, log)], data dir)."""
    data = tmp_path / "data"
    generate_synthetic_dataset(str(data), n_user=40, n_item=32,
                               avg_degree=6, seed=9)
    coord = fixed_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank),
                   HEARTBEAT_TIMEOUT_S=str(HEARTBEAT_TIMEOUT_S))
        log = open(tmp_path / f"{module}_rank{rank}.txt", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", f"gdmcf_torch.{module}", "--device",
             "cpu", "--mesh_dp", "1", "--mesh_mp", "2", "--serve_batch",
             "8", "--k_max", "5", f"--data_path={data}",
             "--dataset=meshhttp", "--dims=[16]", "--steps=5",
             "--sampling_steps=0", "--ckpt_dir_serve", ckpt_dir, *extra],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            text=True), log))
    return procs, data


def _http_world(tmp_path, port, ckpt_dir):
    """``serve_http.main`` on (1, 2): only rank 0 binds ``port``."""
    return _mesh_cli(tmp_path, "serve_http", ckpt_dir, "--host",
                     "127.0.0.1", "--port", str(port))


def _logs(procs):
    text = []
    for r, (_, log) in enumerate(procs):
        log.seek(0)
        text.append(f"--- rank {r}\n{log.read()[-3000:]}")
    return "\n".join(text)


def _kill(procs):
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
        log.close()


def _single(data, ckpt_dir):
    train = data_load(*(str(data / f) for f in (
        "train_list.npy", "valid_list.npy", "test_list.npy")))[0]
    return Recommender.from_checkpoint(TConfig(**HTTP_CFG), ckpt_dir, train,
                                       serve_batch=8, k_max=5)


def test_serve_http_on_a_mesh_serves_reloads_idles_and_stops(tmp_path):
    """The main rank serves what one process serves from the checkpoint;
    it outlives an idle period longer than the process group's timeout
    (its heartbeats); SIGHUP under 8 clients reloads every rank with no
    failed request (the answers after it are the new checkpoint's);
    SIGTERM stops both ranks, each exiting 0."""
    ckpt = str(tmp_path / "ckpt")
    _http_checkpoint(ckpt, 5, 1, 0.0)
    port = fixed_port()
    procs, data = _http_world(tmp_path, port, ckpt)
    base = f"http://127.0.0.1:{port}"
    users = [0, 3, 7, 11, 19, 23, 31, 39]
    qs = "/recommend?users=" + ",".join(map(str, users)) + "&k=5"
    try:
        _wait_up(base, [p for p, _ in procs])
        single = _single(data, ckpt)
        assert _get(base + qs)[1]["items"] == \
            single.recommend(users, k=5)[0].tolist()
        time.sleep(HEARTBEAT_TIMEOUT_S + 2)   # idle past the timeout
        assert all(p.poll() is None for p, _ in procs), _logs(procs)
        body = _get(base + "/healthz")[1]
        assert body["stats"]["heartbeats"] >= 2, body
        assert _get(base + qs)[1]["items"] == \
            single.recommend(users, k=5)[0].tolist()
        # a newer checkpoint in the directory, then SIGHUP under load
        _http_checkpoint(ckpt, 6, 2, 0.02)
        failures, done = [], threading.Event()

        def client(c):
            while not done.is_set():
                try:
                    _get(base + f"/recommend?users={c},{c + 8}&k=5")
                except Exception as e:   # noqa: BLE001 — counted
                    failures.append(repr(e))
        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(8)]
        for c in clients:
            c.start()
        time.sleep(0.5)
        procs[0][0].send_signal(signal.SIGHUP)
        deadline = time.time() + 60
        while _get(base + "/healthz")[1]["stats"]["params_version"] != 1:
            assert time.time() < deadline, "SIGHUP never reloaded"
            time.sleep(0.2)
        time.sleep(0.5)
        done.set()
        for c in clients:
            c.join(timeout=60)
        assert failures == []
        single.reload_params()
        assert _get(base + qs)[1]["items"] == \
            single.recommend(users, k=5)[0].tolist()
        procs[0][0].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p, _ in procs]
        assert codes == [0, 0], _logs(procs)
    finally:
        _kill(procs)


def test_a_follower_that_loses_the_main_rank_exits_nonzero(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _http_checkpoint(ckpt, 5, 1, 0.0)
    port = fixed_port()
    procs, _ = _http_world(tmp_path, port, ckpt)
    try:
        _wait_up(f"http://127.0.0.1:{port}", [p for p, _ in procs])
        procs[0][0].kill()
        code = procs[1][0].wait(timeout=HEARTBEAT_TIMEOUT_S + 60)
        assert code != 0, _logs(procs)
    finally:
        _kill(procs)


def test_the_serve_cli_on_a_mesh_prints_once(tmp_path):
    """``python -m gdmcf_torch.serve`` on (1, 2): the main rank prints one
    process's answers, the other rank follows and prints none; both exit
    0."""
    ckpt = str(tmp_path / "ckpt")
    _http_checkpoint(ckpt, 5, 1, 0.0)
    procs, data = _mesh_cli(tmp_path, "serve", ckpt, "--users", "0,3,39",
                            "--k", "5")
    try:
        codes = [p.wait(timeout=120) for p, _ in procs]
        assert codes == [0, 0], _logs(procs)
        outs = []
        for _, log in procs:
            log.seek(0)
            outs.append(log.read())
        want = _single(data, ckpt).recommend([0, 3, 39], k=5)[0]
        for u, row in zip((0, 3, 39), want):
            assert f"user {u}: top-5 -> {row.tolist()}" in outs[0], outs[0]
        assert "user 0:" not in outs[1] and "latency" not in outs[1]
    finally:
        _kill(procs)
