"""One rank of a gloo world for tests/test_torch_parallel_mesh.py.

Launched once per rank under the env contract of
``gdmcf_torch.parallel.multihost.initialize`` (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID), on the CPU. ``WORK_DIR`` holds ``inputs.npz``
and ``inputs.json`` written by the test; each rank writes
``rank<r>.npz`` (rank 0: the whole tensors) and ``rank<r>.json`` (checks
and small results) there. ``MODE=dead_peer`` runs the failure-detection
check instead; ``MODE=serve`` (tests/test_torch_serve_mesh.py) a mesh
``Recommender`` and, on (2, 1), the options that read across batch rows;
``MODE=option`` (tests/test_torch_parallel.py) two train steps of one such
option. ``MODE=fault`` and ``MODE=resume`` (tests/test_torch_fault.py) are
the recovery story of tests/multihost_fault_worker.py on the port's mesh
``fit``: the last rank SIGKILLs itself at the top of epoch 3, once the
epoch-2 checkpoint has committed, and the survivors must fail; then every
rank restarts, restores epoch 2, trains epochs 3-4 and prints its metrics.

Imports torch and the port only.
"""

import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from gdmcf_torch.parallel import multihost  # noqa: E402


def t_(a):
    return torch.from_numpy(np.array(a))


def load_full_state(model, full) -> None:
    """Copy whole tensors (a single-device state_dict) into a sharded
    module: this rank keeps its blocks."""
    from gdmcf_torch.parallel.sharding import local_block, shard_of

    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            src = torch.as_tensor(full[name])
            if shard_of(t) is not None:
                src = local_block(src, shard_of(t))
            t.copy_(src.to(t.device, t.dtype))


def full_state(model) -> dict:
    """{name: whole tensor} of a sharded module (collective)."""
    from gdmcf_torch.parallel.sharding import full_tensor

    return {k: full_tensor(t) for k, t in
            model.state_dict(keep_vars=True).items()}


def dead_peer():
    multihost.initialize(device="cpu")
    import torch.distributed as dist

    rank = dist.get_rank()
    dist.barrier()
    if rank == 1:
        os._exit(0)   # a peer dies mid-run
    time.sleep(0.5)
    t0 = time.perf_counter()
    try:
        for _ in range(100):
            dist.all_reduce(torch.ones(4))
        print("DEAD_PEER no error", flush=True)
    except Exception as e:   # the survivor must raise, not hang
        print(f"DEAD_PEER raised {type(e).__name__} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    os._exit(0)


FAULT_EPOCH, FAULT_EPOCHS = 3, 4


def fault_world():
    """MODE=fault / MODE=resume on the mesh MESH="dp,mp" over the splits in
    WORK_DIR/fault.npz, checkpoints in WORK_DIR/ck (``ckpt_every`` 1). Each
    rank prints EPOCH_DONE after an epoch; under fault the last rank prints
    FAULT_SELF_KILL and dies at the top of epoch 3 and the others print
    SURVIVOR_ENTERING there; under resume every rank holds what it restored
    bitwise against its blocks of the file and prints RESTORED, and
    WORKER_OK with its recall at the end. Under FAULT=stall the last rank
    stops itself instead of dying."""
    import scipy.sparse as sp
    import torch.distributed as dist

    from torch_fault_hooks import check_restores, die, hook_epochs, wait_for

    from gdmcf_torch.config import Config
    from gdmcf_torch.train.trainer import Trainer

    multihost.initialize(device="cpu")   # HEARTBEAT_TIMEOUT_S: the env's
    rank, world = dist.get_rank(), dist.get_world_size()
    mode, work = os.environ["MODE"], os.environ["WORK_DIR"]
    dp, mp = (int(v) for v in os.environ["MESH"].split(","))
    data = np.load(os.path.join(work, "fault.npz"))
    tr, va, te = (sp.csr_matrix(data[k]) for k in ("train", "valid", "test"))
    ckpt = os.path.join(work, "ck")
    cfg = Config(device="cpu", backbone="DNN", dims=[8], emb_size=10,
                 steps=5, batch_size=4 * dp, sampling_steps=0, lr=1e-3,
                 topN=[5, 10], mesh_dp=dp, mesh_mp=mp, epochs=FAULT_EPOCHS,
                 eval_every=100, ckpt_every=1, ckpt_dir=ckpt,
                 resume=mode == "resume")
    t = Trainer(cfg, *tr.shape)
    spe = (tr.shape[0] // dp) // (cfg.batch_size // dp)   # steps an epoch

    def before(epoch):
        if mode != "fault" or epoch != FAULT_EPOCH:
            return
        if rank == world - 1:
            # the epoch-2 checkpoint has committed (the main rank writes it
            # in the background)
            wait_for(os.path.join(ckpt, "periodic",
                                  f"ckpt_{(FAULT_EPOCH - 1) * spe}.pt"))
            # FAULT=stall: alive but silent, its sockets open (a hung
            # process, a host lost without a reset)
            stall = os.environ.get("FAULT") == "stall"
            die(f"FAULT_SELF_{'STOP' if stall else 'KILL'} rank={rank} "
                f"epoch={epoch} t={time.time():.3f}", stop=stall)
        print(f"SURVIVOR_ENTERING rank={rank} epoch={epoch}", flush=True)

    hook_epochs(t, spe, before, lambda epoch, loss: print(
        f"EPOCH_DONE rank={rank} epoch={epoch} loss={loss:.6f}", flush=True))
    check_restores(lambda state, path: print(
        f"RESTORED rank={rank} step={state.step} epoch={state.step // spe}",
        flush=True))

    state, _ = t.fit(tr, va, te, log=lambda *a: None)
    rows = tr.astype(np.float32).toarray()
    gt = va.astype(np.float32).toarray()
    res = t.evaluate(state, rows, gt, rows, [5, 10])
    print(f"WORKER_OK rank={rank} mode={mode} step={state.step} "
          f"recall={[round(float(v), 6) for v in res[1]]}", flush=True)
    multihost.shutdown()


def cut_train_draws(d, lo, hi, rows_lo, rows_hi, attention):
    """This rank's rows of whole-batch train draws held as arrays
    (``d_tsu``, ``d_corrupt``, ``d_ts``, ``d_noise``, ``d_drop<i>``):
    ``lo:hi`` of the batch, or ``rows_lo:rows_hi`` of a OneHotMatrix 1
    block adjacency; ``attention``: the indices of the dropout draws whose
    rows are dim 1 (the transformer's [nhead, B, B] weights)."""
    from gdmcf_torch.diffusion.engine import TimestepDraws, TrainDraws

    a, b = (rows_lo, rows_hi) if rows_lo is not None else (lo, hi)

    def rows(x):
        return None if x is None else t_(x[a:b])

    def ts(x):
        return None if x is None else TimestepDraws(rows(x), rows(x))

    drops, i = [], 0
    while f"d_drop{i}" in d:
        u = d[f"d_drop{i}"]
        drops.append(t_(u[:, a:b]) if i in attention else t_(u[a:b]))
        i += 1
    return TrainDraws(ts_u=ts(d.get("d_tsu")), corrupt_u=rows(
        d.get("d_corrupt")), ts=ts(d["d_ts"]), noise=rows(d["d_noise"]),
        dropout=tuple(drops))


def option_steps(cfg, n_user, n_item, weights, batches, draws, mesh):
    """Steps of a Trainer on this rank's dp blocks of ``batches`` [(x,
    idx)], from ``weights`` (whole tensors; None: the seeded init), with
    ``draws`` (whole-batch arrays per step; None: its own); returns
    (losses, whole parameters and AdamW moments ("mu.<name>",
    "nu.<name>"), the trainer)."""
    from gdmcf_torch.parallel.sharding import full_tensor, shard_of
    from gdmcf_torch.train.trainer import Trainer

    import torch.distributed as dist

    dp, mp = mesh
    t = Trainer(cfg, n_user, n_item)
    if weights is not None:
        load_full_state(t.model, weights)
    state = t.init_state()
    b = cfg.batch_size // dp
    d_i = dist.get_rank() // mp
    lo, hi = d_i * b, (d_i + 1) * b
    total = cfg.batch_size + n_item
    rows = total // dp
    losses = []
    for s, (x, idx) in enumerate(batches):
        d = None
        if draws is not None:
            oh1 = cfg.OneHotMatrix == 1
            att = {2 + 4 * k + 2 for k in range(8)} \
                if cfg.backbone == "DNNOneHotTransformer" else set()
            d = cut_train_draws(draws[s], lo, hi,
                                d_i * rows if oh1 else None,
                                (d_i + 1) * rows if oh1 else None, att)
        state, loss = t.train_step(state, t_(x[lo:hi]), t_(idx[lo:hi]),
                                   draws=d)
        losses.append(float(loss))
    whole = {k: full_tensor(p).detach().numpy().copy()
             for k, p in state.params.items()}
    for which in ("mu", "nu"):
        for k, m in getattr(state.opt_state, which).items():
            whole[f"{which}.{k}"] = full_tensor(
                m, shard_of(state.params[k])).float().numpy().copy()
    return losses, whole, t


def option_world():
    """MODE=option: two train steps of OPTION on its own draws; rank 0
    writes the losses and the whole parameters."""
    work = os.environ["WORK_DIR"]
    multihost.initialize(device="cpu")
    import torch.distributed as dist

    from gdmcf_torch.config import Config

    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    meta = json.load(open(os.path.join(work, "inputs.json")))
    dp, mp = meta["mesh"]
    cfg = Config(device="cpu", mesh_dp=dp, mesh_mp=mp, **meta["cfg"])
    batches = [(inp[f"x{s}"], inp[f"i{s}"]) for s in range(meta["steps"])]
    losses, params, _ = option_steps(cfg, meta["n_user"], meta["n_item"],
                                     None, batches, None, (dp, mp))
    if dist.get_rank() == 0:
        np.savez(os.path.join(work, "rank0.npz"), **params)
        with open(os.path.join(work, "rank0.json"), "w") as fh:
            json.dump({"losses": losses}, fh)
    multihost.sync_hosts()
    dist.destroy_process_group()


def serve_world():
    """MODE=serve: mesh Recommenders over the dispatch plans of the test
    (rank 0 runs each plan and stops, the others follow), the scores of
    the first dispatch, and on (2, 1) the options that read across batch
    rows. ``MESH`` is "dp,mp"; every rank writes
    ``serve_<dp>x<mp>_rank<r>.json``, rank 0 ``serve_<dp>x<mp>.npz``."""
    import scipy.sparse as sp

    work = os.environ["WORK_DIR"]
    dp, mp = (int(v) for v in os.environ["MESH"].split(","))
    multihost.initialize(device="cpu")
    import torch.distributed as dist

    from gdmcf_torch.config import Config
    from gdmcf_torch.parallel.collectives import all_gather_list
    from gdmcf_torch.serve import Recommender
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    rank = dist.get_rank()
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    meta = json.load(open(os.path.join(work, "inputs.json")))
    n_user, n_item = meta["n_user"], meta["n_item"]
    train = sp.csr_matrix(inp["train"])
    weights = {k[2:]: v for k, v in inp.items() if k.startswith("w.")}
    res, out = {}, {}
    sb, k_max = meta["serve_batch"], meta["k_max"]

    def cfg(**kw):
        return Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                      **dict(meta["cfg"], **kw))

    def run(rec, plan, tag):
        if rec.is_main:
            got = []
            for step in plan:
                if step[0] == "reload":
                    info = rec.reload_params(os.path.join(work, step[1]))
                    got.append(info["params_version"])
                else:
                    got.append(rec.recommend_batch(
                        np.asarray(step[1]), np.asarray(step[2])).tolist())
            rec.stop()
            res[tag] = got
        else:
            rec.follow()
        res[tag + "_version"] = rec.params_version

    def first_scores(rec, tag):
        """Every rank: the first dispatch's scores at the generator's first
        state, this rank's dp block gathered (as ``_dispatch`` runs it)."""
        _, users, excl = meta["plan_b"][0]
        padded = np.zeros(sb, np.int64)
        padded[:len(users)] = users
        flags = np.zeros(sb, bool)
        flags[:len(users)] = excl
        t = rec.trainer
        block = (t.row_block(sb // dp) if t._eval_shardable(sb) else None)
        lo, hi = (0, sb) if block is None else (block.lo, block.hi)
        rows, mask = rec._rows(padded[lo:hi], flags[lo:hi])
        gen = torch.Generator().manual_seed(t.cfg.random_seed + 777)
        _, scores = t.eval_step(t_(rows), t_(padded[lo:hi]), t_(mask),
                                sampling_steps=t.cfg.sampling_steps,
                                top_k=k_max, generator=gen,
                                return_scores=True, block=block)
        if block is not None:
            scores = torch.cat(all_gather_list(scores, block.group))
        out[tag + "_scores"] = scores.numpy()

    def check(name, fn):
        print(f"rank {rank}: {name}", flush=True)
        try:
            fn()
            res[name] = True
        except Exception:
            res[name] = "ERROR " + traceback.format_exc()[-2000:]
            raise

    def mesh_checkpoint():
        t = Trainer(cfg(), n_user, n_item)
        load_full_state(t.model, weights)
        state = t.init_state()
        b = t.cfg.batch_size // dp
        lo = (rank // mp) * b
        state, _ = t.train_step(state, t_(inp["ck_x"][lo:lo + b]),
                                t_(inp["ck_i"][lo:lo + b]))
        Checkpointer(os.path.join(work, "mesh_ckpt")).save(state)

    def recommenders():
        rec = Recommender.from_state(Trainer(cfg(), n_user, n_item), weights,
                                     train, serve_batch=sb, k_max=k_max)
        first_scores(rec, "fresh")
        run(rec, meta["plan_a"], "fresh")
        for tag in ("single_ckpt", "mesh_ckpt"):
            run(Recommender.from_checkpoint(
                cfg(), os.path.join(work, tag), train, serve_batch=sb,
                k_max=k_max), meta["plan_b"], tag)
        rec = Recommender.from_state(
            Trainer(cfg(sampling_steps=0), n_user, n_item), weights, train,
            serve_batch=sb, k_max=k_max)
        first_scores(rec, "jax")
        run(rec, meta["plan_b"], "jax")

    def lightgcn():
        t = Trainer(cfg(**meta["lgn_cfg"]), n_user, n_item, train_csr=train)
        res["lgn_local_user"] = list(t.model.frozen_lgn_user.shape)
        run(Recommender.from_state(t, None, train, serve_batch=sb,
                                   k_max=k_max), meta["plan_b"], "lgn")

    def options():
        batches = [(inp[f"ox{s}"], inp[f"oi{s}"]) for s in range(3)]
        for name, kw in meta["options"].items():
            ocfg = cfg(**kw)
            w = {k[len(name) + 3:]: v for k, v in inp.items()
                 if k.startswith(f"o.{name}.")}
            draws = [{k.split(".", 3)[3]: v for k, v in inp.items()
                      if k.startswith(f"od.{name}.{s}.")} for s in range(3)]
            # the eval step at the JAX weights, before any step
            t = Trainer(ocfg, n_user, n_item)
            load_full_state(t.model, w)
            x, idx = inp["ex"], inp["ei"]
            b = ocfg.batch_size // dp
            lo = (rank // mp) * b
            block = t.row_block(b)
            ev = None
            if f"oe.{name}.sprinkle0" in inp:   # the JAX sampler's draws
                from gdmcf_torch.diffusion.engine import PSampleDraws
                steps = ocfg.steps
                ev = PSampleDraws(
                    None, None,
                    [t_(inp[f"oe.{name}.sprinkle{i}"][lo:lo + b])
                     for i in range(steps)],
                    [t_(inp[f"oe.{name}.gate{i}"][lo:lo + b])
                     for i in range(steps)], [])
            gen = torch.Generator().manual_seed(11)
            ids, scores = t.eval_step(
                t_(x[lo:lo + b]), t_(idx[lo:lo + b]), t_(x[lo:lo + b]),
                sampling_steps=ocfg.sampling_steps, top_k=k_max,
                generator=gen, draws=ev, return_scores=True, block=block)
            out[f"{name}.eval_ids"] = torch.cat(
                all_gather_list(ids, block.group)).numpy()
            out[f"{name}.eval_scores"] = torch.cat(
                all_gather_list(scores, block.group)).numpy()
            for tag, wt, dr in (("jax", w, draws), ("own", None, None)):
                losses, params, _ = option_steps(ocfg, n_user, n_item, wt,
                                                 batches, dr, (dp, mp))
                res[f"{name}.{tag}_losses"] = losses
                out.update({f"{name}.{tag}.{k}": v
                            for k, v in params.items()})

    if (dp, mp) == (2, 2):
        check("mesh_checkpoint", mesh_checkpoint)
    multihost.sync_hosts()
    check("recommenders", recommenders)
    if (dp, mp) == (1, 2):
        check("lightgcn", lightgcn)
    if (dp, mp) == (2, 1):
        check("options", options)
    if rank == 0:
        np.savez(os.path.join(work, f"serve_{dp}x{mp}.npz"), **out)
    with open(os.path.join(work, f"serve_{dp}x{mp}_rank{rank}.json"),
              "w") as fh:
        json.dump(res, fh)
    multihost.sync_hosts()
    dist.destroy_process_group()


def main():
    if os.environ.get("MODE") == "dead_peer":
        return dead_peer()
    if os.environ.get("MODE") in ("fault", "resume"):
        return fault_world()
    if os.environ.get("MODE") == "option":
        return option_world()
    if os.environ.get("MODE") == "serve":
        return serve_world()
    work = os.environ["WORK_DIR"]
    multihost.initialize(device="cpu")
    import torch.distributed as dist

    from gdmcf_torch.config import Config
    from gdmcf_torch.data.loader import RowSlice
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.diffusion.engine import TimestepDraws, TrainDraws
    from gdmcf_torch.ops.topk import chunked_topk, sharded_topk
    from gdmcf_torch.parallel.embed import sharded_embedding_lookup
    from gdmcf_torch.parallel.mesh import axis_group, axis_index
    from gdmcf_torch.parallel.sharding import (describe, full_tensor,
                                               local_block, shard_of)
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    rank = dist.get_rank()
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    meta = json.load(open(os.path.join(work, "inputs.json")))
    dp, mp = meta["mesh"]
    out, res = {}, {}

    def check(name, fn):
        print(f"rank {rank}: {name}", flush=True)
        try:
            res[name] = fn()
        except Exception:
            res[name] = "ERROR " + traceback.format_exc()[-1500:]

    def weights(prefix):
        return {k[len(prefix):]: v for k, v in inp.items()
                if k.startswith(prefix)}

    b = int(meta["batch"])
    d_i = rank // mp
    lo, hi = d_i * (b // dp), (d_i + 1) * (b // dp)

    def block(a):
        return t_(a[lo:hi])

    # -- the flagship: placements, forward, one train step ---------------
    cfg = Config(device="cpu", mesh_dp=dp, mesh_mp=mp, **meta["cfg"])
    n_user, n_item = meta["n_user"], meta["n_item"]
    trainer = Trainer(cfg, n_user, n_item)
    res["placements"] = {k: describe(v) for k, v in trainer.placements.items()}
    res["local_shapes"] = {k: list(v.shape) for k, v in
                           trainer.model.state_dict().items()}
    load_full_state(trainer.model, weights("w."))
    model = trainer.model
    group_dp = axis_group(trainer.mesh, "dp")

    def forward():
        model.eval()
        with torch.no_grad():
            y, _ = model(block(inp["f_x"]), block(inp["f_t"]).long(),
                         block(inp["f_xu"]), index=block(inp["f_idx"]).long(),
                         graph=block(inp["f_xu"]))
        from gdmcf_torch.parallel.collectives import all_gather_list
        out["forward"] = torch.cat(all_gather_list(y, group_dp), 0).numpy()
        return True
    check("forward", forward)

    def step_draws():
        """This rank's rows of the JAX mesh step's draws."""
        ts = TimestepDraws(block(inp["d_ts"]), block(inp["d_ts"]))
        tsu = TimestepDraws(block(inp["d_tsu"]), block(inp["d_tsu"]))
        return TrainDraws(ts_u=tsu, corrupt_u=block(inp["d_corrupt"]),
                          ts=ts, noise=block(inp["d_noise"]),
                          dropout=(block(inp["d_drop0"]),
                                   block(inp["d_drop1"])))

    def train_step(clip, tag):
        t = trainer
        if clip:
            t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                               grad_clip_norm=clip, **meta["cfg"]),
                        n_user, n_item)
            load_full_state(t.model, weights("w."))
        state = t.init_state()
        state, loss = t.train_step(state, block(inp["s_x"]),
                                   block(inp["s_idx"]), draws=step_draws())
        res[f"{tag}_loss"] = float(loss)
        full = {k: full_tensor(p) for k, p in state.params.items()}
        for k, v in full.items():
            out[f"{tag}.{k}"] = v.detach().numpy().copy()
        out[f"{tag}.lt_history"] = state.lt.history.numpy()
        out[f"{tag}.lt_count"] = state.lt.count.numpy()
        return t, state
    check("step", lambda: bool(train_step(0.0, "step")))
    check("clip", lambda: bool(train_step(float(meta["clip"]), "clip")))

    # -- steps that draw their own randomness: the whole batch's ---------
    def own_draws():
        t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                           **meta["cfg"]), n_user, n_item)
        load_full_state(t.model, weights("w."))
        state = t.init_state()
        losses = []
        for s in range(2):
            x = inp[f"o_x{s}"]
            state, loss = t.train_step(state, block(x), block(inp["s_idx"]))
            losses.append(float(loss))
        for k, p in state.params.items():
            out[f"own.{k}"] = full_tensor(p).detach().numpy().copy()
        out["own.lt_history"] = state.lt.history.numpy()
        return losses
    check("own_draws", own_draws)

    # -- the sharded lookup: values and the table gradient ---------------
    def lookup():
        table = t_(inp["l_table"])
        ids = t_(inp["l_ids"]).long()
        w = t_(inp["l_w"])
        mesh = trainer.mesh
        shard_rows = table.shape[0] // mp
        m_i = axis_index(mesh, "mp")
        blk = table[m_i * shard_rows:(m_i + 1) * shard_rows].clone()
        blk.requires_grad_(True)
        vals = sharded_embedding_lookup(mesh, blk, ids[lo:hi])
        (vals * w[lo:hi]).sum().backward()
        from gdmcf_torch.parallel.collectives import (all_gather_list,
                                                      all_reduce)
        g = all_reduce(blk.grad, group_dp)
        out["lookup_vals"] = torch.cat(all_gather_list(vals.detach(),
                                                       group_dp)).numpy()
        out["lookup_grad"] = torch.cat(all_gather_list(
            g, axis_group(mesh, "mp"))).numpy()
        return True
    check("lookup", lookup)

    # -- sharded top-k ----------------------------------------------------
    def topk():
        scores = t_(inp["k_scores"])
        k = int(meta["k"])
        n = scores.shape[1]
        pad = (-n) % mp
        padded = torch.nn.functional.pad(scores, (0, pad),
                                         value=float("-inf"))
        vals, idx = sharded_topk(trainer.mesh, padded, k)
        idx = idx.clamp_max(n - 1)
        cv, ci = chunked_topk(scores, k)
        out["topk_idx"] = idx.numpy()
        out["topk_vals"] = vals.numpy()
        return bool(torch.equal(idx, ci)) and bool(torch.equal(vals, cv))
    check("topk_equals_chunked", topk)

    # -- host vectors travel bit-exactly ----------------------------------
    def host_vectors():
        v = inp["h_vec"][rank]
        got = multihost.allgather_host_vectors(v)
        return (got.shape == inp["h_vec"].shape
                and got.view(np.uint64).tolist()
                == inp["h_vec"].view(np.uint64).tolist())
    check("allgather_host_vectors", host_vectors)

    def row_ranges():
        n = int(meta["rows_n"])
        r = multihost.local_row_range(n, trainer.mesh)
        sl = RowSlice(NativeCSR.from_scipy(__import__("scipy.sparse").sparse
                                           .csr_matrix(inp["e_train"])), r)
        return [r.start, r.stop, len(sl)]
    check("local_row_range", row_ranges)

    # -- fit with dp-sharded evaluation, then replicated ------------------
    def fit_eval():
        import scipy.sparse as sp

        tr = sp.csr_matrix(inp["e_train"])
        va = sp.csr_matrix(inp["e_valid"])
        te = sp.csr_matrix(inp["e_test"])
        ecfg = dict(meta["cfg"], **meta["fit"])
        ckpt = os.path.join(work, "fit_ckpt")
        t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                           ckpt_dir=ckpt, **ecfg), tr.shape[0], tr.shape[1])
        lines = []
        state, best = t.fit(tr, va, te, log=lines.append)
        res["fit_lines"] = lines
        res["fit_best"] = best
        rows_ = tr.astype(np.float32).toarray()
        gt = va.astype(np.float32).toarray()
        # drop_last false: a trailing batch of 3 rows runs replicated
        nat = [NativeCSR.from_scipy(tr)]
        gt_n = NativeCSR.from_scipy(va, strict=False)
        sharded = t.evaluate(state, rows_, gt, rows_, ecfg["topN"],
                             drop_last=False)
        s_sharded = t.evaluate_streaming(state, nat, gt_n, nat,
                                         ecfg["topN"], drop_last=False)
        t.cfg.eval_replicated = True
        t._eval_cache.clear()
        replicated = t.evaluate(state, rows_, gt, rows_, ecfg["topN"],
                                drop_last=False)
        s_repl = t.evaluate_streaming(state, nat, gt_n, nat, ecfg["topN"],
                                      drop_last=False)
        res["eval"] = {"sharded": sharded, "replicated": replicated,
                       "stream_sharded": s_sharded,
                       "stream_replicated": s_repl}
        for k, v in full_state(t.model).items():
            out[f"fit.{k}"] = v.detach().numpy().copy()
        return True
    check("fit_eval", fit_eval)

    # -- checkpoints: write one on the mesh, restore the test's -----------
    def checkpoints():
        t, state = train_step(0.0, "second")
        ck = Checkpointer(os.path.join(work, "mesh_ckpt"))
        ck.save(state)
        shards = {k: shard_of(p) for k, p in state.params.items()}
        for k, p in state.params.items():
            out[f"ck.param.{k}"] = full_tensor(p).detach().numpy().copy()
            out[f"ck.mu.{k}"] = full_tensor(
                state.opt_state.mu[k], shards[k]).float().numpy().copy()
            out[f"ck.nu.{k}"] = full_tensor(
                state.opt_state.nu[k], shards[k]).float().numpy().copy()
        # the test's single-device checkpoint restores into the mesh
        state2 = t.init_state()
        Checkpointer(os.path.join(work, "single_ckpt")).restore(state2)
        import torch as _t
        data = _t.load(os.path.join(work, "single_ckpt",
                                    f"ckpt_{meta['single_step']}.pt"),
                       weights_only=True)
        ok = state2.step == meta["single_step"]
        for k, p in state2.params.items():
            want = data["params"][k]
            if shards[k] is not None:
                want = local_block(want, shards[k])
            ok = ok and _t.equal(p.detach(), want)
            want_mu = data["mu"][k]
            if shards[k] is not None:
                want_mu = local_block(want_mu, shards[k])
            ok = ok and _t.equal(state2.opt_state.mu[k], want_mu)
        ok = ok and _t.equal(state2.lt.history, data["lt_history"])
        return bool(ok)
    check("checkpoint_single_into_mesh", checkpoints)

    # -- bf16_weights: bfloat16 storage, masters sharded as their tensors
    def bf16_mesh():
        t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                           bf16_weights=tuple(meta["bf16_weights"]),
                           **meta["cfg"]), n_user, n_item)
        load_full_state(t.model, weights("w."))
        state = t.init_state()
        state, loss = t.train_step(state, block(inp["s_x"]),
                                   block(inp["s_idx"]), draws=step_draws())
        local = {}
        for k, m in state.opt_state.master.items():
            p = state.params[k]
            local[k] = [list(m.shape), list(p.shape), str(p.dtype),
                        str(m.dtype)]
            out[f"bf16.master.{k}"] = full_tensor(
                m, shard_of(p)).numpy().copy()
        for k, p in state.params.items():
            out[f"bf16.param.{k}"] = full_tensor(p).detach().float() \
                .numpy().copy()
        Checkpointer(os.path.join(work, "bf16_ckpt")).save(state)
        return {"loss": float(loss), "local": local}
    check("bf16_mesh", bf16_mesh)

    # -- DNNlightGCN: the frozen tables sharded --------------------------
    def lightgcn():
        import scipy.sparse as sp

        tr = sp.csr_matrix(inp["g_train"])
        t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                           backbone="lightGCN", **meta["lgn_cfg"]),
                    tr.shape[0], tr.shape[1], train_csr=tr)
        res["lgn_local_user"] = list(t.model.frozen_lgn_user.shape)
        for k, v in full_state(t.model).items():
            out[f"lgn.{k}"] = v.detach().numpy().copy()
        n = tr.shape[0]
        x = t_(inp["g_train"][:b].astype(np.float32))
        with torch.no_grad():
            t.model.eval()
            y, _ = t.model(x[lo:hi], torch.zeros(hi - lo, dtype=torch.long),
                           None, index=torch.arange(lo, hi))
        from gdmcf_torch.parallel.collectives import all_gather_list
        out["lgn_forward"] = torch.cat(all_gather_list(y, group_dp)).numpy()
        return n > 0
    check("lightgcn", lightgcn)

    # -- DNNCat2: the fuse sharded by its output ---------------------------
    def cat2():
        t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                           backbone="DNNCat2", **meta["cat2_cfg"]),
                    n_user, n_item)
        res["cat2_placement"] = describe(t.placements["cat_layer.weight"])
        load_full_state(t.model, weights("c2."))
        t.model.eval()
        with torch.no_grad():
            y, _ = t.model(block(inp["f_x"]), block(inp["f_t"]).long(),
                           block(inp["f_xu"]))
        from gdmcf_torch.parallel.collectives import all_gather_list
        out["cat2_forward"] = torch.cat(all_gather_list(y, group_dp)).numpy()
        return True
    check("cat2", cat2)

    # -- global_mesh: the default lays mp over the host's ranks -----------
    def mesh_api():
        from gdmcf_torch.parallel.mesh import axis_index, mesh_shape

        m = multihost.global_mesh(dp=dp, mp=mp)
        whole = multihost.global_mesh()   # no LOCAL_WORLD_SIZE: mp = world
        return [mesh_shape(m), axis_index(m, "dp"), axis_index(m, "mp"),
                mesh_shape(whole), multihost.is_main_process()]
    check("mesh_api", mesh_api)

    # -- refusals in a world ---------------------------------------------
    def refusals():
        said = {}
        try:
            Trainer(Config(device="cpu", mesh_dp=1, mesh_mp=1,
                           **meta["cfg"]), n_user, n_item)
        except ValueError as e:
            said["world"] = str(e)
        try:
            t = Trainer(Config(device="cpu", mesh_dp=dp, mesh_mp=mp,
                               **dict(meta["cfg"], batch_size=dp * 3 + 1)),
                        n_user, n_item)
            import scipy.sparse as sp
            t.train_epoch(t.init_state(), NativeCSR.from_scipy(
                sp.csr_matrix(inp["e_train"])), np.random.default_rng(0))
        except ValueError as e:
            said["dp"] = str(e)
        return said
    check("refusals", refusals)

    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    multihost.sync_hosts()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
