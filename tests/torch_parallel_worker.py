"""One rank of a gloo world for tests/test_torch_parallel_mesh.py.

Launched once per rank under the env contract of
``gdmcf_torch.parallel.multihost.initialize`` (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID), on the CPU. ``WORK_DIR`` holds ``inputs.npz``
and ``inputs.json`` written by the test; each rank writes
``rank<r>.npz`` (rank 0: the whole tensors) and ``rank<r>.json`` (checks
and small results) there. ``MODE=dead_peer`` runs the failure-detection
check instead.

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


def main():
    if os.environ.get("MODE") == "dead_peer":
        return dead_peer()
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
