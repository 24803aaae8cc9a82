"""Driver ``sgl_pretrain``: SGL-ED pretraining, closed loop, whole steps.

Set-up draws the graph from the seed, builds the port's stepping
pretrainer with SGL's views (``gdmcf_torch.models.lightgcn.BPRPretrainer``
with ``ssl_reg > 0``: N's operands, the two views drawn from the host
generator and their operands, the table ``initial_table(seed)`` and K1's
state), saves its start (the views with it), runs ``warmup_steps`` steps
(the SpMM's, cuBLAS's and K1's first launches among them), then puts the
table, the moments, K1's count, the generator and the views back to that
start. The views' draw and build time is its own set-up phase. The
warm-up's triples are checked against the graph.

The window runs ``pretrainer.steps(chunk_steps)`` until ``--seconds``
have passed, fetching each chunk's loss sum after the next chunk is
queued; it ends after the last fetch. A view redraw comes once an epoch,
``nnz // batch`` steps, so none falls in the window. Its first
``ref_steps`` steps, from the seed's start, are the ones checked: the
first moment after step 1 and the table after step ``ref_steps`` are
copied behind them into host buffers pinned in set-up. After the window
the program is let go and the plain reference (``reference/sgl.py``) runs
those steps on the program's own triples and views, at full size on the
card, from the start table it draws from the seed itself:

- ``loss_gap``: the first step's total loss (BPR, L2 and InfoNCE),
  relative;
- ``grad_gap``: the first gradient, the program's first moment over
  (1 - b1), against the reference's autograd gradient, a relative norm
  over the whole table;
- ``change_gap``: the table after ``ref_steps`` steps less the
  reference's start, against the reference's change, a relative norm over
  the whole table;
- ``triples_valid``: triples of the warm-up and of the checked steps with
  a positive outside the user's row or a negative inside it;
- ``views_valid``: views whose kept edges are not ``floor((1 - ratio) *
  nnz)`` distinct interactions of the graph, plus one if the two views
  are the same.

Metrics: ``train_examples_per_s`` (the window's triples over its
seconds). Counters for the per-layer metrics: the window's steps, its
seconds, the table's elements, the batch and the width, K1's launches,
the InfoNCE's least flops a step (``costs_sgl``) and chunks, and for each
of the six operands (N, view 1, view 2; forward and transpose) its
``spmm_rows`` launches and slabbed launches in the window, its nonzeros
and its least bytes a launch (``costs_lightgcn``); one view's draw and
build seconds.
"""

from __future__ import annotations

import math
import time

OPERANDS = ("n", "view1", "view2")


def reference_steps(csr, views, table, batches, recipe: dict, device,
                    lowp: bool = False):
    """The reference after one step on each [3, B] batch of triples, from
    ``table``, on the views ``views``."""
    from h100bench.reference import sgl as RS

    ref = RS.Pretrainer(csr, views, table, recipe["n_layers"], recipe["lr"],
                        recipe["decay"], recipe["ssl_reg"],
                        recipe["ssl_temp"], device, lowp=lowp)
    for b in batches:
        ref.step(b)
    return ref


def operand_counters(pairs, d: int) -> dict:
    """Launches, slabbed launches, nonzeros and least bytes a launch of
    each operand of the (name, (forward, transpose)) pairs."""
    from h100bench import costs_lightgcn as C

    out = {}
    for name, ops in pairs:
        for direction, op in zip(("fwd", "t"), ops):
            k = f"spmm.{name}_{direction}"
            out[f"{k}.launches"] = op.launches
            out[f"{k}.slabbed"] = op.slabbed
            out[f"{k}.nnz"] = op.nnz
            out[f"{k}.bytes"] = C.spmm_bytes(C.operand_counts(op), d)
    return out


def run(ctx):
    from h100bench import harness as H
    from h100bench import program

    clock = ctx.clock
    with clock.phase("imports"):
        import torch

        # first, so that a program without SGL's views stops here, before
        # the graph is drawn
        from gdmcf_torch.models import sgl as _  # noqa: F401
        from gdmcf_torch.models.lightgcn import BPRPretrainer
        from gdmcf_torch.ops import fused_adamw as FA
        from gdmcf_torch.train.trainer import matmul_precision
        from h100bench import costs_sgl as CS
        from h100bench import data as D
        from h100bench import tracing as T
        from h100bench.drivers.bpr_pretrain import _host_buffer, rel_norm
        from h100bench.reference import lightgcn as R
        from h100bench.reference import sgl as RS

    conf, traffic = ctx.cell.config, ctx.cell.workload["traffic"]
    rc = conf["recipe"]
    warmup, chunk = traffic["warmup_steps"], traffic["chunk_steps"]
    n_ref = traffic["ref_steps"]
    with clock.phase("data"):
        csr = D.graph(conf["graph"], conf["n_user"], conf["n_item"],
                      ctx.seed)
    build = "pretrainer (N's operand build, the port's own init)"
    with clock.phase(build):
        pt = BPRPretrainer(
            csr, n_layers=rc["n_layers"], latent_dim=rc["latent_dim"],
            batch_size=rc["batch_size"], lr=rc["lr"], decay=rc["decay"],
            seed=ctx.seed, sparse=rc["sparse"], block_size=rc["block_size"],
            block_rows=rc["block_rows"], device=ctx.device,
            keep_batches=max(warmup, n_ref), ssl_reg=rc["ssl_reg"],
            ssl_ratio=rc["ssl_ratio"], ssl_temp=rc["ssl_temp"])
        start = pt.state()
        program.sync(pt.device)
    # the views' draws and builds ran inside the pretrainer's construction
    views_s = sum(pt.sgl.seconds)
    clock.phases[build] -= views_s
    clock.phases["views (two draws and operand builds)"] = views_s
    device = pt.device
    with matmul_precision(tf32=False):   # as pretrain runs its steps
        with clock.phase(f"warm-up ({warmup} steps)"):
            pt.loss_total(pt.steps(warmup))
            warm = pt.recent(warmup)
        with clock.phase("state back to the seed's start"):
            pt.restore(start)
            grad1 = _host_buffer(pt.e0, device)
            table = _host_buffer(pt.e0, device)
            program.sync(device)
    with clock.phase("warm-up triples checked"):
        bad_triples = R.invalid_triples(csr, warm)
    del warm
    setup_s = clock.total()

    pairs = list(zip(OPERANDS, (pt.operands(), *pt.sgl.operands())))
    for _, ops in pairs:
        for op in ops:
            op.launches = op.slabbed = 0
    FA.reset_launch_counts()
    chunks0 = pt.sgl.counts["infonce_chunks"]
    bad = 0
    with matmul_precision(tf32=False), T.Tracer(ctx.trace) as tr:
        t0 = time.perf_counter()
        first = pt.steps(1)
        grad1.copy_(pt.opt_state.mu["e0"], non_blocking=True)
        rest = pt.steps(n_ref - 1)
        table.copy_(pt.e0.detach(), non_blocking=True)
        checked = pt.recent(n_ref)
        pending = torch.cat([first, rest])
        first_losses = pending.clone()
        while True:
            queued = pt.steps(chunk)
            total = pt.loss_total(pending)
            if not math.isfinite(total):
                bad += int((~torch.isfinite(pending)).sum())
            pending = queued
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        total = pt.loss_total(pending)
        if not math.isfinite(total):
            bad += int((~torch.isfinite(pending)).sum())
        window_s = time.perf_counter() - t0
    steps = pt.n_steps
    peak = program.peak_bytes(device)
    d, b = rc["latent_dim"], rc["batch_size"]
    counters = {
        "steps": steps, "triples": steps * b, "window_s": window_s,
        "params": pt.e0.numel(), "dim": d, "batch": b,
        "k1_launches": FA.LAUNCHES["fused_adamw"],
        "infonce_flops_per_step": CS.infonce_flops(
            b, d, conf["n_user"], conf["n_item"]),
        "infonce_chunks_per_step": (pt.sgl.counts["infonce_chunks"] - chunks0)
        / max(steps, 1),
        "view_build_s": views_s / max(len(pt.sgl.seconds), 1),
        **operand_counters(pairs, d)}
    views = pt.views()
    kept = [len(k) for k in views]
    prog_losses = [float(x) for x in first_losses.cpu()]
    grad1 = grad1.float() / (1 - 0.9)
    table = table.float()
    del pt, pairs, first, rest, pending, queued, first_losses
    program.release(device)

    ref_start = R.initial_table(ctx.seed, conf["n_user"] + conf["n_item"],
                                d)
    start_gap = rel_norm(torch.from_numpy(start.e0),
                         torch.from_numpy(ref_start))
    del start
    ref = reference_steps(csr, views, ref_start, checked, rc, device)
    ref_losses = list(ref.losses)
    ref_grad = ref.first_grad.cpu()
    e_start = torch.from_numpy(ref_start)
    change = rel_norm(table - e_start, ref.e0.cpu() - e_start)
    del ref
    program.release(device)
    bad_triples += R.invalid_triples(csr, checked)
    bad_views = RS.invalid_views(csr, views, rc["ssl_ratio"])

    def gap(a, b):
        return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) \
            else math.inf

    checks = {
        "loss_gap": H.Check(gap(prog_losses[0], ref_losses[0]),
                            ctx.limit("loss_gap")),
        "grad_gap": H.Check(rel_norm(grad1, ref_grad),
                            ctx.limit("grad_gap")),
        "change_gap": H.Check(change, ctx.limit("change_gap")),
        "triples_valid": H.Check(float(bad_triples),
                                 ctx.limit("triples_valid")),
        "views_valid": H.Check(float(bad_views), ctx.limit("views_valid")),
    }
    launches = {k: v for k, v in counters.items()
                if k.endswith((".launches", ".slabbed"))}
    lines = [
        clock.line(setup_s),
        f"window: {steps} steps of {b} triples, {window_s:.3f} s; "
        f"spmm_rows {launches}; K1 {counters['k1_launches']}; InfoNCE "
        f"chunks a step {counters['infonce_chunks_per_step']}",
        f"views: kept {kept} of {csr.nnz}; one view's draw and build "
        f"{counters['view_build_s']:.3f} s; peak {peak} B",
        f"start tables: program's against the reference's {start_gap:.3e}",
        f"checked steps: program losses {prog_losses}, reference "
        f"{ref_losses}, gaps "
        + ", ".join(f"{gap(a, b):.3e}"
                    for a, b in zip(prog_losses, ref_losses)),
    ]
    return H.DriverResult(
        e2e={"train_examples_per_s": steps * b / window_s},
        counters=counters, checks=checks, attempted=steps, failed=bad,
        memory_peak_bytes=peak, setup_s=setup_s, trace=tr.summary,
        lines=lines)
