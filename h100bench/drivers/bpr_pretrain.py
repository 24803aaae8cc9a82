"""Driver ``bpr_pretrain``: LightGCN BPR pretraining, closed loop, whole
steps.

Set-up draws the graph from the seed, builds the port's stepping
pretrainer (``gdmcf_torch.models.lightgcn.BPRPretrainer``: the operand's
host build, its row operands on the device, the table
``initial_table(seed)`` and K1's state), saves its start, runs
``warmup_steps`` steps (the SpMM's and K1's first builds among them),
then puts the table, the moments, K1's count and the host generator back
to that start. The warm-up's triples are checked against the graph.

The window runs ``pretrainer.steps(chunk_steps)`` until ``--seconds``
have passed, fetching each chunk's loss sum after the next chunk is
queued, so the card is never left waiting for the fetch; it ends after
the last fetch. Its first ``ref_steps`` steps, from the seed's start,
are the ones checked: the first moment after step 1 and the table after
step ``ref_steps`` are copied behind them into host buffers pinned in
set-up (no device memory added, no pinning inside the window). After the
window the program is let go and the plain reference
(``reference/lightgcn.py``) runs those steps on the program's own
triples, at full size on the card, from the start table it draws from
the seed itself (``initial_table``), so that a program that starts
elsewhere fails the gaps:

- ``loss_gap``: the first step's loss, relative;
- ``grad_gap``: the first gradient, the program's first moment over
  (1 - b1), against the reference's, a relative norm over the whole table;
- ``change_gap``: the table after ``ref_steps`` steps less the
  reference's start, against the reference's change, a relative norm over
  the whole table;
- ``triples_valid``: triples of the warm-up and of the checked steps with
  a positive outside the user's row or a negative inside it.

Metrics: ``train_examples_per_s`` (the window's triples over its
seconds). Counters for the per-layer metrics: the window's steps and
triples, its seconds, ``spmm_rows`` launches by direction (the port's
``ops.spmm.LAUNCHES``), each direction's least bytes a launch
(``costs_lightgcn``), the table's elements.
"""

from __future__ import annotations

import math
import time


def _host_buffer(t, device):
    """A host tensor like ``t``, pinned for the card's copies behind the
    stream (pinning 300 MB takes a while, so set-up does it)."""
    import torch

    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=device.type == "cuda")


def rel_norm(a, b) -> float:
    """||a - b|| / ||b|| in float64, inf when a holds a non-finite value."""
    import torch

    a, b = a.double(), b.double()
    if not bool(torch.isfinite(a).all()):
        return math.inf
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def reference_steps(csr, table, batches, recipe: dict, device,
                    lowp: bool = False):
    """The reference after one step on each [3, B] batch of triples, from
    ``table``."""
    from h100bench.reference import lightgcn as R

    ref = R.Pretrainer(csr, table, recipe["n_layers"], recipe["lr"],
                       recipe["decay"], device, lowp=lowp)
    for b in batches:
        ref.step(b)
    return ref


def run(ctx):
    from h100bench import harness as H
    from h100bench import program

    clock = ctx.clock
    with clock.phase("imports"):
        import torch

        # first, so that a program without the stepping pretrainer stops
        # here, before the graph is drawn
        from gdmcf_torch.models.lightgcn import BPRPretrainer
        from gdmcf_torch.ops import fused_adamw as FA
        from gdmcf_torch.ops import spmm as S
        from gdmcf_torch.train.trainer import matmul_precision
        from h100bench import costs_lightgcn as C
        from h100bench import data as D
        from h100bench import tracing as T
        from h100bench.reference import lightgcn as R

    conf, traffic = ctx.cell.config, ctx.cell.workload["traffic"]
    rc = conf["recipe"]
    warmup, chunk = traffic["warmup_steps"], traffic["chunk_steps"]
    n_ref = traffic["ref_steps"]
    with clock.phase("data"):
        csr = D.graph(conf["graph"], conf["n_user"], conf["n_item"],
                      ctx.seed)
    with clock.phase("pretrainer (operand build, the port's own init)"):
        pt = BPRPretrainer(
            csr, n_layers=rc["n_layers"], latent_dim=rc["latent_dim"],
            batch_size=rc["batch_size"], lr=rc["lr"], decay=rc["decay"],
            seed=ctx.seed, sparse=rc["sparse"], block_size=rc["block_size"],
            block_rows=rc["block_rows"], device=ctx.device,
            keep_batches=max(warmup, n_ref))
        start = pt.state()
        program.sync(pt.device)
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

    S.reset_launch_counts()
    FA.reset_launch_counts()
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
    launches = dict(S.LAUNCHES)
    k1 = FA.LAUNCHES["fused_adamw"]
    d = rc["latent_dim"]
    counts = {k: C.operand_counts(op) for k, op in
              zip(("spmm_rows_fwd", "spmm_rows_t"), pt.operands() or ())}
    prog_losses = [float(x) for x in first_losses.cpu()]
    grad1 = grad1.float() / (1 - 0.9)
    table = table.float()
    elements = pt.e0.numel()
    del pt, first, rest, pending, queued, first_losses
    program.release(device)

    counters = {"steps": steps, "triples": steps * rc["batch_size"],
                "window_s": window_s, "params": elements,
                "k1_launches": k1,
                **{f"{k}_launches": launches[k] for k in counts},
                **{f"{k}_bytes": C.spmm_bytes(c, d)
                   for k, c in counts.items()}}

    ref_start = R.initial_table(ctx.seed, conf["n_user"] + conf["n_item"],
                                rc["latent_dim"])
    start_gap = rel_norm(torch.from_numpy(start.e0),
                         torch.from_numpy(ref_start))
    ref = reference_steps(csr, ref_start, checked, rc, device)
    ref_losses = [float(x) for x in ref.losses]
    ref_grad = ref.first_grad.cpu()
    e_start = torch.from_numpy(ref_start)
    change = rel_norm(table - e_start, ref.e0.cpu() - e_start)
    del ref
    program.release(device)
    bad_triples += R.invalid_triples(csr, checked)

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
    }
    lines = [
        clock.line(setup_s),
        f"window: {steps} steps of {rc['batch_size']} triples, "
        f"{window_s:.3f} s; spmm_rows launches {launches}, K1 {k1}; "
        f"operands {counts}",
        f"start tables: program's against the reference's {start_gap:.3e}",
        f"checked steps: program losses {prog_losses}, reference "
        f"{ref_losses}, gaps "
        + ", ".join(f"{gap(a, b):.3e}"
                    for a, b in zip(prog_losses, ref_losses)),
    ]
    return H.DriverResult(
        e2e={"train_examples_per_s": steps * rc["batch_size"] / window_s},
        counters=counters, checks=checks, attempted=steps, failed=bad,
        memory_peak_bytes=peak, setup_s=setup_s, trace=tr.summary,
        lines=lines)
