"""Driver ``train``: the recipe's training job, closed loop, whole epochs.

Set-up builds one Trainer and train state with the seed's weights and
step generator, and runs the first epoch through ``Trainer.train_epoch``,
the window's own call and feed: its first group of K steps runs eagerly,
then the group's CUDA graph is captured and replayed for the rest. Then
it puts the same state back to the seed's start, in place (``restart``:
the tensors the graph holds stay the same). The window runs shuffled
epochs on that state until ``--seconds`` have passed, so it spans epoch
boundaries as ``fit`` does; its first group, the first K steps from the
seed's start on epoch 1's batches, is a replay of the captured graph.

What is compared, with the reference run once the window has closed and
the program's memory is given back:

- The set-up epoch's first three (eager) steps, recorded through
  wrappers set on the Trainer instance and gone before the capture:
  ``loss_gap`` (the first step's loss), ``grad_gap`` (the first gradient
  as the optimizer got it, from the first moment after step 1; the median
  leaf's: the worst leaves are the 1-, 10- and 100-element ones, whose
  gradients sum a batch's cancelling products and move by 1e-3 under TF32
  alone) and ``change_gap`` (the parameters' change after the three, the
  worst leaf).
- The window's first group, a replay (``ReplayProbe``): its K losses
  (``replay_loss_gap``, the worst step) and the parameters' change after
  it (``replay_change_gap``, the worst leaf), against the reference's K
  steps from the seed's weights on the same batches.

Every step's gap is printed. Metrics: ``train_examples_per_s`` (every
example of the window's epochs over the window's seconds). Counters for
the per-layer metrics: steps, the window's seconds, the flops of a step
and the AdamW elements.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

REF_STEPS = 3


class FirstSteps:
    """Records the first ``REF_STEPS`` steps of ``trainer`` (instance
    wrappers of ``loss_and_grads`` and ``_update``, removed after them)."""

    def __init__(self, trainer, seed: int):
        from h100bench.reference import flagship as R

        self.R = R
        self.trainer, self.seed = trainer, seed
        self.losses, self.first_grad, self.change = [], {}, {}
        self._updates = 0
        self._lag = trainer.loss_and_grads
        self._upd = trainer._update
        trainer.loss_and_grads = self.loss_and_grads
        trainer._update = self.update

    def loss_and_grads(self, *a, **k):
        out = self._lag(*a, **k)
        self.losses.append(out[0].detach().clone())
        return out

    def update(self, state, grads, new_lt, lr):
        self._upd(state, grads, new_lt, lr)
        self._updates += 1
        if self._updates == 1:
            self.first_grad = {k: self.R.first_grad_norm(m)
                               for k, m in state.opt_state.mu.items()}
        if self._updates == REF_STEPS:
            self.change = {k: float(v) for k, v in
                           change_norms(state.params, self.seed).items()}
            del self.trainer.loss_and_grads, self.trainer._update
            self.trainer = self._lag = self._upd = None
            self.losses = [float(x) for x in self.losses[:REF_STEPS]]


def change_norms(params, seed: int):
    """Leaf norms (0-d device tensors) of the parameters' change since the
    weights of ``seed``, each start drawn again leaf by leaf."""
    import torch

    from h100bench.reference import flagship as R

    out = {}
    with torch.no_grad():
        for k, p in params.items():
            start = R.fill_leaf(torch.empty(p.shape, device=p.device),
                                seed, k)
            out[k] = torch.linalg.vector_norm(p.detach().float() - start)
            del start
    return out


class ReplayProbe:
    """Records the next fused group of ``trainer`` (an instance wrapper of
    ``_train_group``, removed at that call): its losses, how many CUDA-graph
    replays it ran, and the leaf norms of the parameters' change since the
    seed's weights after it. The norms stay on the device, queued behind
    the group, until ``read``."""

    def __init__(self, trainer, seed: int):
        self.trainer, self.seed = trainer, seed
        self.inner = vars(trainer).get("_train_group")
        self.losses, self.change, self.replays = None, {}, 0
        self.events = None
        trainer._train_group = self

    def __call__(self, state, batches):
        import torch

        tr = self.trainer
        if self.inner is None:
            del tr._train_group
        else:
            tr._train_group = self.inner
        graphs = tr.graphs() if tr.device.type == "cuda" else None
        before = graphs.replays() if graphs else 0
        state, losses = tr._train_group(state, batches)
        self.replays = graphs.replays() - before if graphs else 0
        self.losses = losses.detach().clone()
        if graphs:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        self.change = change_norms(state.params, self.seed)
        if graphs:
            ev[1].record()
            self.events = ev
        self.trainer = self.inner = None
        return state, losses

    def read(self):
        """(the losses, the change's leaf norms, the device milliseconds
        the norms took or None), as floats; lets go of the Trainer."""
        self.trainer = self.inner = None
        if self.losses is None:
            return [], {}, None
        ms = self.events[0].elapsed_time(self.events[1]) if self.events \
            else None
        return ([float(x) for x in self.losses.cpu()],
                {k: float(v) for k, v in self.change.items()}, ms)


def restart(state, seed: int, draw_seed: int) -> None:
    """The train state back to the seed's start, in place, so that the
    tensors a captured graph reads and writes stay the same: the weights
    drawn again, the moments, K1's step count and the importance sampler's
    ring zeroed, the step generator seeded again, the host's step 0."""
    import torch

    from h100bench.reference import flagship as R

    opt = state.opt_state
    if opt.master:
        raise RuntimeError("restart has no float32 masters to draw")
    with torch.no_grad():
        for k, p in state.params.items():
            R.fill_leaf(p.data, seed, k)
        for t in (*opt.mu.values(), *opt.nu.values(), opt.count,
                  state.lt.history, state.lt.count):
            t.zero_()
    state.generator.manual_seed(draw_seed)
    state.step = 0


def epoch_batches(seed: int, epoch: int, n_user: int, bs: int, lo: int,
                  hi: int, rows: int = None):
    """The user ids of batches ``lo`` to ``hi`` of epoch ``epoch``'s
    shuffled order (``rows``: the first rows of each only)."""
    from h100bench import program

    order = np.arange(n_user)
    program.epoch_rng(seed, epoch).shuffle(order)
    return [order[j * bs:j * bs + (rows or bs)] for j in range(lo, hi)]


def reference_steps(hp: dict, csr, seed: int, batches, device,
                    lowp: bool = False):
    """The reference after one step on each batch of user ids, from the
    weights of ``seed`` and a generator seeded as the program's step
    generator; ``hp``: the recipe's numbers (``recipe_numbers``)."""
    import torch

    from h100bench.reference import flagship as R

    n_item = csr.shape[1]
    ref = R.TrainReference(
        R.weights(seed, R.param_shapes(csr.shape[0], n_item, hp["dim"],
                                       hp["emb_size"]), device),
        R.Tables(hp["steps"], hp["noise_scale"], hp["noise_min"],
                 hp["noise_max"], device),
        torch.Generator(device).manual_seed(R.derive_seed(seed,
                                                          "train draws")),
        emb_size=hp["emb_size"], lr=hp["lr"], discrete=hp["discrete"],
        history=hp["history"], moment_dtype=getattr(torch, hp["moments"]))
    for users in batches:
        ref.step(R.dense_rows(csr.indptr, csr.indices, users, n_item,
                              device),
                 torch.from_numpy(users).to(device), lowp=lowp)
    return ref


def recipe_numbers(get) -> dict:
    """The numbers the reference takes from the recipe; ``get(key)`` reads
    the configuration's (the port's defaults included)."""
    return {"dim": get("dims")[-1], "emb_size": get("emb_size"),
            "steps": get("steps"), "noise_scale": get("noise_scale"),
            "noise_min": get("noise_min"), "noise_max": get("noise_max"),
            "lr": get("lr"), "discrete": get("discrete"),
            "history": get("history_num_per_term"),
            "moments": get("opt_moment_dtype"), "bs": get("batch_size"),
            "k": get("train_steps_per_call")}


def run(ctx):
    from h100bench import harness as H
    from h100bench import program

    clock = ctx.clock
    with clock.phase("imports"):
        from gdmcf_torch.data.native import NativeCSR
        from h100bench import costs
        from h100bench import tracing as T
        from h100bench.reference import flagship as R
        from h100bench.reference import judge

    trainer, csr, cfg = program.build(ctx)
    conf = ctx.cell.config
    hp = recipe_numbers(lambda k: getattr(cfg, k))
    shapes = R.param_shapes(conf["n_user"], conf["n_item"], hp["dim"],
                            hp["emb_size"])
    draw_seed = R.derive_seed(ctx.seed, "train draws")
    with clock.phase("train state"):
        data = NativeCSR.from_scipy(csr)
        state = trainer.init_state()
        state.generator.manual_seed(draw_seed)
    probe = FirstSteps(trainer, ctx.seed)
    with clock.phase("first epoch (eager group, capture, replays)"):
        state, _ = trainer.train_epoch(state, data,
                                       program.epoch_rng(ctx.seed, 0))
    with clock.phase("state back to the seed's start"):
        restart(state, ctx.seed, draw_seed)
        program.sync(trainer.device)
    setup_s = clock.total()

    bs = cfg.batch_size
    steps_per_epoch = len(data) // bs
    if ctx.trace:   # the benchmark's spans around its calls into the layer
        group = trainer._train_group

        def spanned_group(*a, **k):
            with T.span("bench.train_group"):
                return group(*a, **k)

        trainer._train_group = spanned_group
    replay = ReplayProbe(trainer, ctx.seed)
    epochs = bad = 0
    with T.Tracer(ctx.trace) as tr:
        t0 = time.perf_counter()
        while True:
            with (T.span("bench.epoch") if ctx.trace
                  else contextlib.nullcontext()):
                state, total = trainer.train_epoch(
                    state, data, program.epoch_rng(ctx.seed, epochs + 1))
            epochs += 1
            bad += 0 if math.isfinite(total) else 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    peak = program.peak_bytes(trainer.device)
    replay_losses, replay_change, probe_ms = replay.read()
    device = trainer.device
    del trainer, state, data
    program.release(device)

    steps = epochs * steps_per_epoch
    counters = {
        "steps": steps, "window_s": window_s, "params": R.n_params(shapes),
        "flops_per_step": costs.flagship_matmul_flops(
            hp["dim"], hp["emb_size"], conf["n_item"], bs,
            gcn_layers=cfg.gcnLayerNum)}

    # the reference: the set-up epoch's first three steps, then the
    # window's first group, each from the seed's weights on its batches
    n_user = conf["n_user"]
    ref = reference_steps(hp, csr, ctx.seed, epoch_batches(
        ctx.seed, 0, n_user, bs, 0, REF_STEPS), device)
    keep = judge.kept_leaves(ref.first_grad)
    ref_losses, ref_change = ref.losses, ref.change(ctx.seed)
    g_leaves = judge.leaf_gaps(probe.first_grad, ref.first_grad, keep)
    c_leaves = judge.leaf_gaps(probe.change, ref_change, keep)
    change_gap, change_leaf = judge.leaf_gap(probe.change, ref_change, keep)
    del ref
    program.release(device)
    ref = reference_steps(hp, csr, ctx.seed, epoch_batches(
        ctx.seed, 1, n_user, bs, 0, hp["k"]), device)
    keep_r = judge.kept_leaves(ref.first_grad)
    replay_ref_losses, replay_ref_change = ref.losses, ref.change(ctx.seed)
    del ref
    r_leaves = judge.leaf_gaps(replay_change, replay_ref_change, keep_r)
    r_gap, r_leaf = judge.leaf_gap(replay_change, replay_ref_change, keep_r)
    losses = [float(x) for x in probe.losses]
    checks = {
        "loss_gap": H.Check(judge.rel_gap(losses[:1], ref_losses[:1]),
                            ctx.limit("loss_gap")),
        "grad_gap": H.Check(judge.median_gap(g_leaves),
                            ctx.limit("grad_gap")),
        "change_gap": H.Check(change_gap, ctx.limit("change_gap")),
        "replay_loss_gap": H.Check(
            judge.rel_gap(replay_losses, replay_ref_losses),
            ctx.limit("replay_loss_gap")),
        "replay_change_gap": H.Check(r_gap, ctx.limit("replay_change_gap")),
    }

    def gaps(prog, want):
        return ", ".join(f"{judge.rel_gap([a], [b]):.3e}"
                         for a, b in zip(prog, want))

    lines = [
        clock.line(setup_s),
        f"window: {epochs} epochs, {steps} steps, {window_s:.3f} s",
        f"first steps (eager): program losses {losses}, reference "
        f"{ref_losses}, gaps {gaps(losses, ref_losses)}; worst change "
        f"leaf {change_leaf}; leaves compared {len(keep)} of {len(shapes)}",
        "leaf gaps (first gradient, change): " + "; ".join(
            f"{k} {g_leaves[k]:.3e} {c_leaves[k]:.3e}" for k in keep),
        f"window's first group: {replay.replays} graph replays, losses "
        f"{replay_losses}, reference {replay_ref_losses}, gaps "
        f"{gaps(replay_losses, replay_ref_losses)}; worst change leaf "
        f"{r_leaf}; the change's norms took {probe_ms} device ms of the "
        "window",
        "leaf gaps (change after the group): " + "; ".join(
            f"{k} {r_leaves[k]:.3e}" for k in keep_r),
    ]
    return H.DriverResult(
        e2e={"train_examples_per_s": steps * bs / window_s},
        counters=counters, checks=checks, attempted=steps,
        failed=bad * steps_per_epoch, memory_peak_bytes=peak,
        setup_s=setup_s, trace=tr.summary, lines=lines)
