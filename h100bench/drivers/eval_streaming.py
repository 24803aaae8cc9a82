"""Driver ``eval_streaming``: ``Trainer.evaluate_streaming`` over every user
of a validation split, pass after pass.

Set-up builds the Trainer with the seed's weights and the splits
(``data.amazon_splits`` of the seed's graph: the model reads the train
rows, the history mask is the train rows, the ground truth the valid
split), then runs one pass, the window's own call and feed: the first
group of ``eval_batches_per_call`` batches eagerly, then the group's CUDA
graph captured and replayed. Over that pass the benchmark records each
batch's ranked ids as the metric accumulator receives them and the
pass's metric means (wrappers of ``MetricAccumulator``, gone before the
window). The window runs passes until ``--seconds`` have passed.

Once the program's memory is given back, the reference (1) computes the
metric means from the recorded ids and the ground truth in plain NumPy
and holds the program's means, as its accumulator has them before it
rounds them to 4 decimals, to them (``metric_gap``: the worst relative
gap of the 16), and (2) scores a sample of the users drawn from the
seed, the longest histories among them, and holds their ranked lists to
its ranking (``score_gap``, as the serving cells).

Metric: ``eval_users_per_s`` (the users of the window's passes over its
seconds).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class Recorder:
    """Records what one evaluation's metric accumulator receives and makes:
    the ranked ids of every ``add_packed`` call, in order, and the means
    before ``result`` rounds them (class-level wrappers of
    ``MetricAccumulator``, removed by ``close``)."""

    def __init__(self):
        from gdmcf_torch.ops.metrics import MetricAccumulator

        self.cls = MetricAccumulator
        self.orig = (MetricAccumulator.add_packed, MetricAccumulator.result)
        self.ids, self.means = [], None
        rec = self

        def add_packed(acc, gt_packed, pred_idx, n_item):
            rec.ids.append(pred_idx.detach().to("cpu", copy=True))
            return rec.orig[0](acc, gt_packed, pred_idx, n_item)

        def result(acc):
            out = rec.orig[1](acc)     # drains the pending sums first
            rec.means = acc.sums / max(acc.n_users, 1)
            return out

        MetricAccumulator.add_packed = add_packed
        MetricAccumulator.result = result

    def close(self) -> np.ndarray:
        self.cls.add_packed, self.cls.result = self.orig
        return np.concatenate([t.reshape(-1, t.shape[-1]).numpy()
                               for t in self.ids])


def run(ctx):
    from h100bench import harness as H
    from h100bench import program

    clock, traffic = ctx.clock, ctx.cell.workload["traffic"]
    with clock.phase("imports"):
        import torch

        from gdmcf_torch.data.native import NativeCSR
        from h100bench import data as D
        from h100bench import tracing as T
        from h100bench.reference import flagship as R
        from h100bench.reference import judge
        from h100bench.reference import metrics as M

    trainer, graph, cfg = program.build(ctx)
    with clock.phase("splits"):
        train, valid, _ = D.amazon_splits(
            graph, R.derive_seed(ctx.seed, "splits"))
        for m in (train, valid):
            m.sum_duplicates()
            m.sort_indices()
        train_n = NativeCSR.from_scipy(train)
        valid_n = NativeCSR.from_scipy(valid, strict=False)
    topn = list(cfg.topN)

    def one_pass():
        return trainer.evaluate_streaming(None, [train_n], valid_n,
                                          [train_n], topn)

    with clock.phase("first pass (eager group, capture, replays)"):
        probe = Recorder()
        try:
            first = one_pass()
        finally:
            ranked = probe.close()
        program.sync(trainer.device)
    setup_s = clock.total()

    users_per_pass = ranked.shape[0]
    if ctx.trace:   # the benchmark's span around its calls into the layer
        group = trainer._eval_group

        def spanned_group(*a, **k):
            with T.span("bench.eval_group"):
                return group(*a, **k)

        trainer._eval_group = spanned_group
    passes = 0
    with T.Tracer(ctx.trace) as tr:
        t0 = time.perf_counter()
        while True:
            with (T.span("bench.eval_pass") if ctx.trace
                  else contextlib.nullcontext()):
                one_pass()
            passes += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    peak = program.peak_bytes(trainer.device)
    device = trainer.device
    del trainer, train_n, valid_n
    program.release(device)

    # (1) the metrics of the recorded rankings, in plain NumPy
    users = np.arange(users_per_pass)
    want = M.metric_means(ranked, valid.indptr, valid.indices, users, topn)
    metric_gap = judge.means_gap(probe.means, want)
    # (2) a sample of the rankings against the reference's
    history = np.diff(train.indptr)[:users_per_pass]
    longest = np.argsort(-history, kind="stable")[:traffic["judge_longest"]]
    rng = np.random.default_rng([int(ctx.seed) % 2 ** 63, 0xE7A1])
    picked = np.concatenate([longest, rng.choice(
        np.setdiff1d(users, longest),
        size=traffic["judge_users"] - longest.size, replace=False)])
    conf = ctx.cell.config
    tables = R.Tables(cfg.steps, cfg.noise_scale, cfg.noise_min,
                      cfg.noise_max, device)
    gap = 0.0
    k = max(topn)
    with R.precision(False, device):
        P = R.weights(ctx.seed, R.param_shapes(
            conf["n_user"], conf["n_item"], cfg.dims[-1], cfg.emb_size),
            device)
        for lo in range(0, picked.size, traffic["judge_block"]):
            blk = picked[lo:lo + traffic["judge_block"]]
            x = R.dense_rows(train.indptr, train.indices, blk,
                             conf["n_item"], device)
            s = R.scores(P, tables, x, torch.from_numpy(blk).to(device),
                         cfg.emb_size, mask=x > 0)
            for j, u in enumerate(blk):
                gap = max(gap, judge.served_gap(s[j], ranked[u].tolist(), k))
    del P
    checks = {"metric_gap": H.Check(metric_gap, ctx.limit("metric_gap")),
              "score_gap": H.Check(gap, ctx.limit("score_gap"))}
    lines = [
        clock.line(setup_s),
        f"window: {passes} passes of {users_per_pass} users, "
        f"{window_s:.3f} s",
        f"metrics: program {first}; program means {probe.means.tolist()}; "
        f"reference means {want.tolist()}",
        f"judged {picked.size} rankings at k {k}",
    ]
    return H.DriverResult(
        e2e={"eval_users_per_s": passes * users_per_pass / window_s},
        counters={"passes": passes, "window_s": window_s,
                  "users": passes * users_per_pass},
        checks=checks, attempted=passes * users_per_pass, failed=0,
        memory_peak_bytes=peak, setup_s=setup_s, trace=tr.summary,
        lines=lines)
