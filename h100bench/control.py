"""The control of each check: the reference put in the program's place,
computed one precision below the configuration's, must come out not
correct.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,3

The configuration runs its float32 products as TF32 (``compute_dtype``
bfloat16), so the control computes its products in bfloat16. For a
training cell it runs the steps a run compares (the first three of epoch
0 and the first group of epoch 1) from the same weights, draws and
batches, in float32 and in bfloat16, and reads the training checks
between them, with the readings of faults planted in the reference
beside them; for an evaluation cell it ranks a sample of ``judge_users``
users drawn as a run draws them, those of the longest histories among
them, and reads ``score_gap`` of the bfloat16 ranking against the
float32 reference and ``metric_gap`` of metric means summed in bfloat16.
Prints one line a seed and the limits. The benchmark's own runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


RECIPE_DEFAULTS = {"noise_min": 0.001, "noise_max": 0.01,
                   "discrete": 0.9995, "history_num_per_term": 10}


def train_readings(cell, seed: int, device: str):
    """The training checks of the control (bfloat16 products) and of
    faults planted in the reference, each against the float32 reference,
    as a run reads them: the first three steps of epoch 0 and the first
    group of epoch 1, each from the seed's weights. Faults: half of every
    batch left out, the mean taken over the rest; and (the group only) a
    stale batch buffer, the group run on the set-up epoch's last group's
    batches."""
    from h100bench import data as D
    from h100bench import program
    from h100bench.reference import judge

    drv, conf = cell.driver, cell.config
    rc = conf["recipe"]
    hp = drv.recipe_numbers(lambda k: rc.get(k, RECIPE_DEFAULTS.get(k)))
    csr = D.graph(conf["graph"], conf["n_user"], conf["n_item"], seed)
    n_user, bs, k = conf["n_user"], hp["bs"], hp["k"]
    last = n_user // bs // k * k

    def run(epoch, lo, hi, lowp=False, rows=None):
        ref = drv.reference_steps(hp, csr, seed, drv.epoch_batches(
            seed, epoch, n_user, bs, lo, hi, rows), device, lowp)
        out = (ref.losses, ref.first_grad, ref.change(seed))
        del ref
        program.release(device)
        return out

    eager = {"sound": run(0, 0, drv.REF_STEPS),
             "control": run(0, 0, drv.REF_STEPS, lowp=True),
             "half_batch": run(0, 0, drv.REF_STEPS, rows=bs // 2)}
    group = {"sound": run(1, 0, k), "control": run(1, 0, k, lowp=True),
             "half_batch": run(1, 0, k, rows=bs // 2),
             "stale_batch": run(0, last - k, last)}
    l32, g32, c32 = eager["sound"]
    keep = judge.kept_leaves(g32)
    rl32, rg32, rc32 = group["sound"]
    keep_r = judge.kept_leaves(rg32)
    out = {}
    for name in ("control", "half_batch", "stale_batch"):
        got = {}
        if name in eager:
            losses, grads, change = eager[name]
            g_leaves = judge.leaf_gaps(grads, g32, keep)
            got.update(
                loss_gap=judge.rel_gap(losses[:1], l32[:1]),
                step_loss_gaps=[judge.rel_gap([a], [b])
                                for a, b in zip(losses, l32)],
                grad_gap=judge.median_gap(g_leaves),
                grad_leaves=g_leaves,
                change_gap=judge.leaf_gap(change, c32, keep)[0])
        losses, _, change = group[name]
        got.update(
            replay_loss_gap=judge.rel_gap(losses, rl32),
            replay_step_loss_gaps=[judge.rel_gap([a], [b])
                                   for a, b in zip(losses, rl32)],
            replay_change_gap=judge.leaf_gap(change, rc32, keep_r)[0],
            replay_change_leaves=judge.leaf_gaps(change, rc32, keep_r))
        out[name] = got
    return out


def rank_readings(conf: dict, traffic: dict, seed: int, device: str):
    """An evaluation cell's control: score_gap of the bfloat16 ranking
    against the float32 reference, on the users a run judges (drawn from
    every user of the split, whose input rows are the train split), and
    metric_gap of metric means summed in bfloat16."""
    import torch

    from h100bench import data as D
    from h100bench.reference import flagship as R
    from h100bench.reference import judge

    rc = conf["recipe"]
    n_user, n_item = conf["n_user"], conf["n_item"]
    csr = D.graph(conf["graph"], n_user, n_item, seed)
    csr, valid, _ = D.amazon_splits(csr, R.derive_seed(seed, "splits"))
    for m in (csr, valid):
        m.sum_duplicates()
        m.sort_indices()
    k = max(rc["topN"])
    users = np.arange(n_user // rc["batch_size"] * rc["batch_size"])
    history = np.diff(csr.indptr)
    longest = users[np.argsort(-history[users],
                               kind="stable")[:traffic["judge_longest"]]]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0xE7A1])
    picked = np.concatenate([longest, rng.choice(
        np.setdiff1d(users, longest),
        size=traffic["judge_users"] - longest.size, replace=False)])
    tables = R.Tables(rc["steps"], rc["noise_scale"],
                      rc.get("noise_min", 0.001), rc.get("noise_max", 0.01),
                      device)
    P = R.weights(seed, R.param_shapes(n_user, n_item, rc["dims"][-1],
                                       rc["emb_size"]), device)
    gap = 0.0
    for lo in range(0, picked.size, traffic["judge_block"]):
        blk = picked[lo:lo + traffic["judge_block"]]
        x = R.dense_rows(csr.indptr, csr.indices, blk, n_item, device)
        idx = torch.from_numpy(blk).to(device)
        with R.precision(False, device):
            ref = R.scores(P, tables, x, idx, rc["emb_size"], mask=x > 0)
        with R.precision(True, device):
            low = R.scores(P, tables, x, idx, rc["emb_size"], mask=x > 0)
        served = R.top_ids(low.float(), k).cpu().tolist()
        for j in range(blk.size):
            gap = max(gap, judge.served_gap(ref[j], served[j], k))
    return {"control": {"score_gap": gap, "metric_gap": metric_control(
        P, tables, csr, valid, users, rc, device)}}


def metric_control(P, tables, train, valid, users, rc, device) -> float:
    """metric_gap of metric means whose per-batch sums are rounded to
    bfloat16, against float64 sums, over every user's ranking (the
    bfloat16 reference's)."""
    import torch

    from h100bench.reference import flagship as R
    from h100bench.reference import judge
    from h100bench.reference import metrics as M

    bs, k = rc["batch_size"], max(rc["topN"])
    ranked = []
    for lo in range(0, users.size, bs):
        blk = users[lo:lo + bs]
        x = R.dense_rows(train.indptr, train.indices, blk, train.shape[1],
                         device)
        with R.precision(True, device):
            s = R.scores(P, tables, x, torch.from_numpy(blk).to(device),
                         rc["emb_size"], mask=x > 0)
        ranked.append(R.top_ids(s.float(), k).cpu().numpy())
    ranked = np.concatenate(ranked)
    want = M.metric_means(ranked, valid.indptr, valid.indices, users,
                          rc["topN"], block=bs)
    low = M.metric_means(ranked, valid.indptr, valid.indices, users,
                         rc["topN"], block=bs, sum_dtype=torch.bfloat16)
    return judge.means_gap(low, want)


def readings(name: str, seed: int, device: str, root: Path = None):
    from h100bench import harness as H

    cell = H.find_cell(name, H.HERE if root is None else root)
    if cell.workload["driver"] == "train":
        return train_readings(cell, seed, device)
    return rank_readings(cell.config, cell.workload["traffic"], seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import harness as H

    limits = H.find_cell(args.workload).workload["checks"]
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
