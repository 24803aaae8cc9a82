"""The port's side of the golden-parity protocol: seeds of ``Trainer.fit``
on one dataset, written in the JSON shape ``benchmarks/golden_parity.py``
judges (per-epoch train losses, valid/test metrics every 5 epochs, the best
epoch's test results).

The counterpart of the JAX package's ``benchmarks/parity_run.py``, with its
flags and defaults (the flagship recipe's golden gate) plus ``--device``:

    python -m gdmcf_torch.parity_run --device cpu --data-dir DIR \\
        --backbone DNN --OneHotMatrix 0 --lr 1e-4 --batch 400 \\
        --epochs 150 --seeds 6 7 8 --out runs.json

DIR holds ``{train,valid,test}_list.npy``
(``data.loader.generate_synthetic_dataset`` writes them).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


class Collector:
    """metric_logger for ``Trainer.fit``: the losses and the evaluations."""

    def __init__(self):
        self.losses = []
        self.evals = {}

    def metrics(self, epoch, **kw):
        if "train_loss" in kw:
            self.losses.append(round(float(kw["train_loss"]), 6))

    def eval_results(self, epoch, split, topn, results):
        self.evals.setdefault(epoch, {})[split] = [
            [float(v) for v in group] for group in results]


def run_seed(opts, seed: int) -> dict:
    from gdmcf_torch.config import Config
    from gdmcf_torch.data.loader import data_load_dir
    from gdmcf_torch.train.trainer import Trainer

    train, valid, test, n_user, n_item = data_load_dir(opts.data_dir)
    cfg = Config(
        backbone=opts.backbone, dims=list(opts.dims), emb_size=10,
        lr=opts.lr, weight_decay=0.0, batch_size=opts.batch,
        steps=opts.steps, noise_schedule="linear-var",
        noise_scale=opts.noise_scale, noise_min=0.001, noise_max=0.01,
        sampling_steps=opts.sampling_steps, mean_type=opts.mean_type,
        reweight=bool(opts.reweight), OneHotMatrix=opts.OneHotMatrix,
        epochs=opts.epochs, eval_every=5, diffusion_variant=opts.variant,
        n_user_cap=opts.n_user_cap, fidelity=bool(opts.fidelity),
        random_seed=seed, debug=True, train_steps_per_call=1,
        device=opts.device)
    trainer = Trainer(cfg, min(n_user, opts.n_user_cap or n_user), n_item)
    col = Collector()
    t0 = time.time()
    _state, best = trainer.fit(train, valid, test, log=lambda *a: None,
                               metric_logger=col)
    losses = col.losses
    return {
        "seed": seed, "losses": losses,
        "evals": [{"epoch": e, **ev} for e, ev in sorted(col.evals.items())],
        "best_test": [[float(v) for v in g] for g in best] if best else None,
        # benchmarks/golden_parity.py's tail: the last quarter, rounded down
        "tail_loss": float(np.mean(losses[-max(1, len(losses) // 4):])),
        "elapsed_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backbone", default="DNNOneHotEmbedding")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--dims", type=int, nargs="+", default=[1000])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--noise-scale", type=float, default=0.01)
    ap.add_argument("--sampling-steps", type=int, default=0)
    ap.add_argument("--mean-type", choices=["x0", "eps"], default="x0",
                    dest="mean_type")
    ap.add_argument("--reweight", type=int, default=1)
    ap.add_argument("--n-user-cap", type=int, default=3000)
    ap.add_argument("--fidelity", type=int, default=1)
    ap.add_argument("--OneHotMatrix", type=int, default=2)
    ap.add_argument("--variant", default="discrete",
                    choices=["discrete", "legacy", "ablation"])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)

    runs = [run_seed(opts, s) for s in opts.seeds]
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump({"config": vars(opts), "runs": runs}, fh)
    for r in runs:
        print(json.dumps({"seed": r["seed"], "tail_loss": r["tail_loss"],
                          "best_test": r["best_test"],
                          "elapsed_s": r["elapsed_s"]}))


if __name__ == "__main__":
    main()
