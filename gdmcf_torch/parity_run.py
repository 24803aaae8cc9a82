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

``--dump-scores STEM`` also writes each seed's raw final score matrix to
``STEM.s<seed>.npy`` (``final_scores``), what the tie-neutral OneHotMatrix 1
gate ranks with the unchanged ``benchmarks/oh1_neutral_eval.py``:

    python -m gdmcf_torch.parity_run --data-dir DIR --backbone DNN \\
        --OneHotMatrix 1 --lr 1e-4 --batch 400 \\
        --dump-scores /tmp/oh1/torch --out /tmp/oh1/torch.json
    python benchmarks/oh1_neutral_eval.py --data-dir DIR \\
        --ref '/tmp/oh1/ref_s*.npy' --ours '/tmp/oh1/torch.s*.npy'
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


def final_scores(trainer, train_csr, n_rows: int,
                 generator=None) -> np.ndarray:
    """The raw final score matrix of the tie-neutral OneHotMatrix 1
    protocol, as ``benchmarks/parity_run.py --dump-scores`` makes it:
    ``p_sample`` at the recipe's ``sampling_steps`` over the training rows
    0 .. (n_rows // batch) * batch in batches, with no <= 0.1 zeroing and
    no history mask; under OneHotMatrix 1 each batch's block adjacency
    (``Trainer._to_block_onehot``) is sampled and its [B, n_item]
    user-item block kept. ``generator`` (default: seeded 0 on the
    trainer's device, where the JAX side passes ``PRNGKey(0)``) makes any
    draw the sampler takes. The parameters are the trainer's model's.
    [rows, n_item] float32."""
    import torch

    from gdmcf_torch.train.trainer import matmul_precision

    cfg, dev = trainer.cfg, trainer.device
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dense = train_csr[:n_rows].astype(np.float32).toarray()
    bs = cfg.batch_size
    rows = []
    trainer.model.eval()
    with torch.inference_mode(), matmul_precision(trainer.tf32):
        for start in range(0, (n_rows // bs) * bs, bs):
            x = torch.from_numpy(dense[start:start + bs]).to(dev)
            b = x.shape[0]
            block = (trainer._to_block_onehot(x) if cfg.OneHotMatrix == 1
                     else x)
            s = trainer.diffusion.p_sample(
                trainer.model, block,
                torch.arange(start, start + b, dtype=torch.int64,
                             device=dev),
                sampling_steps=cfg.sampling_steps,
                sampling_noise=cfg.sampling_noise, generator=generator)
            if cfg.OneHotMatrix == 1:
                s = s[:b, b:]
            rows.append(s.float().cpu().numpy())
    return np.concatenate(rows, axis=0)


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
    out = {
        "seed": seed, "losses": losses,
        "evals": [{"epoch": e, **ev} for e, ev in sorted(col.evals.items())],
        "best_test": [[float(v) for v in g] for g in best] if best else None,
        # benchmarks/golden_parity.py's tail: the last quarter, rounded down
        "tail_loss": float(np.mean(losses[-max(1, len(losses) // 4):])),
        "elapsed_s": round(time.time() - t0, 1),
    }
    if opts.dump_scores:
        path = f"{opts.dump_scores}.s{seed}.npy"
        np.save(path, final_scores(trainer, train,
                                   min(n_user, opts.n_user_cap or n_user)))
        out["scores_path"] = path
    return out


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
    ap.add_argument("--dump-scores", default=None,
                    help="path stem for the final raw score matrices "
                         "(<stem>.s<seed>.npy; the tie-neutral OneHotMatrix "
                         "1 protocol)")
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
