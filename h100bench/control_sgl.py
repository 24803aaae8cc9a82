"""The control of the SGL-ED pretraining cell: the plain reference with its
tables and the InfoNCE's operands rounded to bfloat16 before each product
(one precision below the configuration's float32), against the float32
reference, must come out not correct.

    python3 h100bench/control_sgl.py --workload sgl1m-pretrain \
        --seeds 1,2,3

From the seed's graph, the seed's start table (``reference.lightgcn.
initial_table``) and two views drawn plainly (``reference.sgl.
draw_views``), both run ``ref_steps`` steps on the same triples
(``reference.lightgcn.draw_triples``), and the cell's checks are read
between them as a run reads them between the program and the reference.
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


def readings(cell, seed: int, device: str) -> dict:
    """{"control": the cell's checks of the bfloat16 reference against
    the float32 one}."""
    import torch

    from h100bench import data as D
    from h100bench import program
    from h100bench.drivers.bpr_pretrain import rel_norm
    from h100bench.reference import lightgcn as R
    from h100bench.reference import sgl as RS

    drv, conf = cell.driver, cell.config
    rc, n_ref = conf["recipe"], cell.workload["traffic"]["ref_steps"]
    csr = D.graph(conf["graph"], conf["n_user"], conf["n_item"], seed)
    table = R.initial_table(seed, conf["n_user"] + conf["n_item"],
                            rc["latent_dim"])
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5C1])
    views = RS.draw_views(csr.nnz, rc["ssl_ratio"], rng)
    batches = [R.draw_triples(csr, rc["batch_size"], rng)
               for _ in range(n_ref)]
    out = {}
    for name, lowp in (("sound", False), ("control", True)):
        ref = drv.reference_steps(csr, views, table, batches, rc, device,
                                  lowp)
        out[name] = (ref.losses, ref.first_grad.cpu(), ref.e0.cpu())
        del ref
        program.release(device)
    losses, grad, e0 = out["sound"]
    l_lo, g_lo, e_lo = out["control"]
    start = torch.from_numpy(table)
    return {"control": {
        "loss_gap": abs(l_lo[0] - losses[0]) / abs(losses[0]),
        "grad_gap": rel_norm(g_lo, grad),
        "change_gap": rel_norm(e_lo - start, e0 - start),
        "triples_valid": float(R.invalid_triples(csr, np.stack(batches))),
        "views_valid": float(RS.invalid_views(csr, views,
                                              rc["ssl_ratio"])),
        "step_loss_gaps": [abs(a - b) / abs(b) for a, b in zip(l_lo,
                                                               losses)]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import harness as H

    cell = H.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "limits": cell.workload["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
