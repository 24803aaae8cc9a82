"""Time each direction of ``spmm_rows`` alone at the ``lightgcn1m-pretrain``
operand, on the card.

Draws the cell's graph (``h100bench.data.graph``: power law, 1M users x 200k
items, 20M edges) from ``--seed``, builds N's row operands as
``BPRPretrainer`` does (``normalized_operand(csr, "hybrid", 128, 8)``) and
times each direction with CUDA events: ``--launches`` launches after 5
warm-ups, ``--repeats`` times, on a random [n_x, 64] float32 x. Beside each
time: the first launch on the host clock (the schedule's host build
included), the least bytes of ``h100bench/costs_lightgcn.spmm_bytes`` and
their time at 3.35 TB/s, the operand's counts, ``LAUNCHES`` and, where the
package has it, ``SLABBED``, and whether two launches are bitwise equal.
``--plain`` also times ``spmm_rows_reference`` on the card. ``--shares``
times the transpose again at each slab share of the L2 (``ops.spmm.
SLAB_L2_SHARE``, set for the run). Works on any checkout of the package;
``--graph-cache`` keeps the drawn graph in an ``.npz`` so that several
processes draw it once.

    python3 benchmarks/spmm_directions.py --seed 2003 --plain \\
        --shares 0.3333,0.5,0.6667,0.8333 --out spmm_directions.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2003)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--shares", default="")
    ap.add_argument("--graph-cache", default="")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import numpy as np
    import scipy.sparse as sp
    import torch

    from gdmcf_torch.models.lightgcn import normalized_operand
    from gdmcf_torch.ops import spmm as S
    from h100bench import costs_lightgcn as C
    from h100bench import data as D
    from h100bench.costs import HBM_BYTES_PER_S

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the times are the card's")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    res = {"label": args.label, "card": card, "torch": torch.__version__,
           "l2_bytes": torch.cuda.get_device_properties(dev).L2_cache_size,
           "seed": args.seed}
    t0 = time.perf_counter()
    if args.graph_cache and os.path.exists(args.graph_cache):
        csr = sp.load_npz(args.graph_cache).tocsr()
    else:
        csr = D.graph({"kind": "power_law", "n_edges": 20_000_000},
                      1_000_000, 200_000, args.seed)
        if args.graph_cache:
            sp.save_npz(args.graph_cache, csr, compressed=False)
    res["graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd, t = (op.to(dev) for op in normalized_operand(csr, "hybrid", 128, 8))
    torch.cuda.synchronize()
    res["operand_s"] = time.perf_counter() - t0

    def timed(fn, warm=5, n=args.launches):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    slabbed = getattr(S, "SLABBED", None)
    for name, op, n_x in (("spmm_rows_fwd", fwd, t.n_out),
                          ("spmm_rows_t", t, fwd.n_out)):
        x = torch.rand((n_x, 64), generator=gen, device=dev) - 0.5
        S.reset_launch_counts()
        t0 = time.perf_counter()
        y = S.spmm_rows(op, x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        again = S.spmm_rows(op, x)
        torch.cuda.synchronize()
        r = {"first_launch_s": first_s, "bitwise": bool(torch.equal(y, again)),
             "ms": [timed(lambda: S.spmm_rows(op, x))
                    for _ in range(args.repeats)],
             "launches": dict(S.LAUNCHES),
             "slabbed": dict(slabbed) if slabbed is not None else None,
             "n_slab": getattr(op, "n_slab", 1)}
        counts = C.operand_counts(op)
        r["counts"] = counts
        r["least_bytes"] = C.spmm_bytes(counts, 64)
        r["least_ms"] = r["least_bytes"] / HBM_BYTES_PER_S * 1e3
        if args.plain:
            r["plain_ms"] = timed(lambda: S.spmm_rows_reference(op, x), 1, 3)
            r["plain_gap"] = float((y - S.spmm_rows_reference(op, x)).norm()
                                   / y.norm())
        res[name] = r
        print(name, json.dumps(r), flush=True)
        if name == "spmm_rows_t" and args.shares and hasattr(
                S, "SLAB_L2_SHARE"):
            keep = S.SLAB_L2_SHARE
            sweep = []
            for share in (float(v) for v in args.shares.split(",")):
                S.SLAB_L2_SHARE = share
                t0 = time.perf_counter()
                S.spmm_rows(op, x)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                sweep.append({"share": share, "n_slab": op.n_slab,
                              "n_seg": op.n_seg, "build_s": build_s,
                              "ms": [timed(lambda: S.spmm_rows(op, x))
                                     for _ in range(args.repeats)]})
                print("share", json.dumps(sweep[-1]), flush=True)
            S.SLAB_L2_SHARE = keep
            S.spmm_rows(op, x)
            res["sweep"] = sweep
        del x, y, again
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
