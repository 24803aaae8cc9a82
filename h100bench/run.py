"""Run one cell of the benchmark of ``gdmcf_torch`` on this machine's cards.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the cell's data and weights from ``--seed``, builds and warms the
program (set-up), measures for ``--seconds``, then checks what the timed
path produced against the plain reference (``h100bench/reference``).
Earlier lines say what set-up was made of and what the run saw; the last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
also the last lines of standard error.

Exits non-zero, with no result, without enough CUDA devices, and when a
module of JAX or of the JAX package is loaded at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = None):
    """Set up, measure and check one cell; returns the result dict (also
    what tests call, on ``device="cpu"``, past the look for a card)."""
    from h100bench import harness as H

    clock = H.SetupClock()
    root = H.HERE if root is None else root
    cell = H.find_cell(name, root)
    ctx = H.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                    device=device, clock=clock, root=root)
    res = cell.driver.run(ctx)
    for line in res.lines:
        print(line, flush=True)
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 0}
    else:
        dev = dict(H.card(), count=cell.chips)
    return H.result_line(ctx, res, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # a library the port uses must not bring JAX in by itself
    os.environ.setdefault("USE_FLAX", "0")
    from h100bench import harness as H

    chips = H.find_cell(args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {H.power_line()}", flush=True)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = H.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
