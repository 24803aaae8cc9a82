"""The numbers that decide ``correct``: how far the program's outputs lie
from the reference's, each a single number held to a limit.

- ``served_gap``: for a ranked list the program served, the widest gap by
  which the reference's score of the id served at a position lies below
  the reference's own score at that position (the served list against the
  reference's ranking, with history items at -inf). A list with an id
  repeated, out of range, of the wrong length or in the history reads inf.
- ``rel_gap``: a step's loss against the reference's, relative.
- ``leaf_gap``: per-leaf norms (a gradient's, a parameter change's) by the
  worst leaf: the gap between the program's norm and the reference's, over
  the larger of the reference's norm of that leaf and of the median leaf.
  ``kept_leaves`` leaves out the leaves whose reference gradient is nought
  to rounding (under a thousandth of the median leaf's): AdamW moves them
  by round-off alone. ``median_gap``: the median leaf's gap, where the
  worst leaf is one whose gradient is a sum of cancelling products.
- ``means_gap``: metric means against the reference's, relative, the
  worst of them.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch


def served_gap(ref_row: torch.Tensor, ids: Sequence[int], k: int) -> float:
    n = ref_row.numel()
    if (len(ids) != k or len(set(ids)) != k
            or any(not 0 <= int(i) < n for i in ids)):
        return math.inf
    # positions past the items outside the history have nothing to hold
    # the list to
    m = min(k, int(torch.isfinite(ref_row).sum()))
    best = torch.sort(ref_row, descending=True)[0][:m]
    got = ref_row[torch.as_tensor(list(ids)[:m], device=ref_row.device)]
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((best - got).max().clamp_min(0.0)) if m else 0.0


def rel_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) < len(ref):
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(abs(r), 1e-30))
    return worst


def kept_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= share * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's gap (inf where the program has no finite norm)."""
    keep = list(keep)
    med = float(np.median([ref[k] for k in keep]))
    return {k: (abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                if k in prog and math.isfinite(prog[k]) else math.inf)
            for k in keep}


def median_gap(gaps: Dict[str, float]) -> float:
    """The median leaf's gap (inf when any leaf has none)."""
    vals = list(gaps.values())
    return math.inf if not all(map(math.isfinite, vals)) else \
        float(np.median(vals))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Iterable[str]) -> Tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    gaps = leaf_gaps(prog, ref, keep)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def means_gap(prog, ref) -> float:
    if prog is None:
        return math.inf
    p = np.asarray(prog, np.float64).ravel()
    r = np.asarray(ref, np.float64).ravel()
    if p.shape != r.shape or not np.isfinite(p).all():
        return math.inf
    return float((np.abs(p - r) / np.maximum(np.abs(r), 1e-12)).max())
