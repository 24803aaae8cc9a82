"""Plain NumPy ranking metrics of the recipe's evaluation protocol, for
judging the program's evaluation: Precision, Recall, NDCG and MRR at each
cutoff, means over every evaluated user.

The protocol's rules, as the recipe states them: a user with no ground
truth adds 0 to every numerator and still counts in the denominator; IDCG
at k runs over min(k, |ground truth|) positions; NDCG is added only where
IDCG is not 0; MRR is the reciprocal rank of the first hit within k.

``metric_means`` sums in float64. ``sum_dtype`` rounds each block of
``block`` users' sums to another type first (the control's bfloat16).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def user_metrics(ranked: np.ndarray, gt_indptr: np.ndarray,
                 gt_indices: np.ndarray, users: np.ndarray,
                 topn: Sequence[int]) -> np.ndarray:
    """[n, 4, len(topn)] per-user precision, recall, NDCG and MRR."""
    n, kmax = len(users), max(topn)
    hits = np.zeros((n, kmax), np.float64)
    counts = np.zeros(n, np.float64)
    for j, u in enumerate(users):
        gt = gt_indices[gt_indptr[u]:gt_indptr[u + 1]]
        counts[j] = np.unique(gt).size
        hits[j] = np.isin(ranked[j, :kmax], gt)
    disc = 1.0 / np.log2(np.arange(kmax) + 2.0)
    cum = np.cumsum(disc)
    valid = counts > 0
    out = np.zeros((n, 4, len(topn)))
    for c, k in enumerate(topn):
        hk = hits[:, :k]
        h = hk.sum(axis=1)
        idcg_len = np.minimum(counts, k).astype(np.int64)
        idcg = np.where(idcg_len > 0, cum[np.maximum(idcg_len - 1, 0)], 0.0)
        dcg = (hk * disc[:k]).sum(axis=1)
        first = np.argmax(hk > 0, axis=1)
        out[:, 0, c] = np.where(valid, h / k, 0.0)
        out[:, 1, c] = np.where(valid, h / np.maximum(counts, 1.0), 0.0)
        out[:, 2, c] = np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)
        out[:, 3, c] = np.where(hk.any(axis=1), 1.0 / (first + 1.0), 0.0)
    return out


def metric_means(ranked: np.ndarray, gt_indptr: np.ndarray,
                 gt_indices: np.ndarray, users: np.ndarray,
                 topn: Sequence[int], block: int = 400,
                 sum_dtype=None) -> np.ndarray:
    """[4, len(topn)] means over ``users``."""
    per_user = user_metrics(ranked, gt_indptr, gt_indices, users, topn)
    total = np.zeros(per_user.shape[1:])
    for lo in range(0, len(users), block):
        part = per_user[lo:lo + block].sum(axis=0)
        if sum_dtype is not None:
            import torch

            part = torch.from_numpy(part).to(sum_dtype).double().numpy()
        total += part
    return total / max(len(users), 1)
