"""Seeded interaction graphs, copied from the repository's bring-up script.

Copies, not imports, so that the yardstick stays as it is when those
scripts change:

- ``power_law_graph``: ``chip_smoke.py:477``, with its module constants
  (``chip_smoke.py:350``) as arguments.
- ``amazon_splits``: ``chip_smoke.py:1329``.

``graph(spec, seed)`` picks one by a configuration's ``graph`` entry.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def power_law_graph(seed: int, n_user: int, n_item: int, n_edges: int):
    """Seeded power-law user x item graph, vectorized: user degrees are
    10 + a Pareto tail (mean ~20, as in a 10-core dataset); item ids are in
    popularity order with weight (id + 1)^-0.8."""
    rng = np.random.default_rng(seed)
    deg = 10 + np.floor(rng.pareto(1.6, n_user) * 6.0).astype(np.int64)
    deg = np.minimum(deg, 2_000)
    deg = np.maximum(np.round(deg * (n_edges / deg.sum())), 1).astype(np.int64)
    users = np.repeat(np.arange(n_user, dtype=np.int64), deg)
    cdf = np.cumsum((np.arange(n_item) + 1.0) ** -0.8)
    items = np.searchsorted(cdf, rng.random(len(users)) * cdf[-1])
    items = np.minimum(items, n_item - 1)
    keys = np.unique(users * n_item + items)
    return sp.csr_matrix((np.ones(len(keys), np.float32),
                          (keys // n_item, keys % n_item)),
                         shape=(n_user, n_item))


def amazon_splits(csr, seed: int = 2):
    """The graph's edges split 80/10/10 into train/valid/test, seeded."""
    coo = csr.tocoo()
    r = np.random.default_rng(seed).random(coo.nnz)
    parts = []
    for lo, hi in ((0.0, 0.8), (0.8, 0.9), (0.9, 1.0)):
        keep = (r >= lo) & (r < hi)
        parts.append(sp.csr_matrix(
            (np.ones(int(keep.sum()), np.float32),
             (coo.row[keep], coo.col[keep])), shape=csr.shape))
    return parts


def graph(spec: dict, n_user: int, n_item: int, seed: int):
    """The training graph of a configuration's ``graph`` entry, drawn from
    ``seed``: a canonical CSR with sorted indices and unit values."""
    if spec["kind"] == "power_law":
        m = power_law_graph(seed, n_user, n_item, spec["n_edges"])
    else:
        raise ValueError(f"unknown graph kind {spec['kind']!r}")
    m.sum_duplicates()
    m.sort_indices()
    return m
