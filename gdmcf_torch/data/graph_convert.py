"""Graph format converters (the port's copy of the JAX package's
``data/graph_convert.py``, numpy only): vectorized forms of the
reference's per-edge Python loops.

    adjacency_to_edge      the reference's data_utils.py:48-63
    edge_to_adjacency      data_utils.py:65-111
    pred_to_adjacency      data_utils.py:113-161
    adjacency_to_one_hot   main.py:36-68
    one_hot_to_adjacency   main.py:71-106
    top-k binarizers       data_utils.py:11-45

Edge lists are host utilities (their length varies); no training or
serving path builds them: the compute path reads the dense binary rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def adjacency_to_edge(x: np.ndarray, index: np.ndarray,
                      a: int = 5949) -> np.ndarray:
    """Dense [B, n_item] adjacency -> [2, nnz] COO edge list of global ids:
    row k is user ``index[k]``, items are offset by ``a`` (the reference
    hardcodes a = 5949, the Yelp user count)."""
    rows, cols = np.nonzero(np.asarray(x))
    return np.stack([np.asarray(index)[rows], a + cols])


def edge_to_adjacency(edge: np.ndarray, index: np.ndarray, a: int = 5949,
                      b: int = 2810, bs: int = 400) -> np.ndarray:
    """[2, E] global edge list -> dense [bs, b] batch adjacency."""
    x = np.zeros((bs, b), dtype=np.float32)
    rindex = np.zeros(a, dtype=np.int64)
    rindex[np.asarray(index)] = np.arange(len(index))
    u = rindex[np.asarray(edge[0])]
    i = np.asarray(edge[1]) - a
    x[u, i] = 1.0
    return x


def pred_to_adjacency(edge: np.ndarray, index: np.ndarray, a: int = 5949,
                      b: int = 2810, bs: int = 400,
                      pred: Optional[np.ndarray] = None) -> np.ndarray:
    """``edge_to_adjacency`` of the edges whose link prediction is 1."""
    if pred is None:
        # np.asarray(None) == 1 is a 0-d False mask: the call would return
        # an all-zero adjacency instead of filtering
        raise ValueError("pred_to_adjacency requires the per-edge link "
                         "predictions (pred)")
    x = np.zeros((bs, b), dtype=np.float32)
    rindex = np.zeros(a, dtype=np.int64)
    rindex[np.asarray(index)] = np.arange(len(index))
    keep = np.asarray(pred) == 1
    u = rindex[np.asarray(edge[0])[keep]]
    i = np.asarray(edge[1])[keep] - a
    x[u, i] = 1.0
    return x


def adjacency_to_one_hot(a: int, b: int, x: np.ndarray) -> np.ndarray:
    """[a, b] adjacency -> [a + b, a + b] block matrix (OneHotMatrix 1):
    only the upper-right block is filled (the reference's symmetric write
    is commented out)."""
    y = np.zeros((a + b, a + b), dtype=np.float32)
    y[:a, a:] = np.asarray(x)
    return y


def one_hot_to_adjacency(a: int, b: int, y: np.ndarray) -> np.ndarray:
    """[a + b, a + b] block matrix -> [a, b] adjacency (values kept)."""
    return np.asarray(y)[:a, a:a + b].copy()


def top_k_indices(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest entries of the flattened array, largest
    first."""
    flat = np.asarray(x).ravel()
    if k <= 0:
        # idx[-0:] is the whole array: k = 0 selects nothing
        return np.empty(0, dtype=np.int64)
    idx = np.argpartition(flat, -k)[-k:]
    return idx[np.argsort(-flat[idx])]


def set_top_k_to_one(x: np.ndarray, k: int = 25000) -> np.ndarray:
    """The global top-k cells -> 1, the rest 0."""
    out = np.zeros_like(np.asarray(x), dtype=np.float32)
    out.ravel()[top_k_indices(x, k)] = 1.0
    return out


def topk_set(x: np.ndarray, k: int = 25000) -> np.ndarray:
    """Each row's top-k cells -> 1, the rest 0."""
    x = np.asarray(x)
    out = np.zeros_like(x, dtype=np.float32)
    if k <= 0:   # [:, -0:] is the whole row
        return out
    idx = np.argpartition(x, -k, axis=1)[:, -k:]
    np.put_along_axis(out, idx, 1.0, axis=1)
    return out
