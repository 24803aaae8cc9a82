"""Structure-only CSR with vectorized batch assembly and BPR sampling
(numpy).

Counterpart of the JAX package's ``data/native.py:NativeCSR``:
``from_edge_list``, ``from_scipy``, ``gather``, ``gather_packed`` and
``sample_bpr``. The JAX
package runs these in a C++ engine (``data/_native/loader.cpp``); here they
are vectorized numpy with its semantics, and ``sample_bpr`` draws the C++
engine's triples bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# splitmix64 (the C++ engine's sampler): the stream of batch slot k starts
# at seed + _SLOT * (k + 1) and advances by _GAMMA before each draw
_SLOT = np.uint64(0x632BE59BD9B4E019)
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(s0: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The j-th (0-based) output of each stream s0, uint64 arrays; the
    arithmetic wraps modulo 2^64 as in C."""
    z = s0 + (j + np.uint64(1)) * _GAMMA
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


class NativeCSR:
    """indptr/indices only (O(nnz)); every stored cell gathers as 1."""

    binary = True

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 n_user: int, n_item: int):
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.n_user = n_user
        self.n_item = n_item

    @classmethod
    def from_edge_list(cls, edges: np.ndarray, n_user: int,
                       n_item: int) -> "NativeCSR":
        """A [nnz, 2] (uid, iid) edge list as CSR: rows by user, each row's
        items ascending, a repeated pair kept as often as it is listed (the
        C++ engine's counting sort)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        order = np.lexsort((edges[:, 1], edges[:, 0]))
        srt = edges[order]
        indptr = np.zeros(n_user + 1, dtype=np.int64)
        np.add.at(indptr[1:], srt[:, 0], 1)
        return cls(np.cumsum(indptr), srt[:, 1].astype(np.int32), n_user,
                   n_item)

    @classmethod
    def from_scipy(cls, csr, strict: bool = True) -> "NativeCSR":
        """``strict`` rejects count-valued/weighted matrices instead of
        binarizing them; ``strict=False`` keeps membership only (serving
        history masks). Explicit zeros are dropped either way."""
        csr = csr.tocsr(copy=True)
        csr.eliminate_zeros()
        csr.sort_indices()
        if strict and csr.nnz and not (csr.data == 1).all():
            raise ValueError(
                "NativeCSR is structure-only and would binarize "
                "count-valued/weighted cells; use from_scipy(..., "
                "strict=False) if membership semantics are intended")
        return cls(csr.indptr, csr.indices, csr.shape[0], csr.shape[1])

    def __len__(self) -> int:
        return self.n_user

    def _cells(self, rows: np.ndarray):
        """(batch row, item) of every stored cell of the given user rows."""
        rows = np.asarray(rows, dtype=np.int64)
        starts = self.indptr[rows]
        lens = self.indptr[rows + 1] - starts
        r = np.repeat(np.arange(len(rows)), lens)
        offs = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                      lens)
        return r, self.indices[np.repeat(starts, lens) + offs]

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Dense float32 [len(rows), n_item] batch."""
        out = np.zeros((len(rows), self.n_item), dtype=np.float32)
        r, items = self._cells(rows)
        out[r, items] = 1.0
        return out

    def gather_packed(self, rows: np.ndarray) -> np.ndarray:
        """Bit-packed uint8 [len(rows), ceil(n_item/8)], little bit order
        (the ops/bitpack wire format)."""
        out = np.zeros((len(rows), (self.n_item + 7) // 8), dtype=np.uint8)
        r, items = self._cells(rows)
        np.bitwise_or.at(out, (r, items >> 3),
                         np.left_shift(1, items & 7).astype(np.uint8))
        return out

    def sample_bpr(self, users: np.ndarray,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """(pos, neg) int32 item ids for the given users: a positive drawn
        from the user's row and a negative rejection-sampled outside it,
        the C++ engine's triples bit for bit. Each batch slot k has its own
        splitmix64 stream; its first draw picks the positive
        (``indices[lo + z % deg]``), the following ones are negative
        candidates (``z % n_item``), redrawn in rounds over the slots still
        rejected, with membership looked up in the sorted keys
        ``user * n_item + item``. A user with no items gets ``z % n_item``
        for both."""
        indptr = self.indptr
        max_deg, keys = self._bpr_index()
        if max_deg >= self.n_item:
            # no negative exists for that user: rejection would never end
            raise ValueError(
                "BPR negative sampling impossible: some user interacted "
                f"with all {self.n_item} items (no negatives exist)")
        u = np.asarray(users, dtype=np.int32).astype(np.int64)
        lo = indptr[u]
        deg = indptr[u + 1] - lo
        s0 = (np.uint64(seed)
              + _SLOT * (np.arange(len(u), dtype=np.uint64) + np.uint64(1)))
        n_item = np.uint64(self.n_item)
        z = _splitmix64(s0, np.zeros(len(u), np.uint64))
        has = deg > 0
        pos = (z % n_item).astype(np.int32)
        pos[has] = self.indices[lo[has] + (z[has] % deg[has].astype(
            np.uint64)).astype(np.int64)]
        neg = (_splitmix64(s0, np.ones(len(u), np.uint64))
               % n_item).astype(np.int32)
        todo = np.flatnonzero(has)
        draw = np.ones(len(todo), np.uint64)
        while len(todo):
            cand = (_splitmix64(s0[todo], draw) % n_item).astype(np.int64)
            key = u[todo] * self.n_item + cand
            at = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
            taken = keys[at] == key
            neg[todo[~taken]] = cand[~taken]
            todo, draw = todo[taken], draw[taken] + np.uint64(1)
        return pos, neg

    def _bpr_index(self) -> Tuple[int, np.ndarray]:
        """(the longest row, ``user * n_item + item`` of every stored cell
        sorted), built on the first call and kept."""
        index = getattr(self, "_bpr_cache", None)
        if index is None:
            deg = np.diff(self.indptr)
            rows = np.repeat(np.arange(self.n_user, dtype=np.int64), deg)
            index = self._bpr_cache = (
                int(deg.max()) if self.n_user else 0,
                np.sort(rows * self.n_item + self.indices[:len(rows)]))
        return index
