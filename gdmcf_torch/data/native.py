"""Structure-only CSR with vectorized batch assembly (numpy).

Counterpart of the JAX package's ``data/native.py:NativeCSR`` for what serving
needs: ``from_scipy``, ``gather`` and ``gather_packed``. The C++ engine of
the JAX package is ported in a later slice; these are its numpy semantics.
"""

from __future__ import annotations

import numpy as np


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
