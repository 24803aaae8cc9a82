"""Edge-list ``.npy`` triples -> scipy CSR user x item matrices, and the
epoch's batches (the port's copy of the JAX package's ``data/loader.py``:
``data_load``, ``data_load_dir``, ``DiffusionDataset``, ``epoch_stop`` and
``epoch_batches``)."""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from gdmcf_torch.ops.bitpack import is_binary, pack_rows


def data_load(train_path: str, valid_path: str, test_path: str):
    """-> (train_csr, valid_csr, test_csr, n_user, n_item).

    n_user/n_item come from the max ids in the *train* list; valid/test ids
    outside that range are rejected.
    """
    def as_edges(path, name):
        a = np.asarray(np.load(path, allow_pickle=True), dtype=np.int64)
        if a.size == 0:
            return a.reshape(0, 2)
        if a.ndim != 2 or a.shape[1] != 2:
            raise ValueError(f"{name} list must be [nnz, 2] (uid, iid) "
                             f"pairs, got shape {a.shape}")
        return a

    train_list = as_edges(train_path, "train")
    valid_list = as_edges(valid_path, "valid")
    test_list = as_edges(test_path, "test")
    if len(train_list) == 0:
        raise ValueError("train list is empty — cannot infer n_user/n_item")

    n_user = int(train_list[:, 0].max()) + 1
    n_item = int(train_list[:, 1].max()) + 1
    for name, arr in (("valid", valid_list), ("test", test_list)):
        if len(arr) and (arr[:, 0].max() >= n_user
                         or arr[:, 1].max() >= n_item):
            raise ValueError(
                f"{name} list contains ids outside the train-inferred "
                f"({n_user}, {n_item}) grid")

    def to_csr(lst):
        return sp.csr_matrix(
            (np.ones(len(lst), dtype=np.float64), (lst[:, 0], lst[:, 1])),
            shape=(n_user, n_item))

    return (to_csr(train_list), to_csr(valid_list), to_csr(test_list),
            n_user, n_item)


def data_load_dir(data_path: str):
    """:func:`data_load` over ``{train,valid,test}_list.npy`` in a directory."""
    return data_load(os.path.join(data_path, "train_list.npy"),
                     os.path.join(data_path, "valid_list.npy"),
                     os.path.join(data_path, "test_list.npy"))


class DiffusionDataset:
    """Dense float32 rows of a CSR interaction matrix; row i is user i.
    At catalog sizes where the dense rows do not fit the host (Amazon-Book
    would take 41 GB), ``data.native.NativeCSR`` serves the same
    ``gather``/``gather_packed`` interface from the sparse structure."""

    def __init__(self, csr: sp.spmatrix, n_rows: Optional[int] = None):
        if n_rows is not None:
            csr = csr[:n_rows]
        # cast before densifying: a float64 dense would double the peak
        self.rows = np.ascontiguousarray(csr.astype(np.float32).toarray())
        # count cells > 1 (duplicate pairs) or weights cannot be packed
        self.binary = is_binary(self.rows)

    def __len__(self) -> int:
        return self.rows.shape[0]

    def gather(self, idx: np.ndarray) -> np.ndarray:
        return self.rows[idx]

    def gather_packed(self, idx: np.ndarray) -> np.ndarray:
        """Bit-packed batch (``ops/bitpack`` wire format); binary rows."""
        return pack_rows(self.rows[idx])


def epoch_stop(n: int, batch_size: int, drop_last: bool) -> int:
    """Rows an epoch iterates: ``drop_last`` trims to full batches, except
    that a dataset smaller than one batch gives its one partial batch (the
    reference would train on nothing)."""
    stop = (n // batch_size) * batch_size if drop_last else n
    if stop == 0 and n > 0:
        stop = n
    return stop


def epoch_batches(dataset, batch_size: int,
                  rng: Optional[np.random.Generator] = None,
                  shuffle: bool = True, drop_last: bool = True,
                  packed: bool = False
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (x [B, n_item] float32, index [B] int32) batches; the index is
    the row position, the user id. ``packed`` (binary datasets only) ships
    x as the bit-packed uint8 wire format."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        if rng is None:
            rng = np.random.default_rng()
        rng.shuffle(order)
    stop = epoch_stop(n, batch_size, drop_last)
    if packed:
        gather = getattr(dataset, "gather_packed", None)
        if gather is None:
            def gather(idx):
                return pack_rows(dataset.gather(idx))
    else:
        gather = dataset.gather
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size]
        yield gather(idx), idx.astype(np.int32)
