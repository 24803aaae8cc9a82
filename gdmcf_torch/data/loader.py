"""Edge-list ``.npy`` triples -> scipy CSR user x item matrices, and the
epoch's batches (the port's copy of the JAX package's ``data/loader.py``:
``data_load``, ``data_load_dir``, ``DiffusionDataset``, ``epoch_stop``,
``epoch_batches`` and ``generate_synthetic_dataset``)."""

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

    @classmethod
    def from_rows(cls, rows: np.ndarray) -> "DiffusionDataset":
        """Wrap an already-dense row matrix (no CSR densification)."""
        self = cls.__new__(cls)
        self.rows = np.ascontiguousarray(rows, dtype=np.float32)
        self.binary = is_binary(self.rows)
        return self

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


def generate_synthetic_dataset(
    out_dir: str,
    n_user: int = 6000,
    n_item: int = 2800,
    avg_degree: int = 12,
    valid_frac: float = 0.1,
    test_frac: float = 0.2,
    seed: int = 0,
    alpha: float = 1.2,
) -> Tuple[str, str, str]:
    """Write train/valid/test_list.npy edge lists with power-law popularity;
    the same files, byte for byte, as the JAX package's function for the
    same arguments (the golden parity data was made with it).

    Every user receives >= 3 interactions so each split is non-degenerate.
    Returns the three file paths.
    """
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_item + 1) ** alpha
    pop /= pop.sum()

    edges = []
    for u in range(n_user):
        deg = max(3, rng.poisson(avg_degree))
        items = rng.choice(n_item, size=min(deg, n_item), replace=False, p=pop)
        for i in items:
            edges.append((u, int(i)))
    edges = np.array(edges, dtype=np.int64)
    rng.shuffle(edges)

    # per-user split so valid/test ground truth is non-empty for most users
    train, valid, test = [], [], []
    by_user: dict = {}
    for u, i in edges:
        by_user.setdefault(u, []).append(i)
    for u, items in by_user.items():
        items = np.array(items)
        n = len(items)
        n_test = max(1, int(n * test_frac))
        n_valid = max(1, int(n * valid_frac))
        test.extend((u, i) for i in items[:n_test])
        valid.extend((u, i) for i in items[n_test:n_test + n_valid])
        train.extend((u, i) for i in items[n_test + n_valid:])

    # data_load infers n_user/n_item from the TRAIN max ids: move one edge
    # of every item/user that only occurs in valid/test into train so the
    # inferred grid covers all ids
    train_items = {i for _, i in train}
    train_users = {u for u, _ in train}
    for split in (valid, test):
        kept = []
        for u, i in split:
            if i not in train_items or u not in train_users:
                train.append((u, i))
                train_items.add(i)
                train_users.add(u)
            else:
                kept.append((u, i))
        split[:] = kept

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, lst in (("train", train), ("valid", valid), ("test", test)):
        path = os.path.join(out_dir, f"{name}_list.npy")
        np.save(path, np.array(lst, dtype=np.int64))
        paths.append(path)
    return tuple(paths)
