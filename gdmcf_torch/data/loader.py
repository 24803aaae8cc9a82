"""Edge-list ``.npy`` triples -> scipy CSR user x item matrices, and the
epoch's batches (the port's copy of the JAX package's ``data/loader.py``:
``data_load``, ``data_load_dir``, ``DiffusionDataset``, ``epoch_stop``,
``epoch_batches``, ``generate_synthetic_dataset``, and the LightGCN
pretrainer's ml-100k ingest ``generate_ml100k_csv`` / ``load_ml100k``, in
numpy alone)."""

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


def generate_ml100k_csv(path: str, n_user: int = 400, n_item: int = 600,
                        avg_degree: int = 40, seed: int = 0,
                        alpha: float = 1.1) -> str:
    """Write a synthetic ml-100k-shaped ``u.data`` TSV (user_id, item_id,
    rating 1-5, timestamp), the input of the reference LightGCN
    pretrainer's ingest; the JAX package's file byte for byte. Raw ids
    start at 1 and skip about 20% of the id space, so the label encoding
    has work to do."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_item + 1) ** alpha
    pop /= pop.sum()
    user_ids = np.sort(rng.choice(n_user * 5, n_user, replace=False)) + 1
    item_ids = np.sort(rng.choice(n_item * 5, n_item, replace=False)) + 1
    rows = []
    for u in user_ids:
        deg = max(5, rng.poisson(avg_degree))
        items = rng.choice(n_item, size=min(deg, n_item), replace=False,
                           p=pop)
        for i in items:
            rating = int(rng.integers(1, 6))
            ts = int(rng.integers(874_000_000, 893_000_000))
            rows.append((int(u), int(item_ids[i]), rating, ts))
    rng.shuffle(rows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        for r in rows:
            fh.write("\t".join(str(v) for v in r) + "\n")
    return path


def load_ml100k(path: str, min_rating: int = 3, test_size: float = 0.2,
                random_state: int = 16):
    """ml-100k ``u.data`` ingest with the reference LightGCN pretrainer's
    semantics, in numpy:

      * keep ratings >= ``min_rating``;
      * split the rows as sklearn's ``train_test_split(test_size=0.2,
        random_state=16)`` does: the first ``ceil(test_size * n)`` rows of
        ``np.random.RandomState(random_state).permutation(n)`` are the
        test split, the rest the train split, in that order;
      * encode user and item ids as their ranks among the train ids (what
        ``LabelEncoder`` fitted on the train split does);
      * keep the test rows whose user AND item appear in train;
      * n_users / n_items = the distinct train ids.

    Returns (train_csr [n_users, n_items], test_csr, n_users, n_items);
    interactions are binary (a duplicate pair counts once)."""
    with open(path) as fh:
        raw = np.array(fh.read().split(), dtype=np.int64)
    table = raw.reshape(-1, 4)        # user_id, item_id, rating, timestamp
    table = table[table[:, 2] >= min_rating]
    n = len(table)
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(random_state).permutation(n)
    train, test = table[perm[n_test:]], table[perm[:n_test]]
    user_ids = np.unique(train[:, 0])
    item_ids = np.unique(train[:, 1])
    test = test[np.isin(test[:, 0], user_ids) & np.isin(test[:, 1], item_ids)]
    n_users, n_items = len(user_ids), len(item_ids)

    def to_csr(rows):
        m = sp.coo_matrix(
            (np.ones(len(rows), dtype=np.float32),
             (np.searchsorted(user_ids, rows[:, 0]),
              np.searchsorted(item_ids, rows[:, 1]))),
            shape=(n_users, n_items)).tocsr()
        m.data[:] = 1.0
        return m

    return to_csr(train), to_csr(test), n_users, n_items
