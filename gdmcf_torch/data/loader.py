"""Edge-list ``.npy`` triples -> scipy CSR user x item matrices (the port's
copy of the JAX package's ``data/loader.py:data_load`` and
``data_load_dir``)."""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp


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
