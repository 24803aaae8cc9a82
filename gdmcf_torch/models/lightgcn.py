"""LightGCN normalized adjacency and propagation.

Port of the propagation half of the JAX package's ``models/lightgcn.py``: with
R the user x item interactions, N = D_u^{-1/2} R D_i^{-1/2}, one layer is
``u' = N @ e_item, i' = N^T @ e_user``, and the final tables are the mean
over layers 0..K. The sparse forms run on ``ops/spmm`` (the CUDA kernel for
CUDA tensors, one launch per product): each operand carries a row operand
per direction, the CSR of N and that of N^T, so both directions are the
same row gather. Pretraining and ``bpr_loss`` are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from gdmcf_torch.ops.spmm import (BlockSparse, HybridSparse, RowOperand,
                                  degree_sort_permutation, spmm_rows,
                                  to_block_sparse, to_hybrid)

# a dense [n_user, n_item] f32 N above this many bytes switches the
# lightGCN backbone to the hybrid sparse operand
_DENSE_LIMIT_BYTES = 2 << 30


def _inv_sqrt_degrees(r, eps: float):
    deg_u = np.asarray(r.sum(axis=1)).ravel()
    deg_i = np.asarray(r.sum(axis=0)).ravel()
    du = np.power(deg_u + eps, -0.5)
    di = np.power(deg_i + eps, -0.5)
    du[np.isinf(du)] = 0.0
    di[np.isinf(di)] = 0.0
    return du, di


def normalized_bipartite_blocks(train_csr: sp.spmatrix,
                                eps: float = 1e-9) -> np.ndarray:
    """N as a dense [n_user, n_item] float32 matrix."""
    r = train_csr.astype(np.float32).toarray()
    du, di = _inv_sqrt_degrees(r, eps)
    return (r * du[:, None]) * di[None, :]


def _normalized_sparse_n(train_csr: sp.spmatrix, eps: float,
                         degree_sort: bool):
    r = train_csr.tocsr().astype(np.float32)
    du, di = _inv_sqrt_degrees(r, eps)
    n = sp.diags(du) @ r @ sp.diags(di)
    perms = None
    if degree_sort:
        row_perm, col_perm = degree_sort_permutation(n)
        n = n.tocsr()[row_perm][:, col_perm]
        perms = (row_perm, col_perm)
    return n, perms


def normalized_bipartite_sparse(train_csr: sp.spmatrix, br: int = 128,
                                bc: int = 128, eps: float = 1e-9,
                                max_bytes: int = 8 << 30,
                                degree_sort: bool = False):
    """N as ONE BlockSparse (its ``t_rows`` serve N^T); with
    ``degree_sort`` also returns (row_perm, col_perm)."""
    n, perms = _normalized_sparse_n(train_csr, eps, degree_sort)
    n_bs = to_block_sparse(n, br, bc, max_bytes)
    return (n_bs, perms) if degree_sort else n_bs


def normalized_bipartite_hybrid(train_csr: sp.spmatrix, br: int = 8,
                                bc: int = 128, min_fill: int = 4,
                                eps: float = 1e-9, max_bytes: int = 8 << 30,
                                degree_sort: bool = False):
    """N as a HybridSparse (tiles + COO remainder, and the row operands
    over all of its nonzeros that the products run on)."""
    n, perms = _normalized_sparse_n(train_csr, eps, degree_sort)
    h = to_hybrid(n, br=br, bc=bc, min_fill=min_fill, max_bytes=max_bytes)
    return (h, perms) if degree_sort else h


def _layers(e_user, e_item, n_layers, fwd, bwd):
    n_user, n_item = e_user.shape[0], e_item.shape[0]
    us, its = [e_user], [e_item]
    u, i = e_user, e_item
    for _ in range(n_layers):
        u, i = fwd(i)[:n_user], bwd(u)[:n_item]
        us.append(u)
        its.append(i)
    return sum(us) / (n_layers + 1), sum(its) / (n_layers + 1)


def propagate(e_user: torch.Tensor, e_item: torch.Tensor,
              n_mat: torch.Tensor, n_layers: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-layer propagation on the dense N, mean over layers 0..K."""
    return _layers(e_user, e_item, n_layers, lambda i: n_mat @ i,
                   lambda u: n_mat.T @ u)


def propagate_rows(e_user: torch.Tensor, e_item: torch.Tensor,
                   fwd: RowOperand, t: RowOperand, n_layers: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``propagate`` on the row operands of N and N^T alone (either
    format's ``fwd_rows`` and ``t_rows``), so the tiles need not be on the
    device."""
    return _layers(e_user, e_item, n_layers, lambda i: spmm_rows(fwd, i),
                   lambda u: spmm_rows(t, u))


def propagate_sparse(e_user: torch.Tensor, e_item: torch.Tensor,
                     a: BlockSparse, n_layers: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``propagate`` on the block-sparse N (its tiles' nonzeros)."""
    return propagate_rows(e_user, e_item, a.fwd_rows, a.t_rows, n_layers)


def propagate_hybrid(e_user: torch.Tensor, e_item: torch.Tensor,
                     h: HybridSparse, n_layers: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``propagate`` on the hybrid N: one launch per product on CUDA."""
    return propagate_rows(e_user, e_item, h.fwd_rows, h.t_rows, n_layers)
