"""Denoiser backbones.

Port of the JAX package's ``models/backbones.py``; this slice holds
``DNNlightGCN`` (JAX ``dnn_lightgcn``). The other backbones are listed in
ROADMAP.md §A."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from gdmcf_torch.models.layers import (dropout, l2_normalize, linear_init,
                                       mlp_init, mlp_out, mlp_tanh,
                                       timestep_embedding, xavier_uniform)


def _tower_dims(in_dims: List[int], emb_size: int) -> List[int]:
    """Prepend the time-embedding width to the first layer."""
    return [in_dims[0] + emb_size] + list(in_dims[1:])


class DNNlightGCN(nn.Module):
    """LightGCN link filter in front of a plain DNN denoiser.

    The reference scores every (user, item) edge with LightGCN embeddings
    propagated over the frozen train graph and keeps the edges whose
    sigmoid score exceeds 0.5. The threshold blocks every gradient to the
    embeddings, so they keep their init values and one propagation at
    construction is exact: ``frozen_lgn_user``/``frozen_lgn_item`` are
    buffers, and the filter is ``(e_user[index] @ e_item.T) > 0``.

    ``norm_adj``: dense normalized N (a [n_user, n_item] tensor);
    ``sparse_adj``: a BlockSparse or HybridSparse N, propagated with the
    SpMM kernels on CUDA. Neither: the raw init tables are used.
    """

    def __init__(self, in_dims, out_dims, emb_size: int, n_user: int,
                 n_item: int, generator: torch.Generator, device=None,
                 norm: bool = False, dropout_rate: float = 0.5,
                 lgn_dim: int = 64, lgn_layers: int = 2,
                 norm_adj: Optional[torch.Tensor] = None, sparse_adj=None):
        super().__init__()
        assert out_dims[0] == in_dims[-1]
        self.emb_size = emb_size
        self.norm = norm
        self.dropout_rate = dropout_rate
        # the LightGCN table is drawn first, so that a caller can redraw the
        # raw table from the same seed (see draw_lgn_table)
        e_user, e_item = self.draw_lgn_table(n_user, n_item, lgn_dim,
                                             generator, device)
        if sparse_adj is not None:
            from gdmcf_torch.models.lightgcn import (propagate_hybrid,
                                                     propagate_sparse)
            from gdmcf_torch.ops.spmm import HybridSparse
            op = sparse_adj.to(e_user.device)
            prop = (propagate_hybrid if isinstance(op, HybridSparse)
                    else propagate_sparse)
            e_user, e_item = prop(e_user, e_item, op, lgn_layers)
        elif norm_adj is not None:
            from gdmcf_torch.models.lightgcn import propagate
            e_user, e_item = propagate(e_user, e_item,
                                       norm_adj.to(e_user.device), lgn_layers)
        self.emb_layer = linear_init(emb_size, emb_size, generator, device)
        self.in_layers = mlp_init(_tower_dims(in_dims, emb_size), generator,
                                  device)
        self.out_layers = mlp_init(out_dims, generator, device)
        self.register_buffer("frozen_lgn_user", e_user.contiguous())
        self.register_buffer("frozen_lgn_item", e_item.contiguous())

    @staticmethod
    def draw_lgn_table(n_user: int, n_item: int, lgn_dim: int,
                       generator: torch.Generator, device=None):
        """The raw Xavier-uniform (user, item) tables, before propagation."""
        emb = xavier_uniform((n_user + n_item, lgn_dim), generator, device)
        return emb[:n_user], emb[n_user:]

    def forward(self, x, t, x_U=None, index=None, graph=None,
                generator: Optional[torch.Generator] = None):
        link = (self.frozen_lgn_user[index] @ self.frozen_lgn_item.T) > 0.0
        x = x * link.to(x.dtype)
        emb = self.emb_layer(timestep_embedding(t, self.emb_size))
        if self.norm:
            x = l2_normalize(x)
        x = dropout(x, self.dropout_rate, self.training, generator)
        h = torch.cat([x, emb], dim=-1)
        h = mlp_tanh(self.in_layers, h)
        return mlp_out(self.out_layers, h), None
