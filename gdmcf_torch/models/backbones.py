"""Denoiser backbones.

Port of the JAX package's ``models/backbones.py``: ``DNNlightGCN`` (JAX
``dnn_lightgcn``) and the flagship ``DNNOneHotEmbeddingGCN`` (JAX
``dnn_one_hot_embedding_gcn``, with its ``conti`` variant). The other
backbones are listed in ROADMAP.md §A.

Every forward takes ``(x, t, x_U, index, graph)`` and the keywords
``rcloss`` (return the contrastive loss), ``generator`` and ``dropout_u``
(pre-drawn dropout uniforms, in the order the model draws them) and
returns ``(scores, closs or None)``; dropout follows ``self.training``."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from gdmcf_torch.models.gcn import LayerGCN, layer_gcn_user_rows
from gdmcf_torch.models.layers import (cosine_scores, dropout, l2_normalize,
                                       linear_init, mlp_init, mlp_out,
                                       mlp_tanh, nt_xent_loss,
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
    ``sparse_adj``: a BlockSparse or HybridSparse N, propagated on its row
    operands alone (the SpMM kernel on CUDA). Neither: the raw init tables are used.
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
            from gdmcf_torch.models.lightgcn import propagate_rows
            dev = e_user.device
            e_user, e_item = propagate_rows(
                e_user, e_item, sparse_adj.fwd_rows.to(dev),
                sparse_adj.t_rows.to(dev), lgn_layers)
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
                rcloss: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        link = (self.frozen_lgn_user[index] @ self.frozen_lgn_item.T) > 0.0
        x = x * link.to(x.dtype)
        emb = self.emb_layer(timestep_embedding(t, self.emb_size))
        if self.norm:
            x = l2_normalize(x)
        (u,) = dropout_u or (None,)
        x = dropout(x, self.dropout_rate, self.training, generator, u)
        h = torch.cat([x, emb], dim=-1)
        h = mlp_tanh(self.in_layers, h)
        return mlp_out(self.out_layers, h), None


class DNNOneHotEmbeddingGCN(nn.Module):
    """The flagship backbone: two tanh towers (the noisy rows and the
    interleaved one-hot corruption) -> NT-Xent between them -> fuse with a
    learned user table -> GCN over the corruption graph -> learnable
    ``sumW`` blend -> full-catalog cosine scores against a learned item
    table.

    ``conti=True`` is ``DNNOneHotEmbeddingGCN_conti``: the fused vector
    uses the one-hot tower twice and ``noise_type`` routing is skipped.
    ``noise_type`` 1 feeds the first tower the one-hot tower's first n
    columns, 2 feeds the second tower ``[x, x]``; both zero the
    contrastive loss. The GCN hidden width is 512, as in the reference.
    """

    needs_graph = True   # forward reads ``graph``; p_sample must grow one
    GCN_HIDDEN = 512

    def __init__(self, in_dims, out_dims, emb_size: int, n_item: int,
                 n_user: int, generator: torch.Generator, device=None,
                 norm: bool = False, dropout_rate: float = 0.5,
                 gcn_layer_num: int = 2, noise_type: int = 0,
                 symmetric_gcn: bool = False, conti: bool = False,
                 cosine_eps: float = 0.0):
        super().__init__()
        assert out_dims[0] == in_dims[-1]
        in_t = _tower_dims(in_dims, emb_size)
        in_t2 = _tower_dims([in_dims[0] * 2] + list(in_dims[1:]), emb_size)
        d_user = in_t[-1]
        d_item = in_t[-1] + d_user + in_t2[-1]
        self.emb_size = emb_size
        self.norm = norm
        self.dropout_rate = dropout_rate
        self.gcn_layer_num = gcn_layer_num
        self.noise_type = noise_type
        self.symmetric_gcn = symmetric_gcn
        self.conti = conti
        self.cosine_eps = cosine_eps
        self.emb_layer = linear_init(emb_size, emb_size, generator, device)
        self.in_layers = mlp_init(in_t, generator, device)
        self.in_layers2 = mlp_init(in_t2, generator, device)
        self.embedding_item = nn.Parameter(
            xavier_uniform((n_item, d_item), generator, device))
        self.embedding_user = nn.Parameter(
            xavier_uniform((n_user, d_user), generator, device))
        self.gcn = LayerGCN(d_item, self.GCN_HIDDEN, d_item,
                            max(gcn_layer_num, 1), generator, device)
        self.sumW = nn.Parameter(torch.ones((), device=device))

    def forward(self, x, t, x_U=None, index=None, graph=None,
                rcloss: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_u: Sequence[torch.Tensor] = ()):
        u_x, u_xu = dropout_u or (None, None)
        # the one-hot [B, n, 2] flattens interleaved, (cell 0 state 0,
        # cell 0 state 1, ...), the layout in_layers2's rows are bridged in
        x_U = x_U.reshape(x_U.shape[0], -1)
        emb = self.emb_layer(timestep_embedding(t, self.emb_size))
        if self.norm:
            x, x_U = l2_normalize(x), l2_normalize(x_U)
        x = dropout(x, self.dropout_rate, self.training, generator, u_x)
        x_U = dropout(x_U, self.dropout_rate, self.training, generator, u_xu)

        routed = not self.conti
        if routed and self.noise_type == 1:
            h_in = torch.cat([x_U[:, : x.shape[1]], emb], dim=-1)
        else:
            h_in = torch.cat([x, emb], dim=-1)
        h = mlp_tanh(self.in_layers, h_in)
        if routed and self.noise_type == 2:
            hu_in = torch.cat([x, x, emb], dim=-1)
        else:
            hu_in = torch.cat([x_U, emb], dim=-1)
        h_U = mlp_tanh(self.in_layers2, hu_in)

        closs = None
        if rcloss:
            closs = nt_xent_loss(h, h_U)
            if routed and self.noise_type != 0:
                closs = closs * 0.0

        user_vecs = self.embedding_user[index]
        hc = torch.cat([h_U if self.conti else h, h_U, user_vecs], dim=1)
        if self.gcn_layer_num > 0:
            if self.symmetric_gcn:
                g = graph[..., 1].to(x.dtype)
                gcn_u, _ = self.gcn(hc, self.embedding_item, g,
                                    symmetric=True)
            else:
                # directed graph: the user rows the blend reads ignore it
                gcn_u = layer_gcn_user_rows(self.gcn, hc)
            hc = hc * self.sumW + gcn_u * (1.0 - self.sumW)
        return cosine_scores(hc, self.embedding_item, self.cosine_eps), closs
