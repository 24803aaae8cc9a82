"""Dense bipartite graph convolution over the batch's corruption graph.

Port of the JAX package's ``models/gcn.py``. The batch graph is the binary
matrix ``G [B, n_item]`` with user -> item edges; GCNConv with self-loops
and symmetric normalization on it reduces to two dense products:

    deg_i     = 1 + sum_u G[u, i]
    item_out  = (X_i W) / deg_i + G^T (X_u W) / sqrt(deg_i) + b
    user_out  = (X_u W) + b

so with the reference's directed edges user rows are graph-independent.
``symmetric=True`` adds the reverse edges:

    deg_u     = 1 + sum_i G[u, i]
    user_out  = (X_u W) / deg_u + (G / sqrt(deg_u deg_i)) (X_i W) + b

On a (dp, mp) mesh both sides read across what the mesh splits: G's rows
are a dp block of the batch, and the item rows an mp block of the catalog
when the item table is sharded. ``gcn_conv_bipartite`` then sums deg_i and
the products into the items over dp (``sum_rows``: each block's loss reads
the whole batch's sums) and the products into the users over mp
(``sum_over``); the conv's weight and bias enter the item side through
``copy_to``, so their item-side gradient sums over the mp blocks.

``mean_aggregation`` and ``mini_lightgcn_apply`` are the reference's
parameter-free aggregation alternative; no backbone calls them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdmcf_torch.models.layers import gcn_conv_init, promote
from gdmcf_torch.parallel.collectives import (all_reduce, copy_to, sum_over,
                                              sum_rows)


def gcn_conv_bipartite(conv: nn.Linear, h_users: torch.Tensor,
                       h_items: torch.Tensor, g: torch.Tensor,
                       symmetric: bool = False, batch_group=None,
                       item_shard=None, items: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One GCNConv over the bipartite batch graph; returns (users, items).
    h_users [B, D], h_items [N, D], g [B, N] binary. ``items`` False skips
    the item rows' output (None), which a last layer's caller never reads.

    On a mesh: ``batch_group``, the dp group when h_users and g are a dp
    block's rows; ``item_shard``, the item table's ``MeshShard`` when
    h_items is this rank's block of the item rows (g keeps every column)."""
    # a bfloat16 weight (param_dtype) meets float32 rows: promoted, as jnp
    # does; everything after is float32
    w, b = conv.weight, conv.bias
    xu = F.linear(*promote(h_users, w))
    deg_u = 1.0 + g.sum(dim=1) if symmetric else None
    w_i, b_i, xu_i = w, b, xu
    if item_shard is not None:
        lo = item_shard.index * h_items.shape[0]
        g = g[:, lo:lo + h_items.shape[0]]
        w_i, b_i, xu_i = (copy_to(t, item_shard.group) for t in (w, b, xu))
    xi = F.linear(*promote(h_items, w_i))
    cols = g.sum(dim=0)
    deg_i = 1.0 + (cols if batch_group is None
                   else all_reduce(cols, batch_group))
    if symmetric:
        g = g * torch.rsqrt(deg_u)[:, None] * torch.rsqrt(deg_i)[None, :]
        to_users = g @ xi
        if item_shard is not None:
            to_users = sum_over(to_users, item_shard.group)
        user_out = xu / deg_u[:, None] + to_users
    else:
        user_out = xu
    item_out = None
    if items:
        to_items = g.T @ xu_i
        if batch_group is not None:
            to_items = sum_rows(to_items, batch_group)
        if not symmetric:
            to_items = to_items / torch.sqrt(deg_i)[:, None]
        item_out = xi / deg_i[:, None] + to_items + b_i
    return user_out + b, item_out


def _act(h: torch.Tensor) -> torch.Tensor:
    # ReLU then LeakyReLU(0.1) back to back, as the reference does
    return F.leaky_relu(F.relu(h), 0.1)


class LayerGCN(nn.Module):
    """One or two GCN convs (``conv1`` [+ ``conv2``])."""

    def __init__(self, in_ch: int, hidden_ch: int, out_ch: int,
                 num_layers: int, generator: torch.Generator, device=None):
        super().__init__()
        if num_layers not in (1, 2):
            raise ValueError(f"LayerGCN takes 1 or 2 layers, not {num_layers}")
        self.num_layers = num_layers
        if num_layers == 1:
            self.conv1 = gcn_conv_init(in_ch, out_ch, generator, device)
        else:
            self.conv1 = gcn_conv_init(in_ch, hidden_ch, generator, device)
            self.conv2 = gcn_conv_init(hidden_ch, out_ch, generator, device)

    def forward(self, h_users, h_items, g, symmetric: bool = False,
                batch_group=None, item_shard=None, items: bool = True):
        """(users, items) of the stack; ``items`` False: the last layer's
        item rows are not computed (None). The mesh keywords as
        ``gcn_conv_bipartite``'s."""
        mesh = dict(batch_group=batch_group, item_shard=item_shard)
        two = self.num_layers == 2
        u, i = gcn_conv_bipartite(self.conv1, h_users, h_items, g, symmetric,
                                  items=items or two, **mesh)
        if two:
            u, i = gcn_conv_bipartite(self.conv2, _act(u), _act(i), g,
                                      symmetric, items=items, **mesh)
        return u, i


def layer_gcn_user_rows(gcn: LayerGCN, h_users: torch.Tensor) -> torch.Tensor:
    """The user rows of ``LayerGCN`` on the directed graph, which receive
    only their self-loop: ``X_u W1 + b1`` [then ``act(.) W2 + b2``]. Equal
    to ``gcn(...)[0]`` with ``symmetric=False`` without the item side."""
    u = gcn.conv1(h_users)
    if gcn.num_layers == 2:
        u = gcn.conv2(_act(u))
    return u


def mean_aggregation(h_users: torch.Tensor, h_items: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One parameter-free add-aggregation hop over the directed user ->
    item edges: items sum their users' features, users receive nothing
    (no self-loops)."""
    return torch.zeros_like(h_users), g.T @ h_users


def mini_lightgcn_apply(h_users: torch.Tensor, h_items: torch.Tensor,
                        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two aggregation hops with relu between, as the reference's module.

    Degenerate by construction, as in the reference: hop 1 zeroes the user
    features and hop 2 aggregates those zeros while it drops the item
    features, so the result is (0, 0) for every input."""
    u, i = mean_aggregation(h_users, h_items, g)
    return mean_aggregation(F.relu(u), F.relu(i), g)
