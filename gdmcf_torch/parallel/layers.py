"""The mesh forms of the layer ops that touch a sharded parameter.

Each function is the plain op when its parameter is replicated (no mesh, or
a dimension the mp size does not divide), so the backbones call them on
every path:

  linear_parts(layer, parts)  ``layer(cat(parts, -1))``. With the weight
      sharded over its input (``Shard(1)``: the towers' catalog-wide first
      layers), each rank multiplies its block of the concatenated input by
      its weight block and the partial products are summed over mp. Only
      the parts that need a gradient (the time embedding) go through
      ``copy_to``: the catalog-wide rows are data.
  linear_out(layer, x)        ``layer(x)``. With the weight sharded over
      its output (``Shard(0)``: DNNCat2's fuse), each rank computes its
      output block and the blocks are gathered.
  cosine_head(u, table, eps)  ``cosine_scores``. With the item table
      sharded by rows, each rank scores its items and the [B, n] scores are
      gathered.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from gdmcf_torch.models.layers import cosine_scores
from gdmcf_torch.parallel.collectives import copy_to, gather_from, sum_over
from gdmcf_torch.parallel.sharding import shard_of


def linear_parts(layer: torch.nn.Linear,
                 parts: Sequence[torch.Tensor]) -> torch.Tensor:
    shard = shard_of(layer.weight)
    if shard is None:
        return layer(torch.cat(list(parts), dim=-1))
    if shard.dim != 1:
        raise ValueError("linear_parts takes a weight sharded by input")
    width = layer.weight.shape[1]
    lo = shard.index * width
    hi = lo + width
    acc = None
    off = 0
    for p in parts:
        # every rank runs the same ops (a part outside its block is an
        # empty slice), so the backward's all-reduces line up over mp
        a = min(max(lo, off), off + p.shape[-1])
        b = max(min(hi, off + p.shape[-1]), a)
        piece = copy_to(p, shard.group)[..., a - off:b - off]
        c = min(max(a - lo, 0), width)
        term = F.linear(piece, layer.weight[:, c:c + (b - a)])
        acc = term if acc is None else acc + term
        off += p.shape[-1]
    return sum_over(acc, shard.group) + layer.bias


def linear_out(layer: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
    shard = shard_of(layer.weight)
    if shard is None:
        return layer(x)
    if shard.dim != 0:
        raise ValueError("linear_out takes a weight sharded by output")
    rows = layer.weight.shape[0]
    bias = layer.bias[shard.index * rows:(shard.index + 1) * rows]
    y = F.linear(copy_to(x, shard.group), layer.weight, bias)
    return gather_from(y, shard.group, -1)


def cosine_head(user_vecs: torch.Tensor, item_table: torch.Tensor,
                eps: float = 0.0) -> torch.Tensor:
    shard = shard_of(item_table)
    if shard is None:
        return cosine_scores(user_vecs, item_table, eps)
    local = cosine_scores(copy_to(user_vecs, shard.group), item_table, eps)
    return gather_from(local, shard.group, 1)
