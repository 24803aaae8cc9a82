"""The mesh forms of the layer ops that touch a sharded parameter.

Each function is the plain op when its parameter is replicated (no mesh, or
a dimension the mp size does not divide), so the backbones call them on
every path:

  linear_parts(layer, parts)  ``layer(cat(parts, -1))`` without its
      whole input gradient (``LinearParts``): an input gradient only for
      the parts that need one (the time embedding; the catalog-wide rows
      are data). With the weight sharded over its input (``Shard(1)``: the
      towers' catalog-wide first layers), each rank multiplies its block
      of the concatenated input by its weight block and the partial
      products are summed over mp. Only the parts that need a gradient go
      through ``copy_to``.
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
from torch.autograd.function import once_differentiable

from gdmcf_torch.models.layers import cosine_scores, promote
from gdmcf_torch.parallel.collectives import copy_to, gather_from, sum_over
from gdmcf_torch.parallel.sharding import shard_of


class LinearParts(torch.autograd.Function):
    """``Linear`` over the parts of its input, ``apply(weight, bias,
    *parts)``: ``layer(cat(parts, -1))`` without its whole input gradient.

    Forward: the parts are concatenated and multiplied as ``Linear`` does
    (``F.linear`` with the bias when input, weight and bias are all
    float32; otherwise the product in the common type, then the bias
    added). The concatenation is saved for the backward, as autograd would.

    Backward: the weight gradient is one product of the output gradient
    and the saved concatenation, the bias gradient the output gradient's
    column sums, and an input gradient is formed only for a part that
    requires one, from its block of weight columns (the towers' time
    embedding; their catalog-wide rows are data). A part may be a strided
    view or appear more than once (each place gets its own gradient, which
    autograd sums). No host sync, so a CUDA graph can capture both passes.

    ``calls`` (forward passes) and ``skipped_columns`` (input-gradient
    columns not formed: the widths of the parts that need none, a backward
    pass at a time) count Python calls: a captured CUDA graph counts once,
    at its capture, and not at its replays.
    """

    calls = 0
    skipped_columns = 0

    @staticmethod
    def forward(ctx, weight, bias, *parts):
        LinearParts.calls += 1
        x, w = promote(torch.cat(parts, dim=-1), weight)
        if x.dtype == weight.dtype == bias.dtype == torch.float32:
            out = F.linear(x, w, bias)
        else:
            out = F.linear(x, w) + bias
        ctx.save_for_backward(weight, x)
        ctx.bias_dtype = bias.dtype
        ctx.parts = [(p.shape, p.dtype) for p in parts]
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        weight, x = ctx.saved_tensors
        need_w, need_b, *need_parts = ctx.needs_input_grad
        g = grad.reshape(-1, grad.shape[-1])
        gd = g.to(x.dtype)
        gw = None
        if need_w:
            gw = (gd.t() @ x.reshape(-1, x.shape[-1])).to(weight.dtype)
        gb = g.sum(0).to(ctx.bias_dtype) if need_b else None
        grads = []
        off = 0
        for (shape, dtype), need in zip(ctx.parts, need_parts):
            w = shape[-1]
            if need:
                gx = gd @ weight[:, off:off + w].to(x.dtype)
                grads.append(gx.to(dtype).reshape(shape))
            else:
                grads.append(None)
                LinearParts.skipped_columns += w
            off += w
        return (gw, gb, *grads)


def linear_parts(layer: torch.nn.Linear,
                 parts: Sequence[torch.Tensor]) -> torch.Tensor:
    shard = shard_of(layer.weight)
    if shard is None:
        return LinearParts.apply(layer.weight, layer.bias, *parts)
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
        term = F.linear(*promote(piece, layer.weight[:, c:c + (b - a)]))
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
    x, w = promote(copy_to(x, shard.group), layer.weight)
    # a float32 pair keeps the fused bias, as ``Linear`` does
    y = (F.linear(x, w, bias) if x.dtype == bias.dtype == torch.float32
         else F.linear(x, w) + bias)
    return gather_from(y, shard.group, -1)


def cosine_head(user_vecs: torch.Tensor, item_table: torch.Tensor,
                eps: float = 0.0) -> torch.Tensor:
    shard = shard_of(item_table)
    if shard is None:
        return cosine_scores(user_vecs, item_table, eps)
    local = cosine_scores(copy_to(user_vecs, shard.group), item_table, eps)
    return gather_from(local, shard.group, 1)
