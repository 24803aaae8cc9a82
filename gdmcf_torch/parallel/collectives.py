"""Differentiable collectives over one mesh axis.

Every rank of an axis runs the same program on the same rows, so a tensor
that comes out of a collective replicated is used identically by each of
them. The backward of each op follows from that:

  sum_over(x)        forward: all-reduce sum.  backward: identity (each
                     rank's replicated use already is the whole gradient;
                     an all-reduce there would multiply it by the axis
                     size).
  copy_to(x)         forward: identity.  backward: all-reduce sum (x feeds
                     a rank-local part of a sharded op, each rank's gradient
                     is its part's contribution).
  gather_from(x, d)  forward: all-gather of the ranks' blocks along dim d.
                     backward: this rank's block of the gradient.
  gather_rows(x)     forward: all-gather along dim 0. backward: all-reduce
                     sum of the gradient, then this rank's block (each rank
                     computes its own loss from the gathered rows).
  sum_rows(x)        forward: all-reduce sum of each dp block's sum over
                     its rows. backward: all-reduce sum (each block's loss
                     reads the whole batch's sum, so a block's part takes
                     every block's gradient).

Only all-reduce and all-gather are used. Under NCCL a CUDA tensor goes on
the wire as it is; under gloo (CPU ranks, or several ranks sharing one
card) a CUDA tensor travels through host memory: it is copied to the host,
reduced or gathered there, and copied back.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """[each rank's x] in group rank order. bfloat16 travels as its bytes,
    which every backend carries."""
    x = x.contiguous()
    wire = x.reshape(1) if x.ndim == 0 else x
    if x.dtype == torch.bfloat16:
        wire = wire.view(torch.uint8)
    host = _via_host(x, group)
    if host:
        wire = wire.cpu()
    out = [torch.empty_like(wire)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    if host:
        out = [o.to(x.device) for o in out]
    return [o.view(x.dtype).reshape(x.shape) for o in out]


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """In-place all-reduce of a contiguous tensor."""
    if _via_host(x, group):
        y = x.cpu()
        dist.all_reduce(y, op=op, group=group)
        x.copy_(y)
    else:
        dist.all_reduce(x, op=op, group=group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Out-of-place all-reduce."""
    y = x.contiguous().clone()
    all_reduce_(y, group, op)
    return y


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.index = dim, dist.get_rank(group)
        ctx.width = x.shape[dim]
        return torch.cat(all_gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width).contiguous(), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.index = group, dist.get_rank(group)
        ctx.rows = x.shape[0]
        return torch.cat(all_gather_list(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.group)
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows].contiguous(), None


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group) if x.requires_grad else x


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim % x.ndim)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherRows.apply(x, group)


def sum_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _SumRows.apply(x, group)
