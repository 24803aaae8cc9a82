"""Sharding rules: a regex over the parameter name -> a placement per mesh
axis; the ops that touch a sharded parameter run its collectives.

Port of the JAX package's ``parallel/sharding.py``. The rules name the
port's ``state_dict`` entries (``compat``'s one-for-one map of the JAX
tree); a spec is a pair of ``torch.distributed.tensor`` placements over
("dp", "mp"), DTensor's counterpart of a ``PartitionSpec``. Every ``w`` of
the JAX package is stored transposed here ([out, in]), so JAX's
``in_layers/0/w`` P("mp", None) is ``Shard(1)`` and ``cat_layer/w``
P(None, "mp") is ``Shard(0)``; the tables are not transposed.

Strategy (the JAX package's):
  * parameters are replicated over dp; the catalog-sized ones are sharded
    over mp: the item and user tables and the frozen LightGCN tables by
    rows, the towers' first weights by their catalog-wide input, the
    DNNCat2 fuse by its catalog-wide output; everything else replicated;
    the optimizer moments and the float32 masters of bfloat16-stored
    tensors follow their parameters (made from each rank's block, so K1
    updates the rank's own blocks);
  * a dimension the mp size does not divide stays replicated
    (``compatible_spec``).

Where JAX annotates and lets XLA propagate, the port writes the mesh form of
each op that touches a sharded parameter (``parallel/layers.py``,
``parallel/embed.py``); every other op runs unchanged on the rank's rows.
Activations are sharded over dp by rows and replicated over mp
(``batch_spec``), so the engine's per-row math is the single-device code.

``shard_params`` replaces each sharded parameter or buffer of a module by
this rank's block, tagged with a ``MeshShard`` (``shard_of``) that the mesh
ops read; ``full_tensor`` gathers a block back.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from gdmcf_torch.parallel.mesh import axis_group, axis_index, axis_size

Spec = Tuple  # (placement over dp, placement over mp)

# (regex over the state_dict name, spec); the first match wins
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    (r"embedding_item$", (Replicate(), Shard(0))),
    # the user table row-sharded over mp; the backbones gather it through
    # the sharded lookup (parallel/embed.py), never all-gathered
    (r"embedding_user$", (Replicate(), Shard(0))),
    (r"(^|\.)in_layers\.0\.weight$", (Replicate(), Shard(1))),
    (r"(^|\.)in_layers2\.0\.weight$", (Replicate(), Shard(1))),
    (r"(^|\.)cat_layer\.weight$", (Replicate(), Shard(0))),
    (r"(^|\.)out_layers\.(\d+)\.weight$", (Replicate(), Replicate())),
    (r"frozen_lgn_(user|item)$", (Replicate(), Shard(0))),
    (r".*", (Replicate(), Replicate())),
]

REPLICATED: Spec = (Replicate(), Replicate())


class MeshShard(NamedTuple):
    """A tensor that is this rank's block of a parameter sharded over mp:
    ``dim`` of the full tensor is cut into ``count`` equal blocks, this is
    block ``index``; ``group`` is the mp process group."""

    dim: int
    index: int
    count: int
    group: object


def _rank_mismatch(spec: Spec, shape) -> bool:
    """The rules shard matrices and tables (the JAX specs have two
    entries): a tensor of lower rank, or without the dimension, stays
    replicated."""
    return any(isinstance(p, Shard) and (len(shape) < 2 or p.dim >= len(shape))
               for p in spec)


def compatible_spec(spec: Spec, shape, mesh) -> Spec:
    """Replace every ``Shard(d)`` whose dimension the axis size does not
    divide (or that the tensor does not have) by ``Replicate()``: the
    blocks must be equal. Returns a possibly reduced spec."""
    if _rank_mismatch(spec, shape):
        return REPLICATED
    out = []
    for axis, p in zip(("dp", "mp"), spec):
        if isinstance(p, Shard) and shape[p.dim] % axis_size(mesh, axis):
            p = Replicate()
        out.append(p)
    return tuple(out)


def spec_for(name: str, shape, rules=None, mesh=None) -> Spec:
    for pattern, spec in rules or DEFAULT_RULES:
        if re.search(pattern, name):
            # never shard a dim the leaf doesn't have
            if _rank_mismatch(spec, shape):
                return REPLICATED
            return (compatible_spec(spec, shape, mesh)
                    if mesh is not None else spec)
    return REPLICATED


def _named_tensors(model_or_named) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_named, torch.nn.Module):
        return dict(model_or_named.state_dict(keep_vars=True))
    return dict(model_or_named)


def param_specs(model_or_named, rules=None, mesh=None) -> Dict[str, Spec]:
    """{name: spec} for every parameter and buffer (a module's state_dict,
    or a {name: tensor} dict), by the first matching rule; with a mesh,
    reduced by ``compatible_spec``."""
    return {k: spec_for(k, tuple(v.shape), rules, mesh)
            for k, v in _named_tensors(model_or_named).items()}


def shard_of(t: torch.Tensor) -> Optional[MeshShard]:
    """The ``MeshShard`` of a sharded block, None for a replicated tensor."""
    return getattr(t, "mesh_shard", None)


def local_block(full: torch.Tensor, shard: MeshShard) -> torch.Tensor:
    """This rank's block of a full tensor (a view)."""
    width = full.shape[shard.dim] // shard.count
    return full.narrow(shard.dim, shard.index * width, width)


def full_tensor(t: torch.Tensor, shard: Optional[MeshShard] = None
                ) -> torch.Tensor:
    """The whole tensor of a block (an all-gather over mp; collective), or
    ``t`` itself (not a copy) when it is replicated. ``shard`` defaults to the block's
    own tag (moments pass their parameter's)."""
    shard = shard or shard_of(t)
    if shard is None:
        return t
    from gdmcf_torch.parallel.collectives import all_gather_list

    return torch.cat(all_gather_list(t.detach(), shard.group), dim=shard.dim)


def shard_params(model: torch.nn.Module, mesh, rules=None
                 ) -> Dict[str, Spec]:
    """Replace every tensor the rules shard by this rank's block (a
    contiguous copy, so the full tensor is freed), tag it with its
    ``MeshShard``, and return {name: spec} of every tensor."""
    specs = param_specs(model, rules, mesh)
    shards = {}
    for name, spec in specs.items():
        if isinstance(spec[0], Shard):
            raise ValueError(f"{name}: parameters are replicated over dp")
        if isinstance(spec[1], Shard):
            shards[name] = MeshShard(spec[1].dim, axis_index(mesh, "mp"),
                                     axis_size(mesh, "mp"),
                                     axis_group(mesh, "mp"))
    for name, shard in shards.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        old = getattr(owner, leaf)
        block = local_block(old.detach(), shard).contiguous().clone()
        if isinstance(old, torch.nn.Parameter):
            new = torch.nn.Parameter(block, requires_grad=old.requires_grad)
            setattr(owner, leaf, new)
        else:
            new = block
            owner.register_buffer(leaf, new)
        new.mesh_shard = shard
    return specs


def describe(spec: Spec) -> str:
    """'dp:Replicate() mp:Shard(1)' for a placement log line."""
    return " ".join(
        f"{a}:" + (f"Shard({p.dim})" if isinstance(p, Shard) else "Replicate()")
        for a, p in zip(("dp", "mp"), spec))


def batch_spec() -> Spec:
    """Input rows [B, n_item]: the batch over dp, replicated over mp (each
    mp rank holds its dp group's rows whole; the mesh ops take their
    catalog block of them)."""
    return (Shard(0), Replicate())


def index_spec() -> Spec:
    return (Shard(0), Replicate())

