"""Row-sharded embedding lookup (port of the JAX package's
``parallel/embed.py``).

At the 10M-user / 1M-item scale the user and item tables cannot be
replicated on every device. They are row-sharded over mp; a lookup of ids
[B] on each rank is

    local  = table_block[clip(ids - row_offset)] masked to the block's rows
    result = sum over mp of local

Each rank touches only its own rows; B x D crosses the axis once. The sum's
backward is the identity (every mp rank uses the replicated result alike,
``collectives.sum_over``), so the masked gather's backward scatters the
gradient into the owning rank's block alone: no table-sized all-reduce
over mp.

CONTRACT: ids must lie in [0, N). An out-of-range id is owned by no block
and comes back as a zero row, silently; the data layer refuses such ids at
ingest.
"""

from __future__ import annotations

import torch

from gdmcf_torch.parallel.collectives import sum_over
from gdmcf_torch.parallel.mesh import axis_group, axis_index, axis_size
from gdmcf_torch.parallel.sharding import MeshShard, shard_of


def _local_lookup(block: torch.Tensor, ids: torch.Tensor,
                  shard: MeshShard) -> torch.Tensor:
    rows = block.shape[0]
    local_ids = ids.long() - shard.index * rows
    in_range = (local_ids >= 0) & (local_ids < rows)
    gathered = block[local_ids.clamp(0, rows - 1)]
    local = torch.where(in_range[:, None], gathered,
                        gathered.new_zeros(()))
    return sum_over(local, shard.group)


def sharded_embedding_lookup(mesh, table: torch.Tensor, ids: torch.Tensor,
                             axis_name: str = "mp") -> torch.Tensor:
    """table: this rank's row block of an [N, D] table sharded over
    ``axis_name``; ids: [B] (this rank's ids: a dp-sharded batch's block).
    Returns [B, D], replicated over that axis. Differentiable: the gradient
    lands on the owning block only."""
    shard = MeshShard(0, axis_index(mesh, axis_name),
                      axis_size(mesh, axis_name), axis_group(mesh, axis_name))
    return _local_lookup(table, ids, shard)


def lookup_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, sharded when ``table`` is a row block
    (``shard_params`` tagged it)."""
    shard = shard_of(table)
    if shard is None:
        return table[ids]
    if shard.dim != 0:
        raise ValueError("a lookup table must be sharded by rows")
    return _local_lookup(table, ids, shard)
