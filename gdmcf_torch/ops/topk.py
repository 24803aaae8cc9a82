"""Exact chunked top-k with lowest-index tie order, and its sharded form.

Counterpart of the JAX package's ``ops/topk.py``. ``lax.top_k`` breaks ties
toward the lowest index and tie order alone can move recall; ``torch.topk``
promises no tie order, so every stage here uses a stable descending sort,
which keeps equal values in index order.

``sharded_topk`` ranks a score matrix whose catalog axis is split over the
mesh's mp ranks: each rank selects the top-k of its block of columns, only
[B, k] values and global ids cross the axis (all-gathered in shard order),
and a stable merge picks the global top-k. Candidates are shard-major and
rank-minor, which is index order among equal values, so ties still go to
the lowest global index."""

from __future__ import annotations

from typing import Tuple

import torch


def _stable_topk(scores: torch.Tensor, k: int):
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def chunked_topk(scores: torch.Tensor, k: int, chunk: int = 512
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk select, then a merge over the chunk-major, rank-minor
    candidates (index order among equal values). Returns (values,
    indices) [B, k], like ``lax.top_k``."""
    b, n = scores.shape
    if n <= max(2 * k, chunk):
        return _stable_topk(scores, k)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad),
                                         value=float("-inf"))
    kc = min(k, chunk)
    vals, idx = _stable_topk(scores.view(b, n_chunks, chunk), kc)
    offs = torch.arange(n_chunks, device=scores.device) * chunk
    gidx = idx + offs[None, :, None]
    mvals, mpos = _stable_topk(vals.reshape(b, n_chunks * kc), k)
    midx = torch.gather(gidx.reshape(b, n_chunks * kc), 1, mpos)
    # padded columns win only in all--inf rows; keep their ids in range
    return mvals, (midx.clamp_max(n - 1) if pad else midx)


def merge_shards(vals, gidx, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k of per-shard candidates: ``vals``/``gidx`` are
    lists of [B, k] blocks in shard order."""
    flat_vals = torch.cat(list(vals), dim=1)
    flat_idx = torch.cat(list(gidx), dim=1)
    mvals, mpos = _stable_topk(flat_vals, k)
    return mvals, torch.gather(flat_idx, 1, mpos)


def topk_local_merge(scores: torch.Tensor, k: int, group
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of columns [B, n_local] (block ``rank`` of the
    group) -> local top-k -> all-gather over ``group`` -> merge. Returns
    (values [B, k], global column ids [B, k]), equal on every rank."""
    from gdmcf_torch.parallel.collectives import all_gather_list

    import torch.distributed as dist

    vals, idx = chunked_topk(scores, k)
    gidx = idx + dist.get_rank(group) * scores.shape[1]
    return merge_shards(all_gather_list(vals, group),
                        all_gather_list(gidx, group), k)


def sharded_topk(mesh, scores: torch.Tensor, k: int,
                 axis_name: str = "mp") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the catalog axis split over ``axis_name``. ``scores``:
    this rank's [B, n] rows (n a multiple of the axis size; the caller
    pads with -inf); the rank ranks its block of n / size columns.
    Output (values, indices) [B, k], replicated over the axis."""
    from gdmcf_torch.parallel.mesh import axis_group, axis_index, axis_size

    size = axis_size(mesh, axis_name)
    b, n = scores.shape
    if n % size:
        raise ValueError(f"{n} columns do not split over {axis_name}={size}:"
                         " pad the scores with -inf first")
    width = n // size
    lo = axis_index(mesh, axis_name) * width
    return topk_local_merge(scores[:, lo:lo + width], k,
                            axis_group(mesh, axis_name))
