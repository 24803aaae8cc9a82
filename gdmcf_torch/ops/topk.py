"""Exact chunked top-k with lowest-index tie order.

Counterpart of the JAX package's ``ops/topk.py:chunked_topk``. ``lax.top_k``
breaks ties toward the lowest index and tie order alone can move recall;
``torch.topk`` promises no tie order, so both stages here use a stable
descending sort, which keeps equal values in index order."""

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
