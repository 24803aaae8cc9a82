"""Bit-packed wire format for binary interaction rows.

``pack_rows`` runs on the host (numpy); ``unpack_rows`` on the device
(torch). Little bit order: element ``8*j + i`` is bit ``i`` of byte ``j``.
"""

from __future__ import annotations

import numpy as np
import torch


def is_binary(a: np.ndarray) -> bool:
    """True iff every cell is exactly 0 or 1: only such rows may be packed
    (``pack_rows`` packs ``x != 0`` and would binarize counts)."""
    a = np.asarray(a)
    return bool(((a == 0) | (a == 1)).all())


def pack_rows(x: np.ndarray) -> np.ndarray:
    """Binary [..., n] (any dtype) -> uint8 [..., ceil(n/8)]."""
    return np.packbits(np.asarray(x) != 0, axis=-1, bitorder="little")


def unpack_rows(packed: torch.Tensor, n: int,
                dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., n8] -> [..., n] on the tensor's device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (8 * packed.shape[-1],))
    return flat[..., :n].to(dtype)
