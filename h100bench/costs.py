"""The card's peaks and the work of the flagship's calls, from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit (a run prints the card's limit beside them).

``flagship_matmul_flops`` is ``chip_smoke.py:677``'s train branch; the AdamW
bytes are K1's 20 bytes an element (``gdmcf_torch/ops/fused_adamw.py``'s
module docstring: p, g read at 4, the bfloat16 moments read at 2, p
written at 4, the moments written at 2).
"""

from __future__ import annotations

TF32_FLOPS = 495e12       # dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
ADAMW_BYTES_PER_ELEMENT = 20


def flagship_matmul_flops(dim: int, emb_size: int, n_item: int, batch: int,
                          gcn_layers: int = 2) -> float:
    """Matmul flops of one flagship train step (forward and backward) at
    ``batch``, from the shapes: the two towers, NT-Xent's [B, B]
    similarity, the GCN user rows and the cosine head. The backward of a
    tower needs only its weight gradient (the input has none); the others
    need both operand gradients."""
    d = dim
    d_item = 3 * d
    towers = 2 * batch * ((n_item + emb_size)
                          + (2 * n_item + emb_size)) * d
    gcn = 2 * batch * d_item * 512 * 2 if gcn_layers == 2 else 0
    rest = 2 * batch * d_item * n_item + gcn
    return 2 * towers + 3 * (rest + 2 * batch * batch * d)


def adamw_bound_s(elements: int) -> float:
    """The least time of one AdamW pass over ``elements``: bytes over the
    card's memory bandwidth (the pass does 16 float32 operations an
    element, so bytes bound it)."""
    return ADAMW_BYTES_PER_ELEMENT * elements / HBM_BYTES_PER_S
