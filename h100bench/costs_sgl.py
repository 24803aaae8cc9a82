"""The least floating-point work of an SGL-ED step, from its shapes.

- ``infonce_flops(b, d, n_user, n_item)``: the whole-table InfoNCE of one
  step, ``6 * b * d * (n_user + n_item)``: for each side, the logits
  [b, n] = q [b, d] @ keys^T (2 b d n), the gradient at q (2 b d n) and at
  the keys (2 b d n), each once. A recomputation of the logits in the
  backward pass, as ``gdmcf_torch.models.sgl.info_nce`` runs, is not
  counted, so any implementation of the loss is judged on the same work.
- ``spmm_flops(nnz, d)``: one ``spmm_rows`` launch, 2 flops a nonzero and
  column. Its least bytes are ``costs_lightgcn.spmm_bytes``.
"""

from __future__ import annotations


def infonce_flops(b: int, d: int, n_user: int, n_item: int) -> int:
    return 6 * b * d * (n_user + n_item)


def spmm_flops(nnz: int, d: int) -> int:
    return 2 * nnz * d


def spmm_keys(counters: dict):
    """The operand keys (``spmm.<operand>_<direction>``) of a run's
    counters."""
    return sorted(k[:-len(".launches")] for k in counters
                  if k.startswith("spmm.") and k.endswith(".launches"))
