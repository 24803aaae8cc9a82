"""The least bytes of LightGCN pretraining's kernels, from their operands.

- ``spmm_bytes(op, d)``: one ``spmm_rows`` launch (``gdmcf_torch/csrc/
  spmm.cu``) on a row operand at width ``d``, each byte read or written
  once: every nonzero's value and column id (8 B; the CSR implies its
  row), the segment arrays the kernel reads (``seg_ptr``, ``seg_row`` and
  ``seg_part``, and two ``row_seg_ptr`` entries for each row cut into
  several segments, whose part sums it joins), the rows of x the nonzeros
  touch and the output's rows. A copy of ``chip_smoke.py``'s
  ``nnz_bytes``, the count behind PERF.md's kernel table (0.0952 / 0.1056
  ms at the 1M x 200k operand at D 64), so that the yardstick stays as it
  is when that script changes.
  Bytes bound the kernel (2 flops a nonzero and column against 8 bytes
  a nonzero and 4 a column of x), so its least time is these bytes over
  the card's memory bandwidth.
- ``adamw_bound_s``: one K1 pass with float32 moments, 28 bytes an element
  (p, g, mu and nu read at 4; p, mu and nu written at 4).
"""

from __future__ import annotations

from h100bench.costs import HBM_BYTES_PER_S

ADAMW_F32_BYTES_PER_ELEMENT = 28


def operand_counts(op) -> dict:
    """The numbers of a row operand (``gdmcf_torch.ops.spmm.RowOperand``)
    that its launch's bytes follow from."""
    return {"nnz": int(op.cols.shape[0]),
            "n_out": int(op.row_ptr.shape[0] - 1),
            "n_seg": int(op.seg_row.shape[0]),
            "x_rows": int(op.cols.unique().numel()),
            "split_rows": int(op.seg_row[op.seg_part >= 0].unique().numel())}


def spmm_bytes(counts: dict, d: int) -> int:
    meta = 4 * (counts["n_seg"] + 1) + 8 * counts["n_seg"] \
        + 8 * counts["split_rows"]
    return counts["nnz"] * 8 + meta \
        + (counts["x_rows"] + counts["n_out"]) * d * 4


def adamw_bound_s(elements: int) -> float:
    return ADAMW_F32_BYTES_PER_ELEMENT * elements / HBM_BYTES_PER_S
