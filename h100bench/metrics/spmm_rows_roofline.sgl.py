"""spmm_rows_roofline.sgl: the SpMM kernel (``spmm_rows_kernel``) in SGL-ED
pretraining, its launches' least time over their device time in the
traced window.

Least time: ``spmm_rows_roofline.pretrain``'s formula over all six
operands (N, view 1 and view 2, each forward and transpose): each
operand's least bytes a launch (``costs_lightgcn.spmm_bytes``) times its
launches in the window (``RowOperand.launches``), over the card's 3.35
TB/s. Silent without a trace, without launches, or when the trace holds
no such kernel."""

from h100bench import costs_sgl
from h100bench.costs import HBM_BYTES_PER_S

KERNEL = "spmm_rows_kernel"


def read(run):
    tr, c = run["trace"], run["counters"]
    keys = costs_sgl.spmm_keys(c)
    if tr is None or not keys:
        return None
    least = sum(c[f"{k}.bytes"] * c[f"{k}.launches"] for k in keys)
    seconds, names = tr.op_seconds(KERNEL)
    if not names or seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / HBM_BYTES_PER_S / seconds
