"""spmm_rows_roofline.pretrain: the SpMM kernel (``spmm_rows_kernel``,
``gdmcf_torch/csrc/spmm.cu``) in LightGCN pretraining, its launches'
least time over their device time in the traced window.

Least time: each direction's least bytes a launch (``costs_lightgcn.
spmm_bytes``: values and column ids, the segment arrays, the x rows read
and the output, each once) times its launches in the window (the port's
``ops.spmm.LAUNCHES``), over the card's 3.35 TB/s. Silent without a trace,
without launches, or when the trace holds no such kernel."""

from h100bench.costs import HBM_BYTES_PER_S

KERNEL = "spmm_rows_kernel"
DIRECTIONS = ("spmm_rows_fwd", "spmm_rows_t")


def read(run):
    tr, c = run["trace"], run["counters"]
    if tr is None or not all(f"{d}_bytes" in c for d in DIRECTIONS):
        return None
    least = sum(c[f"{d}_bytes"] * c[f"{d}_launches"] for d in DIRECTIONS)
    seconds, names = tr.op_seconds(KERNEL)
    if not names or seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / HBM_BYTES_PER_S / seconds
