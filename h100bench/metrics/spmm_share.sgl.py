"""spmm_share.sgl: the SpMM kernel's (``spmm_rows_kernel``) share of the
device's busy seconds in the traced SGL-ED window. Silent without a trace
or without such a kernel in it."""

KERNEL = "spmm_rows_kernel"


def read(run):
    tr = run["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    seconds, names = tr.op_seconds(KERNEL)
    if not names:
        return None
    return 100.0 * seconds / tr.busy_s
