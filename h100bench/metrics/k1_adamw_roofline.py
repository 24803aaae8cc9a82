"""k1_adamw_roofline: K1 (``ops/fused_adamw._adamw_kernel``), its pass's
least time over its measured time.

Least time: 20 bytes an updated element over the card's 3.35 TB/s (bytes
bound it). Measured: the device seconds of the kernel in the traced window
over the passes (one a step). Silent when the trace holds no such
kernel."""

from h100bench import costs

KERNEL = "_adamw_kernel"


def read(run):
    tr, c = run["trace"], run["counters"]
    if tr is None or not c.get("steps"):
        return None
    seconds, names = tr.op_seconds(KERNEL)
    if not names or seconds <= 0:
        return None
    return 100.0 * costs.adamw_bound_s(c["params"]) / (seconds / c["steps"])
