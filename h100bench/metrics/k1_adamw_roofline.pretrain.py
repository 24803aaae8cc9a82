"""k1_adamw_roofline.pretrain: K1 (``ops/fused_adamw._adamw_kernel``) with
float32 moments in LightGCN pretraining, its pass's least time over its
measured time.

Least time: 28 bytes an element of the table (p, g, mu and nu read at 4;
p, mu and nu written at 4) over the card's 3.35 TB/s. Measured: the
kernel's device seconds in the traced window over the window's steps (one
pass a step). Silent when the trace holds no such kernel."""

from h100bench import costs_lightgcn

KERNEL = "_adamw_kernel"


def read(run):
    tr, c = run["trace"], run["counters"]
    if tr is None or not c.get("steps") or not c.get("params"):
        return None
    seconds, names = tr.op_seconds(KERNEL)
    if not names or seconds <= 0:
        return None
    return 100.0 * costs_lightgcn.adamw_bound_s(c["params"]) \
        / (seconds / c["steps"])
