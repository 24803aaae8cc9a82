"""train_mfu: the whole train step's share of the card's TF32 peak.

The model's matmul flops of a step from its shapes (``costs``), times the
steps of the traced window, over the window's seconds, over 495 TFLOP/s:
the port runs its float32 products as TF32 under ``compute_dtype``
bfloat16. Silent without a trace or without steps."""

from h100bench import costs


def read(run):
    tr, c = run["trace"], run["counters"]
    if tr is None or not c.get("steps") or tr.busy_s <= 0:
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / tr.window_s \
        / costs.TF32_FLOPS
