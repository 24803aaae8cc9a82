"""train_mfu.sgl: the whole SGL-ED step's share of the card's TF32 peak.

The step's least flops (``costs_sgl``): the whole-table InfoNCE's
``6 B D (n_user + n_item)`` times the window's steps, plus ``2 nnz D`` for
each ``spmm_rows`` launch of the window on its operand's nonzeros; over
the traced window's seconds, over 495 TFLOP/s, the peak ``train_mfu``
uses. Silent without a trace, without device activity in it or
without steps."""

from h100bench import costs, costs_sgl


def read(run):
    tr, c = run["trace"], run["counters"]
    if tr is None or not c.get("steps") or tr.busy_s <= 0 \
            or "infonce_flops_per_step" not in c:
        return None
    flops = c["infonce_flops_per_step"] * c["steps"] + sum(
        c[f"{k}.launches"] * costs_sgl.spmm_flops(c[f"{k}.nnz"], c["dim"])
        for k in costs_sgl.spmm_keys(c))
    return 100.0 * flops / tr.window_s / costs.TF32_FLOPS
