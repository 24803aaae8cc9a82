"""bpr_sample_ms.pretrain: the host's BPR sampling a step, in ms: the time
of the program's span ``gdmcf.bpr.sample`` (the batch's users and
``NativeCSR.sample_bpr``) over the traced window's steps. Silent without
the span or steps."""

from h100bench import spans

SPAN = "gdmcf.bpr.sample"


def read(run):
    t, steps = spans.totals(), run["counters"].get("steps")
    if not t or SPAN not in t or not steps:
        return None
    return 1e3 * t[SPAN][1] / steps
