"""batch_wait_ms.train: the training loop's wait for its next batch from
the prefetch thread, in ms a step: the time of the program's span
``gdmcf.prefetch.wait`` (one a batch, and one for each epoch's end of the
stream) over the traced window's steps. Silent without the span or
steps."""

from h100bench import spans

SPAN = "gdmcf.prefetch.wait"


def read(run):
    t, steps = spans.totals(), run["counters"].get("steps")
    if not t or SPAN not in t or not steps:
        return None
    return 1e3 * t[SPAN][1] / steps
