"""group_dispatch_ms.eval: the host's side of one fused evaluation group,
in ms: the time of the program's span ``gdmcf.eval.group`` (the stack of
the group's batches and the fused call: the feed and the CUDA-graph
launch, waits inside them included) over its count. Silent without the
span."""

from h100bench import spans

SPAN = "gdmcf.eval.group"


def read(run):
    t = spans.totals()
    n = spans.count(t, SPAN)
    if not n:
        return None
    return 1e3 * t[SPAN][1] / n
