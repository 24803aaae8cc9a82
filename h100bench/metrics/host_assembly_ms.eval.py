"""host_assembly_ms.eval: the host's time on one evaluation batch outside
its fused group, in ms: the self time of the program's spans
``gdmcf.eval.assemble`` (the union of its rows and mask),
``gdmcf.eval.ground_truth`` (its ground truth's gather and copy) and
``gdmcf.eval.metrics`` (its metric sums enqueued, a wait for the device
included where the enqueue waits) over the count of
``gdmcf.eval.assemble`` (the window's batches). Silent without those
spans."""

from h100bench import spans

PER_BATCH = ("gdmcf.eval.assemble", "gdmcf.eval.ground_truth",
             "gdmcf.eval.metrics")


def read(run):
    t = spans.totals()
    batches = spans.count(t, PER_BATCH[0])
    if not batches:
        return None
    return 1e3 * sum(t[n][2] for n in PER_BATCH if n in t) / batches
