"""graph_replay_share.eval: the share of the traced window's evaluation
batches that ran in CUDA-graph replays: K (``eval_batches_per_call``)
times the count of the program's span ``gdmcf.graphs.eval.replay`` over
the count of ``gdmcf.eval.assemble`` (the batches). 0 when the program's
spans hold no replay; silent without batches."""

from h100bench import spans

SPAN = "gdmcf.graphs.eval.replay"


def read(run):
    t = spans.totals()
    batches = spans.count(t, "gdmcf.eval.assemble")
    if not batches:
        return None
    k = run["config"]["recipe"]["eval_batches_per_call"]
    return 100.0 * k * spans.count(t, SPAN) / batches
