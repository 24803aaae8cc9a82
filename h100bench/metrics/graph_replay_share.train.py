"""graph_replay_share.train: the share of the traced window's train steps
that ran as CUDA-graph replays: K (``train_steps_per_call``) times the
count of the program's span ``gdmcf.graphs.train.replay`` over the
window's steps. 0 when the program's spans hold no replay; silent without
them or without steps."""

from h100bench import spans

SPAN = "gdmcf.graphs.train.replay"


def read(run):
    t, steps = spans.totals(), run["counters"].get("steps")
    if not t or not steps:
        return None
    k = run["config"]["recipe"]["train_steps_per_call"]
    return 100.0 * k * spans.count(t, SPAN) / steps
