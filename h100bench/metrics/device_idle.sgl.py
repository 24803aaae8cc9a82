"""device_idle.sgl: the share of the traced SGL-ED window in which no
operation ran on the device (the union of its activity intervals)."""


def read(run):
    tr = run["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
