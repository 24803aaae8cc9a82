"""view_build_s.sgl: one SGL view's host draw and operand build, in
seconds, on the host's clock: the set-up phase of that name in
``drivers/sgl_pretrain.py`` over the views it built (``view_build_s``:
the pretrainer's own clock of each view). The views are built at the
pretrainer's construction, before the traced window opens, so the span
``gdmcf.sgl.views`` records none of them in the cell, and the number
moves ``setup_s``. Silent without the counter."""


def read(run):
    return run["counters"].get("view_build_s")
