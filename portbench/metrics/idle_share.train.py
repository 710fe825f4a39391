"""idle_share.train (%, device): the share of the traced fold's window in
which no kernel, copy or set ran on the card (``portbench/trace.py``)."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
