"""busy_ms_per_step.train (ms, fused epochs): the card's busy time in the
traced fold over the training steps the fold took."""


def read(ctx):
    if ctx.summary is None or not ctx.traced_steps:
        return None
    return 1e3 * ctx.summary.busy_s / ctx.traced_steps
