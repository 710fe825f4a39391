"""peak_mem.train (GiB, device): ``torch.cuda.max_memory_allocated`` over
the window, its counter reset after set-up."""


def read(ctx):
    return ctx.peak_window_bytes / 2**30 if ctx.peak_window_bytes else None
