"""mfu.train (%, the training step as a whole): the model's operations in
the window's folds (``portbench/counts.py::fold_flops``: forward and
backward of every training sample and the validation forwards, over the
real bag lengths, no recompute) over those folds' wall and the card's
dense bf16 peak. The folds after the traced one, where there are any:
the profiler slows the fold it traces and takes seconds to close."""

from portbench.counts import PEAK_FLOPS_BF16


def read(ctx):
    w = ctx.window
    skip = w["traced_folds"] if len(w["fold_walls"]) > w["traced_folds"] else 0
    flops, wall = sum(w["fold_flops"][skip:]), sum(w["fold_walls"][skip:])
    if not flops or wall <= 0:
        return None
    return 100.0 * flops / wall / PEAK_FLOPS_BF16
