"""The program's own spans and counters (``healnet_tpu_torch.utils.profiling``)
over two folds, shared by the readers of the fold loop's metrics.

After the window, in a traced run only, :func:`record` builds a new trainer
on the cell's module, runs one fold unrecorded (it makes the trainer's
tables, as set-up's warm-up fold does), then records two folds (splits 1
and 2, the window's first two seeds) and keeps the record on ``ctx`` as
``ctx.program_spans``; a reader that finds it there uses it as it is. The
window's folds run with recording off. A program without the recorder
(no ``profiling.recording``) leaves ``ctx.program_spans`` None, and the
readers read nothing.
"""

from __future__ import annotations

import torch

from healnet_tpu_torch.utils import profiling
from portbench import program, traffic


def record(ctx):
    """The record of two folds, or None where the program keeps none."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    recording = getattr(profiling, "recording", None)
    if recording is None:
        return None
    cohort, mix, n_bins = ctx.cohort, ctx.mix, int(ctx.cfg["output_dims"])
    splits = [traffic.train_val_test_split(cohort.n, mix["split"]["train"], mix["split"]["test"],
                                           seed=k) for k in (1, 2)]
    trainer = program.build_trainer(ctx.module, ctx.cfg, mix, cohort, ctx.device)
    program.run_fold(trainer, cohort, splits[0], 1, traffic.fold_seed(ctx.seed, 2), n_bins)
    with recording() as rec:
        for k, split in enumerate(splits):
            program.run_fold(trainer, cohort, split, k + 1, traffic.fold_seed(ctx.seed, 3 + k),
                             n_bins)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    del trainer
    ctx.program_spans = rec
    return rec


def in_folds(rec, name: str):
    """The spans called ``name`` inside a ``fit`` span."""
    return [s for s in rec.spans if s.name == name and rec.spans[s.root].name == "fit"]


def seconds(rec, *names: str) -> float:
    """The summed seconds of the spans of ``names`` inside ``fit`` spans."""
    return sum(s.seconds for name in names for s in in_folds(rec, name))


def folds(rec) -> int:
    return sum(s.name == "fit" for s in rec.spans)
