"""capture_s_per_fold.train (s, fused epochs): the seconds of a fold's
graph captures, each bucket's eager warm-up step and capture (the
program's ``fused.capture`` spans, ``portbench/spans.py``), per recorded
fold."""

from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not spans.folds(rec):
        return None
    return spans.seconds(rec, "fused.capture") / spans.folds(rec)
