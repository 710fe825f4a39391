"""captures_per_fold.train (count, fused epochs): the CUDA graphs a fold
captures (the program's ``fused.captures`` counter, ``portbench/spans.py``),
per recorded fold; none on the CPU."""

from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not spans.folds(rec):
        return None
    return rec.counters.get("fused.captures", 0) / spans.folds(rec)
