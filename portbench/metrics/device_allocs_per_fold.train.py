"""device_allocs_per_fold.train (count, device): the allocator's device
allocations (``cudaMalloc``) in a fold's ``fit`` (the program's
``device_allocs`` counter, ``portbench/spans.py``), per recorded fold;
nothing off the card."""

from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not spans.folds(rec) or "device_allocs" not in rec.counters:
        return None
    return rec.counters["device_allocs"] / spans.folds(rec)
