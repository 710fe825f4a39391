"""validation_share.train (%, fold loop): the share of the recorded folds'
``fit`` time spent in validation (the program's ``fit.validate`` spans,
``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    total = spans.seconds(rec, "fit")
    return 100.0 * spans.seconds(rec, "fit.validate") / total if total > 0 else None
