"""epoch_host_ms.train (ms, fold loop): the host's own work an epoch in
the recorded folds: drawing and grouping the batches (``fit.batches``),
packing and enqueueing the bucket uploads (``fused.upload``) and the loss
and c-index (``fit.metrics``), training's and validation's, over the
``fit.epoch`` spans (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    epochs = len(spans.in_folds(rec, "fit.epoch"))
    if not epochs:
        return None
    return 1e3 * spans.seconds(rec, "fit.batches", "fused.upload", "fit.metrics") / epochs
