"""The port's spans and counters (``healnet_tpu_torch/utils/profiling.py``)
on the CPU: the recorder itself, the span tree a fused fold leaves, that a
fold with recording off records and constructs nothing, that spans mirror
into a running ``torch.profiler`` session, and that recording leaves the
fold's results bit-equal."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.train.loop import SurvivalTrainer
from healnet_tpu_torch.utils import profiling

CFG = dict(n_modalities=2, channel_dims=(10, 8), num_spatial_axes=(1, 1), out_dims=4,
           depth=1, l_c=4, l_d=8, x_heads=1, cross_dim_head=6, l_heads=1,
           latent_dim_head=4, self_per_cross_attn=0, num_freq_bands=2, max_freq=2.0,
           attn_dropout=0.2, ff_dropout=0.3)
WIDTHS = (4, 8)  # the two bucket widths
EPOCHS = 2


class Buckets:
    """A streaming arena source of 14 patients whose batches come in the
    two bucket widths, shuffled across buckets."""

    def __init__(self, seed=0, n=14):
        rng = np.random.default_rng(seed)
        self.lengths = np.asarray([2, 6] * (n // 2), np.int32)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int32)
        self.omic = rng.normal(size=(n, 1, 10)).astype(np.float32)
        self.y = rng.integers(0, 4, size=n).astype(np.int32)
        self.cens = (rng.uniform(size=n) < 0.4).astype(np.float32)
        self.time = rng.uniform(1, 100, size=n).astype(np.float32)
        self.arena = np.concatenate([rng.normal(size=(int(self.lengths.sum()), 8)),
                                     np.zeros((WIDTHS[-1], 8))]).astype(np.float32)

    def _chunks(self, idx, batch_size):
        out = []
        for lo, hi in zip((0,) + WIDTHS[:-1], WIDTHS):
            sel = [i for i in idx if lo < self.lengths[i] <= hi]
            out += [(hi, sel[s:s + batch_size]) for s in range(0, len(sel), batch_size)]
        return out

    def count_batches(self, indices, batch_size, boundaries):
        return len(self._chunks(range(len(self.lengths)), batch_size))

    def iter_batches(self, batch_size, shuffle=False, rng=None, bucket_boundaries=None):
        idx = np.arange(len(self.lengths))
        if shuffle:
            rng.shuffle(idx)
        chunks = self._chunks(list(idx), batch_size)
        for g in (rng.permutation(len(chunks)) if shuffle else range(len(chunks))):
            width, sel = chunks[g]
            mask = np.ones(batch_size, np.float32)
            mask[len(sel):] = 0.0
            sel = np.asarray(sel + [sel[-1]] * (batch_size - len(sel)))
            yield {"tensors": (self.omic[sel],),
                   "kv_masks": (None, np.arange(width)[None, :] < self.lengths[sel, None]),
                   "patch_offsets": self.offsets[sel], "patch_lengths": self.lengths[sel],
                   "y_disc": self.y[sel], "censorship": self.cens[sel],
                   "event_time": self.time[sel], "sample_mask": mask}


def _trainer(source, fused=True):
    module = HealNetModule(**CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    return SurvivalTrainer(module, batch_size=4, epochs=EPOCHS, l1=1e-4, max_lr=1e-3, seed=3,
                           early_stopping=False, device="cpu", feature_arena=source.arena,
                           fused_epochs=fused, prefetch=0)


def _children(record, index):
    return [i for i, s in enumerate(record.spans) if s.parent == index]


def _names(record, indices):
    return [record.spans[i].name for i in indices]


@pytest.fixture(scope="module")
def recorded():
    """A fused fit of two buckets, validating every epoch, under
    ``recording()``; its results, its record and the bucket count."""
    source = Buckets()
    with profiling.recording() as record:
        out = _trainer(source).fit(source, source, verbose=False)
    return out, record, len(WIDTHS)


def test_fused_fit_span_tree(recorded):
    out, record, buckets = recorded
    roots = [i for i, s in enumerate(record.spans) if s.parent is None]
    assert _names(record, roots) == ["fit"]
    assert all(s.root == roots[0] and s.end_ns is not None for s in record.spans)
    epochs = _children(record, roots[0])
    assert _names(record, epochs) == ["fit.epoch"] * EPOCHS
    for e in epochs:
        assert _names(record, _children(record, e)) == (
            ["fit.batches"] + ["fused.upload"] * buckets + ["fit.metrics", "fit.validate"])
        validate = _children(record, e)[-1]
        # evaluate's draw of the split, then the fused evaluation's grouping
        assert _names(record, _children(record, validate)) == (
            ["fit.batches", "fit.batches"] + ["fused.upload"] * buckets + ["fit.metrics"])
    assert not any(s.name == "fused.capture" for s in record.spans)
    for s in record.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = record.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert len(out["history"]) == EPOCHS


def test_cpu_fit_captures_nothing_and_counts_no_device_allocs(recorded):
    _, record, _ = recorded
    assert record.counters.get("fused.captures", 0) == 0
    assert "device_allocs" not in record.counters


def test_epoch_seconds_lie_inside_the_epoch_span(recorded):
    out, record, _ = recorded
    spans = [s for s in record.spans if s.name == "fit.epoch"]
    for h, s in zip(out["history"], spans):
        assert 0.0 < h["seconds"] <= s.seconds


def test_stepwise_fit_and_set_fold_spans():
    """A stepwise fold after ``set_fold``: two roots, no fused spans."""
    source = Buckets()
    trainer = _trainer(source, fused=False)
    with profiling.recording() as record:
        trainer.set_fold(seed=4)
        trainer.fit(source, source, verbose=False)
    roots = [i for i, s in enumerate(record.spans) if s.parent is None]
    assert _names(record, roots) == ["fold.set_fold", "fit"]
    assert {s.name for s in record.spans} == {"fold.set_fold", "fit", "fit.epoch", "fit.metrics",
                                             "fit.validate"}
    assert sum(s.name == "fit.validate" for s in record.spans) == EPOCHS


def test_recording_off_records_and_constructs_nothing(monkeypatch):
    """With no recording and no profiler a fold opens no span: a
    ``record_function`` made anywhere would raise."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    source = Buckets()
    with profiling.recording() as before:
        pass
    assert not profiling.is_recording()
    assert profiling.span("fit") is profiling.span("fit.epoch")  # the shared null context
    _trainer(source).fit(source, source, verbose=False)
    profiling.count("fused.captures")
    assert before.spans == [] and before.counters == {}


def test_same_results_with_recording_on_and_off():
    source = Buckets()
    off = _trainer(source).fit(source, source, verbose=False)
    with profiling.recording():
        on = _trainer(source).fit(source, source, verbose=False)
    for a, b in zip(off["history"], on["history"]):
        for key in ("train_loss", "train_c_index", "val_loss", "val_c_index"):
            assert a[key] == b[key] or (np.isnan(a[key]) and np.isnan(b[key])), key
    assert off["params"].keys() == on["params"].keys()
    for name, value in off["params"].items():
        assert torch.equal(value, on["params"][name]), name


@pytest.mark.parametrize("record", [False, True], ids=["mirror-only", "recorded-and-mirrored"])
def test_spans_mirror_into_the_profiler(record):
    source = Buckets()
    trainer = _trainer(source)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if record:
            with profiling.recording() as rec:
                trainer.fit(source, source, verbose=False)
        else:
            trainer.fit(source, source, verbose=False)
    names = {e.name for e in prof.events()}
    assert {"fit", "fit.epoch", "fit.batches", "fused.upload", "fit.metrics",
            "fit.validate"} <= names
    if record:
        assert sum(s.name == "fit.epoch" for s in rec.spans) == EPOCHS


def test_recorder_nests_counts_and_closes_on_error():
    with profiling.recording() as outer:
        profiling.count("a")
        profiling.count("a", 4)
        with profiling.span("x"):
            with pytest.raises(ValueError):
                with profiling.span("y"):
                    raise ValueError("inside y")
            with profiling.span("z"):
                pass
        with profiling.recording() as inner:
            with profiling.span("w"):
                profiling.count("b")
        with profiling.span("v"):
            pass
    assert outer.counters == {"a": 5} and inner.counters == {"b": 1}
    assert [(s.name, s.parent, s.root) for s in outer.spans] == [
        ("x", None, 0), ("y", 0, 0), ("z", 0, 0), ("v", None, 3)]
    assert [s.name for s in inner.spans] == ["w"] and outer.open == [] and inner.open == []
    assert all(s.end_ns >= s.start_ns for s in outer.spans + inner.spans)
    assert not profiling.is_recording()
