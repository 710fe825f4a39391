"""``portbench/spans.py`` on the tiny cell on the CPU: it records two
whole folds of the program's spans, and the readers that read them give
finite values (no capture and no device allocation on the CPU); and each
reader's arithmetic on a synthetic record, to the exact value."""

import math
from types import SimpleNamespace

import pytest
import torch

from healnet_tpu_torch.utils.profiling import Record, Span
from portbench import HERE, load_file, program, spans, traffic
from portbench.tests.tiny import tiny_files

READERS = ("capture_s_per_fold.train", "captures_per_fold.train", "device_allocs_per_fold.train",
           "validation_share.train", "epoch_host_ms.train")

# (name, parent, start s, end s) of two recorded folds and a span outside them
SPANS = [("fold.set_fold", None, 0.0, 0.1),
         ("fit", None, 1.0, 5.0),
         ("fit.epoch", 1, 1.0, 3.0),
         ("fit.batches", 2, 1.0, 1.01),
         ("fused.upload", 2, 1.01, 1.03),
         ("fused.capture", 2, 1.03, 1.53),
         ("fit.metrics", 2, 1.6, 1.63),
         ("fit.validate", 2, 1.63, 2.63),
         ("fit.batches", 7, 1.63, 1.64),
         ("fit.metrics", 7, 2.6, 2.62),
         ("fit.epoch", 1, 3.0, 5.0),
         ("fit.validate", 10, 4.0, 4.5),
         ("fit", None, 6.0, 8.0),
         ("fit.epoch", 12, 6.0, 8.0),
         ("fused.capture", 13, 6.0, 6.3),
         ("fused.upload", 13, 6.3, 6.34),
         ("fit.validate", 13, 7.0, 7.25),
         ("fit.validate", None, 9.0, 19.0)]

WANT = {"capture_s_per_fold.train": (0.5 + 0.3) / 2, "captures_per_fold.train": 6.0,
        "device_allocs_per_fold.train": 95.0,
        "validation_share.train": 100 * (1.0 + 0.5 + 0.25) / (4.0 + 2.0),
        "epoch_host_ms.train": 1e3 * (0.01 + 0.02 + 0.03 + 0.01 + 0.02 + 0.04) / 3}


def _read(name, ctx):
    return load_file(HERE / "metrics" / f"{name}.py", "spans_reader_" + name.replace(".", "_")
                     ).read(ctx)


def _record():
    rec = Record(counters={"fused.captures": 12, "device_allocs": 190})
    for i, (name, parent, start, end) in enumerate(SPANS):
        root = i if parent is None else rec.spans[parent].root
        rec.spans.append(Span(name, parent, root, round(start * 1e9), round(end * 1e9)))
    return rec


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_record(name):
    assert _read(name, SimpleNamespace(program_spans=_record())) == pytest.approx(WANT[name])


@pytest.fixture(scope="module")
def ctx():
    _, cfg, mix, _ = tiny_files(precision="f32")
    dev = torch.device("cpu")
    cohort = traffic.Cohort(cfg, mix, 11, dev)
    ctx = SimpleNamespace(module=program.build_module(cfg, dev), cohort=cohort, cfg=cfg, mix=mix,
                          device=dev, seed=2**31 + 12345)
    spans.record(ctx)
    return ctx


def test_records_two_folds(ctx):
    rec = ctx.program_spans
    assert rec is spans.record(ctx)  # recorded once, then kept
    fits = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in fits] == ["fold.set_fold", "fit"] * 2
    assert spans.folds(rec) == 2
    assert len(spans.in_folds(rec, "fit.epoch")) == 2 * ctx.mix["epochs"]
    assert len(spans.in_folds(rec, "fit.validate")) == 2 * ctx.mix["epochs"]


@pytest.mark.parametrize("name", READERS)
def test_reader_on_the_cpu(ctx, name):
    value = _read(name, ctx)
    if name == "device_allocs_per_fold.train":
        assert value is None
    elif name == "captures_per_fold.train":
        assert value == 0
    else:
        assert value is not None and math.isfinite(value) and value >= 0
        if name == "validation_share.train":
            assert 0 < value < 100


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(spans.profiling, "recording")
    ctx = SimpleNamespace()
    assert spans.record(ctx) is None and ctx.program_spans is None
