"""Each per-layer metric's reader on a tiny cell on the CPU: the trace
and counter readers' arithmetic, and the roofline readers' measured
call, which must run forward and backward through the port's module."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import program, traffic
from portbench.tests.tiny import tiny_files
from portbench.trace import TraceSummary

ROOT = Path(__file__).resolve().parents[2]
METRICS = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]]


def _reader(name):
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"),
                                                  ROOT / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ctx():
    _, cfg, mix, _ = tiny_files(precision="bf16")
    dev = torch.device("cpu")
    cohort = traffic.Cohort(cfg, mix, 5, dev)
    summary = TraceSummary(window_s=2.0, busy_s=1.5)
    window = dict(folds=3, samples=100, failed=0, wall_s=7.0, fold_walls=[5.0, 1.0, 1.0],
                  fold_flops=[1e12, 1e12, 1e12], traced_folds=1)
    return SimpleNamespace(summary=summary, window=window, traced_steps=20,
                           peak_window_bytes=3 * 2**30, module=program.build_module(cfg, dev),
                           cohort=cohort, cfg=cfg, mix=mix, device=dev, seed=5)


@pytest.mark.parametrize("name", METRICS)
def test_reader(ctx, name):
    reader = _reader(name)
    value = reader.read(ctx)
    if name.split(".")[0].endswith("_roofline"):
        assert value is None  # a device time: only on the card
        step, flops, nbytes = reader.work(ctx)
        step()
        assert flops > 0 and nbytes > 0
    else:
        want = {"idle_share.train": 25.0, "peak_mem.train": 3.0,
                "mfu.train": 100 * 1e12 / 989e12, "busy_ms_per_step.train": 75.0}[name]
        assert value == pytest.approx(want)
