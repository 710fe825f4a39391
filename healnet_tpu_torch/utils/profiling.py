"""Tracing and timing helpers: the port's counterpart of
``healnet_tpu/utils/profiling.py``.

- :func:`trace`: ``torch.profiler`` over the enclosed block, written as a
  Chrome trace (``trace.json``) into ``log_dir``;
- :class:`StepTimer`: wall-clock step statistics whose ``stop`` fences on
  the device: CUDA work is asynchronous, so it synchronises the card before
  reading the clock;
- :func:`enable_compilation_cache`: where the port keeps what it compiles
  (its nvcc builds of ``ops/csrc`` and the host runtime library), which
  later processes reuse;
- :func:`log_compile_time`: first-call against steady-state latency of a
  function.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def enable_compilation_cache(directory: Optional[str] = None,
                             min_compile_secs: float = 0.5) -> None:
    """Keep the compiled kernels and the runtime library under ``directory``
    (``kernels-<hash>/``, ``runtime-<hash>/``), where later processes load
    them instead of compiling again. The default, None, leaves them where
    they are: ``build/`` at the root of the checkout. ``min_compile_secs``
    is kept from the JAX signature; every build is kept."""
    del min_compile_secs
    if directory is None:
        return
    from healnet_tpu_torch import runtime
    from healnet_tpu_torch.ops import cuda_build

    cuda_build.BUILD_ROOT = Path(directory)
    runtime.BUILD_ROOT = Path(directory)


@contextlib.contextmanager
def trace(log_dir: str = "logs/torch-trace"):
    """Profile the enclosed block (host and, where present, CUDA activity)
    and write ``<log_dir>/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StepTimer:
    """Accumulates fenced step timings; report percentiles and throughput."""

    def __init__(self, samples_per_step: int = 1):
        self.samples_per_step = samples_per_step
        self._durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, fence=None) -> float:
        """End the step. ``fence``: a tensor (or a device) whose device's
        queued work the step waits for; on a CUDA device that is
        ``torch.cuda.synchronize``. None waits for nothing."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() called before start()")
        if fence is not None:
            device = fence.device if isinstance(fence, torch.Tensor) else torch.device(fence)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self._durations.append(dt)
        return dt

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        ds = np.asarray(self._durations[skip_warmup:] or self._durations)
        if ds.size == 0:  # no steps recorded: well-defined empty summary
            return {
                "steps": 0, "mean_s": float("nan"), "p50_s": float("nan"),
                "p95_s": float("nan"), "samples_per_sec": float("nan"),
            }
        return {
            "steps": len(ds),
            "mean_s": float(ds.mean()),
            "p50_s": float(np.percentile(ds, 50)),
            "p95_s": float(np.percentile(ds, 95)),
            "samples_per_sec": float(self.samples_per_step / ds.mean()),
        }



def log_compile_time(fn: Callable, name: Optional[str] = None) -> Callable:
    """Wrap ``fn``; print its first call's latency ("incl. compile", in
    seconds) and its second's ("steady-state dispatch", in milliseconds).

    Like the JAX package's, it times the Python call and does not
    synchronise: on the card a call that returns a device tensor is timed
    to its launch, one that returns host data (a numpy array) to its end.
    A first call there can include nvcc's build of the port's kernels
    (:mod:`healnet_tpu_torch.ops.cuda_build`) and cuDNN's set-up."""
    label = name or getattr(fn, "__name__", "fn")
    state = {"calls": 0, "first": None}

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        state["calls"] += 1
        if state["calls"] == 1:
            state["first"] = dt
            print(f"[{label}] first call (incl. compile): {dt:.2f}s")
        elif state["calls"] == 2:
            print(f"[{label}] steady-state dispatch: {dt * 1e3:.2f}ms")
        return out

    return wrapped
