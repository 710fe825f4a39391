"""Spans, counters and timing helpers: the port's counterpart of
``healnet_tpu/utils/profiling.py``.

- :func:`span` and :func:`count`: named host intervals and counters where
  the program does its work (the fold loop, the fused epochs), kept in
  memory inside :func:`recording`. While a ``torch.profiler`` session runs,
  a span is also a ``record_function`` range: a host range of the
  profiler's trace, on the clock of the device's kernels and copies. With
  neither on, a span costs two flag reads and a count one;
- :func:`enable_compilation_cache`: where the port keeps what it compiles
  (its nvcc builds of ``ops/csrc`` and the host runtime library), which
  later processes reuse;
- :func:`log_compile_time`: first-call against steady-state latency of a
  function.

No span or count may sit where a CUDA graph captures (a step body, the
model): it would run once, at the capture, and never at a replay.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@dataclass
class Span:
    """One span: its name, the index of the span it opened inside
    (``parent``, None for an outermost one), the index of the outermost
    span it lies in (``root``, its own for an outermost one) and its
    start and end on ``time.perf_counter_ns``."""

    name: str
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Record:
    """What :func:`recording` kept: the spans in the order they opened and
    the counters by name."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    open: List[int] = field(default_factory=list, repr=False)


_record: Optional[Record] = None
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record every span and count of the enclosed block; yields the
    :class:`Record`, filled as the block runs. Nothing is written out. A
    recording opened inside another keeps what its block records to
    itself."""
    global _record
    outer, _record = _record, Record()
    try:
        yield _record
    finally:
        _record = outer


def is_recording() -> bool:
    return _record is not None


def span(name: str):
    """A context manager around a stretch of the program's host work,
    recorded under ``name`` inside :func:`recording` and mirrored into the
    trace of a running ``torch.profiler`` session."""
    if _record is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _span(name)


@contextlib.contextmanager
def _span(name: str):
    record = _record
    mirror = (torch.profiler.record_function(name) if _autograd_profiler._is_profiler_enabled
              else _NULL)
    with mirror:
        if record is None:
            yield
            return
        index = len(record.spans)
        parent = record.open[-1] if record.open else None
        root = index if parent is None else record.spans[parent].root
        record.spans.append(Span(name, parent, root, time.perf_counter_ns()))
        record.open.append(index)
        try:
            yield
        finally:
            record.open.pop()
            record.spans[index].end_ns = time.perf_counter_ns()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open recording, if any."""
    record = _record
    if record is None:
        return
    record.counters[name] = record.counters.get(name, 0) + n


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
