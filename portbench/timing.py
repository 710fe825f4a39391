"""Device timing of one operation alone (copied from ``chip_smoke.py``'s
``time_ms`` and ``wall_ms``), and of a captured graph of it.

:func:`time_ms` queues ``reps`` calls behind a sleep kernel with a CUDA
event between each and takes the median per-call device time, so the
host's launch cost is hidden as long as the queue stays ahead.
:func:`graph_ms` captures the call once in a CUDA graph (as the training
step runs it) and times the graph's replays, so a call of many small
kernels is timed without the host's launch gaps.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall milliseconds of single synchronised calls (after one
    warm-up call), launch cost included."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def time_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call: the median of ``reps`` CUDA-event
    timings of calls queued back to back behind a sleep kernel."""
    wall = wall_ms(fn) / 1e3
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    sleep_s = 0.005 + 2 * wall * reps
    torch.cuda._sleep(int(2e9 * sleep_s))  # clock64 cycles at ~2 GHz
    t0 = time.perf_counter()
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    queued = time.perf_counter() - t0 < sleep_s
    events[-1].synchronize()
    if not queued:
        print("timing: the host fell behind the device; device time includes launch gaps",
              file=sys.stderr)
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def graph_ms(fn, reps: int = 20) -> float:
    """:func:`time_ms` of ``fn`` captured in one CUDA graph."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):  # the warm-up's stream, as the trainer's
        fn()
    torch.cuda.synchronize()
    try:
        return time_ms(graph.replay, reps)
    finally:
        del graph
