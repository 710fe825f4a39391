"""A traced window: ``torch.profiler`` over one call, reduced in memory to
the device's busy time, its largest operations and its idle gaps.

The profiler keeps only device events that fall inside its window on the
host's clock, so the window stays open ``SETTLE_S`` before the call and
after its closing synchronise (``chip_smoke.py``'s ``device_profile``
margins); the measured span is the call's own ``record_function`` range.
Busy time is the union of every kernel's, copy's and set's device interval
inside that span; annotation ranges on the device (which span kernels
already counted) are left out. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

SETTLE_S = 0.05
SPAN = "portbench.traced"
# idle gaps shorter than this are counted together, not labelled one by one
SHORT_GAP_US = 20.0


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_events: int = 0


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _host_label(host, starts, mid: float, scan: int = 4096) -> str:
    """The innermost host event running at ``mid``: among the events that
    started by then, the latest-started one still running."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - scan, -1), -1):
        if host[j][1] >= mid:
            return host[j][2]
    return "host (no traced op)"


def _rows(prof):
    """(name, on the device, start us, end us, an annotation) of every
    event the profiler kept: from its raw kineto events, which reads a
    window of a million kernels in seconds where ``prof.events()`` takes
    minutes."""
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns() / 1e3, e.is_user_annotation())


def summarize(rows, top: int = 10) -> TraceSummary:
    """The summary of a traced window's events (times in microseconds)."""
    rows = list(rows)
    span = [r for r in rows if r[0] == SPAN and not r[1]]
    if not span:
        raise RuntimeError("the traced window's span is missing from the trace")
    lo, hi = span[0][2], span[0][3]
    device, host = [], []
    by_name: Dict[str, float] = defaultdict(float)
    for name, on_device, start, end, annotation in rows:
        start, end = max(start, lo), min(end, hi)
        if end <= start or name == SPAN:
            continue
        if on_device:
            if annotation:
                continue
            device.append((start, end))
            by_name[name] += (end - start) / 1e6
        else:
            host.append((start, end, name))
    merged = _merge(device)
    busy = sum(end - start for start, end in merged)
    gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(merged, merged[1:])]
    if merged:
        gaps = [(lo, merged[0][0])] + gaps + [(merged[-1][1], hi)]
    else:
        gaps = [(lo, hi)]
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for start, end in gaps:
        if end <= start:
            continue
        label = f"between kernels (< {SHORT_GAP_US:g} us)"
        if end - start >= SHORT_GAP_US:
            label = _host_label(host, starts, 0.5 * (start + end))
        idle[label][0] += (end - start) / 1e6
        idle[label][1] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gap_rows = sorted(((f"{name} x{n}", s) for name, (s, n) in idle.items()),
                      key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6, device_ops=ops,
                        idle_gaps=gap_rows, device_events=len(device))


def traced(fn):
    """``(fn(), profile)`` of one call under the profiler; reduce the
    profile with ``summarize(_rows(profile))`` once the window is over."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        with record_function(SPAN):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    return out, prof


def reduce(prof) -> TraceSummary:
    summary = summarize(_rows(prof))
    if summary.device_events == 0:
        raise RuntimeError("the traced window saw no device operation")
    return summary
