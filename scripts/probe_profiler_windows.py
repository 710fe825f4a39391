#!/usr/bin/env python3
"""Which ``torch.profiler`` windows come back without device kernels.

    python3 scripts/probe_profiler_windows.py [--windows 40]

Needs one CUDA GPU and nvcc. ``chip_smoke.device_profile`` has seen windows
of three short calls return no device kernel right after windows of
training steps (phase 8 after phase 7). This script loads the profiler the
same way (three windows of three training steps of a small HealNet model
on the flash and projection kernels, a backward in autograd's thread),
then profiles ``--windows`` short windows of three projection calls (one
kernel each, launched through ``ctypes``) in each of four ways, in turns:

- ``stop``: the profiler stops right after the closing synchronise;
- ``pad``: the window stays open 50 ms before the first call and after
  the closing synchronise (what ``device_profile`` does now);
- ``gc``: as ``stop``, with the earlier windows' profiler objects released
  (``gc.collect()``) before each window;
- ``held``: as ``stop``, with every earlier window's profiler object kept
  alive.

For each way it prints the windows with no device kernel and with fewer
than three, and, over the windows that saw kernels, how far the first
kernel's start lies after the first launch call's start on the profiler's
clock (a kernel cannot start before its launch: a negative gap is an
offset between the device's and the host's clocks, which would move a
short window's kernels out of its range).
"""

from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from healnet_tpu_torch.models.healnet import HealNetModule  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops.fused_project import fused_kv_project  # noqa: E402
from healnet_tpu_torch.train.loop import SurvivalTrainer  # noqa: E402

PAD_S = 0.05


def window(fn, pad: float = 0.0):
    """(device kernels seen, first kernel start minus first launch start in
    us or None, the profile) of three calls of ``fn``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if pad:
            time.sleep(pad)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = [e for e in events if e.name.startswith(("cudaLaunch", "cuLaunch"))]
    gap = None
    if kernels and launches:
        gap = (min(e.time_range.start for e in kernels)
               - min(e.time_range.start for e in launches))
    return len(kernels), gap, prof


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=40)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_profiler_windows: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    cuda_build.build(("fused_project", "fused_project_tma", "fused_project_f32",
                      "fused_project_bwd", "flash_attention", "flash_attention_bwd"))
    rng = np.random.default_rng(0)
    module = HealNetModule(n_modalities=2, channel_dims=(40, 64), num_spatial_axes=(1, 1),
                           out_dims=4, depth=2, l_c=17, l_d=32, x_heads=1, cross_dim_head=16,
                           self_per_cross_attn=0, attn_dropout=0.1, ff_dropout=0.2,
                           attention_impl="flash", device="cuda")
    trainer = SurvivalTrainer(module, l1=1e-6, device="cuda")
    batch = {"tensors": (rng.normal(size=(8, 1, 40)).astype(np.float32),
                         rng.normal(size=(8, 512, 64)).astype(np.float32)),
             "y_disc": rng.integers(0, 4, 8), "censorship": np.zeros(8, np.float32),
             "event_time": np.ones(8, np.float32), "sample_mask": np.ones(8, np.float32)}
    step = lambda: trainer.train_step(batch, 100)  # noqa: E731
    ctx = torch.randn((8, 4096, 2048), device="cuda").to(torch.bfloat16)
    enc = torch.randn((4096, 5), device="cuda").to(torch.bfloat16)
    w = torch.randn((2053, 252), device="cuda") * 0.02
    b = torch.zeros(252, device="cuda")
    short = lambda: fused_kv_project(ctx, enc, w, b, eps=1e-5)  # noqa: E731
    for _ in range(3):
        step()
        short()
    torch.cuda.synchronize()
    held = [window(step)[2] for _ in range(3)]
    seen = {"stop": [], "pad": [], "gc": [], "held": []}
    gaps = {way: [] for way in seen}
    for _ in range(args.windows):
        for way in seen:
            if way == "gc":
                gc.collect()
            count, gap, prof = window(short, pad=PAD_S if way == "pad" else 0.0)
            seen[way].append(count)
            if gap is not None:
                gaps[way].append(gap)
            if way == "held":
                held.append(prof)
            del prof
    for way, counts in seen.items():
        g = gaps[way]
        gap_line = (f"first kernel start - first launch start min {min(g):.1f}, median "
                    f"{statistics.median(g):.1f}, max {max(g):.1f} us" if g else "no gaps")
        print(f"{way}: {sum(c == 0 for c in counts)} of {len(counts)} windows saw no device "
              f"kernel, {sum(c < 3 for c in counts)} fewer than 3; {gap_line}; kernels seen per "
              f"window: {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
