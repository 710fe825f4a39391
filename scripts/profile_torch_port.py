#!/usr/bin/env python3
"""Where the time goes in one serving micro-batch of the PyTorch port.

    python3 scripts/profile_torch_port.py [--reps 5]

Needs one CUDA GPU. Builds the full-width BRCA-tuned HealNet of
``chip_smoke.py`` (bf16, flash attention, fused projection kernel, batch 8,
4096-token WSI bag, random weights from a seeded generator) and profiles,
with ``torch.profiler``:

- the model's forward on inputs already on the card;
- one ``Predictor`` micro-batch from host arrays (upload included).

For each it prints the wall time per pass, the device's busy time per pass
(the sum of kernel and copy times), the idle share (1 - busy / wall), the
kernels and copies per pass, and those by device time. Then it prints the
host time to enqueue the forward and each of its kernel wrappers, with the
device queue absorbing the work.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import BATCH, OMIC, PATCH, TOKENS, brca_predictor  # noqa: E402
from healnet_tpu_torch.ops.flash_attention import flash_attention_kernel  # noqa: E402
from healnet_tpu_torch.ops.fourier import positional_encoding  # noqa: E402
from healnet_tpu_torch.ops.fused_project import (  # noqa: E402
    _prep,
    fused_kv_project,
    fused_project_kernel,
)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _on_device(evt) -> bool:
    """Kernels and copies themselves, not the host-side operators that
    launched them (which carry the same device time again)."""
    return evt.device_type == torch.autograd.DeviceType.CUDA and _device_us(evt) > 0


def host_ms(fn, reps: int = 30) -> float:
    """Host milliseconds to enqueue one call, with the device queue absorbing
    the work (no synchronisation inside the timed loop)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * 0.2))  # keep the device busy: nothing drains
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return elapsed


def report(name: str, fn, reps: int) -> None:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [e for e in prof.key_averages() if _on_device(e)]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3 / reps
    ops = sum(e.count for e in rows) / reps
    print(f"{name}: wall {wall_ms:.4f} ms per pass, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}, {ops:.0f} kernels and copies per pass "
          "(profiler on)")
    for e in sorted(rows, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) / 1e3 / reps:9.4f} ms  x{e.count / reps:5.1f}  {e.key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device is available", file=sys.stderr)
        return 1
    pred = brca_predictor(torch.bfloat16, "flash", "auto")
    rng = np.random.default_rng(0)
    omic = rng.standard_normal((BATCH, 1, OMIC), dtype=np.float32)
    wsi = rng.standard_normal((BATCH, TOKENS, PATCH), dtype=np.float32)
    x = [torch.as_tensor(omic, device="cuda"), torch.as_tensor(wsi, device="cuda")]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    with torch.inference_mode():
        report("model forward, inputs on the card", lambda: pred.module(x), args.reps)
    report("Predictor micro-batch from host arrays", lambda: pred([omic, wsi]), args.reps)

    # host cost of enqueueing each piece of the forward (profiler off)
    attn = pred.module.layer0_cross_attn_m1
    dat = x[1].to(torch.bfloat16)
    folds = [pred.module._modules[f"layer{k}_cross_attn_m1"].kv_fold() for k in (0, 1)]
    w_all = torch.cat([w for w, _ in folds], dim=1)
    b_all = torch.cat([b for _, b in folds])
    enc = positional_encoding((TOKENS,), 2.0, 2, dtype=torch.bfloat16, device="cuda")
    ops = _prep(dat, enc, w_all, b_all, torch.bfloat16)
    kv = fused_project_kernel(dat, *ops, w_all.shape[0], 1e-5)[0]
    qh = torch.randn((BATCH, 1, 17, 63), device="cuda", dtype=torch.bfloat16)
    kh, vh = kv[..., :63][:, None], kv[..., 63:126][:, None]
    with torch.inference_mode():
        lat = pred.module.latents.to(torch.bfloat16).expand(BATCH, 17, 126)
        pieces = {
            "model forward": lambda: pred.module(x),
            "fused_kv_project (prep + kernel)": lambda: fused_kv_project(dat, enc, w_all, b_all),
            "fused_project_kernel alone": lambda: fused_project_kernel(
                dat, *ops, w_all.shape[0], 1e-5),
            "flash_attention_kernel": lambda: flash_attention_kernel(qh, kh, vh, None, 0.25),
            "one cross-attention block": lambda: attn(lat, kv=kv[..., :126]),
        }
        for name, fn in pieces.items():
            print(f"host time to enqueue {name}: {host_ms(fn):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
