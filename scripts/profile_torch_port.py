#!/usr/bin/env python3
"""Where the time goes in the PyTorch port: one serving micro-batch and
one training step.

    python3 scripts/profile_torch_port.py [--mode serving|training|all] [--reps 5]

Needs one CUDA GPU. Builds the full-width BRCA-tuned HealNet of
``chip_smoke.py`` (bf16, flash attention, fused projection kernel, batch 8,
4096-token WSI bag, random weights from a seeded generator) and profiles,
with ``torch.profiler``:

- serving: the model's forward on inputs already on the card, and one
  ``Predictor`` micro-batch from host arrays (upload included);
- training: one ``SurvivalTrainer.train_step`` (forward with dropout,
  NLL/16 + L1, backward through both kernels' backwards, Adam under
  OneCycle) on a batch already on the card.

For each it prints the wall time per pass, the device's busy time per pass
(the sum of kernel and copy times), the idle share (1 - busy / wall), the
kernels and copies per pass, and those by device time. Then it prints the
host time to enqueue each piece (the serving forward and its kernel
wrappers; the training step's forward, backward and update), with the
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    BATCH,
    HORIZON,
    OMIC,
    PATCH,
    TOKENS,
    device_us,
    predictor,
    brca_trainer,
    device_profile,
    train_batch,
)
from healnet_tpu_torch.ops.flash_attention import flash_attention_kernel  # noqa: E402
from healnet_tpu_torch.ops.fourier import positional_encoding  # noqa: E402
from healnet_tpu_torch.ops.fused_project import (  # noqa: E402
    _prep,
    fused_kv_project,
    fused_project_kernel,
)


def host_ms(fn, reps: int = 30) -> float:
    """Host milliseconds to enqueue one call, nothing synchronised inside
    the timed loop. The device keeps up with these host-bound passes, so
    the launch queue stays short and the host never waits on it (a device
    held asleep instead would fill the queue, about a thousand launches,
    and block the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return elapsed


def report(name: str, fn, reps: int) -> None:
    wall_ms, busy_ms, ops, rows = device_profile(fn, reps)
    print(f"{name}: wall {wall_ms:.4f} ms per pass, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}, {ops:.0f} kernels and copies per pass "
          "(profiler on)")
    for e in sorted(rows, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e) / 1e3 / reps:9.4f} ms  x{e.count / reps:5.1f}  {e.key[:90]}")


def profile_serving(reps: int) -> None:
    pred = predictor(torch.bfloat16, "flash", "auto")
    rng = np.random.default_rng(0)
    omic = rng.standard_normal((BATCH, 1, OMIC), dtype=np.float32)
    wsi = rng.standard_normal((BATCH, TOKENS, PATCH), dtype=np.float32)
    x = [torch.as_tensor(omic, device="cuda"), torch.as_tensor(wsi, device="cuda")]
    with torch.inference_mode():
        report("model forward, inputs on the card", lambda: pred.module(x), reps)
    report("Predictor micro-batch from host arrays", lambda: pred([omic, wsi]), reps)

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


def profile_training(reps: int) -> None:
    trainer = brca_trainer(torch.bfloat16, "flash", "auto")
    batch = train_batch(np.random.default_rng(1), torch.bfloat16)
    report("train step (forward + backward + Adam), inputs on the card",
           lambda: trainer.train_step(batch, HORIZON), reps)

    # host cost of enqueueing the step's pieces (profiler off)
    placed = trainer._place(batch)
    trainer.module.train()
    forward = lambda: trainer._loss(placed)[0]
    update = lambda: (trainer.grad_stats(), trainer.optimizer.step())
    forward_ms = host_ms(forward)
    with_backward_ms = host_ms(lambda: forward().backward())
    pieces = {
        "train step": host_ms(lambda: trainer.train_step(batch, HORIZON)),
        "forward + loss": forward_ms,
        "backward (forward + loss + backward, less forward + loss)": with_backward_ms - forward_ms,
        "grad norms + Adam update": host_ms(update),
    }
    for name, ms in pieces.items():
        print(f"host time to enqueue {name}: {ms:.4f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=("serving", "training", "all"), default="all")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.mode in ("serving", "all"):
        profile_serving(args.reps)
    if args.mode in ("training", "all"):
        profile_training(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
