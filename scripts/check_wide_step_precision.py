#!/usr/bin/env python3
"""How far the f32 paths' step gradients lie from f64 at a 576-wide head.

    python3 scripts/check_wide_step_precision.py

Needs one CUDA GPU and nvcc. One training step of the full-width brca model
(``chip_smoke.BRCA`` with ``cross_dim_head`` ``chip_smoke.CHUNKED_D``) from seeded
weights, on two batches: the first draw of ``numpy.random.default_rng(4)``
and its third, the batch of ``chip_smoke.phase_wide_step``'s chunked-route
step. For each f32 path (flash attention or plain, the projection kernel or
plain) it prints the worst gradient error against the plain path in f64
(``chip_smoke.worst_grad_error``: relative L2 a parameter, floored at 1% of
the global norm) and, for every cross feed-forward, how many SELU gates of
its first layer fall on the other side of zero than in f64, with the
smallest gate magnitude: a gate that close to the kink can flip with f32
rounding and move that layer's gradients far more than rounding does.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from healnet_tpu_torch.models.healnet import HealNetModule  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.train.loop import SurvivalTrainer  # noqa: E402

PATHS = {"kernel path": ("flash", "auto"), "flash, plain projection": ("flash", "xla"),
         "plain attention, projection kernel": ("xla", "auto"), "plain path": ("xla", "xla")}


def trainer(head, dtype, attention, projection, state):
    module = HealNetModule(**{**cs.BRCA, "cross_dim_head": head}, dtype=dtype,
                           attention_impl=attention, projection_impl=projection, device="cuda")
    module.load_state_dict({n: v.to(dtype or torch.float32) for n, v in state.items()})
    return SurvivalTrainer(module, l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0, device="cuda")


def step(t, batch):
    """Step 1 of ``t``; (its gradients, the first-layer outputs of every
    cross feed-forward)."""
    outs = {}

    def keep(name, out) -> None:  # a hook that returns nothing leaves the output as it is
        outs.setdefault(name, out.detach().double())

    for name, mod in t.module.named_modules():
        if "cross_ff" in name and name.endswith("fn.net_0"):
            mod.register_forward_hook(lambda m, i, o, n=name: keep(n, o))
    t.train_step(batch, cs.HORIZON)
    return {n: p.grad for n, p in t.module.named_parameters()}, outs


def main() -> int:
    head = cs.CHUNKED_D
    if not torch.cuda.is_available():
        print("check_wide_step_precision: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    state = HealNetModule(**{**cs.BRCA, "cross_dim_head": head}, device="cuda",
                          generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(4)
    draws = [cs.train_batch(rng, torch.float32)]
    cs.train_batch(rng, torch.bfloat16)
    draws.append(cs.train_batch(rng, torch.float32))
    for label, batch in zip(("first draw", "third draw"), draws):
        b64 = {**batch, "tensors": tuple(x.double() for x in batch["tensors"])}
        ref, ref_out = step(trainer(head, torch.float64, "xla", "xla", state), b64)
        ref = {n: g.float() for n, g in ref.items()}
        print(f"head {head}, {label}:")
        for name, (attention, projection) in PATHS.items():
            grads, outs = step(trainer(head, None, attention, projection, state), batch)
            worst, where = cs.worst_grad_error(grads, ref)
            flips = []
            for layer, out in outs.items():
                gate, gate64 = out.chunk(2, dim=-1)[1], ref_out[layer].chunk(2, dim=-1)[1]
                flips.append(f"{layer.split('.')[0]} {int(((gate > 0) != (gate64 > 0)).sum())}"
                             f" (min |gate| {gate64.abs().min().item():.3g})")
            print(f"  {name}: worst {worst:.4g} ({where}); gate flips " + ", ".join(flips),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
