#!/usr/bin/env python3
"""Per-launch device profile of the flash cross-attention kernels.

    python3 scripts/profile_flash.py [--clusters 16,8,4]

Needs one CUDA GPU and nvcc. At the brca shape (8, 17, 4096, 63) and the
kirp shape (8, 17, 4096, 27), bf16, unmasked, and at the brca shape in f32,
it profiles one forward and one backward call of the wrappers
(``torch.profiler``, ``chip_smoke.launch_profile``) and prints every device
kernel of a call with its time per launch and launches per call, beside the
times of the calls and of SDPA's forward and backward on the same inputs
(``chip_smoke.time_ms``). K and V are the column slices of a merged KV
buffer, as the model hands them over. It prints each kernel's clusters
resident at once per cluster size (``cudaOccupancyMaxActiveClusters``, the
table ``flash_plan`` picks from). With ``--clusters``, every call is timed
again with the cluster forced to each size (keys split evenly in whole
tiles) in place of ``flash_plan``'s choice.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FLASH_SHAPES, attention_inputs, launch_profile, time_ms  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from healnet_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd_kernel,
    flash_attention_kernel,
)


def forced_plan(cluster: int):
    """A stand-in for ``flash_plan`` that always takes ``cluster`` blocks."""
    def plan(rows, lkv, sms, max_cluster, tile=64):
        tiles = max(1, -(-lkv // tile))
        per = -(-tiles // cluster) * tile
        return max(1, -(-lkv // per)), per
    return plan


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--clusters", default="", help="cluster sizes to force, e.g. 16,8,4")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cuda_build.build(("flash_attention", "flash_attention_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, lq, lkv = 8, 17, 4096
    for label, (d, width, dtype) in FLASH_SHAPES.items():
        eff = d**-0.5 / 0.5
        q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype, width=width)
        fwd = lambda: flash_attention_kernel(q, k, v, None, eff)
        out, lse = fwd()
        do = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)
        delta = (do.float() * out.float()).sum(-1)[:, None]
        do = do[:, None]
        bwd = lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=eff)
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=eff)
        sdpa_bwd = lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True)
        shape = f"({b}, {lq}, {lkv}, {d}) {str(dtype)[6:]}"
        print(f"{label} {shape}")
        print(f"  forward  {launch_profile(fwd)[1]}; kernel {time_ms(fwd)[0]:.4f} ms, "
              f"SDPA {time_ms(sdpa)[0]:.4f} ms")
        print(f"  backward {launch_profile(bwd)[1]}; kernel {time_ms(bwd)[0]:.4f} ms, "
              f"SDPA backward {time_ms(sdpa_bwd)[0]:.4f} ms")
        for key, counts in fa._RESIDENT.items():
            print(f"  clusters resident at once {key}: {counts}")
        fa._RESIDENT.clear()
        for c in [int(x) for x in args.clusters.split(",") if x]:
            fa.flash_plan, plan = forced_plan(c), fa.flash_plan
            try:
                print(f"  cluster {c}: forward {time_ms(fwd)[0]:.4f} ms, backward "
                      f"{time_ms(bwd)[0]:.4f} ms")
            finally:
                fa.flash_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
