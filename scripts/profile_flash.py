#!/usr/bin/env python3
"""Per-launch device profile of the flash cross-attention kernels.

    python3 scripts/profile_flash.py [--clusters 16,8,4]
    python3 scripts/profile_flash.py --parent DIR
    python3 scripts/profile_flash.py --wide [--parent DIR]

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

``--parent DIR`` alone (the root of an unpacked ``git archive`` of another
commit, at least its ``healnet_tpu_torch/`` and ``chip_smoke.py``) times
the forward and backward at those four shapes without dropout and with
dropout 0.083 in that commit's kernels and this tree's, each in a process
of its own (parent, this tree, this tree, parent), on inputs from the same
seed, a device word passed as a tensor to both (a commit before the
kernels read their seed from device memory takes it by value); this
tree's kernels also take a shard's hash row offset (64, as a data shard
of a sharded batch passes it).

``--wide`` times the wide and panel kernels instead, at (8, 17, 4096, d)
for d 320 and 512 (one panel) and 576 and 1024 (two or three panels), f32
and bf16, unmasked: the kernels' forward and backward, SDPA's, the plain versions'
and the bound (``chip_smoke.bound_ms``). With ``--parent DIR`` (the root of
an unpacked ``git archive`` of another commit, at least its
``healnet_tpu_torch/`` and ``chip_smoke.py``) the same calls of that
commit's wrappers, built from its own sources, are timed in the same run:
a process of its own before and after this tree's timings (parent, this
tree, this tree, parent), on inputs from the same seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    FLASH_SHAPES,
    attention_inputs,
    bound_ms,
    launch_profile,
    nbytes,
    time_ms,
)
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from healnet_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd_kernel,
    flash_attention_kernel,
)

# head dims of --wide, at (8, 17, 4096, d), f32 and bf16
WIDE_DIMS = (320, 512, 576, 1024)

# the timing run of --wide, for this tree or (in a process of its own, with
# sys.path[0] the other commit's root) for the other commit: prints one JSON
# line {"d dtype": [forward ms, backward ms]}
TIMING = """
import json, sys, torch
from chip_smoke import attention_inputs, time_ms
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.flash_attention import flash_attention_bwd_kernel, flash_attention_kernel
cuda_build.build(("flash_attention", "flash_attention_bwd", "flash_wide"))
gen = torch.Generator(device="cuda").manual_seed(0)
times = {}
for d, name in SHAPES:
    dtype = getattr(torch, name)
    eff = d**-0.5 / 0.5
    q, k, v = attention_inputs(gen, 8, 17, 4096, d, dtype)
    out, lse = flash_attention_kernel(q, k, v, None, eff)
    do = torch.randn((8, 1, 17, d), generator=gen, device="cuda").to(dtype)
    delta = (do.float() * out.float().reshape(8, 1, 17, d)).sum(-1)
    times[f"{d} {name}"] = (
        time_ms(lambda: flash_attention_kernel(q, k, v, None, eff))[0],
        time_ms(lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff))[0])
print(json.dumps(times))
"""


# the timing run of --parent alone: {"label rate": [forward ms, backward ms]}
# at FLASH_SHAPES without dropout and with dropout 0.083, the seed a device
# word, and for this tree (THIS_TREE) a shard's hash row offset
DROPOUT_TIMING = """
import json, sys, torch
from chip_smoke import FLASH_SHAPES, attention_inputs, time_ms
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.flash_attention import flash_attention_bwd_kernel, flash_attention_kernel
cuda_build.build(("flash_attention", "flash_attention_bwd"))
gen = torch.Generator(device="cuda").manual_seed(0)
seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
rows = (64, 1) if THIS_TREE else ()  # a shard's hash row offset
times = {}
for label, (d, width, dtype) in FLASH_SHAPES.items():
    eff = d**-0.5 / 0.5
    q, k, v = attention_inputs(gen, 8, 17, 4096, d, dtype, width=width)
    do = torch.randn((8, 1, 17, d), generator=gen, device="cuda").to(dtype)
    for rate in (0.0, 0.083):
        out, lse = flash_attention_kernel(q, k, v, None, eff, rate, seed, *rows)
        delta = (do.float() * out.float().reshape(8, 1, 17, d)).sum(-1)
        times[f"{label} {rate}"] = (
            time_ms(lambda: flash_attention_kernel(q, k, v, None, eff, rate, seed, *rows))[0],
            time_ms(lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff, rate,
                                                       seed, *rows))[0])
print(json.dumps(times))
"""


def timing_run(root: Path, shapes, code: str = TIMING) -> dict:
    """The --wide timings (or ``code``'s) of the commit at ``root`` in a
    process of its own."""
    code = f"SHAPES = {shapes!r}\nTHIS_TREE = {root == ROOT}\n" + code
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(root)}, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"the timing run at {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def profile_wide(parent: str) -> None:
    """The wide and panel kernels at (8, 17, 4096, d) for d of WIDE_DIMS
    against SDPA, the plain versions and the bound; beside ``parent``'s
    kernels where given."""
    shapes = [(d, dt) for d in WIDE_DIMS for dt in ("float32", "bfloat16")]
    runs = []
    if parent:
        runs.append(("parent", timing_run(Path(parent).resolve(), shapes)))
    runs += [("this tree", timing_run(ROOT, shapes)), ("this tree", timing_run(ROOT, shapes))]
    if parent:
        runs.append(("parent", timing_run(Path(parent).resolve(), shapes)))
    cuda_build.build(("flash_wide",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d, name in shapes:
        dtype = getattr(torch, name)
        eff = d**-0.5 / 0.5
        q, k, v = attention_inputs(gen, 8, 17, 4096, d, dtype)
        fwd = lambda: flash_attention_kernel(q, k, v, None, eff)
        out, lse = fwd()
        do = torch.randn((8, 1, 17, d), generator=gen, device="cuda").to(dtype)
        delta = (do.float() * out.float().reshape(8, 1, 17, d)).sum(-1)
        bwd = lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff)
        dq, dk, dv = bwd()
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=eff)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=eff)
        sdpa_bwd = lambda: torch.autograd.grad(o, (ql, kl, vl), do, retain_graph=True)
        plain = lambda: fa.multihead_attention(q, k, v, scale=eff, temperature=1.0)
        plain_bwd = lambda: fa.flash_backward_plain(q, k, v, None, do, lse, delta, eff)
        pan, pan_bwd = fa.flash_panels(dtype, d), fa.flash_panels(dtype, d, backward=True)
        bf, bb = (bound_ms(nbytes(q, k, v, out, lse), 4.0 * 8 * 17 * 4096 * d, dtype),
                  bound_ms(nbytes(q, k, v, do, lse, delta, dq, dk, dv),
                           10.0 * 8 * 17 * 4096 * d, dtype))
        print(f"(8, 17, 4096, {d}) {name}: {fa.flash_variant(dtype, d)}, {pan.count} panel(s) "
              f"x {pan.passes} pass(es) forward, {pan_bwd.count} x {pan_bwd.passes} backward, "
              f"{fa.launch_counter(dtype, d)}")
        for key, counts in fa._RESIDENT.items():
            print(f"  clusters resident at once {key}: {counts}")
        fa._RESIDENT.clear()
        key = f"{d} {name}"
        kernel = [", ".join(f"{who} {t[key][i]:.4f}" for who, t in runs) for i in (0, 1)]
        print(f"  forward  {launch_profile(fwd)[1]}")
        print(f"  forward: {kernel[0]} ms; SDPA {time_ms(sdpa)[0]:.4f}, plain "
              f"{time_ms(plain)[0]:.4f}, bound {bf[0]:.5f} ({bf[1]})")
        print(f"  backward {launch_profile(bwd)[1]}")
        print(f"  backward: {kernel[1]} ms; SDPA backward {time_ms(sdpa_bwd)[0]:.4f}, plain "
              f"{time_ms(plain_bwd)[0]:.4f}, bound {bb[0]:.5f} ({bb[1]})", flush=True)
        del q, k, v, out, lse, do, delta, dq, dk, dv, ql, kl, vl, o


def profile_parent(parent: str) -> None:
    """The tensor-core and FMA rows with and without dropout beside
    ``parent``'s kernels: parent, this tree, this tree, parent."""
    other = Path(parent).resolve()
    runs = [("parent", timing_run(other, None, DROPOUT_TIMING)),
            ("this tree", timing_run(ROOT, None, DROPOUT_TIMING)),
            ("this tree", timing_run(ROOT, None, DROPOUT_TIMING)),
            ("parent", timing_run(other, None, DROPOUT_TIMING))]
    for key in runs[0][1]:
        for i, direction in enumerate(("forward", "backward")):
            print(f"(8, 17, 4096) {key:<14} {direction:<8}: "
                  + ", ".join(f"{who} {t[key][i]:.4f}" for who, t in runs) + " ms", flush=True)


def forced_plan(cluster: int):
    """A stand-in for ``flash_plan`` that always takes ``cluster`` blocks."""
    def plan(rows, lkv, sms, max_cluster, tile=64, panels=1):
        tiles = max(1, -(-lkv // tile))
        per = -(-tiles // max(1, cluster // panels)) * tile
        return max(1, -(-lkv // per)) * panels, per
    return plan


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--clusters", default="", help="cluster sizes to force, e.g. 16,8,4")
    parser.add_argument("--wide", action="store_true",
                        help="time the wide and panel kernels (d 320-1024)")
    parser.add_argument("--parent", default="",
                        help="another commit's root, to time its kernels beside this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    if args.wide:
        profile_wide(args.parent)
        return 0
    if args.parent:
        profile_parent(args.parent)
        return 0
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
