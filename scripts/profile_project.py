#!/usr/bin/env python3
"""Per-launch device profile of the fused KV projection forward kernels.

    python3 scripts/profile_project.py [--stages 2,3,4] [--dtype bf16|f32]

Needs one CUDA GPU and nvcc. At the shapes of ``chip_smoke.PROJECT_SHAPES``
(brca's WSI bag (8, 4096, 2048) -> F 252 in bf16 and int8, kirp's F 270 in
both, the trimodal third bag (8, 1024, 1024) -> 252 and the omic vector
(8, 1, 2000) -> 252) it profiles one call of the wrapper (``torch.profiler``,
``chip_smoke.launch_profile``) and prints each device kernel of the call
with its time per launch and launches per call, beside the call's time
(``chip_smoke.time_ms``), the generic kernel's on the same inputs,
``torch.matmul`` of the GEMM alone (on the dequantized bf16 context for
int8) and the bound. ``torch.profiler`` gives no L2 counters, so the bytes
the weights take from L2 per call are reckoned from the tile plan
(``project_plan``): one weight tile per row tile, column pass and
64-channel k-step. With ``--stages`` the brca and kirp calls are timed
again with the ring depth forced (a depth that does not fit shared memory
is skipped).

With ``--dtype f32`` it profiles the f32 route instead (the f32 kernel,
``csrc/fused_project_f32.cu``) at brca and kirp's WSI bag in f32, brca's
int8 bag computed in f32 and the omic vector in f32: each call's kernels
on the profiler, its time beside ``torch.matmul`` f32 and the bound, the
plan (``project_f32_plan``) and the weights it takes from L2, one tile of
32 channels per row tile, column pass and k-step.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    BATCH, OMIC, PATCH, PROJECT_SHAPES, TOKENS, launch_profile, projection_timing, time_ms)
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import fused_project as fp  # noqa: E402


def weight_l2_bytes(m: int, c: int, f: int, itemsize: int) -> int:
    """Bytes of weights one call takes from L2 under the plan: each block
    loads a tile of ``nb`` rows of 64 bf16 channels per row tile, column
    pass and k-step."""
    plan = fp.project_plan(m, f, itemsize)
    return plan.row_tiles * plan.n_col * -(-c // 64) * plan.nb * 64 * 2


def forced_stages(stages: int):
    """A stand-in for ``project_plan`` with the ring depth forced."""
    plan_fn = fp.project_plan

    def plan(m, f, itemsize):
        p = plan_fn(m, f, itemsize)
        held = fp.project_smem(p.nb, itemsize, stages, p.pitch, False) > 232448
        smem = fp.project_smem(p.nb, itemsize, stages, p.pitch, held)
        return p._replace(stages=stages, held_staging=held, smem=smem)
    return plan


def profile_f32() -> None:
    """The f32 route at brca and kirp in f32 and brca int8 in f32 compute."""
    torch.backends.cuda.matmul.allow_tf32 = False  # torch.matmul f32 in full f32
    cuda_build.build(("fused_project_f32",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, t, c, f, dtype) in {
            "brca f32": (BATCH, TOKENS, PATCH, 252, torch.float32),
            "kirp f32": (BATCH, TOKENS, PATCH, 270, torch.float32),
            "brca int8 -> f32": (BATCH, TOKENS, PATCH, 252, torch.int8),
            "omic f32": (BATCH, 1, OMIC, 252, torch.float32)}.items():
        timing, run = projection_timing(gen, b, t, c, f, dtype, torch.float32)
        itemsize = 1 if dtype == torch.int8 else 4
        plan = fp.project_f32_plan(b * t, c, f, itemsize,
                                   torch.cuda.get_device_properties(0).multi_processor_count)
        weights = plan.row_tiles * plan.n_col * plan.nk * 32 * plan.nb * 4
        print(f"{label} ({b}, {t}, {c}) -> F {f}: {launch_profile(run)[1]}")
        print(f"  kernel {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
              f"torch.matmul f32 {timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} "
              f"ms ({timing['bound_by']}), {timing['bound_ms'] / timing['ms']:.3f} of it; plan nb "
              f"{plan.nb}, {plan.n_col} column pass(es), {plan.row_tiles} row tiles, "
              f"{plan.stages} stages, {plan.smem} B shared memory; weights from L2 "
              f"{weights / 1e6:.1f} MB per call (reckoned)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--stages", default="", help="ring depths to force, e.g. 2,3,4")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                        help="the bf16 kernels (default) or the f32 route")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_project: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    if args.dtype == "f32":
        profile_f32()
        return 0
    cuda_build.build(("fused_project", "fused_project_tma"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, t, c, f, dtype) in PROJECT_SHAPES.items():
        itemsize = 1 if dtype == torch.int8 else 2
        timing, run = projection_timing(gen, b, t, c, f, dtype)
        plan = fp.project_plan(b * t, f, itemsize)
        print(f"{label} ({b}, {t}, {c}) {str(dtype)[6:]} -> F {f}: {launch_profile(run)[1]}")
        generic_ms = time_ms(lambda: run("generic"))[0]
        print(f"  kernel {timing['ms']:.4f} ms, generic kernel {generic_ms:.4f} ms, "
              f"plain {timing['plain_ms']:.4f} ms, "
              f"torch.matmul GEMM alone {timing['library_ms']:.4f} ms, bound "
              f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}); plan nb {plan.nb}, "
              f"{plan.n_col} column pass(es), {plan.stages} stages, "
              f"rows staged in {'a held stage' if plan.held_staging else 'their own region'}, "
              f"{plan.smem} B shared memory; weights from L2 "
              f"{weight_l2_bytes(b * t, c, f, itemsize) / 1e6:.1f} MB per call "
              f"(reckoned), context from HBM {b * t * c * itemsize * plan.n_col / 1e6:.1f} MB")
        if t < 4096:
            continue
        for stages in [int(x) for x in args.stages.split(",") if x]:
            plan_fn, fp.project_plan = fp.project_plan, forced_stages(stages)
            try:
                p = fp.project_plan(b * t, f, itemsize)
                if p.smem > 232448:
                    print(f"  {stages} stages: {p.smem} B, does not fit")
                    continue
                print(f"  {stages} stages: {time_ms(run)[0]:.4f} ms")
            finally:
                fp.project_plan = plan_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
