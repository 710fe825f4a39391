#!/usr/bin/env python3
"""Per-launch device profile of the fused KV projection forward kernels.

    python3 scripts/profile_project.py [--kernel tma|f32|generic] [--stages 2,3,4]
        [--parent DIR]

Needs one CUDA GPU and nvcc. At the shapes of ``chip_smoke.PROJECT_SHAPES``
(brca's WSI bag (8, 4096, 2048) -> F 252 in bf16 and int8, kirp's F 270 in
both, the trimodal third bag (8, 1024, 1024) -> 252 and the omic vector
(8, 1, 2000) -> 252) it profiles one call of the wrapper (``torch.profiler``,
``chip_smoke.launch_profile``) and prints each device kernel of the call
with its time per launch and launches per call, beside the call's time
(``chip_smoke.time_ms``), ``torch.matmul`` of the GEMM alone (on the dequantized bf16 context for
int8) and the bound. ``torch.profiler`` gives no L2 counters, so the bytes
the weights take from L2 per call are reckoned from the tile plan
(``project_plan``): one weight tile per row tile, column pass and
64-channel k-step. With ``--stages`` the brca and kirp calls are timed
again with the ring depth forced (a depth that does not fit shared memory
is skipped).

With ``--kernel f32`` it profiles the f32 route instead (the f32 kernel,
``csrc/fused_project_f32.cu``) at brca and kirp's WSI bag in f32, brca's
int8 bag computed in f32 and the omic vector in f32: each call's kernels
on the profiler, its time beside ``torch.matmul`` f32 and the bound, the
plan (``project_f32_plan``) and the weights it takes from L2, one tile of
32 channels per row tile, column pass and k-step.

With ``--kernel generic`` it profiles the generic route (rows at any byte
offset) at ``chip_smoke.GENERIC_SHAPES``: each call's kernels on the
profiler, its time beside the plain version, ``torch.matmul``, the bound
and the plan (``project_generic_plan``); the image modality's output
through the Hopper kernel's own route (8 channels); then the time of the split kernel
and of the hull kinds, each forced, at (m, 1, 2001) -> 252 for m from 8 to
2048 (where ``SPLIT_MAX_ROWS`` should lie). With ``--parent DIR`` (a copy
of an earlier ``healnet_tpu_torch/ops/csrc``, e.g. from ``git archive``)
it also builds that tree's ``fused_project.cu`` and ``fused_project_tma.cu``
under ``build/project-parent/`` and times, in the same run and on the same
inputs, its generic kernel (``healnet_fused_project_generic``: (C, F)
weights, 128-row blocks) at every shape and its Hopper kernel at the
aligned shapes of ``PROJECT_SHAPES``, beside this tree's (in turns:
parent, this tree, this tree, parent; with the spills ptxas reports for
each build).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    BATCH, GENERIC_SHAPES, OMIC, PATCH, PROJECT_SHAPES, TOKENS, launch_profile,
    projection_case_at, projection_timing, time_ms)
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


def build_parent(parent: Path) -> dict:
    """The earlier tree's generic and Hopper kernels, built with this tree's
    flags: {source name: loaded library}."""
    out = ROOT / "build/project-parent"
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(parent), "-o", str(lib),
               str(parent / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{proc.stderr}")
        spills = [line.strip() for line in proc.stderr.splitlines() if "spill" in line]
        print(f"the parent's {name}.cu: {'; '.join(spills)}", flush=True)
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(2) as pool:
        libs = dict(pool.map(one, ("fused_project", "fused_project_tma")))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["fused_project"].healnet_fused_project_generic.argtypes = \
        [p] * 9 + [i] * 4 + [f, f] + [i] * 2 + [p]
    libs["fused_project_tma"].healnet_fused_project_tma.argtypes = \
        [p] * 9 + [i] * 4 + [f, f] + [i] * 7 + [p]
    libs["fused_project_tma"].healnet_fused_project_tma_max_blocks.argtypes = \
        [i, i, ctypes.c_longlong]
    return libs


def parent_run(libs, kind, dat, scale, ops, w_all, d_total):
    """A call of the parent's generic (``kind`` "generic": (C, F) weights)
    or Hopper kernel on the same inputs (the Hopper kernel's operands)."""
    b, t, c = dat.shape
    f = ops[3].shape[1]
    kv = torch.empty((b, t, f), dtype=torch.bfloat16, device="cuda")
    s1, s2 = (torch.empty((b, t), device="cuda") for _ in range(2))
    quantized = dat.dtype == torch.int8
    scale_ptr = scale.data_ptr() if quantized else None
    args = (dat.data_ptr(), None, ops[1].data_ptr(), ops[2].data_ptr(), ops[3].data_ptr(),
            scale_ptr, kv.data_ptr(), s1.data_ptr(), s2.data_ptr(), b * t, c, f, t,
            float(d_total), 1e-5, int(quantized))
    if kind == "generic":
        w = w_all[:c].to(torch.bfloat16).contiguous()
        vec = int(c % 8 == 0 and dat.data_ptr() % (8 if quantized else 16) == 0)
        fn = libs["fused_project"].healnet_fused_project_generic
        rest = (vec,)
    else:
        w = ops[0]
        plan = fp.project_plan(b * t, f, dat.element_size())
        blocks = libs["fused_project_tma"].healnet_fused_project_tma_max_blocks(
            plan.nb, int(quantized), plan.smem)
        fn = libs["fused_project_tma"].healnet_fused_project_tma
        rest = (plan.nb, plan.n_col, min(blocks, plan.row_tiles * plan.n_col), plan.stages,
                plan.pitch, int(plan.held_staging))

    def run():
        code = fn(args[0], w.data_ptr(), *args[2:], *rest,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"the parent's {kind} kernel failed to launch: {code}")
        return kv, s1, s2
    return run


def profile_generic(parent) -> None:
    """The generic route at ``GENERIC_SHAPES``, beside the parent's kernels
    where ``parent`` names their sources; then the split kernel against the
    hull kinds over the row count."""
    cuda_build.build(("fused_project", "fused_project_tma"))
    print("this tree's fused_project_tma.cu: " + "; ".join(
        line for line in cuda_build.BUILD_LOG["fused_project_tma"]["ptxas"].splitlines()
        if "spill" in line))
    libs = build_parent(Path(parent)) if parent else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    if libs is not None:  # the Hopper kernel's own route, this tree's beside the parent's
        for label, (b, t, c, f, dtype) in PROJECT_SHAPES.items():
            dat, scale, _, ops, w_all, _, _ = projection_case_at(gen, b, t, c, f, dtype)
            new = lambda: fp._project_launch(dat, *ops, w_all.shape[0], 1e-5, scale)
            old = parent_run(libs, "tma", dat, scale, ops, w_all, w_all.shape[0])
            same = all(torch.equal(x, y) for x, y in zip(new(), old()))
            times = [time_ms(fn)[0] for fn in (old, new, new, old)]
            print(f"{label} on the Hopper kernel's own route (parent, this tree, this tree, "
                  f"parent): {', '.join(f'{x:.4f}' for x in times)} ms; the same bits: {same}",
                  flush=True)
    for label, (b, t, c, f, dtype, forced) in GENERIC_SHAPES.items():
        itemsize = 1 if dtype == torch.int8 else 2
        timing, run = projection_timing(gen, b, t, c, f, dtype, route="generic")
        plan = fp.project_generic_plan(b * t, c, f, itemsize)
        print(f"{label} ({b}, {t}, {c}) {str(dtype)[6:]} -> F {f}"
              f"{' (forced)' if forced else ''}: {launch_profile(run)[1]}")
        line = (f"  generic {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
                f"torch.matmul {timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
                f"({timing['bound_by']}); plan {plan.path}, {plan.classes} row classes"
                + (f", nb {plan.rows.nb}, {plan.rows.stages} stages" if plan.rows else
                   f", clusters of {plan.cluster} x {plan.slices} slices, "
                   f"{plan.col_groups * plan.row_groups * plan.cluster} blocks"))
        if libs is not None:
            dat, scale, _, ops, w_all, _, plain = projection_case_at(gen, b, t, c, f, dtype)
            old = parent_run(libs, "generic", dat, scale, ops, w_all, w_all.shape[0])
            err = (old()[0].float() - plain()[0].float()).abs().max().item()
            line += (f"; the parent's generic kernel {time_ms(old)[0]:.4f} ms (max|d| {err:.4g} "
                     "from the plain version)")
            if forced:
                new = lambda: fp._project_launch(dat, *ops, w_all.shape[0], 1e-5, scale)
                line += (f"; the Hopper kernel on its own route {time_ms(new)[0]:.4f} ms, "
                         f"the parent's {time_ms(parent_run(libs, 'tma', dat, scale, ops, w_all, w_all.shape[0]))[0]:.4f} ms")
        print(line, flush=True)
    # the image modality's 202 MB of output through the pipe's epilogue on the
    # Hopper kernel's own route: 8 channels, rows TMA can describe
    timing, run = projection_timing(gen, BATCH, 224 * 224, 8, 252, torch.bfloat16)
    print(f"(8, 50176, 8) -> 252 on the Hopper kernel's own route: {launch_profile(run)[1]}; "
          f"{timing['ms']:.4f} ms, torch.matmul {timing['library_ms']:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms", flush=True)
    # the split kernel against the hull kinds over the row count
    limit = fp.SPLIT_MAX_ROWS
    try:
        for m in (8, 16, 32, 64, 128, 256, 512, 1024, 2048):
            dat, scale, _, ops, w_all, a2d, _ = projection_case_at(gen, m, 1, 2001, 252,
                                                                   torch.bfloat16)
            run = lambda: fp._project_launch(dat, *ops, w_all.shape[0], 1e-5, scale)
            times = {}
            for path, forced_limit in (("split", 1 << 30), ("rows", 7)):
                fp.SPLIT_MAX_ROWS = forced_limit
                times[path] = time_ms(run)[0]
            fp.SPLIT_MAX_ROWS = limit
            w = w_all[:2001].to(torch.bfloat16)
            print(f"({m}, 1, 2001) -> 252: split {times['split']:.4f} ms, hull kinds "
                  f"{times['rows']:.4f} ms, torch.matmul {time_ms(lambda: a2d @ w)[0]:.4f} ms",
                  flush=True)
    finally:
        fp.SPLIT_MAX_ROWS = limit


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--kernel", choices=("tma", "f32", "generic"), default="tma",
                        help="the Hopper kernel (default), the f32 route or the generic route")
    parser.add_argument("--stages", default="", help="ring depths to force, e.g. 2,3,4")
    parser.add_argument("--parent", default="",
                        help="with --kernel generic: an earlier csrc tree to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_project: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    if args.kernel == "f32":
        profile_f32()
        return 0
    if args.kernel == "generic":
        profile_generic(args.parent)
        return 0
    cuda_build.build(("fused_project", "fused_project_tma"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, t, c, f, dtype) in PROJECT_SHAPES.items():
        itemsize = 1 if dtype == torch.int8 else 2
        timing, run = projection_timing(gen, b, t, c, f, dtype)
        plan = fp.project_plan(b * t, f, itemsize)
        print(f"{label} ({b}, {t}, {c}) {str(dtype)[6:]} -> F {f}: {launch_profile(run)[1]}")
        print(f"  kernel {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
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
