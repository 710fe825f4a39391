#!/usr/bin/env python3
"""Where the time goes inside the flash kernels, any variant.

    python3 scripts/profile_flash_phases.py [--variant tc|fma|wide] [--d 63]

Needs one CUDA GPU and nvcc. ``ncu`` is not available everywhere, so this
builds instrumented copies of ``healnet_tpu_torch/ops/csrc/flash_attention.cu``
and ``flash_attention_bwd.cu`` into ``build/flash-phases/``: at each phase
boundary thread 0 of every block adds the ``clock64()`` cycles since the
previous boundary to that phase's counter in shared memory, and adds the
counters to device memory at the block's end. Only the chosen variant's
section of each file is instrumented. It runs the forward and the backward
at (8, 17, 4096, d), bf16 for the tensor-core variant and f32 for the FMA
one, unmasked, K and V as slices of a merged KV buffer
(``chip_smoke.attention_inputs``), 20 times each, and prints each phase's
cycles per block and call (averaged over the blocks) and its share. Thread
0 is in warp 0 (which owns three of 17 query rows in the FMA kernels), so
a phase that ends at a barrier includes the wait for the slowest warp.

``--variant wide`` profiles the kernels of ``flash_wide.cu``: the one-pass
wide kernels (heads of 257-512; ``--d`` defaults to 320 there) or, with
``--d`` past 512, the panel kernels, f32 and bf16, forward and backward:
that source carries its own markers (``WIDE_PHASE``, empty unless this
script defines them), so no anchor moves with it.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import attention_inputs  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import flash_attention as fa  # noqa: E402
from healnet_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd_kernel,
    flash_attention_kernel,
)

HEADER = '''
__device__ unsigned long long g_prof[4096][16];
__shared__ long long prof_s[16];
__shared__ long long t_last;
#define PROF(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  prof_s[k] += t_ - t_last; t_last = t_; } } while (0)
#define PROF_FLUSH() do { if (threadIdx.x == 0) for (int k_ = 0; k_ < 16; ++k_) { \\
  g_prof[blockIdx.y * gridDim.x + blockIdx.x][k_] += prof_s[k_]; prof_s[k_] = 0; } } while (0)
'''
FOOTER = '''
extern "C" void prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" void prof_reset() {
  static unsigned long long z[4096][16];
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
INIT = ("  if (threadIdx.x == 0) { for (int k_ = 0; k_ < 16; ++k_) prof_s[k_] = 0; "
        "t_last = clock64(); }\n")
TC_SECTION = ("// ------------------------------------------------- tensor-core", None)
FMA_SECTION = ("// ---------------------------------------------- FMA variant",
               "// ------------------------------------------------- tensor-core")
# the section instrumented, the line after which the counters start, and
# (text after which a marker goes, marker), in source order
FWD = {
    "section": TC_SECTION, "start": "  const int S = p.stages;\n",
    "phases": {1: "prologue and q load", 2: "wait for the tile", 10: "issue the next tile",
               3: "unpack", 4: "scores, softmax, @V", 5: "warp states",
               6: "block merge and push", 7: "cluster barrier", 8: "merge and store",
               9: "next-group barrier"},
    "markers": [
        ("    const bool active = g0 + mt * 16 < p.lq;  // the warp's query tile holds a query\n",
         "PROF(1);"),
        ("      __syncthreads();  // tile `it` has landed; every warp is done with it - 1\n",
         "PROF(2);"),
        ("      tc::cp_async_commit();\n      const int k0 = kv_begin + it * tc::kKeyTile;\n",
         "PROF(10);"),
        ("                          mask != nullptr, k0, kv_end, p.d, tid);\n      __syncthreads();\n",
         "PROF(3);"),
        ("        tc::mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);\n      }\n", "PROF(4);"),
        ("            make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);\n    }\n    __syncthreads();\n",
         "PROF(5);"),
        ("        tc::st_cluster(rl + rank * QG + r, j, ls);\n      }\n    }\n", "PROF(6);"),
        ("    cluster.sync();\n    // this block's share of the row's output: the blocks' states merged in\n",
         "PROF(7);"),
        ("      if (c == 0) p.lse[(size_t)row * p.lq + g0 + r] = mx + logf(lc);\n    }\n",
         "PROF(8);"),
        ("    if (g0 + QG < p.lq) cluster.sync();\n", "PROF(9); PROF_FLUSH();"),
    ],
}
BWD = {
    "section": TC_SECTION, "start": "  const int S = p.stages;\n",
    "phases": {1: "prologue, q/dO load", 2: "wait for the tile", 10: "issue the next tile",
               3: "unpack", 4: "s^T, dp^T, p, ds", 5: "dv, dk, dq products",
               6: "dk, dv staged and stored", 7: "dq push", 8: "cluster barrier",
               9: "dq merge and store"},
    "markers": [
        ("  for (int i = tid; i < lqp * AP; i += tc::kThreads) dq_s[i] = 0.f;\n", "PROF(1);"),
        ("    __syncthreads();  // tile `it` has landed; every warp is done with it - 1\n",
         "PROF(2);"),
        ("      tc::cp_async_commit();\n      const int k0 = kv_begin + it * tc::kKeyTile;\n",
         "PROF(10);"),
        ("                          mask != nullptr, k0, kv_end, p.d, tid);\n      __syncthreads();\n",
         "PROF(3);"),
        ("      __syncthreads();  // the tile's p^T and ds^T are complete\n", "PROF(4);"),
        ("      if (grp + 1 < ngroups) __syncthreads();  // p^T and ds^T are rewritten by the next group\n",
         "PROF(5);"),
        ("        tc::bulk_commit();\n      }\n", "PROF(6);"),
        ("      tc::st_cluster(rdq + rank * share + e - owner * share, owner, dq_s[r * AP + c]);\n    }\n",
         "PROF(7);"),
        ("    cluster.sync();\n    __nv_bfloat16* dq = p.dq + ((size_t)row * p.lq + q0c) * p.d;\n",
         "PROF(8);"),
        ("      dq[e] = __float2bfloat16(a * p.scale);\n    }\n", "PROF(9); PROF_FLUSH();"),
    ],
}


FMA_PROLOGUE = ("      fv::unpack<T, DP>(tiles, raw, rc.shift, k, p.k_st, v, p.v_st, mask, kv_begin,"
                " kv_end,\n                        p.d, tid);\n    }\n")
FMA_FWD = {
    "section": FMA_SECTION,
    "start": "  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;\n",
    "phases": {1: "first tiles issued, q load, tile 0 unpacked", 2: "wait for the tile",
               3: "issue a tile", 12: "unpack the next tile", 4: "scores",
               5: "softmax, p stored", 6: "acc += p V", 7: "ring drained", 8: "state pushed",
               9: "cluster barrier", 10: "merge and store", 11: "next-group barrier"},
    "markers": [
        (FMA_PROLOGUE, "PROF(1);"),
        ("    // with tile it - 1 (its aligned tile is refilled below)\n    __syncthreads();\n",
         "PROF(2);"),
        ("      ring1 = raw + ((it + 1) % St) * TF;\n    }\n", "PROF(3);"),
        ("                        kv_begin + (it + 1) * KT, kv_end, p.d, tid);\n", "PROF(12);"),
        ("      fv::tile_dots<DP, NS, 1>(sc, qs, nullptr, ks, nullptr, warp, lane);\n",
         "PROF(4);"),
        ("      __syncwarp();\n", "PROF(5);"),
        ("      fv::tile_axpy<DP, NS>(a, pw, KT, vs, lane);\n", "PROF(6);"),
        ("  if constexpr (S::kRing) tc::cp_async_wait(0);  // only empty groups are left\n",
         "PROF(7);"),
        ("#undef FWD_GROUP\n", "PROF(8);"),
        ("    cluster.sync();\n    // this block's share of the group's output: the blocks' states"
         " merged\n    // in rank order from its own shared memory\n", "PROF(9);"),
        ("      if (c == 0) p.lse[(size_t)row * p.lq + g0 + r] = mx + logf(lc);\n    }\n",
         "PROF(10);"),
        ("    if (g0 + QG < p.lq) cluster.sync();\n", "PROF(11); PROF_FLUSH();"),
    ],
}
FMA_BWD = {
    "section": FMA_SECTION,
    "start": "  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;\n",
    "phases": {1: "first tiles issued, q/dO load, tile 0 unpacked", 2: "wait for the tile",
               3: "issue a tile", 12: "unpack the next tile", 4: "dk, dv products and stores",
               5: "s, dp", 6: "p, round(p e), round(ds) stored", 7: "dq += ds K",
               8: "dq pushed", 9: "cluster barrier", 10: "dq merge and store"},
    "markers": [
        (FMA_PROLOGUE, "PROF(1);"),
        ("    // (the pd/ds buffer tile it writes)\n    __syncthreads();\n", "PROF(2);"),
        ("        ring1 = raw + ((it + 1) % St) * TF;\n      }\n", "PROF(3);"),
        ("                          kv_begin + (it + 1) * KT, kv_end, p.d, tid);\n    }\n",
         "PROF(12);"),
        ("                       dv, dk_acc, dv_acc, first, last);\n    }\n", "PROF(4);"),
        ("        fv::tile_dots<DP, NS, 2>(sd, qs, dos, ks, vs, warp, lane);\n", "PROF(5);"),
        ("        __syncwarp();\n", "PROF(6);"),
        ("        fv::tile_axpy<DP, NS>(dqa, ds + warp * KT, tc::kWarps * KT, ks, lane);\n",
         "PROF(7);"),
        ("#undef BWD_CHUNK\n", "PROF(8);"),
        ("    cluster.sync();\n    // the chunk's dq: the parts added in rank order, scaled once\n",
         "PROF(9);"),
        ("    if (!last) cluster.sync();\n", "PROF(10); PROF_FLUSH();"),
    ],
}


# flash_wide.cu's own markers, switched on
WIDE_HEADER = ("#define WIDE_PHASE(k) PROF(k)\n"
               "#define WIDE_PHASE_INIT() do {" + INIT.strip() + "} while (0)\n"
               "#define WIDE_PHASE_FLUSH() PROF_FLUSH()\n")
# (with panels, phase 12 is the tile's partial scores and their stores into
# the peers, and phase 5 starts with the wait for the peers' partials)
WIDE_FWD = {"phases": {1: "prologue: ring primed, q loaded", 2: "wait for the tile",
                       3: "issue the next tile", 4: "shift the tile in place",
                       12: "panels: partial scores shared", 5: "scores (panels: exchange wait)",
                       6: "softmax, p stored", 7: "acc += p V", 8: "state pushed",
                       9: "cluster barrier", 10: "merge and store", 11: "next-group barrier"}}
WIDE_BWD = {"phases": {1: "prologue: ring primed, q/dO loaded", 2: "wait for the tile",
                       3: "issue the next tile", 4: "shift the tile in place",
                       12: "panels: partial s, dp shared",
                       5: "s, dp (panels: exchange wait), p, round(p e), round(ds)",
                       6: "dq += ds K", 7: "dv, dk products and stores", 8: "dq pushed",
                       9: "cluster barrier", 10: "dq merge and store"}}


def build_instrumented(name: str, spec: dict, tag: str) -> ctypes.CDLL:
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    src = src.replace('#include "hash_dropout.cuh"', '#include "hash_dropout.cuh"\n' + HEADER
                      + (WIDE_HEADER if spec is None else ""))
    if spec is not None:
        begin, end = spec["section"]
        i = src.index(begin)
        j = src.index(end, i) if end else len(src)
        part = src[i:j]
        for anchor, marker in [(spec["start"], None), *spec["markers"]]:
            if part.count(anchor) != 1:
                raise RuntimeError(
                    f"{name}.cu changed; no single place for marker {marker or 'start'}")
            part = part.replace(anchor, anchor + (INIT if marker is None else f"{marker}\n"), 1)
        src = src[:i] + part + src[j:]
    out = ROOT / "build" / "flash-phases"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_{tag}_phases.cu"
    path.write_text(src + FOOTER)
    lib_path = out / f"lib{name}_{tag}_phases.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                           "-o", str(lib_path), str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path.name}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    lib.healnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.healnet_cuda_error_string.restype = ctypes.c_char_p
    lib.prof_read.argtypes = [ctypes.c_void_p]
    return lib


def report(label: str, lib: ctypes.CDLL, fn, spec: dict, calls: int = 20) -> None:
    fn()
    torch.cuda.synchronize()
    lib.prof_reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * (4096 * 16))()
    lib.prof_read(ctypes.cast(counts, ctypes.c_void_p))
    cycles = np.array(counts, dtype=np.float64).reshape(4096, 16)
    cycles = cycles[cycles.sum(axis=1) > 0].mean(axis=0) / calls
    total = cycles.sum()
    print(f"{label}: {start.elapsed_time(end) / calls * 1e3:.2f} us per call (instrumented, "
          f"{calls} calls back to back), {total:.0f} cycles per block and call")
    for k, name in spec["phases"].items():
        print(f"  {name:28s} {cycles[k]:8.0f} cycles {100 * cycles[k] / total:6.2f}%")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", choices=("tc", "fma", "wide"), default="tc")
    parser.add_argument("--d", type=int, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_flash_phases: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.variant == "wide":
        lib = build_instrumented("flash_wide", None, "wide")
        cuda_build._LIBS["flash_wide"] = lib
        d = args.d or 320
        for dtype in (torch.float32, torch.bfloat16):
            bf, pan = int(dtype == torch.bfloat16), fa.flash_panels(dtype, d)
            sizes = fa._sizes(fa.flash_variant(dtype, d), pan.count)
            resident = {c: lib.healnet_flash_wide_fwd_max_clusters(d, bf, c, pan.count, pan.passes)
                        for c in sizes}
            cluster = fa._max_cluster(lambda c: resident[c], ("profile", d, bf), 8, sizes)
            print(f"{str(dtype)[6:]} d {d}: {pan.count} panel(s) x {pan.passes} pass(es); forward "
                  f"clusters resident at once by size {resident}; 8 rows take clusters of "
                  f"{cluster}")
            profile_pair(lib, lib, WIDE_FWD, WIDE_BWD, dtype, d)
        return 0
    fwd_spec, bwd_spec = (FWD, BWD) if args.variant == "tc" else (FMA_FWD, FMA_BWD)
    dtype = torch.bfloat16 if args.variant == "tc" else torch.float32
    fwd_lib = build_instrumented("flash_attention", fwd_spec, args.variant)
    bwd_lib = build_instrumented("flash_attention_bwd", bwd_spec, args.variant)
    # the wrappers load their libraries through this cache
    cuda_build._LIBS["flash_attention"] = fwd_lib
    cuda_build._LIBS["flash_attention_bwd"] = bwd_lib
    profile_pair(fwd_lib, bwd_lib, fwd_spec, bwd_spec, dtype, args.d or 63)
    return 0


def profile_pair(fwd_lib, bwd_lib, fwd_spec, bwd_spec, dtype, d) -> None:
    """Forward and backward at (8, 17, 4096, d) in ``dtype``, unmasked."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = attention_inputs(gen, 8, 17, 4096, d, dtype)
    eff = d**-0.5 / 0.5
    out, lse = flash_attention_kernel(q, k, v, None, eff)
    do = torch.randn((8, 1, 17, d), generator=gen, device="cuda").to(dtype)
    delta = (do.float() * out.float().reshape(8, 1, 17, d)).sum(-1)
    shape = f"(8, 17, 4096, {d}) {str(dtype)[6:]}"
    report(f"forward {shape}", fwd_lib, lambda: flash_attention_kernel(q, k, v, None, eff),
           fwd_spec)
    report(f"backward {shape}", bwd_lib,
           lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff), bwd_spec)


if __name__ == "__main__":
    sys.exit(main())
