#!/usr/bin/env python3
"""Where the time goes inside the fused latent-chain kernel.

    python3 scripts/profile_chain_phases.py [--rows brca kirp trimodal]

Needs one CUDA GPU and nvcc. ``ncu`` is not available everywhere, so this
builds an instrumented copy of ``healnet_tpu_torch/ops/csrc/fused_chain.cu``
into ``build/chain-phases/``: after each of the kernel's block-wide barriers
thread 0 adds the ``clock64()`` cycles since the previous one to that
phase's counter. It runs the chain once per row at ``chip_smoke.py``'s
phase-11 inputs (bf16, dropout off) and prints the kernel's time (CUDA
events) and each phase's share of the cycles, averaged over the blocks.
A phase ends at a barrier, so its share includes the wait for the slowest
warp; "loads" is the issue of a key tile's loads through its stores to
shared memory.
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

from chip_smoke import ROWS, chain_case, chain_extras, row_inputs, row_model  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops.fused_chain import fused_latent_chain  # noqa: E402

PHASES = {1: "LN1", 2: "q product + rounding", 3: "pass 1 loads", 4: "pass 1 scores",
          5: "pass 1 row max/sum", 6: "pass 2 @V", 7: "pass 2 loads",
          8: "pass 2 scores + probabilities", 9: "out product + residual", 10: "LN2",
          11: "FF first product", 12: "gating", 13: "FF second product + residual"}

HEADER = '''
__shared__ long long g_tlast;
__device__ unsigned long long g_prof[256][16];
#define PROF(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  g_prof[blockIdx.x][k] += t_ - g_tlast; g_tlast = t_; } } while (0)
'''
FOOTER = '''
extern "C" void prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" void prof_reset() {
  static unsigned long long z[256][16];
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
# (text after which a marker goes, marker)
MARKERS = [
    ("      __syncthreads();  // the previous tile's readers are done", "PROF(pass ? 6 : 5);"),
    ("      if (tid < kTile) mk[tid] = mtid;\n      __syncthreads();", "PROF(pass ? 7 : 3);"),
    ("          if (i < lc) ps[i * kTile + sj] = sc[r];\n        }\n        __syncthreads();",
     "PROF(4);"),
    ("            ps[i * kTile + sj] = round_to<T>(pr);\n          }\n        }\n"
     "        __syncthreads();", "PROF(8);"),
    ("  for (int i = tid; i < n; i += kThreads) xs[i] = to_float(x0[i]);",
     "if (tid == 0) g_tlast = clock64();"),
    ("p.w[kLn1B] + site * ld, ys, lc, ld);\n      __syncthreads();", "PROF(1);"),
    ("round_to<T>(qs[i]) : 0.f;\n      }\n      __syncthreads();", "PROF(2);"),
    ("(uint32_t)p.seeds[site]);\n      __syncthreads();", "PROF(6);"),
    ("xs[i] = pres * (o >= 0.f ? o : 0.01f * o) + xs[i];\n      }\n      __syncthreads();",
     "PROF(9);"),
    ("p.w[kLn2B] + site * ld, ys, lc, ld);\n      __syncthreads();", "PROF(10);"),
    ("2 * f, hid, 2 * f, lc, part);\n      __syncthreads();", "PROF(11);"),
    ("activation(hid[r * 2 * f + f + c], p.gelu);\n      }\n      __syncthreads();", "PROF(12);"),
    ("xs[i] = pres * h + xs[i];\n      }\n      __syncthreads();", "PROF(13);"),
]


def build_instrumented() -> ctypes.CDLL:
    src = (cuda_build.CSRC / "fused_chain.cu").read_text()
    src = src.replace('#include "hash_dropout.cuh"', '#include "hash_dropout.cuh"\n' + HEADER)
    for anchor, marker in MARKERS:
        if anchor not in src:
            raise RuntimeError(f"fused_chain.cu changed; no marker place for {marker}")
        src = src.replace(anchor, f"{anchor}\n{marker}", 1)
    out = ROOT / "build" / "chain-phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_chain_phases.cu").write_text(src + FOOTER)
    lib_path = out / "libfused_chain_phases.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                    "-o", str(lib_path), str(out / "fused_chain_phases.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.healnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.healnet_cuda_error_string.restype = ctypes.c_char_p
    lib.prof_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", nargs="+", default=list(ROWS), choices=list(ROWS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_chain_phases: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    lib = build_instrumented()
    # the chain's wrapper loads its library through this cache
    cuda_build._LIBS["fused_chain"] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row in args.rows:
        module = row_model(row, torch.bfloat16).eval()
        x = row_inputs(gen, row, torch.bfloat16)
        ops, spec = chain_case(module, x, chain_extras(gen, module), training=False)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            fused_latent_chain(*ops, spec)
            torch.cuda.synchronize()
            lib.prof_reset()
            start.record()
            fused_latent_chain(*ops, spec)
            end.record()
            torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * (256 * 16))()
        lib.prof_read(ctypes.cast(counts, ctypes.c_void_p))
        cycles = np.array(counts, dtype=np.float64).reshape(256, 16)[:x[0].shape[0]].mean(axis=0)
        total = cycles.sum()
        print(f"{row}: {start.elapsed_time(end):.4f} ms (instrumented, one call), "
              f"{total:.0f} cycles per block")
        for k, name in PHASES.items():
            print(f"  {name:32s} {100 * cycles[k] / total:6.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
