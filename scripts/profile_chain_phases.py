#!/usr/bin/env python3
"""Where the time goes inside the fused latent-chain kernel.

    python3 scripts/profile_chain_phases.py [--rows brca kirp trimodal] [--sources A.cu ...]

Needs one CUDA GPU and nvcc. ``ncu`` is not available everywhere, so this
builds an instrumented copy of ``healnet_tpu_torch/ops/csrc/fused_chain.cu``
(or of each file given to ``--sources``, compiled in parallel) into
``build/chain-phases/``: after block-wide and cluster barriers that end a
phase, thread 0 adds the ``clock64()`` cycles since the previous marker to
that phase's counter. For each row, at ``chip_smoke.py``'s phase-11 inputs
(bf16, dropout off), and each source in turn, it prints the instrumented
kernel's time (``chip_smoke.time_ms``), the launch plan, how many SMs the
blocks ran on and each phase's share of the cycles of one call, averaged
over every block of every cluster. A phase ends at a barrier, so its share
includes the wait for the slowest warp; a phase that ends at a cluster
barrier (each exchange) includes the wait for the slowest block of the
cluster.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    ROWS,
    chain_case,
    chain_extras,
    row_inputs,
    row_model,
    time_ms,
)
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops.fused_chain import (  # noqa: E402
    chain_launch_plan,
    fused_latent_chain,
)

PHASES = {1: "LN1", 2: "q product + exchange", 3: "score pass (K loads, scores)",
          4: "row max/sum", 5: "(max, sum) exchange + merge", 6: "probabilities + V loads",
          7: "@V (V tiles, products)", 8: "@V exchange (partials, sums)",
          9: "out product + residual + exchange", 10: "LN2", 11: "FF first product (local)",
          12: "FF second product (partial) + exchange", 13: "FF sums + residual + exchange"}

HEADER = '''
__shared__ long long g_tlast;
__device__ unsigned long long g_prof[256][16];
__device__ unsigned int g_smid[256];
#define PROF(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \\
  g_prof[blockIdx.y * gridDim.x + blockIdx.x][k] += t_ - g_tlast; g_tlast = t_; } } while (0)
'''
FOOTER = '''
extern "C" void prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" void prof_smids(unsigned int* out) {
  cudaMemcpyFromSymbol(out, g_smid, sizeof(g_smid));
}
extern "C" void prof_reset() {
  static unsigned long long z[256][16];
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
# (text after which a marker goes, marker); each anchor is unique in the source
MARKERS = [
    ("  cluster.sync();  // every block runs before the first remote store",
     "if (tid == 0) { unsigned s_; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_)); "
     "g_smid[blockIdx.y * gridDim.x + blockIdx.x] = s_; g_tlast = clock64(); }"),
    ("p.w[kLn1B] + site * ld, ys, lc, ld);\n      __syncthreads();", "PROF(1);"),
    ("// q in the KV dtype\n                       });\n      cluster.sync();", "PROF(2);"),
    ("    score_chunk<T, NS, AC>(qs, sc, mk, tile, kv, st, mask, c0, cn, chunk, lc, inner, kp,\n"
     "                           p.scale);", "PROF(3);"),
    ("        m_s[i] = m_new;\n      }\n    }\n    __syncthreads();", "PROF(4);"),
    ("    l_s[i] = fmaxf(l, 1e-30f);\n  }\n  __syncthreads();", "PROF(5);"),
    ("      __syncthreads();  // the probabilities are formed; the previous tile's readers done",
     "PROF(t0 == 0 ? 6 : 7);"),
    ("      ld.store(tile, kp);\n      __syncthreads();\n      if (t0 + kTile < cn) "
     "ld.load(kv + inner, st, c0 + t0 + kTile, c0 + cn, inner, kp);", "PROF(7);"),
    ("    __syncthreads();  // the chunk's readers are done before the next one's scores",
     "PROF(7);"),
    ("                           cluster);\n      cluster.sync();", "PROF(8);"),
    ("put_all(avs + i * kp + q0 + c, cs, v);\n      }\n      cluster.sync();", "PROF(8);"),
    ("0.01f * o) + xs[i * ld + c]);\n                       });\n      cluster.sync();",
     "PROF(9);"),
    ("p.w[kLn2B] + site * ld, ys, lc, ld);\n      __syncthreads();", "PROF(10);"),
    ("g * activation(v, p.gelu);\n                      });\n      __syncthreads();", "PROF(11);"),
    ("owner, h);\n                       });\n      cluster.sync();", "PROF(12);"),
    ("pres * h + xs[i * ld + c]);\n      }\n      cluster.sync();", "PROF(13);"),
]


def build_instrumented(source: Path, tag: str) -> ctypes.CDLL:
    src = source.read_text()
    src = src.replace('#include "hash_dropout.cuh"', '#include "hash_dropout.cuh"\n' + HEADER)
    for anchor, marker in MARKERS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{source.name} changed; no single marker place for {marker}")
        src = src.replace(anchor, f"{anchor}\n{marker}", 1)
    out = ROOT / "build" / "chain-phases" / tag
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
    lib.prof_smids.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", nargs="+", default=list(ROWS), choices=list(ROWS))
    parser.add_argument("--sources", nargs="+", type=Path,
                        default=[cuda_build.CSRC / "fused_chain.cu"],
                        help="copies of fused_chain.cu to profile in turns (the anchors must "
                             "be in each; includes resolve in the package's csrc)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_chain_phases: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    with ThreadPoolExecutor(max_workers=len(args.sources)) as pool:
        libs = list(pool.map(lambda a: build_instrumented(*a),
                             [(src, f"{i}-{src.stem}") for i, src in enumerate(args.sources)]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row in args.rows:
        module = row_model(row, torch.bfloat16).eval()
        x = row_inputs(gen, row, torch.bfloat16)
        ops, spec = chain_case(module, x, chain_extras(gen, module), training=False)
        for src, lib in zip(args.sources, libs):
            # the chain's wrapper loads its library through this cache
            cuda_build._LIBS["fused_chain"] = lib
            with torch.no_grad():
                run = lambda: fused_latent_chain(*ops, spec)
                ms, _ = time_ms(run)
                torch.cuda.synchronize()
                lib.prof_reset()
                run()
                torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * (256 * 16))()
            lib.prof_read(ctypes.cast(counts, ctypes.c_void_p))
            cluster, kpb, chunk = chain_launch_plan(spec, x[0].shape[0], ops[0].dtype,
                                                    ops[0].device)
            blocks = x[0].shape[0] * cluster
            per_block = np.array(counts, dtype=np.float64).reshape(256, 16)[:blocks]
            cycles = per_block.mean(axis=0)
            total = cycles.sum()
            smids = (ctypes.c_uint * 256)()
            lib.prof_smids(ctypes.cast(smids, ctypes.c_void_p))
            per_sm = np.bincount(np.array(smids[:blocks]))
            print(f"{row} [{src.name}]: {ms:.4f} ms a call (instrumented; chip_smoke.time_ms), "
                  f"clusters of {cluster}, keys per block {kpb}, chunk {chunk}; {blocks} blocks "
                  f"on {np.count_nonzero(per_sm)} SMs (at most {per_sm.max()} on one); "
                  f"{total:.0f} cycles per block (slowest block "
                  f"{per_block.sum(axis=1).max():.0f})")
            for k, name in PHASES.items():
                print(f"  {name:40s} {100 * cycles[k] / total:6.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
