#!/usr/bin/env python3
"""What bounds the flash kernels' FMA variants: their time with a part taken out.

    python3 scripts/probe_flash_variants.py [--kernel fwd|bwd|wide] [--d 320]

Needs one CUDA GPU and nvcc. ``ncu`` is not available everywhere, so this
builds copies of ``flash_attention.cu`` (``fwd``) or
``flash_attention_bwd.cu`` (``bwd``) into ``build/flash-variants/<kernel>/``
with one part of the FMA kernel's work removed, and times each
(``chip_smoke.time_ms``) beside the kernel as it is, at brca (8, 17, 4096,
63) and kirp (8, 17, 4096, 27) in f32, unmasked (``chip_smoke.FLASH_SHAPES``).
A variant's outputs are wrong by design; only its time is read. Each edit is
found by its anchor text and the script raises if the source moved on.

``fwd``: ``no staging`` (the ring issues no copies after the first tiles),
``no unpack`` (no tile after the first is shifted into the aligned
tiles), ``no scores`` (one shared load in place of a row's dot products),
``no p V`` (one add in place of the product with the value tile).

``bwd``: ``no staging``, ``no unpack`` as above, ``no dk dv`` (no dk/dv
products or stores), ``no s dp`` (one shared load in place of the two dot
products of a row), ``no dq`` (one add in place of dq += dS K).

``wide``: the kernels of ``flash_wide.cu``, forward and backward at
(8, 17, 4096, d) in f32 and bf16 (``--d``: 320 by default; past 512 the
panel kernels): ``no staging`` (no K/V row copies, all four kernels; the
bf16 panels' bulk-copy barriers still arrive, expecting no bytes), and per
kernel the products or stores named (``tc``: the bf16 kernels, ``fma``:
the f32 ones).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import FLASH_SHAPES, attention_inputs, time_ms  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import flash_attention as fa  # noqa: E402

CSRC = ROOT / "healnet_tpu_torch/ops/csrc"
OUT = ROOT / "build/flash-variants"
SOURCES = {"fwd": "flash_attention", "bwd": "flash_attention_bwd", "wide": "flash_wide"}
# the f32 wide kernels' dot-product loop over a lane's half of the head, and
# the same loop run for no channel
FMA_DOTS = ("        for (int c = 4 * half; c < dp; c += 8) {\n"
            "          const float4 kv = *reinterpret_cast<const float4*>(kr + c);")
FMA_NO_DOTS = FMA_DOTS.replace("c < dp", "c < 0")
# variant -> [(anchor, replacement)]
VARIANTS = {
    "fwd": {
        "as is": [],
        "no staging": [("      if (it + St < ntiles)\n        rc.issue(",
                        "      if (false)\n        rc.issue(")],
        "no unpack": [("    if (it + 1 < ntiles)\n      fv::unpack<T, DP>(",
                       "    if (false)\n      fv::unpack<T, DP>(")],
        "no scores": [("      fv::tile_dots<DP, NS, 1>(sc, qs, nullptr, ks, nullptr, warp, lane);\n",
                       "      for (int s = 0; s < NS; ++s) sc[0][s] = ks[lane * P + s];\n")],
        "no p V": [("      fv::tile_axpy<DP, NS>(a, pw, KT, vs, lane);\n",
                    "      a[0][0] += pw[lane];\n")],
    },
    "bwd": {
        "as is": [],
        "no staging": [("        if (it + St < ntiles)\n          rc.issue(",
                        "        if (false)\n          rc.issue(")],
        "no unpack": [("      if (it + 1 < ntiles)\n        fv::unpack<T, DP>(",
                       "      if (false)\n        fv::unpack<T, DP>(")],
        "no dk dv": [("      dkdv_tile<T, DP>(p, pd, pd + rows * KT,",
                      "      if (false) dkdv_tile<T, DP>(p, pd, pd + rows * KT,")],
        "no s dp": [("        fv::tile_dots<DP, NS, 2>(sd, qs, dos, ks, vs, warp, lane);\n",
                     "        for (int s = 0; s < NS; ++s) sd[0][s] = sd[1][s] = ks[lane * P + s];\n")],
        "no dq": [("        fv::tile_axpy<DP, NS>(dqa, ds + warp * KT, tc::kWarps * KT, ks, lane);\n",
                   "        dqa[0][0] += ds[lane];\n")],
    },
    "wide": {
        "as is": [],
        "no staging": [("    for (int c = lane; c < n; c += 32) tc::cp_async16(",
                        "    for (int c = lane; c < 0; c += 32) tc::cp_async16("),
                       ("      hp::mbar_expect_tx(bar, bytes);\n      if (bytes > 0)",
                        "      hp::mbar_expect_tx(bar, 0u);\n      if (false)")],
        "no tc scores": [("kb_row + kk * 16);\n              tc::mma_bf16(s4,",
                          "kb_row + kk * 16);\n              if (false) tc::mma_bf16(s4,")],
        "no tc p V": [("tc::mma_bf16(acc[mt][i], pa,", "if (false) tc::mma_bf16(acc[mt][i], pa,")],
        "no tc dq": [("tc::mma_bf16(dqa[mt][i], a,", "if (false) tc::mma_bf16(dqa[mt][i], a,")],
        "no tc dk dv": [("tile_dkdv_tc(pt, dos, sdv,", "if (false) tile_dkdv_tc(pt, dos, sdv,"),
                        ("tile_dkdv_tc(dst, qs, sdv", "if (false) tile_dkdv_tc(dst, qs, sdv")],
        "no tc dk dv store": [("store_dkv<bf16, kWarps>(sdv, P, dk, dv, k0, blk.kv_end,",
                               "if (last) __syncthreads(); if (false) store_dkv<bf16, kWarps>("
                               "sdv, P, dk, dv, k0, blk.kv_end,")],
        "no fma scores": [(FMA_DOTS + "\n#pragma", FMA_NO_DOTS + "\n#pragma")],
        "no fma p V": [("j < KT; j += 4) {\n          float4 pv[NS];",
                        "j < 0; j += 4) {\n          float4 pv[NS];")],
        "no fma s dp": [(FMA_DOTS + "\n          const float4 vv",
                         FMA_NO_DOTS + "\n          const float4 vv")],
        "no fma dq": [("j < KT; j += 4) {\n          float4 dv4[NS];",
                       "j < 0; j += 4) {\n          float4 dv4[NS];")],
        "no fma dk dv": [("#pragma unroll 2\n      for (int i = 0; i < nq; ++i) {",
                          "#pragma unroll 2\n      for (int i = 0; i < 0; ++i) {")],
        "no fma dk dv store": [("store_dkv<float, NW>(sdv, P, dk, dv, k0, blk.kv_end,",
                                "if (last) __syncthreads(); if (false) store_dkv<float, NW>("
                                "sdv, P, dk, dv, k0, blk.kv_end,")],
    },
}


def build(kernel: str, name: str) -> Path:
    source = SOURCES[kernel]
    src = (CSRC / f"{source}.cu").read_text()
    for anchor, text in VARIANTS[kernel][name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} is gone from {source}.cu")
        src = src.replace(anchor, text)
    out = OUT / kernel / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{source}.cu").write_text(src)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    lib = out / f"lib{source}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(out / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return lib


def use(kernel: str, path: Path) -> None:
    """Make the wrapper load ``path`` in place of the kernel's library."""
    lib = ctypes.CDLL(str(path))
    lib.healnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.healnet_cuda_error_string.restype = ctypes.c_char_p
    cuda_build._LIBS[SOURCES[kernel]] = lib
    fa._RESIDENT.clear()
    fa._max_queries.cache_clear()


def wide_runs(gen, d: int) -> dict:
    """Forward and backward of the wide (or panel) kernels at (8, 17, 4096,
    d), f32 and bf16, unmasked."""
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name, eff = str(dtype)[6:], d**-0.5 / 0.5
        q, k, v = attention_inputs(gen, 8, 17, 4096, d, dtype)
        out, lse = fa.flash_attention_kernel(q, k, v, None, eff)
        do = torch.randn((8, 1, 17, d), generator=gen, device="cuda").to(dtype)
        delta = (do.float() * out.float().reshape(8, 1, 17, d)).sum(-1)
        runs[f"{name} forward"] = (lambda q=q, k=k, v=v:
                                   fa.flash_attention_kernel(q, k, v, None, eff))
        runs[f"{name} backward"] = (lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta:
                                    fa.flash_attention_bwd_kernel(q, k, v, None, do, lse, delta,
                                                                  eff))
    return runs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="fwd")
    parser.add_argument("--d", type=int, default=320, help="head dim of --kernel wide")
    args = parser.parse_args()
    kernel = args.kernel
    if not torch.cuda.is_available():
        print("probe_flash_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    names = list(VARIANTS[kernel])
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(kernel, n), names)))
    cuda_build.build(tuple(SOURCES.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = wide_runs(gen, args.d) if kernel == "wide" else {}
    for label in (() if kernel == "wide" else ("brca f32", "kirp f32")):
        d, width, dtype = FLASH_SHAPES[label]
        eff = d**-0.5 / 0.5
        q, k, v = attention_inputs(gen, 8, 17, 4096, d, dtype, width=width)
        out, lse = fa.flash_attention_kernel(q, k, v, None, eff)
        do = torch.randn((8, 1, 17, d), generator=gen, device="cuda")
        delta = (do * out.reshape(8, 1, 17, d)).sum(-1)
        runs[label] = ((lambda q=q, k=k, v=v, eff=eff: fa.flash_attention_kernel(q, k, v, None, eff))
                       if kernel == "fwd" else
                       (lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, eff=eff:
                        fa.flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff)))
    for name, path in libs.items():
        use(kernel, path)
        times = "; ".join(f"{label} {time_ms(run)[0]:.4f} ms" for label, run in runs.items())
        print(f"{name}: {times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
