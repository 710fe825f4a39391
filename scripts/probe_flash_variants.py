#!/usr/bin/env python3
"""What bounds the flash kernels' FMA variants: their time with a part taken out.

    python3 scripts/probe_flash_variants.py [--kernel fwd|bwd]

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
SOURCES = {"fwd": "flash_attention", "bwd": "flash_attention_bwd"}
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="fwd")
    kernel = parser.parse_args().kernel
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
    runs = {}
    for label in ("brca f32", "kirp f32"):
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
