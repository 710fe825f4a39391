#!/usr/bin/env python3
"""What bounds the Hopper projection kernel: its time with a part taken out.

    python3 scripts/probe_project_variants.py

Needs one CUDA GPU and nvcc. ``ncu`` is not available everywhere, so this
builds copies of ``healnet_tpu_torch/ops/csrc/fused_project_tma.cu`` into
``build/project-variants/`` with one part of the work removed, and times
each (``chip_smoke.time_ms``) at the shapes of ``chip_smoke.PROJECT_SHAPES``
(brca and kirp in bf16 and int8, the omic vector) beside the kernel as it
is:

- ``no products``: the consumers issue no wgmma (loads, row sums, int8
  conversion and the epilogue remain);
- ``no epilogue``: nothing after the row statistics (no encoding values,
  normalisation or stores);
- ``no context``: the context tiles are not loaded (the weights are; the
  products run on whatever the ring holds).

A variant's outputs are wrong by design; only its time is read. Each edit
is found by its anchor text and the script raises if the source moved on.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import PROJECT_SHAPES, projection_timing, time_ms  # noqa: E402
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import fused_project as fp  # noqa: E402

CSRC = ROOT / "healnet_tpu_torch/ops/csrc"
OUT = ROOT / "build/project-variants"
VARIANTS = {
    "as is": [],
    "no products": [
        ("        mma_step<NB>(acc, conv, st + p.ctx_bytes, ks > 0);\n", ""),
        ("        mma_step<NB>(acc, st + a_off, st + p.ctx_bytes, ks > 0);\n", ""),
    ],
    "no epilogue": [
        ("    for (int h = 0; h < 2; ++h) {\n      const int rbase = r0",
         "    for (int h = 0; h < 2 * (p.M < 0); ++h) {\n      const int rbase = r0"),
    ],
    "no context": [
        ("      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes);",
         "      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes - p.ctx_bytes);"),
        ("      hw::tma_load(st, &p.ctx_map, &full[pos.stage], ks * kBK, row_tile * kRows);\n",
         ""),
    ],
}
SHAPES = ("brca", "brca int8", "kirp", "kirp int8", "omic")


def build(name: str) -> Path:
    src = (CSRC / "fused_project_tma.cu").read_text()
    for anchor, text in VARIANTS[name]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} is gone from fused_project_tma.cu")
        src = src.replace(anchor, text)
    out = OUT / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_project_tma.cu").write_text(src)
    shutil.copy(CSRC / "hopper.cuh", out / "hopper.cuh")
    lib = out / "libfused_project_tma.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
           str(out / "fused_project_tma.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_project_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    cuda_build.build(("fused_project",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {label: projection_timing(gen, *PROJECT_SHAPES[label])[1] for label in SHAPES}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.healnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.healnet_cuda_error_string.restype = ctypes.c_char_p
        cuda_build._LIBS["fused_project_tma"] = lib  # the wrapper loads this one now
        fp._resident_blocks.cache_clear()
        times = "; ".join(f"{label} {time_ms(run)[0]:.4f} ms" for label, run in runs.items())
        print(f"{name}: {times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
