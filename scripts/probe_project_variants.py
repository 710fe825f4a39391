#!/usr/bin/env python3
"""What bounds a projection kernel: its time with a part taken out.

    python3 scripts/probe_project_variants.py [--kernel tma|generic|f32|bwd]

Needs one CUDA GPU and nvcc. ``ncu`` is not available everywhere, so this
builds copies of one kernel's source into ``build/project-variants/<kernel>/``
with one part of the work removed, and times each (``chip_smoke.time_ms``)
beside the kernel as it is. A variant's outputs are wrong by design; only
its time is read. Each edit is found by its anchor text and the script
raises if the source moved on.

``tma`` (``fused_project_tma.cu``, the default), at brca and kirp in bf16
and int8 and the omic vector (``chip_smoke.PROJECT_SHAPES``):

- ``no products``: the consumers issue no wgmma (loads, row sums, int8
  conversion and the epilogue remain);
- ``no epilogue``: nothing after the row statistics (no encoding values,
  normalisation or stores);
- ``no context``: the context tiles are not loaded (the weights are; the
  products run on whatever the ring holds);
- ``no encoding``: the epilogue does not copy the encoding projection's
  values into its staged rows (it finishes the products over whatever
  they hold).

``generic`` (the hull kinds of ``fused_project_tma.cu``: rows at any byte
offset), at the parity layout's slide (8, 2048, 4095), the image
modality (8, 50176, 3) and brca's and kirp's bag forced onto the route:

- ``no realign``: the consumers neither shift nor convert the staged hull
  rows (the products run on whatever the conversion tiles hold; no row
  sums);
- ``no products``: no wgmma (the realignment and epilogue remain);
- ``no context``: the hull rows are not copied (the weights are);
- ``no epilogue``, ``no encoding``: as for ``tma``.

``f32`` (``fused_project_f32.cu``), at brca and kirp in f32 and brca int8
with f32 compute, beside ``torch.matmul`` f32; then the SM clock and power
draw ``nvidia-smi`` samples while the kernel runs back to back:

- ``no products``: one add a row and channel in place of the row's 16-17
  FMAs (the shared loads, staging, row sums and epilogue remain);
- ``no staging``: no context or weight copies into the ring (the products
  run on whatever it holds);
- ``one ahead``, ``three ahead``: the operands loaded 1 or 3 channels ahead
  of their products (the kernel loads them 2 ahead).

``bwd`` (``fused_project_bwd.cu``), at brca bf16 and f32, kirp bf16 and
brca int8 with the scale and bsum (8, 4096, F), beside ``torch.mul(g, 2.0)``
(one elementwise pass over the same bytes in and out):

- ``no tail``: each block returns after writing its partial column sums
  (no tickets, no second and third pass over the partials);
- ``one level``: the column sums finished in one level in place of two:
  one ticket, and the last block adds every block's partial of a column
  in block order, 32 loads in flight a thread;
- ``no row stats``: s1 and s2 not copied (the rows' factors come from
  whatever the ring holds);
- ``no stores``: d_raw is not written.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    BATCH, GENERIC_SHAPES, PATCH, PROJECT_SHAPES, TOKENS, projection_timing, time_ms)
from healnet_tpu_torch.ops import cuda_build  # noqa: E402
from healnet_tpu_torch.ops import fused_project as fp  # noqa: E402

CSRC = ROOT / "healnet_tpu_torch/ops/csrc"
OUT = ROOT / "build/project-variants"
SOURCES = {"tma": "fused_project_tma", "generic": "fused_project_tma",
           "f32": "fused_project_f32", "bwd": "fused_project_bwd"}
CONVERTED = "        hw::named_sync(2 + wg, 128);  // the warpgroup's tile is converted\n"
REALIGNED = ("        hw::named_sync(2 + wg, 128);  // the warpgroup's tile is realigned "
             "(and its sums out)\n")
PRODUCTS = "        mma_step<NB>(acc, conv, st + p.ctx_bytes, ks > 0);\n"
NO_EPILOGUE = [("    for (int h = 0; h < 2; ++h) {\n      const int rbase = r0",
                "    for (int h = 0; h < 2 * (p.M < 0); ++h) {\n      const int rbase = r0")]
NO_ENCODING = [("  for (int r = 0; r < nr; ++r) {\n    const __nv_bfloat16* src = p.encp",
                "  for (int r = 0; r < nr * (p.M < 0); ++r) {\n    const __nv_bfloat16* src = p.encp")]
VARIANTS = {
    "tma": {
        "as is": [],
        "no products": [
            (CONVERTED + PRODUCTS, CONVERTED),
            ("        mma_step<NB>(acc, st + a_off, st + p.ctx_bytes, ks > 0);\n", ""),
        ],
        "no epilogue": NO_EPILOGUE,
        "no encoding": NO_ENCODING,
        "no context": [
            ("      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes);",
             "      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes - p.ctx_bytes);"),
            ("        hw::tma_load(st, &p.ctx_map, &full[pos.stage], ks * kBK, row_tile * kRows);\n",
             ""),
        ],
    },
    "generic": {
        "as is": [],
        "no realign": [("        realign(st + hull.off, conv, hull, s1[0], s2[0]);\n", "")],
        "no products": [(REALIGNED + PRODUCTS, REALIGNED)],
        "no context": [
            ("      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes);",
             "      hw::mbar_expect_tx(&full[pos.stage], p.tx_bytes - p.ctx_bytes);"),
            ("        for (int j = 0; j < (1 << p.class_bits); ++j)\n",
             "        for (int j = 0; j < (1 << p.class_bits) * (p.M < 0); ++j)\n"),
        ],
        "no epilogue": NO_EPILOGUE,
        "no encoding": NO_ENCODING,
    },
    "f32": {
        "as is": [],
        "no products": [
            ("          acc[i][j] = fmaf(av[k % kBufs][i], bv[k % kBufs][j], acc[i][j]);\n",
             "          if (j == 0) acc[i][0] += av[k % kBufs][i] + bv[k % kBufs][2 * i] +"
             " bv[k % kBufs][2 * i + 1];\n"),
        ],
        "no staging": [
            ("      load_context(slot_a(s), dat, row0, s * kBK, M, C, vec, tid);\n"
             "      load_weights<NB>(slot_b(s), wp + (size_t)s * kBK * NB, tid);\n", ""),
        ],
        "one ahead": [("    constexpr int kAhead = 2,", "    constexpr int kAhead = 1,")],
        "three ahead": [("    constexpr int kAhead = 2,", "    constexpr int kAhead = 3,")],
    },
    "bwd": {
        "as is": [],
        "no tail": [
            ("  if (take_ticket(&counters[grp], &ticket) != (unsigned)g_size - 1) return;\n",
             "  if (n_groups >= 0) return;\n"),
        ],
        "one level": [
            ("  // first level: the last block of each group of kGroup adds its group's\n",
             "  {\n"
             "    constexpr int kLoads = 32;\n"
             "    if (take_ticket(&counters[0], &ticket) != (unsigned)n_blocks - 1) return;\n"
             "    for (int j = threadIdx.x; j < 2 * F; j += kThreads) {\n"
             "      const float* src = part + (size_t)(j % F / chunk_cols * gridDim.x) * 2 * F + j;\n"
             "      float a = 0.f;\n"
             "      for (int k0 = 0; k0 < (int)gridDim.x; k0 += kLoads) {\n"
             "        float v[kLoads];\n"
             "#pragma unroll\n"
             "        for (int k = 0; k < kLoads; ++k)\n"
             "          v[k] = k0 + k < (int)gridDim.x ? __ldcg(src + (size_t)(k0 + k) * 2 * F)"
             " : 0.f;\n"
             "#pragma unroll\n"
             "        for (int k = 0; k < kLoads; ++k) a += v[k];\n"
             "      }\n"
             "      dsum2[j] = a;\n"
             "    }\n"
             "    if (threadIdx.x == 0) counters[0] = 0u;\n"
             "    return;\n"
             "  }\n"),
        ],
        "no row stats": [
            ("      copy_vec<4>(stat(i, 0), s1 + r, ok);\n"
             "      copy_vec<4>(stat(i, 1), s2 + r, ok);\n", ""),
        ],
        "no stores": [
            ("          *reinterpret_cast<V*>(d_raw + r * F + col) = o;\n",
             "          if (to_float(o.v[0]) == 12345.f)\n"
             "            *reinterpret_cast<V*>(d_raw + r * F + col) = o;\n"),
        ],
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
    fp._resident_blocks.cache_clear()


def clocks_while(run, seconds: float = 2.0) -> str:
    """The SM clock and power draw ``nvidia-smi`` samples every 100 ms while
    ``run`` goes back to back."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                run()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    samples = [line.strip() for line in out.splitlines() if line.strip()]
    return "; ".join(samples[2:-1] or samples)


def runs_for(kernel: str, gen) -> dict:
    """label -> a call of the kernel at the probed shapes."""
    if kernel == "generic":
        return {label: projection_timing(gen, *GENERIC_SHAPES[label][:5], route="generic")[1]
                for label in ("parity wsi", "image", "brca forced", "kirp forced")}
    if kernel == "tma":
        return {label: projection_timing(gen, *PROJECT_SHAPES[label])[1]
                for label in ("brca", "brca int8", "kirp", "kirp int8", "omic")}
    if kernel == "f32":
        runs, library = {}, {}
        for label, f, dtype in (("brca f32", 252, torch.float32),
                                ("brca int8 -> f32", 252, torch.int8),
                                ("kirp f32", 270, torch.float32)):
            timing, runs[label] = projection_timing(gen, BATCH, TOKENS, PATCH, f, dtype,
                                                    torch.float32)
            library[label] = timing["library_ms"]
        print("torch.matmul f32: " + "; ".join(f"{k} {v:.4f} ms" for k, v in library.items()))
        return runs
    runs, copy = {}, {}
    for label, f, dtype, int8 in (("brca bf16", 252, torch.bfloat16, False),
                                  ("brca f32", 252, torch.float32, False),
                                  ("kirp bf16", 270, torch.bfloat16, False),
                                  ("brca int8 + bsum", 252, torch.bfloat16, True)):
        g = torch.randn((BATCH, TOKENS, f), generator=gen, device="cuda").to(dtype)
        x = torch.randn((BATCH, TOKENS, 40), generator=gen, device="cuda") * 2 + 0.5
        s1, s2 = x.sum(-1), (x * x).sum(-1)
        scale = torch.rand((BATCH, TOKENS), generator=gen, device="cuda") if int8 else None
        runs[label] = (lambda g=g, s1=s1, s2=s2, scale=scale, int8=int8:
                       fp.fused_project_bwd_kernel(g, s1, s2, 40, scale=scale, with_bsum=int8))
        copy[label] = time_ms(lambda g=g: torch.mul(g, 2.0))[0]
    print("torch.mul(g, 2.0), one elementwise pass over g's bytes in and out: "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in copy.items()))
    return runs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--kernel", choices=sorted(SOURCES), default="tma")
    kernel = parser.parse_args().kernel
    if not torch.cuda.is_available():
        print("probe_project_variants: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # torch.matmul f32 in full f32
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    names = list(VARIANTS[kernel])
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(kernel, n), names)))
    cuda_build.build(("fused_project", "fused_project_tma"))
    use(kernel, libs["as is"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = runs_for(kernel, gen)
    for name, path in libs.items():
        use(kernel, path)
        times = "; ".join(f"{label} {time_ms(run)[0]:.4f} ms" for label, run in runs.items())
        print(f"{name}: {times}", flush=True)
    if kernel == "f32":
        use(kernel, libs["as is"])
        print(f"clock, power while brca f32 runs: {clocks_while(runs['brca f32'])}")
        a2d = torch.randn((BATCH * TOKENS, PATCH), generator=gen, device="cuda")
        w = torch.randn((PATCH, 252), generator=gen, device="cuda")
        print(f"clock, power while torch.matmul f32 runs: {clocks_while(lambda: a2d @ w)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
