"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/kernels-<hash>/lib<name>.so`` at the root of the checkout,
where ``<hash>`` covers every source under ``csrc/`` and the compiler flags,
so an edited source never loads a stale library. Nothing is compiled or
loaded at import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
KERNELS = ("fused_project", "fused_project_tma", "fused_project_f32", "fused_project_bwd",
           "flash_attention", "flash_attention_bwd", "flash_wide", "fused_chain")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": compile time, "ptxas": register/spill report and warnings}
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built with the CUDA "
        "toolkit's nvcc on the machine with the GPU"
    )


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"


def _compile(name: str) -> Path:
    out = build_dir() / f"lib{name}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": "\n".join(
            line.strip() for line in proc.stderr.splitlines()
            if any(key in line for key in ("Compiling entry", "Used", "stack frame", "arning",
                                           "Performance Loss"))
        ),
    }
    return out


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named sources in parallel (one nvcc each, started
    together) and return each one's compile seconds (0 when cached)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(_compile, n) for n in names]:
            fut.result()
    return {n: float(BUILD_LOG.get(n, {}).get("seconds", 0.0)) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_compile(name)))
        lib.healnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.healnet_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.healnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
