"""ctypes bindings to the native host runtime (``cpp/healnet_runtime.cc``).

Counterpart of ``healnet_tpu/runtime``. The library holds a byte-bounded
LRU of decoded ``.npy`` feature files with a prefetch thread pool
(:class:`NativeFeatureCache`) and the censored c-index
(:func:`concordance_index_native`). It is compiled on first use with the
host's ``c++`` into ``build/runtime-<hash>/libhealnet_runtime.so`` at the
root of the checkout (``<hash>`` covers the source and the flags; never
into ``healnet_tpu/runtime/``, which ``cpp/Makefile`` owns). Where it
cannot be built, :func:`native_available` is false, the feature cache
refuses to start, and the c-index takes its NumPy version
(:func:`healnet_tpu_torch.train.metrics.concordance_index_censored`) with
the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

RUNTIME_SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "healnet_runtime.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
# where the library is built (utils.profiling.enable_compilation_cache moves it)
BUILD_ROOT = RUNTIME_SOURCE.parents[1] / "build"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    """Where the runtime library is built: keyed by the source and flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(RUNTIME_SOURCE.read_bytes())
    return BUILD_ROOT / f"runtime-{digest.hexdigest()[:16]}" / "libhealnet_runtime.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["c++", *CXX_FLAGS, "-o", str(tmp), str(RUNTIME_SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _bind(lib: ctypes.CDLL) -> None:
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.hn_cache_create.restype = ctypes.c_void_p
    lib.hn_cache_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
    lib.hn_cache_destroy.restype = None
    lib.hn_cache_destroy.argtypes = [ctypes.c_void_p]
    lib.hn_cache_ensure.restype = ctypes.c_int64
    lib.hn_cache_ensure.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64, i64]
    lib.hn_cache_read.restype = ctypes.c_int
    lib.hn_cache_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.hn_cache_prefetch.restype = None
    lib.hn_cache_prefetch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int]
    for fn in ("hn_cache_bytes", "hn_cache_count", "hn_cache_hits", "hn_cache_heals"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.hn_concordance_index.restype = ctypes.c_int
    lib.hn_concordance_index.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        i64, i64, i64, i64, ctypes.POINTER(ctypes.c_double)]


def native_library() -> Optional[ctypes.CDLL]:
    """The loaded runtime library, built on the first call; None when it
    cannot be built or loaded (tried once)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            path = _build() if RUNTIME_SOURCE.exists() else None
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:
                    lib = None
                if lib is not None:
                    _bind(lib)
                    _LIB = lib
        return _LIB


def native_available() -> bool:
    return native_library() is not None


class NativeFeatureCache:
    """Byte-bounded LRU over decoded ``.npy`` feature files (little-endian
    f4 / f8, C order, decoded to float32) with a prefetch thread pool."""

    def __init__(self, capacity_mb: int = 2048, n_threads: int = 2):
        lib = native_library()
        if lib is None:
            raise RuntimeError("native runtime unavailable (c++ build failed or missing)")
        self._lib = lib
        self._handle = lib.hn_cache_create(capacity_mb * 1024 * 1024, n_threads)
        self._warned_thrash = False

    def load(self, path) -> np.ndarray:
        path_b = str(path).encode()
        ndim = ctypes.c_int64()
        shape = (ctypes.c_int64 * 8)()
        count = self._lib.hn_cache_ensure(self._handle, path_b, ctypes.byref(ndim), shape)
        if count < 0:
            raise IOError(f"native cache could not load {path}")
        out = np.empty(count, dtype=np.float32)
        ok = self._lib.hn_cache_read(
            self._handle, path_b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count)
        if not ok:
            raise IOError(f"native cache read failed for {path} (IO error)")
        heals = int(self._lib.hn_cache_heals(self._handle))
        if heals >= 64 and not self._warned_thrash:
            hits = int(self._lib.hn_cache_hits(self._handle))
            if heals > max(hits, 1):
                self._warned_thrash = True
                warnings.warn(
                    f"native feature cache is thrashing ({heals} self-healed reads vs "
                    f"{hits} hits): capacity is undersized for the working set, so every "
                    "load pays a second disk read. Raise native_cache_mb.",
                    stacklevel=2,
                )
        return out.reshape(tuple(shape[i] for i in range(ndim.value)))

    def prefetch(self, paths: Sequence) -> None:
        encoded = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        self._lib.hn_cache_prefetch(self._handle, arr, len(encoded))

    @property
    def stats(self) -> dict:
        return {
            "bytes": int(self._lib.hn_cache_bytes(self._handle)),
            "entries": int(self._lib.hn_cache_count(self._handle)),
            "hits": int(self._lib.hn_cache_hits(self._handle)),
            # reads that healed after an eviction race: persistently high
            # against hits means capacity_mb is too small for the working set
            "heals": int(self._lib.hn_cache_heals(self._handle)),
        }

    def __del__(self):  # pragma: no cover
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.hn_cache_destroy(handle)
            self._handle = None


def concordance_index_native(
    event_indicator: np.ndarray,
    event_time: np.ndarray,
    estimate: np.ndarray,
    tied_tol: float = 1e-8,
) -> Tuple[float, int, int, int, int]:
    """The native c-index (the NumPy one where the library is missing):
    ``(cindex, concordant, discordant, tied_risk, tied_time)``."""
    lib = native_library()
    if lib is None:
        from healnet_tpu_torch.train.metrics import concordance_index_censored

        return concordance_index_censored(event_indicator, event_time, estimate, tied_tol)
    event = np.ascontiguousarray(np.asarray(event_indicator, bool).reshape(-1).view(np.uint8))
    time = np.ascontiguousarray(np.asarray(event_time, dtype=np.float64).reshape(-1))
    est = np.ascontiguousarray(np.asarray(estimate, dtype=np.float64).reshape(-1))
    if not (event.shape[0] == time.shape[0] == est.shape[0]):
        raise ValueError("all inputs must have the same length")
    if not event.any():
        raise ValueError("All samples are censored — concordance index is undefined")
    counts = [ctypes.c_int64() for _ in range(4)]
    ci = ctypes.c_double()
    status = lib.hn_concordance_index(
        event.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        time.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        est.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        time.shape[0], tied_tol, *(ctypes.byref(c) for c in counts), ctypes.byref(ci))
    if status != 0:
        raise ValueError("No comparable pairs available")
    return (float(ci.value), *(c.value for c in counts))


__all__ = [
    "NativeFeatureCache",
    "concordance_index_native",
    "library_path",
    "native_available",
    "native_library",
]
