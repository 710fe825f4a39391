"""Survival metrics: the censored concordance index.

Counterpart of ``healnet_tpu/train/metrics.py`` and of the c-index binding
in ``healnet_tpu/runtime``: ``sksurv.metrics.concordance_index_censored``
semantics (events ``(1 - censorship).astype(bool)``, ``tied_tol=1e-8``):

- a pair (i, j) is comparable iff sample i has an event and either
  ``time_j > time_i``, or ``time_j == time_i`` with j censored;
- a comparable pair is concordant when the shorter-surviving sample has the
  strictly higher risk estimate; estimates within ``tied_tol`` count 0.5.

:func:`concordance_index_native` runs ``hn_concordance_index`` of
``cpp/healnet_runtime.cc`` (a sort and one pass per event, no framework),
compiled on first use with the host's ``c++`` into ``build/runtime-<hash>/``
at the root of the checkout. Where it cannot be built it takes
:func:`concordance_index_censored`, the NumPy version, with the same
results; :func:`cindex_implementation` says which one runs. This is a host
metric, read once per epoch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

RUNTIME_SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "healnet_runtime.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def concordance_index_censored(
    event_indicator: np.ndarray,
    event_time: np.ndarray,
    estimate: np.ndarray,
    tied_tol: float = 1e-8,
) -> Tuple[float, int, int, int, int]:
    """``(cindex, concordant, discordant, tied_risk, tied_time)`` in NumPy,
    counted over blocks of rows (bounded memory)."""
    event = np.asarray(event_indicator).astype(bool).reshape(-1)
    time = np.asarray(event_time, dtype=np.float64).reshape(-1)
    est = np.asarray(estimate, dtype=np.float64).reshape(-1)
    n = time.shape[0]
    if not (event.shape[0] == n == est.shape[0]):
        raise ValueError("all inputs must have the same length")
    if not event.any():
        raise ValueError("All samples are censored — concordance index is undefined")
    concordant = tied_risk = total = tied_time = 0
    block = max(1, int(2**22 // max(n, 1)))  # ~32 MB of f64 per block
    for start in range(0, n, block):
        sl = slice(start, min(start + block, n))
        later = time[None, :] > time[sl, None]
        ties_t = time[None, :] == time[sl, None]
        comparable = event[sl, None] & (later | (ties_t & ~event[None, :]))
        rows = np.arange(sl.start, sl.stop)
        comparable[np.arange(rows.size), rows] = False  # no self-pairs
        diff = est[sl, None] - est[None, :]
        concordant += int(np.sum(comparable & (diff > tied_tol)))
        tied_risk += int(np.sum(comparable & (np.abs(diff) <= tied_tol)))
        total += int(np.sum(comparable))
        tied_time += int(np.sum(comparable & ties_t))
    if total == 0:
        raise ValueError("No comparable pairs available")
    discordant = total - concordant - tied_risk
    return float((concordant + 0.5 * tied_risk) / total), concordant, discordant, tied_risk, \
        tied_time


def library_path() -> Path:
    """Where the runtime library is built: keyed by the source and flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(RUNTIME_SOURCE.read_bytes())
    return RUNTIME_SOURCE.parents[1] / "build" / f"runtime-{digest.hexdigest()[:16]}" / \
        "libhealnet_runtime.so"


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
                    i64 = ctypes.POINTER(ctypes.c_int64)
                    lib.hn_concordance_index.restype = ctypes.c_int
                    lib.hn_concordance_index.argtypes = [
                        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
                        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
                        i64, i64, i64, i64, ctypes.POINTER(ctypes.c_double)]
                    _LIB = lib
        return _LIB


def cindex_implementation() -> str:
    """``"native"`` or ``"numpy"``: which c-index :func:`concordance_index_native` runs."""
    return "native" if native_library() is not None else "numpy"


def concordance_index_native(
    event_indicator: np.ndarray,
    event_time: np.ndarray,
    estimate: np.ndarray,
    tied_tol: float = 1e-8,
) -> Tuple[float, int, int, int, int]:
    """The native c-index (the NumPy one where the library is missing);
    the same tuple as :func:`concordance_index_censored`."""
    lib = native_library()
    if lib is None:
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
