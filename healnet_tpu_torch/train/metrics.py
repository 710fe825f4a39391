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
loaded by :mod:`healnet_tpu_torch.runtime`, which builds the library on
first use into ``build/runtime-<hash>/``. Where it cannot be built it takes
:func:`concordance_index_censored`, the NumPy version, with the same
results; :func:`cindex_implementation` says which one runs. This is a host
metric, read once per epoch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from healnet_tpu_torch.runtime import (  # noqa: F401  (the c-index's public names)
    concordance_index_native,
    library_path,
    native_library,
)


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


def cindex_implementation() -> str:
    """``"native"`` or ``"numpy"``: which c-index :func:`concordance_index_native` runs."""
    return "native" if native_library() is not None else "numpy"
