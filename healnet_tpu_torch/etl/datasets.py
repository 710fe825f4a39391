"""Generic multimodal dataset, survival discretisation, class weights and
splits: the port's counterpart of ``healnet_tpu/etl/datasets.py``, without
pandas.

:func:`discretize_survival` gives the JAX package's bins bit for bit: there
``pd.qcut`` cuts quantile edges from the chosen subset (all / censored /
uncensored), the outer edges are widened by ``eps``, and ``pd.cut(...,
right=False, include_lowest=True)`` bins every patient. Here the edges are
``np.quantile`` at pandas' quantile levels (linear interpolation) and the
bins ``np.searchsorted`` on the side pandas takes, so a value exactly on an
edge lands where pandas puts it; duplicate edges and values outside the
edges raise, as they do there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from healnet_tpu_torch.etl.base import Dataset


class MMDataset(Dataset):
    """Generic supervised multimodal dataset."""

    def __init__(self, tensors: Sequence[np.ndarray], target: Optional[np.ndarray] = None):
        """
        Args:
            tensors: one array per modality, each with leading sample axis.
            target: optional per-sample label array.
        """
        self.tensors = [np.asarray(t) for t in tensors]
        n = self.tensors[0].shape[0]
        if not all(t.shape[0] == n for t in self.tensors):
            raise ValueError("all modalities must share the sample axis length")
        self.target = None if target is None else np.asarray(target)
        if self.target is not None and self.target.shape[0] != n:
            raise ValueError("the target must have one entry per sample")

    def __getitem__(self, idx):
        sample = [t[idx] for t in self.tensors]
        if self.target is None:
            return sample
        return sample, self.target[idx]

    def __len__(self) -> int:
        return self.tensors[0].shape[0]


def _quantile_edges(values: np.ndarray, n_bins: int) -> np.ndarray:
    """``pd.qcut``'s edges: quantiles at ``linspace(0, 1, n + 1)`` (levels
    not representable in binary rounded up, as pandas does) over the
    non-missing values, linear interpolation."""
    levels = np.linspace(0, 1, n_bins + 1)
    np.putmask(levels, n_bins * levels != np.arange(n_bins + 1), np.nextafter(levels, 1))
    present = values[~np.isnan(values)]
    if present.size == 0:
        raise ValueError("Bin edges must be unique: no values to cut")
    return np.quantile(present[None, :], levels, axis=1, method="linear")[:, 0]


def _check_unique(edges: np.ndarray) -> None:
    if len(np.unique(edges)) < len(edges) and len(edges) != 2:
        raise ValueError(f"Bin edges must be unique: {edges!r}")


def _cut(values: np.ndarray, edges: np.ndarray, right: bool) -> np.ndarray:
    """Bin indices as ``pd.cut(..., labels=False, include_lowest=True)``
    gives them; a value outside the edges (or missing) raises, as the
    integer cast of pandas' NaN bin does."""
    _check_unique(edges)
    ids = np.searchsorted(edges, values, side="left" if right else "right")
    ids[values == edges[0]] = 1  # include_lowest
    outside = np.isnan(values) | (ids == len(edges)) | (ids == 0)
    if outside.any():
        raise ValueError(f"{int(outside.sum())} values fall outside the bin edges {edges!r}")
    return (ids - 1).astype(np.int64)


def discretize_survival(
    df,
    n_bins: int = 4,
    subset: str = "uncensored",
    label_col: str = "survival_months",
    censorship_col: str = "censorship",
    eps: float = 1e-6,
) -> np.ndarray:
    """Survival times binned into quantile bins, as int64 (one per row).

    ``df`` is any mapping of columns (a :class:`~healnet_tpu_torch.etl.table.Table`,
    a dict of arrays, a DataFrame). subset="all": quantile bins over
    everyone. Otherwise the edges come from the censored / uncensored
    subset, the outer ones widened by ``eps`` to cover the whole population,
    and every patient is binned with left-closed intervals.
    """
    valid_subsets = ("all", "uncensored", "censored")
    if subset not in valid_subsets:
        raise ValueError(f"subset must be one of {valid_subsets}")
    labels = np.asarray(df[label_col], dtype=np.float64)
    if subset == "all":
        return _cut(labels, _quantile_edges(labels, n_bins), right=True)
    flag = 1 if subset == "censored" else 0
    chosen = labels[np.asarray(df[censorship_col]) == flag]
    edges = _quantile_edges(chosen, n_bins)
    _check_unique(edges)  # qcut bins the subset first, which needs unique edges
    edges[-1] = np.nanmax(labels) + eps
    edges[0] = np.nanmin(labels) - eps
    return _cut(labels, edges, right=False)


def class_weights(
    y: np.ndarray, scheme: Optional[str] = "inverse", n_bins: Optional[int] = None
) -> Optional[np.ndarray]:
    """Inverse / inverse-root class weights.

    ``n_bins`` pins the weight-vector length: a small fold whose train split
    misses a survival bin must still produce an ``n_bins``-long vector (the
    loss broadcasts weights against ``(b, n_bins)`` hazards). An absent bin
    gets the maximum weight (it is rarer than any observed bin).
    """
    if scheme in (None, "None"):
        return None
    y = np.asarray(y).astype(np.int64)
    counts = np.bincount(y, minlength=int(n_bins) if n_bins else 0).astype(np.float64)
    if n_bins is not None:
        counts = counts[: int(n_bins)]
    missing = counts == 0
    if missing.any():
        counts[missing] = max(counts[~missing].min(), 1.0) if (~missing).any() else 1.0
    if scheme == "inverse":
        return 1.0 / counts
    if scheme == "inverse_root":
        return 1.0 / np.sqrt(counts)
    raise ValueError(f"unknown class-weight scheme {scheme}")


def train_val_test_split(
    n: int,
    train: float = 0.7,
    test: float = 0.15,
    val: float = 0.15,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random 70/15/15 index split, returned in the order train, test, val."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_train = int(round(train * n))
    n_test = int(round(test * n))
    return (
        idx[:n_train],
        idx[n_train : n_train + n_test],
        idx[n_train + n_test :],
    )
