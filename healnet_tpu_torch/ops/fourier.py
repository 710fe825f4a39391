"""Fourier positional encodings over N spatial axes.

Counterpart of ``healnet_tpu/ops/fourier.py``: per spatial axis, positions
are ``linspace(-1, 1, size)``; ``fourier_encode`` multiplies them by
``linspace(1, max_freq / 2, num_bands) * pi`` and concatenates
``[sin, cos, raw]``, giving ``2 * num_bands + 1`` features per axis.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def fourier_encode(x: torch.Tensor, max_freq: float, num_bands: int = 4) -> torch.Tensor:
    """``(...)`` positions -> ``(..., 2 * num_bands + 1)``: ``[sin, cos, raw]``."""
    x = x[..., None]
    scales = torch.linspace(
        1.0, max_freq / 2.0, num_bands, dtype=x.dtype, device=x.device
    )
    scales = scales.reshape((1,) * (x.ndim - 1) + (num_bands,))
    scaled = x * scales * math.pi
    return torch.cat([torch.sin(scaled), torch.cos(scaled), x], dim=-1)


def fourier_channels(n_axes: int, num_bands: int) -> int:
    """Encoded channel count of a modality."""
    return n_axes * (2 * num_bands + 1)


def positional_encoding(
    spatial_shape: Sequence[int],
    max_freq: float,
    num_bands: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """``(*spatial_shape, n_axes * (2 * num_bands + 1))`` encoding grid."""
    axis_pos = [
        torch.linspace(-1.0, 1.0, size, dtype=dtype, device=device)
        for size in spatial_shape
    ]
    grids = torch.meshgrid(*axis_pos, indexing="ij")
    pos = torch.stack(grids, dim=-1)  # (*spatial, n_axes)
    enc = fourier_encode(pos, max_freq, num_bands)  # (*spatial, n_axes, 2b+1)
    return enc.reshape(*spatial_shape, -1)
