"""Gated activations, temperature softmax and the attention mask fill value.

Counterpart of ``healnet_tpu/ops/activations.py``: the input splits in half
along the channel axis, ``x, gates = split(...)``, and the output is
``x * act(gates)``. GELU is the exact erf form. ``temperature_softmax`` is
``softmax(logits / temperature)``, the reference's T=0.5 attention softmax
as a standalone function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mask_value(dtype: torch.dtype) -> float:
    """Fill for masked logits: half of -finfo.max, so a division by the
    softmax temperature stays finite and fully masked rows stay NaN-free."""
    return -0.5 * float(torch.finfo(dtype).max)


def gated_gelu(x: torch.Tensor) -> torch.Tensor:
    x, gates = torch.chunk(x, 2, dim=-1)
    return x * F.gelu(gates, approximate="none")


def gated_selu(x: torch.Tensor) -> torch.Tensor:
    x, gates = torch.chunk(x, 2, dim=-1)
    return x * F.selu(gates)


def gated_relu(x: torch.Tensor) -> torch.Tensor:
    x, gates = torch.chunk(x, 2, dim=-1)
    return x * F.relu(gates)


GATED_ACTIVATIONS = {
    "gelu": gated_gelu,
    "selu": gated_selu,
    "relu": gated_relu,
}


def temperature_softmax(logits: torch.Tensor, temperature: float = 1.0,
                        axis: int = -1) -> torch.Tensor:
    """Temperature-scaled softmax along ``axis``."""
    return torch.softmax(logits / temperature, dim=axis)
