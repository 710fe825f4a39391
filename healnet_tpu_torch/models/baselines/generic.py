"""Generic MLP baselines: FCNN and RegularizedFCNN.

Counterpart of ``healnet_tpu/models/baselines/generic.py``:

- :class:`FCNN`: a plain MLP with explicit layer sizes;
- :class:`RegularizedFCNN`: the pipeline's ``fcnn`` baseline, input -> 128
  -> 64 -> sigmoid(out) with dropout, and l1 / l2 penalty helpers over the
  Dense kernels.

Both flatten the first tensor they are given; its per-sample shape
(``input_shapes[0]``) sizes the input layer, where Flax infers it at init.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.models.baselines.common import Block, dropout
from healnet_tpu_torch.models.layers import torch_dense


def _first_flat(tensors) -> torch.Tensor:
    x = tensors[0] if isinstance(tensors, (list, tuple)) else tensors
    return x.reshape(x.shape[0], -1)


def _flat_width(input_shapes) -> int:
    return math.prod(input_shapes[0])


def _kernels(module: nn.Module, params: Optional[Mapping[str, torch.Tensor]]):
    """The Dense kernels (weights of two or more axes) of ``params`` (a
    name -> tensor mapping) or of the module's own parameters."""
    items = params.items() if params is not None else module.named_parameters()
    return [p for name, p in items if name.endswith("weight") and p.ndim >= 2]


class FCNN(Block):
    """Plain MLP baseline: ``input`` + ReLU, ``hidden_{i}`` + dropout + ReLU,
    ``output``."""

    def __init__(self, hidden_sizes: Sequence[int], output_size: int, dropout: float = 0.5,
                 *, input_shapes: Sequence[Sequence[int]], device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.hidden_sizes, self.output_size, self.dropout = list(hidden_sizes), output_size, dropout
        self.input = torch_dense(self.hidden_sizes[0], _flat_width(input_shapes))
        for i, (fan_in, width) in enumerate(zip(self.hidden_sizes, self.hidden_sizes[1:])):
            self.add_module(f"hidden_{i}", torch_dense(width, fan_in))
        self.output = torch_dense(output_size, self.hidden_sizes[-1])
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None):
        x = F.relu(self.input(_first_flat(tensors)))
        for i in range(len(self.hidden_sizes) - 1):
            x = getattr(self, f"hidden_{i}")(x)
            x = F.relu(dropout(x, self.dropout, generator, self.training))
        return self.output(x)


class RegularizedFCNN(Block):
    """MLP with sigmoid output and weight-penalty helpers."""

    def __init__(self, output_dim: int, dropout_rate: float = 0.2, l1_penalty: float = 0.01,
                 l2_penalty: float = 0.01, *, input_shapes: Sequence[Sequence[int]],
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.output_dim, self.dropout_rate = output_dim, dropout_rate
        self.l1_penalty, self.l2_penalty = l1_penalty, l2_penalty
        self.input = torch_dense(128, _flat_width(input_shapes))
        self.hidden = torch_dense(64, 128)
        self.output = torch_dense(output_dim, 64)
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None):
        x = F.relu(self.input(_first_flat(tensors)))
        x = F.relu(self.hidden(x))
        x = dropout(x, self.dropout_rate, generator, self.training)
        return torch.sigmoid(self.output(x))

    def l1_regularization(self, params: Optional[Mapping[str, torch.Tensor]] = None):
        """``l1_penalty`` times the summed |kernel| entries."""
        return self.l1_penalty * sum(torch.sum(torch.abs(k)) for k in _kernels(self, params))

    def l2_regularization(self, params: Optional[Mapping[str, torch.Tensor]] = None):
        """``l2_penalty`` times the summed Frobenius norms of the kernels."""
        return self.l2_penalty * sum(torch.linalg.norm(k) for k in _kernels(self, params))
