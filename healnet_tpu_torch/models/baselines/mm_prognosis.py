"""MMPrognosis: pancancer prognosis baseline.

Counterpart of ``healnet_tpu/models/baselines/mm_prognosis.py``: each
modality is encoded into a shared 256-d embedding (a patch bag by two 1-D
convolutions over the patch axis, kernel 5, stride 2, ``"SAME"`` padding,
then the mean over the patch axis; a vector by a tanh Linear), the
embeddings fused by their presence-masked mean, then
:class:`BatchStatNorm` -> dropout -> a 10-layer :class:`Highway` network ->
:class:`BatchStatNorm` -> LayerNorm -> a Linear head.

A tensor is a bag when its per-sample shape has two axes both wider than
one, as JAX decides from the shape it sees; ``input_shapes`` gives those
shapes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.models.baselines.common import Block, Conv, dropout
from healnet_tpu_torch.models.layers import LayerNorm, torch_dense


def _is_bag(shape: Sequence[int]) -> bool:
    return len(shape) == 2 and shape[0] > 1 and shape[1] > 1


class BatchStatNorm(nn.Module):
    """Batch normalisation from the current batch's statistics (biased
    variance), with a learned ``weight`` (Flax ``scale``) and ``bias``."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=0, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=0, keepdim=True)
        return self.weight * (x - mean) * torch.rsqrt(var + self.epsilon) + self.bias


class Highway(Block):
    """Gated highway network: x = g * relu(W_n x) + (1 - g) * W_l x."""

    def __init__(self, size: int = 256, num_layers: int = 10, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"gate_{i}", torch_dense(size, size))
            self.add_module(f"nonlinear_{i}", torch_dense(size, size))
            self.add_module(f"linear_{i}", torch_dense(size, size))
        self.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            gate = torch.sigmoid(getattr(self, f"gate_{i}")(x))
            nonlinear = F.relu(getattr(self, f"nonlinear_{i}")(x))
            linear = getattr(self, f"linear_{i}")(x)
            x = gate * nonlinear + (1.0 - gate) * linear
        return x


class MMPrognosis(Block):
    """Multimodal prognosis network over omic and WSI-patch modalities."""

    def __init__(self, output_dims: int = 4, embedding_dims: int = 256, dropout: float = 0.5,
                 batch_norm: bool = True, tokens_layout: bool = False, *,
                 input_shapes: Sequence[Sequence[int]], device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.output_dims, self.dropout = output_dims, dropout
        self.batch_norm, self.tokens_layout = batch_norm, tokens_layout
        self.bags = [_is_bag(s) for s in input_shapes]
        for i, shape in enumerate(input_shapes):
            if self.bags[i]:
                channels = shape[1] if tokens_layout else shape[0]
                self.add_module(f"conv1_m{i}", Conv(channels, 512, (5,), (2,)))
                self.add_module(f"conv2_m{i}", Conv(512, embedding_dims, (5,), (2,)))
            else:
                self.add_module(f"fc_m{i}", torch_dense(embedding_dims, math.prod(shape)))
        if batch_norm:
            self.bn1 = BatchStatNorm(embedding_dims)
        self.highway = Highway(size=embedding_dims, num_layers=10)
        if batch_norm:
            self.bn2 = BatchStatNorm(embedding_dims)
        self.final_norm = LayerNorm(embedding_dims)
        self.final_head = torch_dense(output_dims, embedding_dims)
        self.reset_parameters(generator)
        self.to(device)

    def forward(self, tensors, presence=None, generator: Optional[torch.Generator] = None):
        if len(tensors) != len(self.bags):
            raise ValueError(f"expected {len(self.bags)} modalities, got {len(tensors)}")
        b = tensors[0].shape[0]
        embeddings = []
        for i, t in enumerate(tensors):
            if _is_bag(t.shape[1:]) != self.bags[i]:
                raise ValueError(f"modality {i}: shape {tuple(t.shape)} is not what the "
                                 "model was built for")
            if self.bags[i]:
                h = t if self.tokens_layout else t.transpose(1, 2)
                h = F.relu(getattr(self, f"conv1_m{i}")(h))
                h = F.relu(getattr(self, f"conv2_m{i}")(h))
                embeddings.append(torch.mean(h, dim=1))
            else:
                embeddings.append(torch.tanh(getattr(self, f"fc_m{i}")(t.reshape(b, -1))))
        stacked = torch.stack(embeddings, dim=0)            # (M, b, d)
        if presence is None:
            x = torch.mean(stacked, dim=0)
        else:
            w = presence.t()[:, :, None].to(stacked.dtype)  # (M, b, 1)
            x = torch.sum(stacked * w, dim=0) / torch.clamp(torch.sum(w, dim=0), min=1e-6)
        # the norms hold their parameters at any batch size; with one sample
        # the batch statistics are degenerate and the norm is bypassed
        if self.batch_norm and b > 1:
            x = self.bn1(x)
        x = dropout(x, self.dropout, generator, self.training)
        x = self.highway(x)
        if self.batch_norm and b > 1:
            x = self.bn2(x)
        x = self.final_norm(x)
        return self.final_head(x)
