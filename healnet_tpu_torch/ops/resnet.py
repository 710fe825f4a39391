"""ResNet-50 patch-feature extractor: the port's counterpart of
``healnet_tpu/ops/resnet.py``, written by hand in PyTorch (torchvision is
not a dependency).

The architecture is torchvision's v1.5 ResNet-50 (the stride of a
downsampling bottleneck in its 3x3 convolution), with torchvision's
parameter names (``conv1``, ``bn1``, ``layerS.B.convN`` / ``bnN``,
``layerS.B.downsample.{0,1}``, ``fc``), so a torchvision ``state_dict``
loads by name (:func:`load_torchvision_state_dict`). BatchNorm runs on its
running statistics with eps 1e-5 (Flax's default); the max-pool is 3x3,
stride 2, padding 1 (padded with -inf, as Flax's); ``features_only`` drops
``fc`` and returns the global average pool, 2048 wide. The convolutions are
``torch.nn.functional.conv2d`` (cuDNN on the card), as the JAX package's
are XLA's: no Pallas kernel lies on this path.

Pretrained weights are not shipped: pass a local torchvision ``resnet50``
checkpoint as ``weights_path``, or the extractor runs on random weights.
Flax variables carry across through
:func:`healnet_tpu_torch.compat.flax_params.state_dict_from_flax_resnet`.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

STAGE_SIZES = (3, 4, 6, 3)
FEATURES = 2048


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (``stride``) -> 1x1 (x4) with a projection shortcut on the
    first block of a stage."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """torchvision-compatible ResNet-50 on NCHW input; ``features_only``
    drops the head and returns ``(b, 2048)``."""

    def __init__(self, num_classes: int = 1000, features_only: bool = True,
                 stage_sizes: Sequence[int] = STAGE_SIZES,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, blocks in enumerate(stage_sizes):
            planes = 64 * 2**stage
            layers = []
            for block in range(blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                layers.append(Bottleneck(inplanes, planes, stride, downsample=block == 0))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
        self.n_stages = len(stage_sizes)
        self.fc = None if features_only else nn.Linear(inplanes, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torchvision's initialisation, drawn from ``generator``: convolutions
        normal with std sqrt(2 / fan_out), BatchNorm at identity (weight 1,
        bias 0, running mean 0, variance 1), ``fc`` uniform in +-1/sqrt(in)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / fan_out))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.mean(dim=(2, 3))  # global average pool -> (b, 2048)
        return x if self.fc is None else self.fc(x)


def load_torchvision_state_dict(model: ResNet50, state: Mapping) -> ResNet50:
    """Copy a torchvision ``resnet50`` state_dict into ``model`` by name.
    Keys the model lacks (``fc.*`` under ``features_only``) are ignored, as
    the JAX importer ignores them; a weight or BatchNorm statistic the
    model has and ``state`` lacks raises (``num_batches_tracked`` may be
    absent: eval mode never reads it)."""
    own = model.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the state_dict lacks {missing[:5]}{'...' if len(missing) > 5 else ''}")
    model.load_state_dict({k: torch.as_tensor(state[k]) for k in own if k in state},
                          strict=False)
    return model


class PatchFeatureExtractor:
    """Batched patch -> 2048-d embedding on the card (or the CPU on request).

    ``weights_path``: a local torchvision ``resnet50`` checkpoint
    (``torch.save(state_dict)``). Without one the weights are random, drawn
    from ``torch.Generator().manual_seed(seed)``: they differ from the JAX
    package's ``PRNGKey(seed)`` initialisation, so the two agree only on
    carried weights (a checkpoint both load, or Flax variables through
    ``state_dict_from_flax_resnet``). The convolutions run in float32;
    whether cuDNN may use TF32 is the caller's setting
    (``torch.backends.cudnn.allow_tf32``), which this class leaves alone.
    """

    def __init__(
        self,
        weights_path: Optional[str] = None,
        batch_size: int = 64,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.model = ResNet50(features_only=True, generator=torch.Generator().manual_seed(seed))
        if weights_path is not None:
            state = torch.load(weights_path, map_location="cpu", weights_only=True)
            load_torchvision_state_dict(self.model, state)
            self.pretrained = True
        else:
            self.pretrained = False
        self.model = self.model.to(self.device).eval()
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        # a tensor, not a Python number: CUDA divides by a host scalar as a
        # product with its reciprocal, which can differ in the last bit
        self._255 = torch.tensor(255.0, device=self.device)

    @torch.no_grad()
    def embed(self, patches: torch.Tensor) -> torch.Tensor:
        """``(b, h, w, 3)`` uint8 or float patches, on the extractor's
        device -> ``(b, 2048)`` float32 there: uint8 scaled by 1/255, then
        ImageNet-normalised, as the JAX package does on the host."""
        x = patches
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / self._255
        x = (x - self._mean) / self._std
        x = x.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        return self.model(x)

    def __call__(self, patches: np.ndarray) -> np.ndarray:
        """(n, 224, 224, 3) uint8/float patches -> (n, 2048) float32 features,
        ``batch_size`` patches a call (a shorter last one)."""
        patches = np.asarray(patches)
        n = patches.shape[0]
        out = np.zeros((n, FEATURES), np.float32)
        for start in range(0, n, self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(patches[start:start + self.batch_size]))
            out[start:start + len(chunk)] = self.embed(chunk.to(self.device)).cpu().numpy()
        return out
