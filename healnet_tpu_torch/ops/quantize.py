"""Per-token int8 context quantization.

Counterpart of ``healnet_tpu/ops/quantize.py``. A WSI patch-feature context
enters the model only through its per-token LayerNorm statistics and the
merged folded-KV projection, and both commute with a per-token rescale:

    x = s_t * q_t            (q int8, s per-token f32)
    rowsum(x)   = s_t * rowsum(q)
    rowsum(x^2) = s_t^2 * rowsum(q^2)
    x @ W       = s_t * (q @ W)

so a context stored as int8 values with one f32 scale per token halves the
bytes of every context read, of the host-to-device upload and of a
device-resident feature arena, while the product and the statistics run on
the exact integer values and are rescaled after accumulation. Symmetric
absmax quantization per token: ``s = max|x_row| / 127``.

:func:`quantize_context` (tensors) and :func:`quantize_context_host` (numpy)
give bit-equal results, and both are bit-equal to the JAX package's: f32
division, ``1 / scale`` only where the scale is above 0, rounding half to
even; a row of zeros gets scale 0 and values 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class QuantizedContext:
    """A per-token int8 quantized modality context.

    data: int8, ``(b, *spatial, channels)``; scale: f32, ``(b, *spatial)``.
    The logical value is ``data * scale[..., None]``. Passed as a modality
    tensor to :class:`healnet_tpu_torch.models.healnet.HealNetModule`, it
    routes that modality's KV projection through the quantized kernel.
    """

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.data.float() * self.scale[..., None]).to(dtype)

    def to(self, device) -> "QuantizedContext":
        """Both tensors on ``device`` (numpy arrays become tensors)."""
        return QuantizedContext(
            torch.as_tensor(self.data, device=device),
            torch.as_tensor(self.scale, device=device),
        )


def quantize_context(x: torch.Tensor) -> QuantizedContext:
    """Symmetric per-token (last-axis) absmax int8 quantization."""
    xf = x.float()
    # over a device scalar: CUDA divides by a CPU scalar as a multiply by its
    # reciprocal, which can differ from the division in the last bit
    scale = torch.amax(torch.abs(xf), dim=-1) / xf.new_full((), 127.0)
    positive = scale > 0
    inv = torch.where(positive, 1.0 / torch.where(positive, scale, 1.0), 0.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return QuantizedContext(q, scale)


def quantize_scales(amax: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(scale, 1 / scale or 0)`` in float32 from each row's absolute
    maximum, in numpy: the arithmetic of :func:`quantize_context`, which
    divides by a device scalar, and of
    :func:`healnet_tpu_torch.parallel.arena.place_quantized`, which takes
    its scales from here."""
    scale = (np.asarray(amax, np.float32) / 127.0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    return scale, inv


def quantize_context_host(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """numpy twin of :func:`quantize_context` for host-side arena packing:
    ``(values int8, scales f32)``, bit-equal to the tensor version on the CPU."""
    xf = np.asarray(x, np.float32)
    scale, inv = quantize_scales(np.max(np.abs(xf), axis=-1))
    q = np.clip(np.round(xf * inv[..., None]), -127, 127).astype(np.int8)
    return q, scale
