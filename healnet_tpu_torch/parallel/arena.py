"""The device-resident feature arena and its bag gather, on one device.

Counterpart of the single-device part of ``healnet_tpu/parallel/arena.py``.
A feature arena packs every slide's patch features back to back into one
``(rows, dim)`` array followed by ``max_patches`` zero rows (the layout of
``healnet_tpu/etl/tcga.py::feature_arena``), uploaded to the device once;
a batch then carries ``(patch_offsets, patch_lengths)`` instead of feature
tensors and each bag is gathered on the device. The arena may be a plain
array or a :class:`healnet_tpu_torch.ops.quantize.QuantizedContext` of int8
rows and one f32 scale per row, half the bytes.

Row-sharded arenas over several devices wait for the multi-device port.
"""

from __future__ import annotations

import torch

from healnet_tpu_torch.ops.quantize import QuantizedContext


def _to_device(x, device) -> torch.Tensor:
    x = torch.as_tensor(x, device=device)
    return x.float() if x.dtype == torch.float64 else x


def place_arena(arena, device):
    """A host arena (numpy, tensor, or a ``QuantizedContext`` of either) on
    ``device``, uploaded once; float64 arrives as float32, as in JAX."""
    if isinstance(arena, QuantizedContext):
        return QuantizedContext(_to_device(arena.data, device), _to_device(arena.scale, device))
    return _to_device(arena, device)


def gather_bag(arena, offsets: torch.Tensor, mask: torch.Tensor):
    """(b,) row offsets -> (b, width, dim) zero-masked bag windows.

    ``mask`` is the (b, width) KV mask; its width is the gather width. Each
    window starts at its offset clamped to ``[0, rows - width]``, as
    ``jax.lax.dynamic_slice`` clamps. Rows outside a bag are zeroed: a float
    window is multiplied by the mask, and a quantized window's scales are
    (a zero-scale row dequantizes to exactly zero), so a model that pools
    tokens unmasked sees the host path's zero padding.
    """
    quantized = isinstance(arena, QuantizedContext)
    rows = (arena.data if quantized else arena).shape[0]
    width = mask.shape[1]
    starts = torch.clamp(offsets.to(torch.int64), 0, rows - width)
    index = starts[:, None] + torch.arange(width, device=starts.device)  # (b, width)
    if quantized:
        scale = arena.scale[index]
        return QuantizedContext(arena.data[index], scale * mask.to(scale.dtype))
    slide = arena[index]
    return slide * mask[..., None].to(slide.dtype)
