"""The device-resident feature arena and its bag gather, replicated or
row-sharded over a mesh's ``seq`` axis.

Counterpart of ``healnet_tpu/parallel/arena.py``.
A feature arena packs every slide's patch features back to back into one
``(rows, dim)`` array followed by ``max_patches`` zero rows (the layout of
``healnet_tpu/etl/tcga.py::feature_arena``), uploaded to the device once;
a batch then carries ``(patch_offsets, patch_lengths)`` instead of feature
tensors and each bag is gathered on the device. The arena may be a plain
array or a :class:`healnet_tpu_torch.ops.quantize.QuantizedContext` of int8
rows and one f32 scale per row, half the bytes.

Row-sharded (:class:`ShardedArena`): a cohort beyond one card's memory. The
rows pad to ``S * shard_rows`` and each of the ``S`` ranks of ``seq`` holds
its rows and a ``halo`` copy of the next shard's first ``halo`` rows, so a
gather window no wider than the halo lies inside one rank's block. The
owner slices the window, the other ranks contribute zeros, and a sum over
``seq`` (of the gathered windows, never of arena rows) assembles it: bit
for bit the replicated gather (one rank contributes, adding zeros is
exact; an int8 arena sums in int32, as narrow-integer collectives differ
by backend).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from healnet_tpu_torch.ops.quantize import QuantizedContext, quantize_scales
from healnet_tpu_torch.parallel.comm import all_reduce_
from healnet_tpu_torch.parallel.mesh import AXIS_SEQ, Mesh


def _to_device(x, device) -> torch.Tensor:
    x = torch.as_tensor(x, device=device)
    return x.float() if x.dtype == torch.float64 else x


def place_arena(arena, device):
    """A host arena (numpy, tensor, or a ``QuantizedContext`` of either) on
    ``device``, uploaded once; float64 arrives as float32, as in JAX."""
    if isinstance(arena, QuantizedContext):
        return QuantizedContext(_to_device(arena.data, device), _to_device(arena.scale, device))
    return _to_device(arena, device)


def place_quantized(arena, device, chunk_rows: int = 16384) -> QuantizedContext:
    """A host float arena as a ``QuantizedContext`` on ``device``, quantized
    there a chunk of rows at a time (per-row int8 values and f32 scales,
    bit-equal to ``quantize_context_host``): the host sends the float rows
    once and computes only each row's scale from its maximum
    (:func:`~healnet_tpu_torch.ops.quantize.quantize_scales`); the device
    holds one chunk in f32 at a time."""
    rows, dim = arena.shape
    data = torch.empty((rows, dim), dtype=torch.int8, device=device)
    scale = torch.empty((rows,), dtype=torch.float32, device=device)
    for lo in range(0, rows, chunk_rows):
        x = _to_device(arena[lo:lo + chunk_rows], device).float()
        s, inv = quantize_scales(torch.amax(torch.abs(x), dim=-1).cpu().numpy())
        inv = torch.from_numpy(inv).to(device)
        data[lo:lo + chunk_rows] = torch.clamp(torch.round(x * inv[:, None]), -127, 127)
        scale[lo:lo + chunk_rows] = torch.from_numpy(s)
    return QuantizedContext(data, scale)


class ShardedArena:
    """This rank's block of a row-sharded arena: ``ext`` ``(shard_rows +
    halo, dim)``, shard ``coord`` of ``n_shards`` along the mesh's ``axis``."""

    def __init__(self, ext: torch.Tensor, shard_rows: int, halo: int, n_shards: int,
                 axis: str = AXIS_SEQ):
        self.ext = ext
        self.shard_rows, self.halo = int(shard_rows), int(halo)
        self.n_shards, self.axis = int(n_shards), axis

    @property
    def shape(self):  # (logical rows, dim), as the replicated arena's
        return (self.n_shards * self.shard_rows, self.ext.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.ext.dtype

    @property
    def device(self) -> torch.device:
        return self.ext.device


def build_sharded_arena(arena_host, mesh: Mesh, halo: int, axis: str = AXIS_SEQ
                        ) -> ShardedArena:
    """This rank's halo'd block of a host arena's rows split over
    ``mesh[axis]``, on the mesh's device. ``halo`` must be at least the
    widest gather window (the batches' KV-mask width); each rank uploads
    ``shard_rows + halo`` rows."""
    n_shards = mesh.shape[axis]
    rows, dim = arena_host.shape
    halo = int(halo)
    shard_rows = -(-rows // n_shards)
    lo = mesh.coord(axis) * shard_rows
    hi = min(lo + shard_rows + halo, rows)
    block = arena_host[lo:max(lo, hi)]
    if not isinstance(block, torch.Tensor):
        block = torch.as_tensor(np.asarray(block))
    if block.dtype == torch.float64:
        block = block.float()
    ext = torch.zeros((shard_rows + halo, dim), dtype=block.dtype, device=mesh.device)
    ext[:block.shape[0]] = block.to(mesh.device)
    return ShardedArena(ext, shard_rows, halo, n_shards, axis)


def build_device_arena(host, mesh: Mesh, halo: int, axis: str = AXIS_SEQ):
    """Halo'd row shards of a plain or int8 host arena: the one function
    that both the pipeline's build-once path and the trainer's lazy one
    call. A
    ``QuantizedContext`` shards values and scales alike, the scales as a
    dim-1 column, so the same halo'd gather serves both."""
    if isinstance(host, QuantizedContext):
        scale = host.scale[:, None] if isinstance(host.scale, torch.Tensor) else \
            np.asarray(host.scale)[:, None]
        return QuantizedContext(build_sharded_arena(host.data, mesh, halo, axis),
                                build_sharded_arena(scale, mesh, halo, axis))
    return build_sharded_arena(host, mesh, halo, axis)


def gather_sharded(arena: ShardedArena, offsets: torch.Tensor, width: int, mesh: Mesh
                   ) -> torch.Tensor:
    """(b,) row offsets (this rank's batch rows) -> (b, width, dim) windows
    of the sharded arena, the same on every rank of its axis."""
    if width > arena.halo:
        raise ValueError(f"gather width {width} exceeds the arena halo {arena.halo}; build the "
                         "sharded arena with halo >= the widest bucket")
    s, rows = mesh.coord(arena.axis), arena.shard_rows
    off = offsets.to(device=arena.ext.device, dtype=torch.int64)
    owner = torch.clamp(off // rows, max=arena.n_shards - 1)
    # the local start means something on the owner only (there it lies in
    # [0, shard_rows)); the clamp keeps the others' slices in the block
    lo = torch.clamp(off - s * rows, 0, rows - 1)
    win = arena.ext[lo[:, None] + torch.arange(width, device=off.device)]
    win = win * (owner == s)[:, None, None].to(win.dtype)
    group = mesh.group(arena.axis)
    if win.dtype.is_floating_point:
        return all_reduce_(win, group)
    return all_reduce_(win.to(torch.int32), group).to(win.dtype)


def gather_bag(arena, offsets: torch.Tensor, mask: torch.Tensor, mesh: Optional[Mesh] = None):
    """(b,) row offsets -> (b, width, dim) zero-masked bag windows.

    ``mask`` is the (b, width) KV mask; its width is the gather width. Each
    window starts at its offset clamped to ``[0, rows - width]``, as
    ``jax.lax.dynamic_slice`` clamps. Rows outside a bag are zeroed: a float
    window is multiplied by the mask, and a quantized window's scales are
    (a zero-scale row dequantizes to exactly zero), so a model that pools
    tokens unmasked sees the host path's zero padding. A
    :class:`ShardedArena` (or a ``QuantizedContext`` of two) is gathered
    over ``mesh`` (:func:`gather_sharded`).
    """
    quantized = isinstance(arena, QuantizedContext)
    width = mask.shape[1]
    if isinstance(arena.data if quantized else arena, ShardedArena):
        if mesh is None:
            raise ValueError("a sharded arena is gathered over its mesh")
        if quantized:
            scale = gather_sharded(arena.scale, offsets, width, mesh)[..., 0]
            return QuantizedContext(gather_sharded(arena.data, offsets, width, mesh),
                                    scale * mask.to(scale.dtype))
        slide = gather_sharded(arena, offsets, width, mesh)
        return slide * mask[..., None].to(slide.dtype)
    rows = (arena.data if quantized else arena).shape[0]
    starts = torch.clamp(offsets.to(torch.int64), 0, rows - width)
    index = starts[:, None] + torch.arange(width, device=starts.device)  # (b, width)
    if quantized:
        scale = arena.scale[index]
        return QuantizedContext(arena.data[index], scale * mask.to(scale.dtype))
    slide = arena[index]
    return slide * mask[..., None].to(slide.dtype)
