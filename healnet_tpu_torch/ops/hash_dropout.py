"""Coordinate-hash dropout keep masks (plain PyTorch version).

Counterpart of ``healnet_tpu/ops/hash_dropout.py``: the keep decision is
``mix32(row * C_ROW ^ q * C_Q ^ kv * C_KV ^ seed) < threshold`` with the
splitmix32 finaliser, a pure function of the seed and the element's absolute
coordinates. The flash kernel (``csrc/hash_dropout.cuh``) computes the same
function in uint32 arithmetic, so both draw bit-identical masks.

PyTorch has no uint32 shift or compare on the CPU, so this version holds
32-bit words in int64 and keeps only the low 32 bits after every step. A
32 x 32-bit product does not fit in int64, so :func:`_mul32` multiplies by
the constant's two 16-bit halves separately.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_C_ROW = 0x9E3779B1
_C_Q = 0x85EBCA77
_C_KV = 0xC2B2AE3D


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finaliser over int64-held 32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def keep_threshold(dropout_rate: float) -> int:
    """uint32 threshold t with P(mix < t) = 1 - rate."""
    keep = max(0.0, min(1.0, 1.0 - float(dropout_rate)))
    return min(int(keep * 2.0**32), 2**32 - 1)


def keep_scale(dropout_rate: float) -> float:
    """The kept values' multiplier, f32(1 / (1 - rate)) as in JAX (1 at rate 0)."""
    rate = float(dropout_rate)
    return float(np.float32(1.0 / (1.0 - rate))) if rate > 0 else 1.0


def _u32(x: Union[int, torch.Tensor]) -> Union[int, torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK32
    return int(x) & _MASK32


def hash_keep(
    seed: Union[int, torch.Tensor],
    row_ids: torch.Tensor,
    q_ids: torch.Tensor,
    kv_ids: torch.Tensor,
    dropout_rate: float,
) -> torch.Tensor:
    """Boolean keep mask (True = keep) over the broadcast id shape."""
    h = (
        _mul32(_u32(row_ids), _C_ROW)
        ^ _mul32(_u32(q_ids), _C_Q)
        ^ _mul32(_u32(kv_ids), _C_KV)
        ^ _u32(seed)
    )
    return _mix32(h) < keep_threshold(dropout_rate)


def hash_rows(
    bh: int,
    row_offset: int = 0,
    heads: Optional[int] = None,
    head_stride: int = 0,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """The hash's row coordinate of each of ``bh`` local (batch*head) rows.

    Local row ``r`` is batch ``r // heads``, head ``r % heads``; its hash row
    is ``row_offset + (r // heads) * head_stride + r % heads``. A shard of a
    sharded batch passes ``row_offset = b0 * H + h0`` and ``head_stride = H``
    (its first batch row ``b0``, its first head ``h0``, the global head count
    ``H``), and so draws the rows of the single-device mask. Without
    ``heads``, or with ``head_stride`` 0 (the local ``heads``), the rows are
    ``row_offset + r``.
    """
    r = torch.arange(bh, dtype=torch.int64, device=device)
    if heads is None or head_stride in (0, heads):
        return r + int(row_offset)
    return int(row_offset) + (r // heads) * int(head_stride) + r % heads


def dense_keep_mask(
    seed: Union[int, torch.Tensor],
    bh: int,
    lq: int,
    lkv: int,
    dropout_rate: float,
    device: Optional[torch.device] = None,
    *,
    row_offset: int = 0,
    kv_offset: int = 0,
    heads: Optional[int] = None,
    head_stride: int = 0,
) -> torch.Tensor:
    """Materialised (bh, lq, lkv) keep mask.

    ``row_offset`` / ``heads`` / ``head_stride`` map the local rows onto the
    hash's row coordinates (:func:`hash_rows`), and ``kv_offset`` is the
    first key's coordinate: a shard of a sharded run gets the single-device
    mask's block at its global coordinates."""
    ids = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    return hash_keep(
        seed,
        hash_rows(bh, row_offset, heads, head_stride, device)[:, None, None],
        ids(lq)[None, :, None],
        (int(kv_offset) + ids(lkv))[None, None, :],
        dropout_rate,
    )


# The attention dropout mask family of the plain path:
#   "hash"     - the coordinate-hash mask above (the default, and the only
#                family the flash kernels and the streaming statistics can
#                realise);
#   "threefry" - an independent Bernoulli mask drawn from the call's explicit
#                torch.Generator, as the reference's F.dropout draws one.
# A switch for isolating the effect of the mask family on a training run, not
# a serving setting: the flash kernels always hash.
_MASK_FAMILY = "hash"


def mask_family(value: Optional[str] = None) -> str:
    """Get or set the attention dropout mask family ("hash" / "threefry")."""
    global _MASK_FAMILY
    if value is not None:
        if value not in ("hash", "threefry"):
            raise ValueError(f"unknown mask family {value!r}")
        _MASK_FAMILY = value
    return _MASK_FAMILY
