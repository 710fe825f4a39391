"""The coordinate-hash attention dropout mask, frozen for the reference.

An element (row, query, key) of a call with 32-bit seed ``seed`` is kept
when ``mix32(row * C_ROW ^ q * C_Q ^ key * C_KV ^ seed) < threshold``, with
the splitmix32 finaliser and ``threshold = floor((1 - rate) * 2**32)``
(capped at ``2**32 - 1``). ``row`` is ``batch_row * heads + head``. The
32-bit words are held in int64 with only their low 32 bits kept after each
step; a 32 x 32-bit product is formed from the constant's two 16-bit
halves, since it does not fit in int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x846CA68B
_C_ROW, _C_Q, _C_KV = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def threshold(rate: float) -> int:
    keep = max(0.0, min(1.0, 1.0 - float(rate)))
    return min(int(keep * 2.0**32), 2**32 - 1)


def keep_mask(seed: int, b: int, heads: int, lq: int, lkv: int, rate: float,
              device) -> torch.Tensor:
    """The (b, heads, lq, lkv) keep mask of one attention call."""
    ids = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    rows = ids(b * heads).reshape(b, heads, 1, 1)
    h = (_mul32(rows, _C_ROW) ^ _mul32(ids(lq).reshape(1, 1, lq, 1), _C_Q)
         ^ _mul32(ids(lkv).reshape(1, 1, 1, lkv), _C_KV) ^ (int(seed) & MASK32))
    return _mix32(h) < threshold(rate)
