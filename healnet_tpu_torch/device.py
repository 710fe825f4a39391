"""Device resolution and tile rounding shared by the port's dispatch rules.

The port runs on the GPU unless the caller asks for the CPU: an entry point
given ``device=None`` takes ``cuda`` and raises when no GPU is present, so a
missing card is never silently replaced by the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default, ``cpu`` (or any other device) on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return ((x + m - 1) // m) * m
