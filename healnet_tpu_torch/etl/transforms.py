"""Composable array transforms: the port's copy of
``healnet_tpu/etl/transforms.py`` (einops and numpy; cv2 for resizing)."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class RearrangeTransform:
    """einops.rearrange as a pipeline stage."""

    def __init__(self, pattern: str, **axes):
        self.pattern = pattern
        self.axes = axes

    def __call__(self, x):
        import einops

        return einops.rearrange(x, self.pattern, **self.axes)


class RepeatTransform:
    """einops.repeat as a pipeline stage."""

    def __init__(self, pattern: str, **axes):
        self.pattern = pattern
        self.axes = axes

    def __call__(self, x):
        import einops

        return einops.repeat(x, self.pattern, **self.axes)


class ResizeTransform:
    """Bilinear resize to (height, width) via cv2 (channels-last uint8/float)."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, x):
        import cv2

        return cv2.resize(
            np.asarray(x), (self.width, self.height), interpolation=cv2.INTER_LINEAR
        )


class ToFloat:
    def __call__(self, x):
        x = np.asarray(x)
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return x.astype(np.float32)
