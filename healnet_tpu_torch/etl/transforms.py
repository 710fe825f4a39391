"""Composable array transforms: the port's copy of
``healnet_tpu/etl/transforms.py`` (einops and numpy; cv2 for resizing), and
:func:`resize_linear_uint8`, OpenCV's bilinear resize of uint8 images in numpy."""

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


# output rows resized at a time: bounds the int32 intermediate of a slide
_ROWS_PER_BLOCK = 256


def _linear_taps(src: int, dst: int):
    """Source indices and 11-bit weights of a half-pixel-centred linear
    resize from ``src`` to ``dst`` samples, as OpenCV's ``INTER_LINEAR``
    computes them: the position in float32, the weights rounded from
    ``w * 2048``, both taps on the edge sample outside the image."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    low, high = s < 0, s >= src - 1
    f[low | high] = 0.0
    s = np.where(low, 0, np.where(high, src - 1, s))
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear_uint8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize of an ``(h, w[, c])`` uint8 image to ``(height,
    width[, c])``, standing in for ``cv2.resize(img, (width, height),
    interpolation=cv2.INTER_LINEAR)``: half-pixel centres, no antialias,
    OpenCV's fixed-point arithmetic (11-bit weights; the horizontal sums
    shifted right by 4, scaled by the vertical weight's high 16 bits, and
    rounded by 2 bits). OpenCV's scalar tail of a row rounds in one step
    instead, so a pixel may differ from it by one."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_uint8 takes uint8, got {img.dtype}")
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    h, w = src.shape[:2]
    xs0, xs1, a0, a1 = _linear_taps(w, width)
    ys0, ys1, b0, b1 = _linear_taps(h, height)
    out = np.empty((height, width, src.shape[2]), dtype=np.uint8)
    for start in range(0, height, _ROWS_PER_BLOCK):
        stop = min(start + _ROWS_PER_BLOCK, height)
        need = np.unique(np.concatenate([ys0[start:stop], ys1[start:stop]]))
        rows = src[need].astype(np.int32)
        horiz = rows[:, xs0] * a0[None, :, None] + rows[:, xs1] * a1[None, :, None]
        pos = {int(r): i for i, r in enumerate(need)}
        d0 = horiz[[pos[int(r)] for r in ys0[start:stop]]] >> 4
        d1 = horiz[[pos[int(r)] for r in ys1[start:stop]]] >> 4
        v = ((d0 * b0[start:stop, None, None]) >> 16) \
            + ((d1 * b1[start:stop, None, None]) >> 16)
        out[start:stop] = np.clip((v + 2) >> 2, 0, 255)
    return out[:, :, 0] if squeeze else out
