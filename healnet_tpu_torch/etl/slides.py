"""Whole-slide-image access: a ctypes binding to libopenslide.

The port's copy of ``healnet_tpu/etl/slides.py``: the OpenSlide C library
bound through ctypes (openslide-python is not a dependency). Importing the
module is always safe; constructing :class:`OpenSlide` raises a clear error
when ``libopenslide.so`` is absent. ``_LIB`` / ``_LIB_ERROR`` hold the
loaded library or the reason it is missing, so a test can put a fake
library in its place.

API subset (as openslide-python): ``OpenSlide(path)``, ``.level_count``,
``.level_dimensions``, ``.dimensions``, ``.properties``,
``.read_region((x, y), level, (w, h)) -> RGBA uint8 array``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Dict, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERROR
    if _LIB is not None or _LIB_ERROR is not None:
        return _LIB
    name = ctypes.util.find_library("openslide")
    candidates = [name] if name else []
    candidates += ["libopenslide.so.1", "libopenslide.so.0", "libopenslide.so"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
            _configure(lib)
            _LIB = lib
            return lib
        except OSError:
            continue
    _LIB_ERROR = (
        "libopenslide not found. WSI reading requires the OpenSlide C library "
        "(apt: libopenslide0). Preprocessed patch-feature pipelines do not "
        "need it."
    )
    return None


def _configure(lib: ctypes.CDLL) -> None:
    c_char_p, c_void_p = ctypes.c_char_p, ctypes.c_void_p
    c_int32, c_int64 = ctypes.c_int32, ctypes.c_int64
    lib.openslide_open.restype = c_void_p
    lib.openslide_open.argtypes = [c_char_p]
    lib.openslide_close.argtypes = [c_void_p]
    lib.openslide_get_level_count.restype = c_int32
    lib.openslide_get_level_count.argtypes = [c_void_p]
    lib.openslide_get_level_dimensions.argtypes = [
        c_void_p, c_int32, ctypes.POINTER(c_int64), ctypes.POINTER(c_int64)
    ]
    lib.openslide_read_region.argtypes = [
        c_void_p, ctypes.POINTER(ctypes.c_uint32), c_int64, c_int64, c_int32,
        c_int64, c_int64,
    ]
    lib.openslide_get_error.restype = c_char_p
    lib.openslide_get_error.argtypes = [c_void_p]
    lib.openslide_get_property_names.restype = ctypes.POINTER(c_char_p)
    lib.openslide_get_property_names.argtypes = [c_void_p]
    lib.openslide_get_property_value.restype = c_char_p
    lib.openslide_get_property_value.argtypes = [c_void_p, c_char_p]


def openslide_available() -> bool:
    return _load_lib() is not None


class OpenSlide:
    """Minimal OpenSlide handle with the openslide-python surface we need."""

    def __init__(self, path):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(_LIB_ERROR)
        self._lib = lib
        self._handle = lib.openslide_open(str(path).encode())
        if not self._handle:
            raise OSError(f"openslide could not open {path}")
        err = lib.openslide_get_error(self._handle)
        if err:
            raise OSError(f"openslide error for {path}: {err.decode()}")

    # ------------------------------------------------------------- metadata
    @property
    def level_count(self) -> int:
        return int(self._lib.openslide_get_level_count(self._handle))

    @property
    def level_dimensions(self) -> Tuple[Tuple[int, int], ...]:
        dims = []
        for level in range(self.level_count):
            w = ctypes.c_int64()
            h = ctypes.c_int64()
            self._lib.openslide_get_level_dimensions(
                self._handle, level, ctypes.byref(w), ctypes.byref(h)
            )
            dims.append((int(w.value), int(h.value)))
        return tuple(dims)

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    @property
    def properties(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        names = self._lib.openslide_get_property_names(self._handle)
        i = 0
        while names[i]:
            key = names[i]
            value = self._lib.openslide_get_property_value(self._handle, key)
            out[key.decode()] = value.decode() if value else ""
            i += 1
        return out

    # --------------------------------------------------------------- pixels
    def read_region(
        self, location: Tuple[int, int], level: int, size: Tuple[int, int]
    ) -> np.ndarray:
        """Read a region as an (h, w, 4) RGBA uint8 array.

        OpenSlide returns premultiplied ARGB in host byte order; it is
        converted to straight RGBA with integer division by alpha (alpha 0
        divides by 1).
        """
        w, h = int(size[0]), int(size[1])
        buf = (ctypes.c_uint32 * (w * h))()
        self._lib.openslide_read_region(
            self._handle, buf, int(location[0]), int(location[1]), int(level), w, h
        )
        arr = np.ctypeslib.as_array(buf).reshape(h, w).copy()
        a = ((arr >> 24) & 0xFF).astype(np.uint8)
        r = ((arr >> 16) & 0xFF).astype(np.uint8)
        g = ((arr >> 8) & 0xFF).astype(np.uint8)
        b = (arr & 0xFF).astype(np.uint8)
        # un-premultiply where alpha > 0
        alpha = np.maximum(a.astype(np.uint16), 1)
        r = np.minimum(r.astype(np.uint16) * 255 // alpha, 255).astype(np.uint8)
        g = np.minimum(g.astype(np.uint16) * 255 // alpha, 255).astype(np.uint8)
        b = np.minimum(b.astype(np.uint16) * 255 // alpha, 255).astype(np.uint8)
        return np.stack([r, g, b, a], axis=-1)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.openslide_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
