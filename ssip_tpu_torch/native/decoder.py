"""ctypes binding of the native JPEG decoder.

Counterpart of ``ssip_tpu/native/decoder.py``: per-file decode to uint8
[H, W, 3] with optional DCT-domain scaling, and the exact short-side resize
plus center crop (Pillow's fixed-point triangle filter, bit for bit PIL's).
The C calls release the GIL, so a thread pool overlaps decode with the
caller's device work. ``load`` builds the library on first use
(``native/build.py``) and raises ``NativeBuildError`` where it cannot be
built; nothing here falls back to PIL. A file the library declines (not a
JPEG, or one libjpeg cannot read) gives None, as in the JAX package, and the
caller decodes that file as the JAX package does then.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

from ssip_tpu_torch.native.build import build
from ssip_tpu_torch.ops.resize import resize_target

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_INTP = ctypes.POINTER(ctypes.c_int)


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.ssip_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_int, _INTP, _INTP]
    lib.ssip_jpeg_dims.restype = ctypes.c_int
    lib.ssip_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, _U8P, ctypes.c_long, _INTP, _INTP]
    lib.ssip_jpeg_decode.restype = ctypes.c_int
    lib.ssip_resize_crop_u8.argtypes = [_U8P, *([ctypes.c_int] * 7), _U8P]
    lib.ssip_resize_crop_u8.restype = ctypes.c_int
    return lib


def _scale_denom_for(path: Path, fast_scale: Optional[int]) -> int:
    """Largest power-of-two denominator keeping the short side ≥ fast_scale."""
    if fast_scale is None:
        return 1
    w, h = ctypes.c_int(), ctypes.c_int()
    if load().ssip_jpeg_dims(str(path).encode(), 1, ctypes.byref(w), ctypes.byref(h)) != 0:
        return 1
    short = min(w.value, h.value)
    denom = 1
    while denom < 8 and short // (denom * 2) >= fast_scale:
        denom *= 2
    return denom


def decode_one(path: Path, fast_scale: Optional[int] = None) -> Optional[np.ndarray]:
    """uint8 [H, W, 3], or None for a file the library declines (JPEG only)."""
    lib = load()
    if Path(path).suffix.lower() not in (".jpg", ".jpeg"):
        return None
    denom = _scale_denom_for(Path(path), fast_scale)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.ssip_jpeg_dims(str(path).encode(), denom, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    buf = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.ssip_jpeg_decode(str(path).encode(), denom, buf.ctypes.data_as(_U8P), buf.nbytes,
                              ctypes.byref(w), ctypes.byref(h))
    return buf if rc == 0 else None


def resize_crop(arr: np.ndarray, resize: int, crop: int) -> Optional[np.ndarray]:
    """Short side to ``resize`` (the long side int-truncated, torchvision's
    rule) with PIL's bilinear filter, then the center crop: uint8
    [crop, crop, 3], or None where the library does not apply (not uint8
    RGB, or a crop larger than the resized image)."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        return None
    h, w = int(arr.shape[0]), int(arr.shape[1])
    if h <= 0 or w <= 0:
        return None
    th, tw = resize_target(h, w, resize)
    row0 = int(round((th - crop) / 2.0))
    col0 = int(round((tw - crop) / 2.0))
    if row0 < 0 or col0 < 0:
        return None
    src = np.ascontiguousarray(arr)
    out = np.empty((crop, crop, 3), np.uint8)
    rc = load().ssip_resize_crop_u8(src.ctypes.data_as(_U8P), h, w, th, tw, row0, col0, crop, out.ctypes.data_as(_U8P))
    return out if rc == 0 else None
