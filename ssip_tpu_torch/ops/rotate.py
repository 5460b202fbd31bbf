"""The rotation kernels' wrappers, one CUDA body (``csrc/rotation.cu``)
with two epilogues.

``augment_images`` replaces ``ssip_tpu/ops/augment.py:_rotate_mxu`` (the
Pallas kernel behind ``random_rotate_nearest``) and fuses the flip before it
and the normalize after it, i.e. the whole of ``train_augment``: uint8 NHWC
in, float32 or bfloat16 NHWC out, any H×W.

``rotate_images`` replaces ``ssip_tpu/ops/augment.py:_rotate_mxu_blocked``
(the 2-D-banded Pallas kernel): flip and rotation alone, uint8 NHWC in and
out, any H×W. The FixMatch strong view needs it: the jitter reads the
rotated pixels' mean before the normalize.

A block of the kernel owns an output tile and stages the tile's source
window, found from the index map at the tile's four corners, in a static
shared buffer; ``ROTATE_TILES``, ``tile_window`` and
``largest_window_bytes`` restate that geometry for the CPU tests.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain PyTorch version (``ops/augment.py:train_augment``, ``rotate_nearest``);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ssip_tpu_torch.ops.augment import Q, index_bound, rotate_nearest, train_augment
from ssip_tpu_torch.ops.resize import normalize_constants

_OUT_DTYPES = (torch.float32, torch.bfloat16)
# A block's output tile (rows, pixels) by output type, and its static source
# window in bytes: RotTile<T> of csrc/rotation.cu. A thread's run is 48
# bytes of output (16, 8 or 4 pixels), and 256 threads hold a tile's runs.
ROTATE_TILES = {torch.uint8: (32, 112, 34272), torch.bfloat16: (16, 128, 34272), torch.float32: (16, 64, 11328)}


def window_slot_bytes(cols: int) -> int:
    """Shared bytes of a window row of ``cols`` pixels: up to 15 bytes of
    alignment before its first byte, rounded up to 16."""
    return (15 + 3 * cols + 15) // 16 * 16


def tile_window(icos: int, isin: int, h: int, w: int, y0: int, x0: int, tile_h: int, tile_w: int):
    """(iy_lo, iy_hi, ix_lo, ix_hi): the source window of the output tile at
    (y0, x0), from the int32 index map at its four corners (clipped to the
    image), as the kernel finds it; an arithmetic shift by 17 is the floor
    division by 2·2¹⁶."""
    y1, x1 = min(y0 + tile_h, h) - 1, min(x0 + tile_w, w) - 1
    ys = np.asarray([2 * y0 - (h - 1), 2 * y1 - (h - 1)], np.int32)[:, None]
    xs = np.asarray([2 * x0 - (w - 1), 2 * x1 - (w - 1)], np.int32)[None, :]
    c, s = np.int32(icos), np.int32(isin)
    iy = (c * ys + s * xs + np.int32(h * Q)) >> 17
    ix = (-s * ys + c * xs + np.int32(w * Q)) >> 17
    return int(iy.min()), int(iy.max()), int(ix.min()), int(ix.max())


def largest_window_bytes(tile_h: int, tile_w: int) -> int:
    """The most shared memory any rotation's window can take for a tile of
    ``tile_h`` × ``tile_w``: rows ≤ ⌊((h−1)|icos| + (w−1)|isin|)/2¹⁶⌋ + 2
    and columns likewise with the roles swapped, each row in a slot, over
    the coefficients of every angle (a sweep of [0°, 90°] by 2·10⁻⁶ rad,
    icos and isin each ±1 about their rounded values: the sweep's steps and
    rounding move neither by more)."""
    theta = np.arange(0.0, np.pi / 2 + 1e-3, 2e-6)
    c0, s0 = np.rint(np.cos(theta) * Q).astype(np.int64), np.rint(np.sin(theta) * Q).astype(np.int64)
    best = 0
    for dc in (-1, 0, 1):
        for ds in (-1, 0, 1):
            c, s = np.abs(c0 + dc), np.abs(s0 + ds)
            rows = (c * (tile_h - 1) + s * (tile_w - 1)) // Q + 2
            cols = (s * (tile_h - 1) + c * (tile_w - 1)) // Q + 2
            best = max(best, int((rows * window_slot_bytes(cols)).max()))
    return best


def _check_images_and_coeffs(images_u8: torch.Tensor, coeffs: torch.Tensor, what: str) -> None:
    """Raise for what neither the kernels nor the plain versions take."""
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"{what} expects uint8 NHWC [B, H, W, 3], got {tuple(images_u8.shape)} {images_u8.dtype}"
        )
    b, h, w, _ = images_u8.shape
    if coeffs.dtype != torch.int32 or tuple(coeffs.shape) != (3, b) or coeffs.device != images_u8.device:
        raise ValueError(
            f"coeffs must be int32 [3, {b}] on {images_u8.device}, got "
            f"{coeffs.dtype} {tuple(coeffs.shape)} on {coeffs.device}"
        )
    if index_bound(h, w) >= 2**31:
        raise ValueError(f"{h}x{w} images overflow the int32 rotation index map")
    if images_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {images_u8.device}")


@lru_cache(maxsize=1)
def _kernel_entry():
    from ssip_tpu_torch.kernels.build import load_library

    fn = load_library().ssip_train_augment_u8
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, i, i, i, i,  # in, out, out_bf16, batch, h, w
        p,  # coeffs [3, batch]
        f, f, f, f, f, f,  # off[3], sc[3]
        p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def augment_images(
    images_u8: torch.Tensor, coeffs: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 3] → flipped, rotated, normalized [B, H, W, 3].

    ``coeffs`` is ``ops/augment.py:augment_coeffs`` as an int32 tensor on
    the images' device. ``augment_images.launches`` counts kernel launches
    (CPU calls and empty batches launch nothing and count nothing).
    """
    _check_images_and_coeffs(images_u8, coeffs, "augment")
    b, h, w, _ = images_u8.shape
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if images_u8.device.type == "cpu":
        return train_augment(images_u8, coeffs, dtype=out_dtype)
    if not (images_u8.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError("augment kernel needs contiguous images and coeffs")

    out = torch.empty((b, h, w, 3), dtype=out_dtype, device=images_u8.device)
    if b == 0:
        return out
    off, sc = normalize_constants()
    with torch.cuda.device(images_u8.device):  # the launch's device; restored after
        err = _kernel_entry()(
            images_u8.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w,
            coeffs.data_ptr(),
            *(float(v) for v in off), *(float(v) for v in sc),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"augment kernel launch failed: cudaError {err}")
    augment_images.launches += 1
    return out


augment_images.launches = 0


@lru_cache(maxsize=1)
def _rotate_entry():
    from ssip_tpu_torch.kernels.build import load_library

    fn = load_library().ssip_rotate_u8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, p]  # in, out, batch, h, w, coeffs [3, batch], stream
    fn.restype = ctypes.c_int
    return fn


def rotate_images(images_u8: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 3] → flipped and rotated uint8 [B, H, W, 3].

    ``coeffs`` is ``ops/augment.py:augment_coeffs`` as an int32 tensor on
    the images' device (a flip flag of 0 gives the bare rotation), of any
    angles: the kernel's shared source window holds a tile's sources at every
    angle, so the call needs no angle bound and reads nothing back from the
    device. ``rotate_images.launches`` counts kernel launches (CPU calls and
    empty batches launch nothing and count nothing).
    """
    _check_images_and_coeffs(images_u8, coeffs, "rotate")
    b, h, w, _ = images_u8.shape
    if images_u8.device.type == "cpu":
        return rotate_nearest(images_u8, coeffs)
    if not (images_u8.is_contiguous() and coeffs.is_contiguous()):
        raise ValueError("rotate kernel needs contiguous images and coeffs")

    out = torch.empty_like(images_u8)
    if b == 0:
        return out
    with torch.cuda.device(images_u8.device):  # the launch's device; restored after
        err = _rotate_entry()(
            images_u8.data_ptr(), out.data_ptr(), b, h, w, coeffs.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err == -1:
        raise ValueError(f"a batch of {b} {h}x{w} images has more tiles than one launch takes")
    if err != 0:
        raise RuntimeError(f"rotate kernel launch failed: cudaError {err}")
    rotate_images.launches += 1
    return out


rotate_images.launches = 0
