"""The rotation kernels' wrappers.

``augment_images`` replaces ``ssip_tpu/ops/augment.py:_rotate_mxu`` (the
Pallas kernel behind ``random_rotate_nearest``) and fuses the flip before it
and the normalize after it, i.e. the whole of ``train_augment``: uint8 NHWC
in, float32 or bfloat16 NHWC out, any H×W (``csrc/augment.cu``).

``rotate_images`` replaces ``ssip_tpu/ops/augment.py:_rotate_mxu_blocked``
(the 2-D-banded Pallas kernel): flip and rotation alone, uint8 NHWC in and
out, any H×W (``csrc/rotate.cu``). The FixMatch strong view needs it: the
jitter reads the rotated pixels' mean before the normalize.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain PyTorch version (``ops/augment.py:train_augment``, ``rotate_nearest``);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ssip_tpu_torch.ops.augment import index_bound, rotate_nearest, train_augment
from ssip_tpu_torch.ops.resize import normalize_constants

_OUT_DTYPES = (torch.float32, torch.bfloat16)


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
