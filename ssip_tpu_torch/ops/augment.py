"""Training augmentations: the plain PyTorch versions.

Counterpart of ``ssip_tpu/ops/augment.py:22-81`` (``random_flip``,
``_rotation_index_map``, ``_rotate_gather``), ``:391-404``
(``train_augment``, ``eval_preprocess``) and ``:407-426`` (the FixMatch views
``weak_augment`` and ``strong_augment``). The random draws are inputs here:
a flip flag and an angle per image, and a brightness and a contrast for the
strong view (``runtime/prng.py`` makes them), so each op is held to the JAX
package given the same draws: bit for bit, except the strong view's jitter,
whose per-image mean sums in another order. ``ops/rotate.py`` runs
``train_augment`` (``augment_images``) and ``rotate_nearest``
(``rotate_images``) on the card as one CUDA kernel body with two epilogues
(``csrc/rotation.cu``) and calls this module for a tensor on the CPU.

The rotation index map is the JAX package's fixed-point one: ``cos`` and
``sin`` quantized once per image to 2⁻¹⁶ (``augment_coeffs``), then int32
arithmetic per pixel with floor division (``torch.div(...,
rounding_mode="floor")``; truncating division is wrong for the negative
numerators of out-of-range pixels).

Which ``cos``: XLA's CPU backend computes float32 ``cos``/``sin`` with the C
library's ``cosf``/``sinf``: bit for bit over 3·10⁵ seeded angles in ±10°,
±25° and ±180°. ``torch.cos`` (SLEEF) and numpy's SIMD ``cos`` are within an
ulp of it but not equal, and an ulp moves ``round(cos·2¹⁶)`` wherever the
product sits near a .5: with ``torch.cos``, 25 of 10⁵ ``icos`` at ±10° and
21 at ±25° differed from JAX's. So ``augment_coeffs`` calls
``cosf``/``sinf`` through ctypes (``tests/test_torch_augment.py`` holds it
to JAX over 2·10⁴ angles at each range).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np
import torch

from ssip_tpu_torch.ops.resize import normalize_imagenet_u8

Q = 1 << 16  # fixed-point scale of the quantized cos and sin


@lru_cache(maxsize=1)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn in (lib.cosf, lib.sinf):
        fn.argtypes = [ctypes.c_float]
        fn.restype = ctypes.c_float
    return lib


def cos_sin_f32(angles) -> tuple[np.ndarray, np.ndarray]:
    """float32 ``cosf`` and ``sinf`` of float32 angles (radians), element by
    element: XLA's CPU ``jnp.cos`` and ``jnp.sin``, bit for bit."""
    angles = np.asarray(angles, dtype=np.float32)
    lib = _libm()
    values = angles.reshape(-1).tolist()
    cos = np.fromiter((lib.cosf(v) for v in values), np.float32, len(values)).reshape(angles.shape)
    sin = np.fromiter((lib.sinf(v) for v in values), np.float32, len(values)).reshape(angles.shape)
    return cos, sin


def augment_coeffs(flip, angles) -> np.ndarray:
    """int32 [3, B]: ``icos``, ``isin`` and the flip flag of each image.

    ``icos = round_half_even(cosf(θ)·2¹⁶)`` in float32 from the float32
    angles (radians), as ``jnp.round(jnp.cos(angles) * q)`` on the CPU;
    likewise ``isin``. The kernel and the plain version take this array.
    """
    angles = np.asarray(angles, dtype=np.float32).reshape(-1)
    flip = np.asarray(flip, dtype=bool).reshape(-1)
    if flip.shape != angles.shape:
        raise ValueError(f"one flip flag per angle: {flip.shape} vs {angles.shape}")
    cos, sin = cos_sin_f32(angles)
    q = np.float32(Q)
    return np.stack([np.rint(cos * q), np.rint(sin * q), flip]).astype(np.int32)


def index_bound(h: int, w: int) -> int:
    """Largest |value| the int32 index map reaches: |icos|, |isin| ≤ 2¹⁶,
    |2y − (h−1)| ≤ h − 1 and |2x − (w−1)| ≤ w − 1, plus the ``h·2¹⁶``
    offset. The map is exact while this stays below 2³¹, that is up to
    10 923 pixels a side for a square image."""
    return Q * ((h - 1) + (w - 1) + max(h, w))


def rotation_index_map(icos: torch.Tensor, isin: torch.Tensor, h: int, w: int):
    """(iy, ix, valid), each [B, H, W]: the source pixel of every output
    pixel under the inverse rotation, unclipped, and whether it is in range."""
    dev = icos.device
    c = icos.to(torch.int32)[:, None, None]
    s = isin.to(torch.int32)[:, None, None]
    yy2 = (2 * torch.arange(h, dtype=torch.int32, device=dev) - (h - 1))[:, None]  # 2(y − cy)
    xx2 = (2 * torch.arange(w, dtype=torch.int32, device=dev) - (w - 1))[None, :]  # 2(x − cx)
    ay = c * yy2 + s * xx2  # 2q·(src_y − cy)
    ax = -s * yy2 + c * xx2
    iy = torch.div(ay + h * Q, 2 * Q, rounding_mode="floor")  # floor(src_y + ½)
    ix = torch.div(ax + w * Q, 2 * Q, rounding_mode="floor")
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return iy, ix, valid


def rotate_gather(images: torch.Tensor, iy, ix, valid) -> torch.Tensor:
    """Apply the index map as one flat take over the batch; zero fill."""
    b, h, w, c = images.shape
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    flat = flat + (torch.arange(b, dtype=torch.int32, device=images.device) * (h * w))[:, None, None]
    gathered = images.reshape(b * h * w, c)[flat.reshape(-1).long()].reshape(images.shape)
    return torch.where(valid[..., None], gathered, torch.zeros((), dtype=images.dtype, device=images.device))


def random_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the images whose flag is set. images: [B, H, W, C]."""
    return torch.where(flip.to(torch.bool)[:, None, None, None], images.flip(2), images)


def rotate_nearest(images_u8: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """flip → nearest-neighbour rotation (zero fill), uint8 NHWC in and out:
    ``random_flip`` then ``random_rotate_nearest`` given the draws. The plain
    version of ``ops/rotate.py:rotate_images``."""
    _, h, w, _ = images_u8.shape
    x = random_flip(images_u8, coeffs[2])
    return rotate_gather(x, *rotation_index_map(coeffs[0], coeffs[1], h, w))


def train_augment(images_u8: torch.Tensor, coeffs: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """flip → nearest-neighbour rotation (zero fill) → ImageNet-normalize.

    uint8 NHWC [B, H, W, 3] and ``augment_coeffs`` as an int32 tensor on the
    same device in; ``dtype`` NHWC out (bfloat16 is the float32 result
    rounded to nearest even).
    """
    _, h, w, _ = images_u8.shape
    x = random_flip(images_u8, coeffs[2])
    iy, ix, valid = rotation_index_map(coeffs[0], coeffs[1], h, w)
    return normalize_imagenet_u8(rotate_gather(x, iy, ix, valid), dtype=dtype)


def weak_augment(images_u8: torch.Tensor, flip: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """FixMatch weak view: horizontal flip only → normalize."""
    return normalize_imagenet_u8(random_flip(images_u8, flip), dtype=dtype)


def strong_augment(
    images_u8: torch.Tensor,
    coeffs: torch.Tensor,
    brightness: torch.Tensor,
    contrast: torch.Tensor,
    dtype=torch.float32,
) -> torch.Tensor:
    """FixMatch strong view: flip → rotate → brightness and contrast jitter
    about the rotated image's own mean → clip to [0, 255] → normalize.

    ``coeffs`` is ``augment_coeffs`` of the view's flips and angles;
    ``brightness`` (U(−32, 32)) and ``contrast``
    (U(0.7, 1.3)) are float32 [B] on the images' device. The rotation is
    ``ops/rotate.py:rotate_images``: the CUDA kernel on the card,
    ``rotate_nearest`` on the CPU. The mean over H, W and C is taken as
    ``jnp.mean`` is on XLA's CPU, a float32 sum times ``f32(1/n)``: the sum
    of the integer-valued view is exact in float64, then rounded to float32,
    so the mean is the JAX package's bit for bit while the sum stays below
    2^24 (past it XLA's float32 order of adds is not known). The jitter and
    the normalize stay plain PyTorch (plain XLA in the JAX package);
    bfloat16 is the float32 result rounded.
    """
    from ssip_tpu_torch.ops.rotate import rotate_images  # it imports this module

    x = rotate_images(images_u8, coeffs).to(torch.float32)
    inv_n = np.float32(1.0) / np.float32(x.shape[1] * x.shape[2] * x.shape[3])
    mean = x.sum(dim=(1, 2, 3), keepdim=True, dtype=torch.float64).to(torch.float32) * float(inv_n)
    shape = (-1, 1, 1, 1)
    x = ((x - mean) * contrast.view(shape) + mean + brightness.view(shape)).clamp(0.0, 255.0)
    return normalize_imagenet_u8(x, dtype=dtype)


def eval_preprocess(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Eval chain: ToTensor → normalize (the resize happened at load)."""
    return normalize_imagenet_u8(images_u8, dtype=dtype)
