"""PIL-exact resizes and the extraction preprocess: the plain PyTorch versions.

Counterpart of ``ssip_tpu/ops/resize.py:27-177``. The numpy helpers
(``triangle_weights``, ``resize_target``, ``center_crop_bounds``) are copied
expression for expression, because the JAX module imports ``jax.numpy``.

``extraction_preprocess`` keeps the JAX form — two dense float32 matmuls
against the triangle-filter matrices, PIL's clip8 after each pass, then
one affine normalize — and is what the CUDA kernel in ``ops/preproc.py`` is
held against, and what its wrapper runs for a tensor on the CPU.
``training_resize`` is the same matmul pair without the crop; it runs once
per corpus, off the hot path. At sizes whose taps are not dyadic (512→224)
the summation order can move a pixel by one uint8 step against the JAX
package, as the JAX package documents against PIL.

Rounding rules carried over exactly:

- clip8 is ``floor(x + 0.5)`` clamped to [0, 255] (PIL rounds half up;
  ``torch.round`` rounds half to even and is wrong here);
- normalize is ``(x − off_c) · sc_c`` with ``off = f32(255·mean)`` and
  ``sc = f32(1/(255·std))`` computed in float64 and rounded once;
- the crop offset uses Python's ``round`` (half to even), as torchvision.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@lru_cache(maxsize=64)
def triangle_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] PIL-bilinear (triangle, antialiased) resample matrix."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear filter support is 1.0 * filterscale
    weights = np.zeros((dst, src), np.float32)
    for i in range(dst):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), src)
        js = np.arange(lo, hi)
        x = (js + 0.5 - center) / filterscale
        w = np.clip(1.0 - np.abs(x), 0.0, None)
        weights[i, lo:hi] = (w / w.sum()).astype(np.float32)
    return weights


def resize_target(h: int, w: int, resize: int) -> tuple:
    """torchvision ``Resize(n)`` output grid: short side → n, long side
    int-truncated (``int(n * long / short)``)."""
    if h <= w:
        return resize, max(1, int(w * resize / h))
    return max(1, int(h * resize / w)), resize


def center_crop_bounds(size: int, crop: int) -> slice:
    """torchvision CenterCrop offset: round((size - crop) / 2)."""
    off = int(round((size - crop) / 2.0))
    return slice(off, off + crop)


def crop_weights(h: int, w: int, resize: int, crop: int) -> tuple[np.ndarray, np.ndarray]:
    """(wv [crop, H], wh [crop, W]): the resample rows that survive the
    center crop — the crop fused by slicing the weights
    (``ssip_tpu/ops/pallas_preproc.py:123-124``)."""
    if crop > resize:
        raise ValueError(
            f"crop ({crop}) must be <= resize ({resize}): the resized "
            "short side cannot satisfy a larger center crop"
        )
    out_h, out_w = resize_target(h, w, resize)
    wv = triangle_weights(h, out_h)[center_crop_bounds(out_h, crop)]
    wh = triangle_weights(w, out_w)[center_crop_bounds(out_w, crop)]
    return wv, wh


def normalize_constants() -> tuple[np.ndarray, np.ndarray]:
    """(offset, scale) float32 per channel: ``255·mean`` and
    ``1/(255·std)`` computed in float64, rounded to float32 once."""
    offset = (255.0 * np.asarray(IMAGENET_MEAN, np.float64)).astype(np.float32)
    scale = (1.0 / (255.0 * np.asarray(IMAGENET_STD, np.float64))).astype(np.float32)
    return offset, scale


def clip8(x: torch.Tensor) -> torch.Tensor:
    """PIL's per-pass clip8: round half up, clamp to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def normalize_imagenet_u8(x_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(x − 255·mean) · 1/(255·std)`` on uint8-valued NHWC input: one
    float32 subtract and one multiply, then a cast to ``dtype``."""
    offset, scale = normalize_constants()
    off = torch.from_numpy(offset).to(x_u8.device)
    sc = torch.from_numpy(scale).to(x_u8.device)
    return ((x_u8.to(torch.float32) - off) * sc).to(dtype)


def _resample(images: torch.Tensor, wv_np: np.ndarray, wh_np: np.ndarray) -> torch.Tensor:
    """NHWC [..., H, W, 3] → float32 NHWC [..., rows(wv), rows(wh), 3],
    uint8-valued: horizontal pass first, then vertical — PIL's order — with
    clip8 after each."""
    dev = images.device
    wv = torch.from_numpy(wv_np).to(dev)
    wh = torch.from_numpy(wh_np).to(dev)
    x = images.to(torch.float32).movedim(-1, -3)  # [..., 3, H, W]
    t = clip8(torch.matmul(x, wh.T))  # [..., 3, H, out_w]
    return clip8(torch.matmul(wv, t)).movedim(-3, -1)  # [..., out_h, out_w, 3]


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of NHWC images, float32 0..255 result
    (``ssip_tpu/ops/resize.py:54-83`` with ``quantize=True``)."""
    h, w = images.shape[-3], images.shape[-2]
    return _resample(images, triangle_weights(h, out_h), triangle_weights(w, out_w))


def training_resize(images_u8: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """The training chain's ``Resize((S, S))``: uint8 NHWC in, uint8 NHWC
    [..., S, S, 3] out (``ssip_tpu/ops/resize.py:171-177`` and the round to
    uint8 of ``ssip_tpu/train/data.py:44-48``; clip8 already made every
    value an integer in [0, 255])."""
    return resize_bilinear(images_u8, image_size, image_size).to(torch.uint8)


def extraction_preprocess(
    images_u8: torch.Tensor,
    resize: int = 256,
    crop: int = 224,
    dtype=torch.float32,
) -> torch.Tensor:
    """Resize(short side) → CenterCrop → ToTensor → ImageNet-normalize.

    uint8 NHWC [B, H, W, 3] in, ``dtype`` NHWC [B, crop, crop, 3] out.
    """
    h, w = images_u8.shape[-3], images_u8.shape[-2]
    return normalize_imagenet_u8(_resample(images_u8, *crop_weights(h, w, resize, crop)), dtype=dtype)
