"""PIL-exact resizes and the extraction preprocess: the plain PyTorch versions.

Counterpart of ``ssip_tpu/ops/resize.py:27-177``. The numpy helpers
(``triangle_weights``, ``resize_target``, ``center_crop_bounds``) are copied
expression for expression, because the JAX module imports ``jax.numpy``.

``extraction_preprocess`` keeps the JAX form — two dense float32 matmuls
against the triangle-filter matrices, PIL's clip8 after each pass, then
one affine normalize — and is what the CUDA kernel in ``ops/preproc.py`` is
held against, and what its wrapper runs for a tensor on the CPU.
``resize_bilinear`` and ``training_resize`` accumulate in XLA's CPU order
instead: each output adds its taps in ascending source order, one fused
multiply-add a tap (``ssip_tpu/ops/resize.py:77,80``), emulated as
``acc = f32(f64(x_k) · f64(w_k) + f64(acc))`` — the float32 product is exact
in float64 — so the training and serving resize is the JAX package's bit for
bit from 512² sources, and the card's is the CPU's at any size. A matmul adds
in another order and, where the taps are not dyadic (512→224), moves a pixel
by one uint8 step. At some other source widths (640; past 512, the outputs
whose taps straddle column 512) XLA's CPU sums in an order not matched yet,
which can move a few pixels by one step (ROADMAP Queue 3 #14).

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


def tap_table(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse form of a [dst, src] resample matrix.

    Returns (start int32 [dst], count int32 [dst], taps float32 [dst, K]):
    row ``i``'s nonzeros are ``weights[i, start[i]:start[i] + count[i]]``,
    stored in ``taps[i, :count[i]]`` and zero-padded to the widest row's K.
    """
    dst = weights.shape[0]
    start = np.zeros(dst, np.int32)
    count = np.zeros(dst, np.int32)
    spans = []
    for i, row in enumerate(weights):
        nz = np.flatnonzero(row)
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        start[i], count[i] = lo, hi - lo
        spans.append(row[lo:hi])
    taps = np.zeros((dst, int(count.max())), np.float32)
    for i, span in enumerate(spans):
        taps[i, : len(span)] = span
    return start, count, taps


@lru_cache(maxsize=64)
def _ascending_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(index int64 [dst, K], weight float64 [dst, K]): each output's taps
    in ascending source order, the shorter rows padded with weight 0 at a
    clamped index (a zero product leaves the sum exact)."""
    start, _count, taps = tap_table(triangle_weights(src, dst))
    index = np.minimum(start[:, None] + np.arange(taps.shape[1]), src - 1)
    return index.astype(np.int64), taps.astype(np.float64)


def _ordered_pass(x: torch.Tensor, src_dim: int, dst: int) -> torch.Tensor:
    """float64 uint8-valued ``x`` resampled along ``src_dim`` to ``dst``:
    the ascending-tap FMA chain in float32, then clip8."""
    index_np, taps_np = _ascending_taps(x.shape[src_dim], dst)
    index = torch.from_numpy(index_np).to(x.device)
    taps = torch.from_numpy(taps_np).to(x.device)
    shape = [1] * x.dim()
    shape[src_dim] = dst
    acc = None
    for k in range(index.shape[1]):
        term = torch.index_select(x, src_dim, index[:, k]) * taps[:, k].view(shape)
        acc = (term if acc is None else term + acc.to(torch.float64)).to(torch.float32)
    return clip8(acc)


# The float64 chain is bound by memory traffic: on the CPU the images go
# through it a few at a time, so that each pass's operands stay in cache
# (about 8× faster for a batch of 512² images); the card takes them whole.
_CPU_CHUNK_BYTES = 16 << 20


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of NHWC images, float32 0..255 result
    (``ssip_tpu/ops/resize.py:54-83`` with ``quantize=True``): horizontal
    pass first, then vertical — PIL's order — with clip8 after each, every
    output's taps summed in XLA's CPU order (module docstring)."""
    if images.device.type == "cpu" and images.dim() == 4:
        chunk = max(1, _CPU_CHUNK_BYTES // (8 * images.shape[1] * images.shape[2] * images.shape[3]))
        if chunk < images.shape[0]:
            return torch.cat([resize_bilinear(part, out_h, out_w) for part in images.split(chunk)])
    x = images.to(torch.float64).movedim(-1, -3)  # [..., 3, H, W]
    t = _ordered_pass(x, -1, out_w).to(torch.float64)  # [..., 3, H, out_w]
    return _ordered_pass(t, -2, out_h).movedim(-3, -1)  # [..., out_h, out_w, 3]


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
