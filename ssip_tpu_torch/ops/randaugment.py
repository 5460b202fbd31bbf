"""RandAugment + Cutout, FixMatch's strong view: the plain PyTorch version.

Counterpart of ``ssip_tpu/ops/randaugment.py`` (``--strong-augment
randaugment``): flip → two RandAugment layers → Cutout → ImageNet normalize.
Each layer picks one op per image from the 14-op FixMatch pool (five
geometric, nine pixel ops), with a magnitude U(0, 1) of the op's full range
and a random sign. The JAX package computes it in plain XLA, outside
Pallas, so it has no hand kernel here either: the same tensor code runs on
the card and on the CPU.

The draws are inputs (``runtime/prng.py:RandAugmentDraws``). Given the
JAX package's draws, the uint8 result is the JAX one bit for bit
(``tests/test_torch_randaugment.py``), because every step keeps its integer
or float32 form and order:

- the geometric ops share one nearest-neighbour inverse-affine warp per
  layer (``_affine_nearest``): the 2×2 matrix and offset of each image's op
  (identity for a pixel op) in 2⁻¹⁶ fixed point, then int32 index
  arithmetic with floor division. The matrix (``geometry``) is made on the
  host from the float32 draws, with ``cosf``/``sinf`` as XLA's CPU
  ``cos``/``sin`` compute them (``ops/augment.py:cos_sin_f32``);
- the nine pixel ops are computed for the whole batch and selected per
  image (``_apply_pixel_bank``), in PIL's 8-bit arithmetic on
  integer-valued float32: the luma ``(19595 R + 38470 G + 7471 B + 2¹⁵) >>
  16``, the enhancement blend ``floor(d + f·(x − d) + ½)``, equalize's
  ``(step//2 + cumsum) // step`` LUT, posterize's bit mask, solarize's
  threshold, and sharpness's 3×3/13 smooth with the border copied;
- contrast's mean gray is ``floor(Σ luma / (H·W) + ½)`` with the sum in
  integers (float32 sums of integers are exact below 2²⁴: to 256² images).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ssip_tpu_torch.ops.augment import Q, cos_sin_f32, random_flip, rotate_gather
from ssip_tpu_torch.ops.resize import normalize_imagenet_u8
from ssip_tpu_torch.runtime.prng import RandAugmentDraws

# the FixMatch pool (Sohn et al. 2020, Table 12); the order fixes the op
# indices of the draws, the geometric ops first
GEO_OPS = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")
PIXEL_OPS = (
    "identity", "autocontrast", "equalize", "posterize", "solarize",
    "color", "contrast", "brightness", "sharpness",
)
N_GEO = len(GEO_OPS)
NUM_OPS = N_GEO + len(PIXEL_OPS)

MAX_ROTATE_DEG = 30.0
MAX_SHEAR = 0.3  # the affine matrix entry
MAX_TRANSLATE = 0.3  # of the image side
MAX_ENHANCE = 0.9  # brightness, color, contrast, sharpness: 1 ± 0.9
MAX_POSTERIZE_DROP = 4  # bits kept: 8 down to 4
CUTOUT_FRACTION = 0.5
CUTOUT_FILL = 127


def geometry(op, magnitude, sign, height: int, width: int) -> np.ndarray:
    """int32 [..., 6, B] on the host: ``round(m·2¹⁶)`` of the inverse affine
    map's ``m00, m01, m10, m11`` and ``round(2·o·2¹⁶)`` of its offsets
    ``oy, ox`` for each image's op (``_geo_params``), from float32 draws of
    shape [..., B]. Each op's inverse is written directly: rotate by −θ, a
    shear's coefficient negated, a translation's whole-pixel shift negated."""
    op = np.asarray(op)
    f32 = np.float32
    v = np.asarray(sign, f32) * np.asarray(magnitude, f32)  # signed magnitude in [-1, 1]
    theta = np.where(op == 0, v * f32(MAX_ROTATE_DEG * np.pi / 180.0), f32(0.0))
    shx = np.where(op == 1, v * f32(MAX_SHEAR), f32(0.0))  # x' = x + s·y
    shy = np.where(op == 2, v * f32(MAX_SHEAR), f32(0.0))  # y' = y + s·x
    tx = np.where(op == 3, np.rint(v * f32(MAX_TRANSLATE) * f32(width)), f32(0.0))
    ty = np.where(op == 4, np.rint(v * f32(MAX_TRANSLATE) * f32(height)), f32(0.0))
    cos, sin = cos_sin_f32(theta)
    q = f32(Q)
    rows = (cos, sin - shy, -sin - shx, cos)  # row basis (y, x); at most one of θ, shx, shy is non-zero
    fixed = [np.rint(m * q) for m in rows] + [np.rint(f32(2.0) * -t * q) for t in (ty, tx)]
    return np.stack(fixed, axis=-2).astype(np.int32)


def _affine_nearest(images: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    """Each image through its inverse affine map about the centre, nearest
    neighbour, zero fill; ``geo`` int32 [6, B] of ``geometry``."""
    _, h, w, _ = images.shape
    dev = images.device
    im00, im01, im10, im11, ioy2, iox2 = (g.to(torch.int32)[:, None, None] for g in geo)
    yy2 = (2 * torch.arange(h, dtype=torch.int32, device=dev) - (h - 1))[:, None]  # 2(y − cy)
    xx2 = (2 * torch.arange(w, dtype=torch.int32, device=dev) - (w - 1))[None, :]  # 2(x − cx)
    ay = im00 * yy2 + im01 * xx2 + ioy2  # 2q·(src_y − cy)
    ax = im10 * yy2 + im11 * xx2 + iox2
    iy = torch.div(ay + h * Q, 2 * Q, rounding_mode="floor")  # floor(src_y + ½)
    ix = torch.div(ax + w * Q, 2 * Q, rounding_mode="floor")
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    return rotate_gather(images, iy, ix, valid)


# pixel ops: integer-valued float32 in [0, 255], [B, H, W, 3], in and out


def _luma601(x: torch.Tensor) -> torch.Tensor:
    """PIL ``convert("L")``: (19595 R + 38470 G + 7471 B + 2¹⁵) >> 16."""
    xi = x.to(torch.int32)
    l24 = 19595 * xi[..., 0] + 38470 * xi[..., 1] + 7471 * xi[..., 2] + 32768
    return (l24 >> 16).to(torch.float32)


def _blend(degenerate: torch.Tensor, x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance: d + f·(x − d), rounded half up, clipped to [0, 255]."""
    out = degenerate + factor.view(-1, 1, 1, 1) * (x - degenerate)
    return torch.floor(out + 0.5).clamp(0.0, 255.0)


def _op_brightness(x, factor):
    return _blend(torch.zeros_like(x), x, factor)


def _op_color(x, factor):
    return _blend(_luma601(x)[..., None].expand_as(x), x, factor)


def _op_contrast(x, factor):
    # PIL: a solid gray at the rounded mean of the L image
    b, h, w, _ = x.shape
    total = _luma601(x).to(torch.int64).sum(dim=(1, 2)).to(torch.float32)
    mean = torch.floor(total / float(h * w) + 0.5)
    return _blend(mean.view(-1, 1, 1, 1).expand_as(x), x, factor)


def _op_sharpness(x, factor):
    # PIL SMOOTH: the 3×3 kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 on
    # the interior, the one-pixel border copied from the source
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = (
        p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
        + p[:, 1:-1, :-2] + 5.0 * x + p[:, 1:-1, 2:]
        + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]
    )
    smooth = torch.floor(acc / 13.0 + 0.5).clamp(0.0, 255.0)
    out = _blend(smooth, x, factor)
    border = torch.ones(x.shape[1:3], dtype=torch.bool, device=x.device)
    border[1:-1, 1:-1] = False
    return torch.where(border[None, :, :, None], x, out)


def _op_posterize(x, magnitude):
    drop = torch.round(magnitude * MAX_POSTERIZE_DROP).to(torch.int32)  # [B], 0..4
    mask = (255 // (1 << drop)) * (1 << drop)  # keep the top 8 − drop bits
    return (x.to(torch.int32) & mask.view(-1, 1, 1, 1)).to(torch.float32)


def _op_solarize(x, magnitude):
    # the FixMatch range [0, 256]: magnitude 0 is threshold 256, the identity
    thresh = torch.round(256.0 * (1.0 - magnitude)).view(-1, 1, 1, 1)
    return torch.where(x < thresh, x, 255.0 - x)


def _op_autocontrast(x):
    # per channel, [lo, hi] stretched to [0, 255] by a truncating LUT,
    # identity for a constant channel: floor((v − lo)·255 / (hi − lo))
    xi = x.to(torch.int32)
    lo = xi.amin(dim=(1, 2), keepdim=True)
    hi = xi.amax(dim=(1, 2), keepdim=True)
    out = torch.div((xi - lo) * 255, torch.clamp(hi - lo, min=1), rounding_mode="floor")
    return torch.where(hi > lo, out, xi).to(torch.float32)


def _op_equalize(x):
    """PIL ImageOps.equalize: per channel ``lut[i] = (step//2 + Σh[:i]) //
    step`` with ``step = (npix − h[last non-zero]) // 255``; identity where
    step is 0."""
    b, h, w, c = x.shape
    v = x.to(torch.int64).permute(0, 3, 1, 2).reshape(b * c, h * w)  # [BC, HW]
    hist = torch.zeros((b * c, 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    last_nz = 255 - torch.argmax((hist > 0).flip(1).to(torch.int32), dim=1)
    cnt_last = hist.gather(1, last_nz[:, None])[:, 0]
    step = torch.div(h * w - cnt_last, 255, rounding_mode="floor")  # [BC]
    csum = torch.cumsum(hist, dim=1) - hist  # Σh[:i], exclusive
    lut = torch.div(torch.div(step, 2, rounding_mode="floor")[:, None] + csum,
                    torch.clamp(step, min=1)[:, None], rounding_mode="floor").clamp(0, 255)
    ident = torch.arange(256, dtype=torch.int64, device=x.device)[None, :]
    lut = torch.where((step > 0)[:, None], lut, ident)
    out = lut.gather(1, v)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def _apply_pixel_bank(x, op, magnitude, sign):
    """The nine pixel ops on the whole batch, each image taking the one its
    op index names (identity where the op was geometric: the warp applied
    it)."""
    enh = 1.0 + sign * magnitude * MAX_ENHANCE  # the enhancement factor, in [0.1, 1.9]
    candidates = (
        _op_autocontrast(x),
        _op_equalize(x),
        _op_posterize(x, magnitude),
        _op_solarize(x, magnitude),
        _op_color(x, enh),
        _op_contrast(x, enh),
        _op_brightness(x, enh),
        _op_sharpness(x, enh),
    )
    out = x
    for i, cand in enumerate(candidates, start=N_GEO + 1):
        out = torch.where((op == i).view(-1, 1, 1, 1), cand, out)
    return out


def randaugment(images_u8: torch.Tensor, op, magnitude, sign, geo: torch.Tensor) -> torch.Tensor:
    """``L`` layers of one drawn op per image, uint8 [B, H, W, 3] in and
    out; ``op``, ``magnitude``, ``sign`` [L, B] and ``geo`` int32 [L, 6, B]
    on the images' device."""
    x = images_u8.to(torch.float32)
    for layer in range(op.shape[0]):
        x = _affine_nearest(x, geo[layer])  # an identity map for the pixel-op images
        x = _apply_pixel_bank(x, op[layer], magnitude[layer], sign[layer])
    return x.clamp(0.0, 255.0).to(torch.uint8)


def cutout(images_u8: torch.Tensor, cy, cx, fraction: float = CUTOUT_FRACTION, fill: int = CUTOUT_FILL):
    """FixMatch CutoutAbs: a gray square of side ``fraction·min(H, W)``
    centred at each image's (``cy``, ``cx``), clipped at the edges."""
    _, h, w, _ = images_u8.shape
    side = int(round(fraction * min(h, w)))
    if side == 0:
        return images_u8
    dev = images_u8.device
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    cy, cx = cy.view(-1, 1, 1), cx.view(-1, 1, 1)
    in_y = (yy >= cy - side // 2) & (yy < cy + (side + 1) // 2)
    in_x = (xx >= cx - side // 2) & (xx < cx + (side + 1) // 2)
    return torch.where((in_y & in_x)[..., None], torch.full((), fill, dtype=torch.uint8, device=dev), images_u8)


def draws_geometry(draws: RandAugmentDraws, height: int, width: int) -> np.ndarray:
    """``geometry`` of host draws (numpy or CPU tensors)."""
    host = draws.map(lambda a: np.asarray(a.cpu() if torch.is_tensor(a) else a))
    return geometry(host.op, host.magnitude, host.sign, height, width)


def strong_view_u8(images_u8: torch.Tensor, draws: RandAugmentDraws, geo: Optional[torch.Tensor] = None):
    """flip → RandAugment → Cutout, uint8 in and out. ``draws`` holds
    tensors on the images' device; ``geo`` is ``draws_geometry`` of them as
    an int32 tensor there, made from ``draws`` when not given (a copy to
    the host)."""
    _, h, w, _ = images_u8.shape
    if geo is None:
        geo = torch.from_numpy(draws_geometry(draws, h, w)).to(images_u8.device)
    x = random_flip(images_u8, draws.flip)
    x = randaugment(x, draws.op, draws.magnitude, draws.sign, geo)
    return cutout(x, draws.cutout_y, draws.cutout_x)


def strong_augment_randaugment(
    images_u8: torch.Tensor, draws: RandAugmentDraws, dtype=torch.float32, geo: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """FixMatch's strong view: flip → RandAugment(2) → Cutout → normalize,
    NHWC ``dtype`` out (bfloat16: the float32 result rounded)."""
    return normalize_imagenet_u8(strong_view_u8(images_u8, draws, geo), dtype=dtype)
