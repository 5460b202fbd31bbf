"""Fused extraction preprocess: wrapper around the CUDA kernel.

Counterpart of ``ssip_tpu/ops/pallas_preproc.py:96-163``
(``preprocess_images_pallas``) and of its kernel body ``_preproc_kernel``
(``:41-62``), which ``csrc/preproc.cu`` replaces. NHWC uint8 in, NHWC
``out_dtype`` out, exactly like the JAX entry — but the CUDA kernel takes any
H×W, so there is no square-only gate and no fallback path.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain PyTorch version (``ops/resize.py:extraction_preprocess``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ssip_tpu_torch.ops.resize import crop_weights, extraction_preprocess, normalize_constants

_OUT_DTYPES = (torch.float32, torch.bfloat16)


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


@lru_cache(maxsize=16)
def _device_tables(h: int, w: int, resize: int, crop: int, device: torch.device):
    """Row and column tap tables for one geometry, resident on ``device``."""
    wv, wh = crop_weights(h, w, resize, crop)
    return tuple(
        torch.from_numpy(a).to(device)
        for a in (*tap_table(wv), *tap_table(wh))
    )


@lru_cache(maxsize=1)
def _kernel_entry():
    from ssip_tpu_torch.kernels.build import load_library

    fn = load_library().ssip_preprocess_u8
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, i, i, i, i, i,  # in, out, out_bf16, batch, h, w, crop
        p, p, p, i,  # v_start, v_count, v_w, kv
        p, p, p, i,  # h_start, h_count, h_w, kh
        f, f, f, f, f, f,  # off[3], sc[3]
        p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def preprocess_images(
    images_u8: torch.Tensor,
    resize: int = 256,
    crop: int = 224,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 3] → normalized NHWC [B, crop, crop, 3].

    ``preprocess_images.launches`` counts kernel launches (CPU calls and
    empty batches launch nothing and count nothing).
    """
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"preprocess expects uint8 NHWC [B, H, W, 3], got "
            f"{tuple(images_u8.shape)} {images_u8.dtype}"
        )
    if crop > resize:
        raise ValueError(
            f"crop ({crop}) must be <= resize ({resize}): the resized "
            "short side cannot satisfy a larger center crop"
        )
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if images_u8.device.type == "cpu":
        return extraction_preprocess(images_u8, resize=resize, crop=crop, dtype=out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"preprocess runs on cpu or cuda tensors, got {images_u8.device}")
    if not images_u8.is_contiguous():
        raise ValueError("preprocess kernel needs a contiguous NHWC tensor")

    b, h, w, _ = images_u8.shape
    out = torch.empty((b, crop, crop, 3), dtype=out_dtype, device=images_u8.device)
    if b == 0:
        return out
    v_start, v_count, v_w, h_start, h_count, h_w = _device_tables(
        h, w, resize, crop, images_u8.device
    )
    off, sc = normalize_constants()
    with torch.cuda.device(images_u8.device):  # the launch's device; restored after
        err = _kernel_entry()(
            images_u8.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), b, h, w, crop,
            v_start.data_ptr(), v_count.data_ptr(), v_w.data_ptr(), v_w.shape[1],
            h_start.data_ptr(), h_count.data_ptr(), h_w.data_ptr(), h_w.shape[1],
            *(float(v) for v in off), *(float(v) for v in sc),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: cudaError {err}")
    preprocess_images.launches += 1
    return out


preprocess_images.launches = 0
