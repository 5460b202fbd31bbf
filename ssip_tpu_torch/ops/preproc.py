"""Fused extraction preprocess: wrapper around the CUDA kernel.

Counterpart of ``ssip_tpu/ops/pallas_preproc.py:96-163``
(``preprocess_images_pallas``) and of its kernel bodies ``_preproc_kernel``
(``:41-62``) and ``_preproc_quant_kernel`` (``:65-90``), which
``csrc/preproc.cu`` replaces. NHWC uint8 in, NHWC ``out_dtype`` out, exactly
like the JAX entry — but the CUDA kernel takes any H×W, so there is no
square-only gate and no fallback path. With ``quant_inv_scale`` the output is
the int8 operand of the quantized stem (``out_dtype`` is ignored), bit for
bit ``quantize(extraction_preprocess(u8, float32), inv_scale)``.

The kernel's tiling is planned here, on the host (``band_plan``): bands of
output rows and columns, each band's source window and the shared memory a
block needs, so that a CPU test can hold the plan to the tap tables.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain PyTorch version (``ops/resize.py:extraction_preprocess``, then
``ops/quant.py:quantize``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ssip_tpu_torch.ops.quant import quantize
from ssip_tpu_torch.ops.resize import crop_weights, extraction_preprocess, normalize_constants, tap_table

_OUT_DTYPES = (torch.float32, torch.bfloat16)


# Shared memory a block of the band kernel may take: three blocks an SM
# (228 KB, 1 KB of it reserved a block); past it, at the most a block can
# have, one block an SM.
BAND_SMEM_TARGET = 72 * 1024
BAND_SMEM_LIMIT = 227 * 1024
BAND_ROWS = (16, 8, 4, 2, 1)  # output rows a band, tallest first
UNROLLED_TAPS = 4  # both passes unrolled when no row and no column has more taps
RUN_BYTES = 48  # a thread's run of output in the vertical pass
PLAN_WORDS = 17  # BandPlan.header()


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


@dataclass(frozen=True)
class BandPlan:
    """The band kernel's tiling of one geometry (``csrc/preproc.cu``).

    A band is ``rows`` output rows by ``cols`` output columns of one image
    (the last band row and column may be shorter). ``row_bands[i]`` is
    (first source row, source rows) of band row i, ``col_bands[j]``
    (first source column, source columns) of band column j: every tap of
    every output row and column of the band. A window row is staged in a
    slot of ``src_pitch`` bytes (up to 15 bytes of alignment before it, and
    room for the zero-weight taps and the last 4-byte word of the unrolled
    form after it); two windows and the horizontal pass's buffer of
    ``h_rows`` × ``h_pitch`` bytes make ``smem_bytes``. The tap tables stay
    in global memory (``tables``).
    """

    crop: int
    rows: int
    cols: int
    taps: int  # 4: both passes unrolled over 4 taps, clip8 unclamped (_clamp_free); 0: counted loops
    kh: int  # taps a column's table entry holds
    kv: int  # taps a row's table entry holds
    src_rows: int
    src_cols: int
    src_pitch: int
    h_rows: int
    h_pitch: int
    smem_bytes: int
    row_bands: np.ndarray  # int32 [n_row_bands, 2]
    col_bands: np.ndarray  # int32 [n_col_bands, 2]

    @property
    def strides(self) -> tuple[int, int]:
        """int32 words of a column's and of a row's table entry."""
        return _round4(2 * self.kh + 2), _round4(2 * self.kv + 2)

    @property
    def offsets(self) -> tuple[int, int]:
        """Where the column and the row tap tables start in ``tables``."""
        h_off = _round4(2 * (len(self.row_bands) + len(self.col_bands)))
        return h_off, h_off + self.crop * self.strides[0]

    def header(self, grid: int) -> list:
        """The kernel's int32 plan (``csrc/preproc.cu:launch_kind``)."""
        return [self.rows, self.cols, self.taps, self.src_rows, self.src_pitch, self.h_rows, self.h_pitch,
                len(self.row_bands), len(self.col_bands), self.kh, self.kv, self.smem_bytes, grid,
                *self.offsets, *self.strides]

    def tables(self, v_table, h_table) -> np.ndarray:
        """int32: the row bands, the column bands, then one tap-table entry an
        output column and one an output row: its weights padded with zeros
        to kh (kv), their addends −2²³·w (float32 bits; the kernel's
        fma(2²³ + x, w, −2²³·w) is x·w rounded once), its first source index
        relative to its band's window, and its tap count."""
        out = np.zeros(self.offsets[1] + self.crop * self.strides[1], np.int32)
        bands = np.concatenate([self.row_bands, self.col_bands]).ravel()
        out[: len(bands)] = bands
        for (start, count, taps), band_size, firsts, k, stride, off in (
            (h_table, self.cols, self.col_bands[:, 0], self.kh, self.strides[0], self.offsets[0]),
            (v_table, self.rows, self.row_bands[:, 0], self.kv, self.strides[1], self.offsets[1]),
        ):
            entries = np.zeros((self.crop, stride), np.int32)
            w = np.zeros((self.crop, k), np.float32)
            w[:, : taps.shape[1]] = taps
            entries[:, :k] = w.view(np.int32)
            entries[:, k : 2 * k] = (w * np.float32(-(1 << 23))).view(np.int32)
            entries[:, 2 * k] = start - np.repeat(firsts, band_size)[: self.crop]
            entries[:, 2 * k + 1] = count
            out[off : off + entries.size] = entries.ravel()
        return out


def _bands(start: np.ndarray, count: np.ndarray, size: int) -> np.ndarray:
    """(first source index, source length) of each run of ``size`` outputs."""
    out = []
    for lo in range(0, len(start), size):
        s, n = start[lo : lo + size], count[lo : lo + size]
        first = int(s.min())
        out.append((first, int((s + n).max()) - first))
    return np.asarray(out, np.int32).reshape(-1, 2)


def _clamp_free(table) -> bool:
    """Every weight ≥ 0 and every entry's weights sum to at most 1 + 2⁻¹⁰, so
    a pass's sum t of bytes times weights lies in [0, 255.5): clip8's
    clamps cannot bind, and the unrolled form leaves them out (the triangle
    filter's normalized rows always qualify)."""
    taps = table[2].astype(np.float64)
    return bool((taps >= 0).all() and (taps.sum(axis=1) <= 1 + 2**-10).all())


def _plan(v_table, h_table, rows: int, cols: int) -> BandPlan:
    (v_start, v_count, _), (h_start, h_count, _) = v_table, h_table
    row_bands, col_bands = _bands(v_start, v_count, rows), _bands(h_start, h_count, cols)
    unrolled = (int(v_count.max()) <= UNROLLED_TAPS and int(h_count.max()) <= UNROLLED_TAPS
                and _clamp_free(v_table) and _clamp_free(h_table))
    kh = UNROLLED_TAPS if unrolled else int(h_count.max())
    kv = UNROLLED_TAPS if unrolled else int(v_count.max())
    pad = UNROLLED_TAPS - 1 if unrolled else 0  # what a zero-weight tap past a window's end reads
    src_rows, src_cols = int(row_bands[:, 1].max()), int(col_bands[:, 1].max())
    # up to 15 bytes of alignment, the row, its zero-weight taps and the
    # unrolled form's last word
    src_pitch = _round16(15 + 3 * (src_cols + pad) + 4)
    h_rows = src_rows + pad
    h_pitch = -(-3 * cols // RUN_BYTES) * RUN_BYTES
    smem = 2 * src_rows * src_pitch + h_rows * h_pitch
    return BandPlan(len(v_start), rows, cols, UNROLLED_TAPS if unrolled else 0, kh, kv, src_rows, src_cols,
                    src_pitch, h_rows, h_pitch, smem, row_bands, col_bands)


@lru_cache(maxsize=16)
def band_plan(h: int, w: int, resize: int, crop: int) -> BandPlan | None:
    """The tallest band of the full crop width whose block fits
    ``BAND_SMEM_TARGET``; where none does, the widest of half, a quarter, …
    of it (down to 16 columns); then the same up to ``BAND_SMEM_LIMIT``.
    None when no band fits at all: the kernel then runs one thread an output
    pixel from global memory."""
    wv, wh = crop_weights(h, w, resize, crop)
    v_table, h_table = tap_table(wv), tap_table(wh)
    widths = [crop]
    while widths[-1] > 16:
        widths.append(max(16, _round16(widths[-1] // 2)))
    for budget in (BAND_SMEM_TARGET, BAND_SMEM_LIMIT):
        for cols in widths:
            for rows in BAND_ROWS:
                plan = _plan(v_table, h_table, min(rows, crop), cols)
                if plan.smem_bytes <= budget:
                    return plan
    return None


@lru_cache(maxsize=16)
def _device_tables(h: int, w: int, resize: int, crop: int, device: torch.device):
    """Row and column tap tables for one geometry, and its band plan's
    ``tables()`` (a placeholder when no band fits), resident on ``device``."""
    wv, wh = crop_weights(h, w, resize, crop)
    v_table, h_table = tap_table(wv), tap_table(wh)
    plan = band_plan(h, w, resize, crop)
    bands = np.zeros(4, np.int32) if plan is None else plan.tables(v_table, h_table)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (*v_table, *h_table, bands))


@lru_cache(maxsize=32)
def _plan_header(h: int, w: int, resize: int, crop: int, out_kind: int, device_index: int):
    """The kernel's int32 plan for one geometry and output kind, with the
    grid: one wave of blocks (resident blocks an SM × SMs), at most one a
    band. All zeros when no band fits."""
    plan = band_plan(h, w, resize, crop)
    if plan is None:
        return (ctypes.c_int * PLAN_WORDS)()
    info = (ctypes.c_int * 4)()
    err = _info_entry()(out_kind, plan.taps, plan.smem_bytes, info)
    if err != 0:
        raise RuntimeError(f"preprocess kernel query failed: cudaError {err}")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return (ctypes.c_int * PLAN_WORDS)(*plan.header(max(1, sms * info[3])))


@lru_cache(maxsize=1)
def _kernel_entries():
    from ssip_tpu_torch.kernels.build import load_library

    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = [
        p, p, p, i,  # v_start, v_count, v_w, kv
        p, p, p, i,  # h_start, h_count, h_w, kh
        f, f, f, f, f, f,  # off[3], sc[3]
    ]
    plain, quant = lib.ssip_preprocess_u8, lib.ssip_preprocess_u8_quant
    plain.argtypes = [p, p, i, i, i, i, i, *tables, p, p, p]  # in, out, out_bf16, batch, h, w, crop, …, plan, bands, stream
    quant.argtypes = [p, p, i, i, i, i, *tables, f, p, p, p]  # in, out, batch, h, w, crop, …, inv_s, plan, bands, stream
    plain.restype = quant.restype = ctypes.c_int
    return plain, quant


@lru_cache(maxsize=1)
def _info_entry():
    from ssip_tpu_torch.kernels.build import load_library

    fn = load_library().ssip_preprocess_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # out_kind, taps, smem, out[4]
    fn.restype = ctypes.c_int
    return fn


def _check_images(images_u8: torch.Tensor, resize: int, crop: int) -> None:
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


def _launch(images_u8: torch.Tensor, resize: int, crop: int, out_dtype: torch.dtype, inv_scale: float | None):
    """(output, launched?) of the kernel on a CUDA batch; an empty batch
    launches nothing. ``inv_scale`` set means the int8 epilogue."""
    if images_u8.device.type != "cuda":
        raise ValueError(f"preprocess runs on cpu or cuda tensors, got {images_u8.device}")
    if not images_u8.is_contiguous():
        raise ValueError("preprocess kernel needs a contiguous NHWC tensor")
    b, h, w, _ = images_u8.shape
    out = torch.empty((b, crop, crop, 3), dtype=out_dtype, device=images_u8.device)
    if b == 0:
        return out, False
    tables = _device_tables(h, w, resize, crop, images_u8.device)
    v_w, h_w = tables[2], tables[5]
    off, sc = normalize_constants()
    shared = (
        *(t.data_ptr() for t in tables[:3]), v_w.shape[1], *(t.data_ptr() for t in tables[3:6]), h_w.shape[1],
        *(float(v) for v in off), *(float(v) for v in sc),
    )
    out_kind = 2 if inv_scale is not None else int(out_dtype == torch.bfloat16)
    plain, quant = _kernel_entries()
    with torch.cuda.device(images_u8.device):  # the launch's device; restored after
        plan = _plan_header(h, w, resize, crop, out_kind, torch.cuda.current_device())
        stream = torch.cuda.current_stream().cuda_stream
        if inv_scale is None:
            err = plain(images_u8.data_ptr(), out.data_ptr(), out_kind, b, h, w, crop, *shared,
                        plan, tables[6].data_ptr(), stream)
        else:
            err = quant(images_u8.data_ptr(), out.data_ptr(), b, h, w, crop, *shared, float(inv_scale),
                        plan, tables[6].data_ptr(), stream)
    if err == -1:
        raise ValueError(f"a batch of {b} {h}x{w} images has more bands than one launch takes")
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: cudaError {err}")
    return out, True


def preprocess_quantize_images(
    images_u8: torch.Tensor, inv_scale: float, resize: int = 256, crop: int = 224
) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 3] → int8 NHWC [B, crop, crop, 3]: the
    normalized value times ``inv_scale``, rounded half to even, clipped to
    ±127. ``inv_scale`` is a Python float holding a float32 value (the
    quantized stem's ``inv_scale``).

    ``preprocess_quantize_images.launches`` counts launches of the kernel's
    int8 form (CPU calls and empty batches launch nothing and count nothing).
    """
    _check_images(images_u8, resize, crop)
    if images_u8.device.type == "cpu":
        return quantize(extraction_preprocess(images_u8, resize=resize, crop=crop, dtype=torch.float32), inv_scale)
    out, launched = _launch(images_u8, resize, crop, torch.int8, float(inv_scale))
    preprocess_quantize_images.launches += int(launched)
    return out


preprocess_quantize_images.launches = 0


def preprocess_images(
    images_u8: torch.Tensor,
    resize: int = 256,
    crop: int = 224,
    out_dtype: torch.dtype = torch.float32,
    quant_inv_scale: float | None = None,
) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 3] → normalized NHWC [B, crop, crop, 3], or with
    ``quant_inv_scale`` the int8 form of ``preprocess_quantize_images``.

    ``preprocess_images.launches`` counts launches of the float forms (CPU
    calls and empty batches launch nothing and count nothing).
    """
    if quant_inv_scale is not None:
        return preprocess_quantize_images(images_u8, quant_inv_scale, resize, crop)
    _check_images(images_u8, resize, crop)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if images_u8.device.type == "cpu":
        return extraction_preprocess(images_u8, resize=resize, crop=crop, dtype=out_dtype)
    out, launched = _launch(images_u8, resize, crop, out_dtype, None)
    preprocess_images.launches += int(launched)
    return out


preprocess_images.launches = 0
