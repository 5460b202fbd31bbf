"""The port's extraction preprocess against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs ``ops.resize.extraction_preprocess`` (XLA) and the Pallas kernel
``preprocess_images_pallas`` in interpret mode. The CUDA kernel cannot run
here; its tap tables and tap arithmetic are checked through a numpy model
of the kernel, its band plan against the tap tables, and its band schedule
through a numpy emulation; the kernel itself by ``tests/test_torch_cuda.py``
on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.pallas_preproc import preprocess_images_pallas
from ssip_tpu.ops.resize import extraction_preprocess as jax_extraction_preprocess
from ssip_tpu.ops.resize import triangle_weights as jax_triangle_weights
from ssip_tpu_torch.ops.preproc import (
    BAND_SMEM_LIMIT, BAND_SMEM_TARGET, UNROLLED_TAPS, band_plan, preprocess_images, tap_table,
)
from ssip_tpu_torch.ops.resize import (
    IMAGENET_STD,
    crop_weights,
    extraction_preprocess,
    normalize_constants,
    triangle_weights,
)

torch.set_num_threads(2)

# one uint8 step before the normalize, after it (tests/test_preprocess.py:96)
ONE_STEP = 1.0 / (255.0 * min(IMAGENET_STD)) + 1e-6


def _images(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _port(x, resize, crop, dtype=torch.float32):
    return preprocess_images(torch.from_numpy(x), resize=resize, crop=crop, out_dtype=dtype)


def test_full_size_bitwise_vs_xla_and_pallas():
    """2×512² → 256 → 224 f32: bitwise against both JAX paths."""
    x = _images((2, 512, 512, 3))
    got = _port(x, 256, 224).numpy()
    xla = np.asarray(jax_extraction_preprocess(jnp.asarray(x), resize=256, crop=224))
    pallas = np.asarray(
        preprocess_images_pallas(jnp.asarray(x), resize=256, crop=224, interpret=True)
    )
    assert got.shape == (2, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


def test_small_size_vs_xla_and_pallas():
    """64² → 32 → 24 within the JAX package's own bound (atol 1e-5)."""
    x = _images((2, 64, 64, 3), seed=1)
    got = _port(x, 32, 24).numpy()
    xla = np.asarray(jax_extraction_preprocess(jnp.asarray(x), resize=32, crop=24))
    pallas = np.asarray(
        preprocess_images_pallas(jnp.asarray(x), resize=32, crop=24, interpret=True)
    )
    np.testing.assert_allclose(got, xla, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


@pytest.mark.parametrize(
    "shape,resize,crop,atol",
    [
        ((2, 48, 64, 3), 32, 24, 1e-5),
        ((1, 64, 48, 3), 32, 24, 1e-5),
        # non-dyadic 427 → 256: the two matmuls sum in another order than
        # XLA's, which moves a few pixels by one uint8 step
        ((1, 427, 640, 3), 256, 224, ONE_STEP),
    ],
)
def test_non_square_vs_xla(shape, resize, crop, atol):
    """Short side → resize, long side int-truncated, center crop."""
    x = _images(shape, seed=2)
    got = _port(x, resize, crop).numpy()
    ref = np.asarray(jax_extraction_preprocess(jnp.asarray(x), resize=resize, crop=crop))
    assert got.shape == (shape[0], crop, crop, 3)
    diff = np.abs(got - ref)
    assert diff.max() <= atol
    assert (diff > 1e-5).mean() < 1e-3


@pytest.mark.parametrize("shape", [(8, 427, 640, 3), (8, 300, 300, 3)])
def test_extraction_preprocess_away_from_512_within_one_step_of_jax(shape):
    """Away from 512² sources XLA's CPU order of the cropped resample's sums
    is not known (ROADMAP Queue 3 #14): neither the matmul pair nor the
    training resize's ascending-tap order matches it. Observed at this
    seed: 34 of 1,204,224 values one uint8 step off at 427×640, 173 at
    300×300; the bound is one step on under 5e-4 of the values."""
    x = _images(shape, seed=14)
    got = extraction_preprocess(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_extraction_preprocess(jnp.asarray(x)))
    diff = np.abs(got - ref)
    assert diff.max() <= ONE_STEP
    assert 0 < (diff > 0).mean() < 5e-4


def test_bf16_is_f32_rounded_to_nearest_even():
    x = _images((2, 96, 96, 3), seed=3)
    f32 = _port(x, 64, 56)
    bf16 = _port(x, 64, 56, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), rtol=0, atol=0)
    ref = np.asarray(
        jax_extraction_preprocess(jnp.asarray(x), resize=64, crop=56, dtype=jnp.bfloat16)
    ).astype(np.float32)
    np.testing.assert_array_equal(bf16.float().numpy(), ref)


@pytest.mark.parametrize("src,dst", [(512, 256), (384, 256), (320, 256), (64, 32), (64, 256), (448, 358)])
def test_triangle_weights_copy_and_tap_tables(src, dst):
    """The numpy copy equals the JAX helper, and its tap table holds exactly
    the nonzeros of each row."""
    w = triangle_weights(src, dst)
    np.testing.assert_array_equal(w, jax_triangle_weights(src, dst))
    start, count, taps = tap_table(w)
    dense = np.zeros_like(w)
    for i in range(dst):
        dense[i, start[i] : start[i] + count[i]] = taps[i, : count[i]]
        assert w[i, start[i]] != 0 and w[i, start[i] + count[i] - 1] != 0
        assert not taps[i, count[i] :].any()
    np.testing.assert_array_equal(dense, w)


def _kernel_model(x, resize, crop):
    """numpy model of csrc/preproc.cu's arithmetic: f32 tap sums in
    ascending source order, clip8 after each pass, one subtract + one
    multiply."""
    b, h, w, _ = x.shape
    wv, wh = crop_weights(h, w, resize, crop)

    def taps(src, table, axis_len):
        start, count, wts = table
        out = np.zeros(src.shape[:-1] + (len(start),), np.float32)
        for j in range(wts.shape[1]):
            idx = np.minimum(start + j, axis_len - 1)
            wj = np.where(j < count, wts[:, j], np.float32(0)).astype(np.float32)
            out = (out + (src[..., idx] * wj).astype(np.float32)).astype(np.float32)
        return np.clip(np.floor(out + np.float32(0.5)), 0, 255).astype(np.float32)

    xf = np.transpose(x, (0, 3, 1, 2)).astype(np.float32)  # [B, 3, H, W]
    t = taps(xf, tap_table(wh), w)  # [B, 3, H, crop]
    y = taps(np.swapaxes(t, -1, -2), tap_table(wv), h)  # [B, 3, crop(x), crop(y)]
    y = np.swapaxes(y, -1, -2)
    off, sc = normalize_constants()
    return ((np.transpose(y, (0, 2, 3, 1)) - off) * sc).astype(np.float32)


def test_kernel_arithmetic_bitwise_at_extraction_size():
    """512² → 256 → 224: every tap weight is dyadic, so the tap sums are
    exact and the kernel's form equals the dense-matmul plain version."""
    x = _images((1, 512, 512, 3), seed=4)
    np.testing.assert_array_equal(_kernel_model(x, 256, 224), _port(x, 256, 224).numpy())


@pytest.mark.parametrize("shape", [(1, 384, 384, 3), (1, 320, 448, 3)])
def test_kernel_arithmetic_within_one_step_elsewhere(shape):
    """Non-dyadic weights: the summation order may move a value by one
    uint8 step before the normalize."""
    x = _images(shape, seed=5)
    diff = np.abs(_kernel_model(x, 256, 224) - _port(x, 256, 224).numpy())
    assert diff.max() <= ONE_STEP


def test_cpu_tensor_runs_plain_version_and_counts_nothing():
    before = preprocess_images.launches
    x = _images((1, 64, 64, 3), seed=6)
    got = _port(x, 32, 24)
    torch.testing.assert_close(
        got, extraction_preprocess(torch.from_numpy(x), resize=32, crop=24), rtol=0, atol=0
    )
    assert preprocess_images.launches == before


@pytest.mark.parametrize(
    "bad,kwargs,match",
    [
        (np.zeros((1, 8, 8, 3), np.float32), {}, "uint8"),
        (np.zeros((1, 8, 8, 4), np.uint8), {}, "NHWC"),
        (np.zeros((8, 8, 3), np.uint8), {}, "NHWC"),
        (np.zeros((1, 8, 8, 3), np.uint8), {"resize": 4, "crop": 6}, "crop"),
        (np.zeros((1, 8, 8, 3), np.uint8), {"out_dtype": torch.float16}, "out_dtype"),
    ],
)
def test_wrapper_rejects_bad_input(bad, kwargs, match):
    with pytest.raises(ValueError, match=match):
        preprocess_images(torch.from_numpy(bad), **kwargs)


# (a) and (b): the band kernel's plan and schedule. Geometries (H, W, resize,
# crop): the extraction size and the non-dyadic ones of the card phase, a
# small one, and sources whose bands take narrower tiles or many taps.
_PLAN_GEOMETRIES = [
    (512, 512, 256, 224), (384, 384, 256, 224), (320, 448, 256, 224), (64, 64, 32, 24),
    (1024, 1024, 256, 224), (4096, 4096, 256, 224), (300, 2048, 256, 224),
]


@pytest.mark.parametrize("h,w,resize,crop", _PLAN_GEOMETRIES)
def test_band_plan_covers_every_tap_and_fits_shared_memory(h, w, resize, crop):
    """Every output row and column lies in one band, whose source window
    holds all of its taps; the window's slots hold a row with its alignment
    and the unrolled form's zero-weight taps; the block fits shared memory."""
    plan = band_plan(h, w, resize, crop)
    assert plan is not None
    (v_start, v_count, _), (h_start, h_count, _) = (tap_table(m) for m in crop_weights(h, w, resize, crop))
    for bands, size, start, count, most in ((plan.row_bands, plan.rows, v_start, v_count, plan.src_rows),
                                            (plan.col_bands, plan.cols, h_start, h_count, plan.src_cols)):
        assert len(bands) == -(-crop // size)
        for i, (first, n) in enumerate(bands):
            out = slice(i * size, min((i + 1) * size, crop))
            assert first == start[out].min() and first + n == (start[out] + count[out]).max()
            assert 0 <= first and n <= most
        assert (start >= 0).all() and (start + count <= (h if bands is plan.row_bands else w)).all()
    taps = max(int(v_count.max()), int(h_count.max()))
    assert plan.taps == (UNROLLED_TAPS if taps <= UNROLLED_TAPS else 0)
    for m in crop_weights(h, w, resize, crop):  # what lets the unrolled form leave clip8's clamps out
        assert (m >= 0).all() and (m.astype(np.float64).sum(axis=1) <= 1 + 2**-10).all()
    pad = UNROLLED_TAPS - 1 if plan.taps else 0
    # a slot: up to 15 bytes of alignment, the row, the zero-weight taps, and a 4-byte word read past them
    assert plan.src_pitch % 16 == 0 and plan.src_pitch >= 15 + 3 * (plan.src_cols + pad) + 4
    assert plan.h_rows == plan.src_rows + pad and plan.h_pitch % 48 == 0 and plan.h_pitch >= 3 * plan.cols
    assert plan.kh >= h_count.max() and plan.kv >= v_count.max()
    assert plan.smem_bytes == 2 * plan.src_rows * plan.src_pitch + plan.h_rows * plan.h_pitch
    # the tap tables: every entry's weights, addends, first index relative to its band's window and count
    tables = plan.tables(tap_table(crop_weights(h, w, resize, crop)[0]), tap_table(crop_weights(h, w, resize, crop)[1]))
    for (start, count, wts), bands, size, stride, off, k in (
            ((h_start, h_count, tap_table(crop_weights(h, w, resize, crop)[1])[2]), plan.col_bands, plan.cols,
             plan.strides[0], plan.offsets[0], plan.kh),
            ((v_start, v_count, tap_table(crop_weights(h, w, resize, crop)[0])[2]), plan.row_bands, plan.rows,
             plan.strides[1], plan.offsets[1], plan.kv)):
        entries = tables[off : off + crop * stride].reshape(crop, stride)
        wk = entries[:, :k].view(np.float32)
        np.testing.assert_array_equal(wk[:, : wts.shape[1]], wts)
        assert not wk[:, wts.shape[1]:].any()
        np.testing.assert_array_equal(entries[:, k : 2 * k].view(np.float32), wk * np.float32(-(1 << 23)))
        np.testing.assert_array_equal(entries[:, 2 * k] + bands[np.arange(crop) // size, 0], start)
        np.testing.assert_array_equal(entries[:, 2 * k + 1], count)
    assert plan.smem_bytes <= BAND_SMEM_TARGET <= BAND_SMEM_LIMIT
    if (h, w) == (512, 512):  # the extraction size: full-width bands, unrolled taps
        assert (plan.cols, plan.taps) == (crop, UNROLLED_TAPS)
    if h == 4096:  # 32 vertical taps an output row: counted loops and narrow tiles
        assert int(v_count.max()) == 32 and plan.taps == 0 and plan.cols < crop


def _band_schedule(x: np.ndarray, resize: int, crop: int, kind: str, inv_scale: float = 1.0) -> np.ndarray:
    """numpy emulation of csrc/preproc.cu's band kernel: band by band, the
    horizontal pass over the band's window rows into a uint8 buffer (taps
    ascending, the first product alone, then float32 adds; the unrolled
    form's zero-weight taps read the bytes past the window, as the kernel
    does), then the vertical pass from that buffer, clip8 and the epilogue
    (``kind``: "f32", "bf16" or "int8")."""
    b, h, w, _ = x.shape
    plan = band_plan(h, w, resize, crop)
    (v_start, v_count, v_w), (h_start, h_count, h_w) = (tap_table(m) for m in crop_weights(h, w, resize, crop))
    kh, kv = (plan.kh, plan.kv) if plan.taps else (h_w.shape[1], v_w.shape[1])
    off, sc = normalize_constants()
    out = np.zeros((b, crop, crop, 3), np.float32)

    def clip8(t):
        return np.clip(np.floor(t + np.float32(0.5)), 0, 255).astype(np.float32)

    def passes(src, start, count, weights, k):  # src [..., n, 3] along the tapped axis at -2
        acc = None
        for j in range(k):
            wj = np.where(j < count, weights[:, j] if j < weights.shape[1] else 0, 0).astype(np.float32)
            idx = np.minimum(start + j, src.shape[-2] - 1)  # a padded tap's byte: any, times 0
            prod = (src[..., idx, :] * wj[:, None]).astype(np.float32)
            if plan.taps == 0:
                prod = np.where((j < count)[:, None], prod, np.float32(0))
            acc = prod if acc is None else (acc + prod).astype(np.float32)
        return clip8(acc)

    for img in range(b):
        for rb, (rs, nr) in enumerate(plan.row_bands):
            oy = slice(rb * plan.rows, min((rb + 1) * plan.rows, crop))
            for cb, (cs, nc) in enumerate(plan.col_bands):
                ox = slice(cb * plan.cols, min((cb + 1) * plan.cols, crop))
                window = x[img, rs : rs + nr, cs:].astype(np.float32)  # the bytes past it too
                hbuf = passes(window, h_start[ox] - cs, h_count[ox], h_w[ox], kh)  # [nr, cols, 3]
                hbuf = np.concatenate([hbuf, np.zeros((kv, hbuf.shape[1], 3), np.float32)])  # rows past it
                y = passes(np.swapaxes(hbuf, 0, 1), v_start[oy] - rs, v_count[oy], v_w[oy], kv)  # [cols, rows, 3]
                out[img, oy, ox] = np.swapaxes(y, 0, 1)
    v = ((out - off) * sc).astype(np.float32)
    if kind == "bf16":
        return torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    if kind == "int8":
        return np.clip(np.rint((v * np.float32(inv_scale)).astype(np.float32)), -127, 127).astype(np.int8)
    return v


_INV_SCALE = float(np.float32(127.0 / 2.64))


def test_band_schedule_bitwise_to_pallas_at_extraction_size():
    """512² → 256 → 224: the band schedule equals the Pallas kernels
    (interpret mode) bit for bit in all three outputs."""
    x = _images((1, 512, 512, 3), seed=8)
    xj = jnp.asarray(x)
    for kind, ref in (
        ("f32", preprocess_images_pallas(xj, resize=256, crop=224, interpret=True)),
        ("bf16", preprocess_images_pallas(xj, resize=256, crop=224, out_dtype=jnp.bfloat16, interpret=True)),
        ("int8", preprocess_images_pallas(xj, resize=256, crop=224, quant_inv_scale=jnp.float32(_INV_SCALE),
                                          interpret=True)),
    ):
        got = _band_schedule(x, 256, 224, kind, _INV_SCALE)
        np.testing.assert_array_equal(got, np.asarray(ref).astype(got.dtype))


@pytest.mark.parametrize("shape,resize,crop", [
    ((1, 384, 384, 3), 256, 224), ((1, 320, 448, 3), 256, 224), ((2, 64, 64, 3), 32, 24),
    ((1, 1024, 1024, 3), 256, 224), ((1, 300, 2048, 3), 256, 224),
])
def test_band_schedule_within_one_step_elsewhere(shape, resize, crop):
    """Elsewhere the band schedule is the first form's arithmetic bit for
    bit (``_kernel_model``) and within one uint8 step of the JAX package's
    ``extraction_preprocess`` before the normalize (int8: that step times
    the scale, plus one)."""
    x = _images(shape, seed=9)
    got = _band_schedule(x, resize, crop, "f32")
    np.testing.assert_array_equal(got, _kernel_model(x, resize, crop))
    ref = np.asarray(jax_extraction_preprocess(jnp.asarray(x), resize=resize, crop=crop))
    assert np.abs(got - ref).max() <= ONE_STEP
    q = _band_schedule(x, resize, crop, "int8", _INV_SCALE)
    want = np.clip(np.rint(ref * np.float32(_INV_SCALE)), -127, 127)
    assert np.abs(q.astype(np.int32) - want).max() <= int(ONE_STEP * _INV_SCALE) + 1
