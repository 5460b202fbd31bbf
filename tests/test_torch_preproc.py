"""The port's extraction preprocess against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs ``ops.resize.extraction_preprocess`` (XLA) and the Pallas kernel
``preprocess_images_pallas`` in interpret mode. The CUDA kernel cannot run
here; its tap tables and tap arithmetic are checked through a numpy model
of the kernel, and the kernel itself by ``tests/test_torch_cuda.py`` on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.pallas_preproc import preprocess_images_pallas
from ssip_tpu.ops.resize import extraction_preprocess as jax_extraction_preprocess
from ssip_tpu.ops.resize import triangle_weights as jax_triangle_weights
from ssip_tpu_torch.ops.preproc import preprocess_images, tap_table
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
