"""The port's uint8 rotation (``rotate_nearest``, the plain version of the
``rotate_images`` kernel) against the JAX package, bit for bit.

The same numpy-seeded images and ``jax.random`` angles go through
``ssip_tpu.ops.augment._rotate_gather`` and through the 2-D-banded Pallas
kernel ``_rotate_mxu_blocked`` in interpret mode (the TPU kernel that
``csrc/rotation.cu`` replaces), at the shapes and angle cases of
``tests/test_rotate_mxu.py``. On the CPU ``rotate_images`` runs
``rotate_nearest``; the kernel itself is held to it on the card
(``tests/test_torch_cuda.py``). The kernel's geometry is held here: its
shift-and-step index map against ``_rotation_index_map``, and the source
window it finds from a tile's corners against every pixel of the tile and
its static shared buffer.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.augment import _mxu_geometry_blocked, _rotate_gather, _rotate_mxu_blocked, _rotation_index_map
from ssip_tpu.ops.augment import random_flip as jax_random_flip
from ssip_tpu_torch.ops.augment import Q, augment_coeffs, rotate_nearest, rotation_index_map
from ssip_tpu_torch.ops.rotate import (
    ROTATE_TILES, largest_window_bytes, rotate_images, tile_window, window_slot_bytes,
)

torch.set_num_threads(2)


def _jax_angles(key, b, max_degrees):
    return jax.random.uniform(key, (b,), minval=-max_degrees, maxval=max_degrees) * (jnp.pi / 180.0)


def _port_rotate(images: np.ndarray, angles, flip=None) -> np.ndarray:
    flip = np.zeros(images.shape[0], bool) if flip is None else flip
    coeffs = torch.from_numpy(augment_coeffs(flip, np.asarray(angles, np.float32)))
    got = rotate_images(torch.from_numpy(images), coeffs)
    assert got.dtype == torch.uint8 and torch.equal(got, rotate_nearest(torch.from_numpy(images), coeffs))
    return got.numpy()


# (shape, max_degrees, the TPU geometry has a block for it, seeds); 224² is
# held at one seed: the interpreted kernel takes seconds there
_SHAPES = [
    ((2, 64, 96, 3), 10.0, True, (0, 1, 2)),
    ((3, 64, 64, 3), 25.0, True, (0, 1, 2)),
    ((2, 224, 224, 3), 10.0, True, (0,)),
    ((1, 32, 128, 3), 2.0, True, (0, 1, 2)),
    ((2, 64, 36, 3), 10.0, False, (0, 1, 2)),
]


@pytest.mark.parametrize(
    "shape,max_degrees,blocked,seed",
    [(shape, deg, blocked, seed) for shape, deg, blocked, seeds in _SHAPES for seed in seeds],
)
def test_rotation_matches_gather_and_blocked_kernel_bitwise(shape, max_degrees, blocked, seed):
    images = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    angles = _jax_angles(jax.random.PRNGKey(seed), shape[0], max_degrees)
    iy, ix, valid = _rotation_index_map(angles, shape[1], shape[2])
    got = _port_rotate(images, angles)
    np.testing.assert_array_equal(got, np.asarray(_rotate_gather(jnp.asarray(images), iy, ix, valid)))
    assert (_mxu_geometry_blocked(shape[1], shape[2], max_degrees) is not None) == blocked
    if blocked:
        ref = _rotate_mxu_blocked(jnp.asarray(images), iy, ix, valid, max_degrees, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("deg", [-25.0, 25.0, -10.0, 10.0])
def test_extreme_angles_match_bitwise(deg):
    """Angles pinned at ±max_degrees: the worst case for the TPU kernel's band."""
    shape = (2, 64, 96, 3)
    images = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    angles = jnp.full((shape[0],), deg * np.pi / 180.0)
    iy, ix, valid = _rotation_index_map(angles, shape[1], shape[2])
    got = _port_rotate(images, angles)
    np.testing.assert_array_equal(got, np.asarray(_rotate_gather(jnp.asarray(images), iy, ix, valid)))
    ref = _rotate_mxu_blocked(jnp.asarray(images), iy, ix, valid, abs(deg), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 5])
def test_flip_then_rotate_matches_jax(seed):
    """With flip flags set the function is ``random_flip`` followed by
    ``random_rotate_nearest``, given the draws."""
    shape = (6, 48, 40, 3)
    images = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    k_flip, k_rot = jax.random.split(jax.random.PRNGKey(seed))
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (shape[0],)))
    angles = _jax_angles(k_rot, shape[0], 10.0)
    assert flip.any() and not flip.all()
    flipped = jax_random_flip(jnp.asarray(images), k_flip)
    ref = _rotate_gather(flipped, *_rotation_index_map(angles, shape[1], shape[2]))
    np.testing.assert_array_equal(_port_rotate(images, angles, flip), np.asarray(ref))


@pytest.mark.parametrize("deg", [45.0, 90.0, 135.0, -170.0])
def test_wide_angles_match_gather_bitwise(deg):
    """Angles the TPU kernels do not take (their bands are sized for small
    ones): the port's rotation takes any."""
    shape = (2, 40, 72, 3)
    images = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    angles = jnp.asarray([deg, deg / 3], jnp.float32) * (jnp.pi / 180.0)
    ref = _rotate_gather(jnp.asarray(images), *_rotation_index_map(angles, shape[1], shape[2]))
    np.testing.assert_array_equal(_port_rotate(images, angles), np.asarray(ref))


def test_wrapper_refusals():
    launches = rotate_images.launches
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8)
    angles = np.float32([12.0, 0.0]) * np.float32(np.pi / 180.0)
    coeffs = torch.from_numpy(augment_coeffs(np.zeros(2, bool), angles))
    assert rotate_images(x, coeffs).shape == x.shape
    with pytest.raises(ValueError, match="uint8 NHWC"):
        rotate_images(x.float(), coeffs)  # dtype
    with pytest.raises(ValueError, match="uint8 NHWC"):
        rotate_images(x[..., :2], coeffs)  # channels
    with pytest.raises(ValueError, match="uint8 NHWC"):
        rotate_images(x[0], coeffs)  # rank
    with pytest.raises(ValueError, match="coeffs"):
        rotate_images(x, coeffs[:, :1])  # batch
    with pytest.raises(ValueError, match="coeffs"):
        rotate_images(x, coeffs.long())
    with pytest.raises(ValueError, match="coeffs"):
        rotate_images(x, coeffs.to("meta"))  # another device than the images'
    with pytest.raises(ValueError, match="cpu or cuda"):
        rotate_images(x.to("meta"), coeffs.to("meta"))
    assert rotate_images(x[:0], coeffs[:, :0]).shape == (0, 16, 16, 3)
    assert rotate_images.launches == launches  # CPU calls launch nothing


# The kernel's geometry. Angles of (c): the pinned ones of the issue's
# cases, in float32 radians as the draws give them.
_MAP_DEGREES = np.float32([10.0, -10.0, 45.0, -45.0, 90.0, 180.0])
_MAP_SHAPES = [(224, 224), (224, 160), (64, 36), (5, 3)]
# coefficients that are no rotation: the map zooms out by 3 (the card test's)
_ZOOM_OUT = np.asarray([[3 << 16, 2 << 16, 1 << 16], [1 << 16, -(1 << 15), 0]], np.int32)


def _shift_and_step_map(icos, isin, h: int, w: int, run: int):
    """(iy, ix) [B, H, W] as ``csrc/rotation.cu`` computes them: per run of
    ``run`` pixels of a row the int32 map at its first pixel, then steps of
    2·isin and 2·icos (wrapping, as the kernel's unsigned adds) and an
    arithmetic shift by 17, past the image's edge included and then cut."""
    icos = np.asarray(icos, np.int32)[:, None, None]
    isin = np.asarray(isin, np.int32)[:, None, None]
    xs0 = np.arange(0, w, run, dtype=np.int32)
    yy2 = (2 * np.arange(h, dtype=np.int32) - (h - 1))[None, :, None]
    xx2 = (2 * xs0 - (w - 1))[None, None, :]
    ay = (icos * yy2 + isin * xx2 + np.int32(h * Q)).astype(np.uint32)
    ax = (-isin * yy2 + icos * xx2 + np.int32(w * Q)).astype(np.uint32)
    steps = np.arange(run, dtype=np.uint32)
    ay = ay[..., None] + (2 * isin.astype(np.uint32))[..., None] * steps  # [B, H, runs, run], wraps
    ax = ax[..., None] + (2 * icos.astype(np.uint32))[..., None] * steps
    iy = (ay.astype(np.int32) >> 17).reshape(icos.shape[0], h, -1)[:, :, :w]
    ix = (ax.astype(np.int32) >> 17).reshape(icos.shape[0], h, -1)[:, :, :w]
    return iy, ix


@pytest.mark.parametrize("run", [16, 8, 4])
@pytest.mark.parametrize("h,w", _MAP_SHAPES)
def test_shift_and_step_index_map_is_jax_bit_for_bit(h, w, run):
    """The kernel's map (one multiply a run, then a step a pixel, a shift in
    place of the floor division) is ``_rotation_index_map`` bit for bit at
    ±10°, ±45°, 90° and 180°, for each output type's run length."""
    angles = _MAP_DEGREES * np.float32(np.pi / 180.0)
    coeffs = augment_coeffs(np.zeros(len(angles), bool), angles)
    iy, ix = _shift_and_step_map(coeffs[0], coeffs[1], h, w, run)
    jy, jx, _ = _rotation_index_map(jnp.asarray(angles), h, w)
    np.testing.assert_array_equal(iy, np.asarray(jy))
    np.testing.assert_array_equal(ix, np.asarray(jx))


@pytest.mark.parametrize("h,w", _MAP_SHAPES)
def test_shift_and_step_index_map_on_the_zoom_out_map(h, w):
    """Coefficients that are no rotation: the same map as the plain
    version's floor division."""
    want_y, want_x, _ = rotation_index_map(torch.from_numpy(_ZOOM_OUT[0]), torch.from_numpy(_ZOOM_OUT[1]), h, w)
    for run in (16, 8, 4):
        iy, ix = _shift_and_step_map(_ZOOM_OUT[0], _ZOOM_OUT[1], h, w, run)
        np.testing.assert_array_equal(iy, want_y.numpy())
        np.testing.assert_array_equal(ix, want_x.numpy())


def _kernel_tiles() -> dict:
    """RotTile<T>'s (rows, pixels, window bytes) as csrc/rotation.cu states them."""
    text = (Path(__file__).resolve().parents[1] / "ssip_tpu_torch" / "csrc" / "rotation.cu").read_text()
    found = re.findall(
        r"struct RotTile<(\w+)> \{\s*static constexpr int kH = (\d+), kW = (\d+), kWindowBytes = (\d+);", text)
    names = {"uint8_t": torch.uint8, "__nv_bfloat16": torch.bfloat16, "float": torch.float32}
    return {names[t]: tuple(map(int, v)) for t, *v in found}


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32])
def test_tile_window_holds_every_source_and_fits_the_static_window(dtype):
    """For the chosen tile of each output type: the kernel's static window
    is the largest any angle asks for (34,272, 34,272 and 11,328 bytes for
    32 × 112, 16 × 128 and 16 × 64), and at every whole degree of a turn (and
    the issue's pinned angles) the window from each tile's corners is the
    exact smallest and largest source row and column of the tile's pixels
    and fits it, over ragged tiles and 5 × 3 included."""
    tile_h, tile_w, window = ROTATE_TILES[dtype]
    assert _kernel_tiles()[dtype] == (tile_h, tile_w, window)
    assert largest_window_bytes(tile_h, tile_w) == window
    degrees = np.concatenate([np.arange(-180.0, 180.0, 1.0), [44.75, -44.75, 10.0, -10.0]]).astype(np.float32)
    coeffs = augment_coeffs(np.zeros(len(degrees), bool), degrees * np.float32(np.pi / 180.0))
    for h, w in ((224, 224), (224, 160), (64, 36), (37, 129), (5, 3)):
        iy, ix, _ = rotation_index_map(torch.from_numpy(coeffs[0]), torch.from_numpy(coeffs[1]), h, w)
        iy, ix = iy.numpy(), ix.numpy()
        for k, (icos, isin) in enumerate(zip(coeffs[0], coeffs[1])):
            for y0 in range(0, h, tile_h):
                for x0 in range(0, w, tile_w):
                    ty, tx = iy[k, y0 : y0 + tile_h, x0 : x0 + tile_w], ix[k, y0 : y0 + tile_h, x0 : x0 + tile_w]
                    lo_y, hi_y, lo_x, hi_x = tile_window(int(icos), int(isin), h, w, y0, x0, tile_h, tile_w)
                    assert (lo_y, hi_y, lo_x, hi_x) == (ty.min(), ty.max(), tx.min(), tx.max())
                    assert (hi_y - lo_y + 1) * window_slot_bytes(hi_x - lo_x + 1) <= window
