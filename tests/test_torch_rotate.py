"""The port's uint8 rotation (``rotate_nearest``, the plain version of the
``rotate_images`` kernel) against the JAX package, bit for bit.

The same numpy-seeded images and ``jax.random`` angles go through
``ssip_tpu.ops.augment._rotate_gather`` and through the 2-D-banded Pallas
kernel ``_rotate_mxu_blocked`` in interpret mode (the TPU kernel that
``csrc/rotate.cu`` replaces), at the shapes and angle cases of
``tests/test_rotate_mxu.py``. On the CPU ``rotate_images`` runs
``rotate_nearest``; the kernel itself is held to it on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.augment import _mxu_geometry_blocked, _rotate_gather, _rotate_mxu_blocked, _rotation_index_map
from ssip_tpu.ops.augment import random_flip as jax_random_flip
from ssip_tpu_torch.ops.augment import augment_coeffs, rotate_nearest
from ssip_tpu_torch.ops.rotate import rotate_images

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
