"""The port's int8 primitives against the JAX package's, on the CPU, exact.

The same numpy-seeded inputs go through ``ssip_tpu.models.quantized_vit``'s
``_quant`` and ``_qdense`` and the port's ``quantize`` and ``qdense``; through
``preprocess_images_pallas(quant_inv_scale=…, interpret=True)`` (the Pallas
kernel ``_preproc_quant_kernel`` in interpret mode) and the port's
``preprocess_images(quant_inv_scale=…)``, which runs its plain version for a
CPU tensor; and through both ``preprocess_host_exact``. Rounding is half to
even in both packages and integer sums are exact, so every comparison is of
equal bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.data.decode import preprocess_host_exact as jax_preprocess_host_exact
from ssip_tpu.models.quantized_vit import _qdense, _quant
from ssip_tpu.ops.pallas_preproc import preprocess_images_pallas
from ssip_tpu_torch.data.decode import preprocess_host_exact
from ssip_tpu_torch.ops.preproc import preprocess_images, preprocess_quantize_images
from ssip_tpu_torch.ops.quant import QuantSite, int8_matmul, qdense, quantize
from ssip_tpu_torch.ops.resize import extraction_preprocess

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inv_scale", [1.0, 37.5, 127.0 / 2.6401, 0.013])
def test_quantize_matches_quant(dtype, inv_scale):
    """Half-way cases (…, −1.5, −0.5, 0.5, 1.5, …) over ``inv_scale``, values
    beyond ±127 steps, and seeded normal values."""
    rng = np.random.default_rng(3)
    inv = np.float32(inv_scale)
    ties = (np.arange(-140, 141, dtype=np.float32) + np.float32(0.5)) / inv
    x = np.concatenate([ties, rng.normal(0.0, 60.0 / inv, 4000).astype(np.float32), np.float32([0.0, -0.0])])
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = np.asarray(_quant(jnp.asarray(x).astype(jdt), jnp.float32(inv)))
    got = quantize(torch.from_numpy(x).to(tdt), float(inv))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == -127 and want.max() == 127
    # the scale as a 0-d tensor gives the same bits as the Python float
    np.testing.assert_array_equal(quantize(torch.from_numpy(x).to(tdt), torch.tensor(inv)).numpy(), want)


def _site(rng, cin, cout):
    return {
        "kernel": rng.integers(-127, 128, (cin, cout)).astype(np.int8),
        "mult": rng.uniform(1e-4, 1e-2, cout).astype(np.float32),
        "bias": rng.normal(0.0, 0.5, cout).astype(np.float32),
        "inv_in_scale": np.float32(rng.uniform(5.0, 50.0)),
    }


@pytest.mark.parametrize("lead,cin,cout", [((37,), 24, 40), ((2, 5), 192, 576), ((300,), 768, 192), ((1,), 8, 8)])
def test_qdense_matches_qdense(lead, cin, cout):
    rng = np.random.default_rng(cin + cout)
    leaves = _site(rng, cin, cout)
    x_q = rng.integers(-127, 128, (*lead, cin)).astype(np.int8)
    want = np.asarray(_qdense(jnp.asarray(x_q), {k: jnp.asarray(v) for k, v in leaves.items()}))
    site = QuantSite(**leaves)
    got = qdense(torch.from_numpy(x_q), site)
    assert got.dtype == torch.float32 and got.shape == (*lead, cout)
    np.testing.assert_array_equal(got.numpy(), want)
    # the int32 product itself, against numpy
    y32 = int8_matmul(torch.from_numpy(x_q).reshape(-1, cin), site.kernel)
    np.testing.assert_array_equal(y32.numpy(), x_q.reshape(-1, cin).astype(np.int32) @ leaves["kernel"].astype(np.int32))


def test_quant_site_holds_the_tree_leaves():
    leaves = _site(np.random.default_rng(0), 16, 24)
    site = QuantSite(**leaves, transposed=True)
    assert site.inv_scale == float(leaves["inv_in_scale"])
    assert set(site.state_dict()) == {"kernel", "mult", "bias", "inv_in_scale", "kernel_t"}
    np.testing.assert_array_equal(site.kernel_t.numpy(), leaves["kernel"].T)
    back = site.leaves()
    for key, value in leaves.items():
        np.testing.assert_array_equal(back[key], value)
    with pytest.raises(ValueError, match="must be int8"):
        QuantSite(leaves["kernel"].astype(np.float32), leaves["mult"], leaves["bias"], 1.0)
    with pytest.raises(ValueError, match=r"must be \[24\]"):
        QuantSite(leaves["kernel"], leaves["mult"][:3], leaves["bias"], 1.0)
    with pytest.raises(ValueError, match="int8_matmul takes int8"):
        int8_matmul(torch.zeros((4, 16)), site.kernel)
    with pytest.raises(ValueError, match="inner sizes differ"):
        int8_matmul(torch.zeros((4, 8), dtype=torch.int8), site.kernel)


@pytest.mark.parametrize(
    "shape,resize,crop,inv_scale",
    [((2, 64, 64, 3), 32, 24, 48.1), ((1, 512, 512, 3), 256, 224, 127.0 / 2.64), ((2, 64, 64, 3), 32, 32, 300.0)],
)
def test_preprocess_quantize_matches_pallas_interpret(shape, resize, crop, inv_scale):
    """Dyadic sizes (a halving resize), where the resample is exact in both
    packages: the int8 images are equal, and equal to quantizing the float32
    preprocess outside. The last scale clips at ±127."""
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    inv = np.float32(inv_scale)
    want = np.asarray(preprocess_images_pallas(
        jnp.asarray(x), resize=resize, crop=crop, quant_inv_scale=jnp.float32(inv), interpret=True))
    xt = torch.from_numpy(x)
    got = preprocess_images(xt, resize, crop, quant_inv_scale=float(inv))
    assert got.dtype == torch.int8 and got.shape == (shape[0], crop, crop, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    outside = quantize(extraction_preprocess(xt, resize, crop, torch.float32), float(inv))
    assert torch.equal(got, outside)
    assert torch.equal(got, preprocess_quantize_images(xt, float(inv), resize, crop))
    assert len(np.unique(want)) > 100  # the scale spreads the values over the int8 range


def test_preprocess_quantize_on_the_cpu_launches_nothing_and_checks_its_input():
    before = preprocess_quantize_images.launches, preprocess_images.launches
    preprocess_images(torch.zeros((1, 16, 16, 3), dtype=torch.uint8), 8, 8, quant_inv_scale=10.0)
    assert (preprocess_quantize_images.launches, preprocess_images.launches) == before
    with pytest.raises(ValueError, match="uint8 NHWC"):
        preprocess_quantize_images(torch.zeros((1, 16, 16, 3)), 10.0, 8, 8)
    with pytest.raises(ValueError, match="crop"):
        preprocess_quantize_images(torch.zeros((1, 16, 16, 3), dtype=torch.uint8), 10.0, 8, 12)


@pytest.mark.parametrize(
    "shape,resize,crop",
    [((64, 64, 3), 36, 32), ((48, 80, 3), 36, 32), ((80, 48, 3), 40, 24), ((512, 512, 3), 256, 224),
     ((36, 36, 3), 36, 32), ((50, 70), 32, 32)],
)
def test_preprocess_host_exact_matches(shape, resize, crop):
    """Portrait, landscape, square, already at the resize size, and one
    grayscale image: equal bytes."""
    arr = np.random.default_rng(shape[0] * shape[1]).integers(0, 256, shape, dtype=np.uint8)
    want = jax_preprocess_host_exact(arr, resize, crop)
    got = preprocess_host_exact(arr, resize, crop)
    assert got.dtype == np.uint8 and got.shape == want.shape == (crop, crop, 3)
    np.testing.assert_array_equal(got, want)


def test_preprocess_host_exact_refuses_a_crop_above_the_resize():
    with pytest.raises(ValueError, match="must be <= resize"):
        preprocess_host_exact(np.zeros((8, 8, 3), np.uint8), 4, 6)
