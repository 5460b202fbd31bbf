"""Tests of the port that need an NVIDIA GPU: the CUDA kernels and the
pinned device feed against their plain versions, on the card.

They are marked ``cuda`` and skip without a card. This file imports no jax,
so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ssip_tpu_torch.data.pipeline import ImageStore, iter_device_batches
from ssip_tpu_torch.ops.augment import augment_coeffs, train_augment
from ssip_tpu_torch.ops.preproc import preprocess_images
from ssip_tpu_torch.ops.resize import IMAGENET_STD, extraction_preprocess
from ssip_tpu_torch.ops.rotate import augment_images
from ssip_tpu_torch.runtime.device import configure_precision
from ssip_tpu_torch.runtime.prng import augment_draws

# one uint8 step before the normalize, after it
ONE_STEP = 1.0 / (255.0 * min(IMAGENET_STD)) + 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels and the pinned feed have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,exact",
    [((4, 512, 512, 3), True), ((4, 384, 384, 3), False), ((4, 320, 448, 3), False)],
)
def test_kernel_matches_plain_on_cuda(cuda, shape, exact):
    """f32 bitwise at the extraction size, bf16 = f32 rounded to nearest
    even; one uint8 step at non-dyadic sizes."""
    configure_precision("float32")  # the plain version's matmuls in true f32
    x = torch.from_numpy(np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    before = preprocess_images.launches
    got = preprocess_images(x, 256, 224, torch.float32)
    got_bf16 = preprocess_images(x, 256, 224, torch.bfloat16)
    assert preprocess_images.launches == before + 2
    ref = extraction_preprocess(x, 256, 224, torch.float32)
    if exact:
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        torch.testing.assert_close(got_bf16, ref.to(torch.bfloat16), rtol=0, atol=0)
    else:
        assert (got - ref).abs().max().item() <= ONE_STEP


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda):
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_images(x[:, ::2], 8, 8)


@pytest.mark.cuda
def test_iter_device_batches_on_cuda(cuda):
    """The pinned, side-stream double-buffered feed delivers every batch
    intact, the last one zero-padded."""
    images = np.random.default_rng(0).integers(0, 256, (11, 8, 8, 3), dtype=np.uint8)
    store = ImageStore.from_array(images, [Path(f"{i}.png") for i in range(11)])
    batches = list(iter_device_batches(store, np.arange(11), 4, cuda))
    assert [b.valid for b in batches] == [4, 4, 3]
    assert all(b.data.device.type == "cuda" and b.data.shape == (4, 8, 8, 3) for b in batches)
    got = torch.cat([b.data[: b.valid] for b in batches]).cpu().numpy()
    np.testing.assert_array_equal(got, images)
    assert not batches[-1].data[3:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 224, 224, 3), (4, 224, 160, 3), (3, 64, 96, 3)])
def test_augment_kernel_matches_plain_on_cuda(cuda, shape):
    """flip → rotate → normalize: float32 bitwise equal to the plain
    ``train_augment``, bfloat16 its float32 result rounded to nearest even;
    drawn angles in ±10° with the first two pinned at ±25°."""
    b = shape[0]
    flip, angles = augment_draws(0, "test", 0, 0, b, 10.0)
    angles[:2] = np.float32([25.0, -25.0]) * np.float32(np.pi / 180.0)
    coeffs = torch.from_numpy(augment_coeffs(flip, angles)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    before = augment_images.launches
    got = augment_images(x, coeffs, torch.float32)
    got_bf16 = augment_images(x, coeffs, torch.bfloat16)
    assert augment_images.launches == before + 2
    ref = train_augment(x, coeffs, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(got_bf16, ref.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.cuda
def test_augment_kernel_rejects_non_contiguous(cuda):
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    coeffs = torch.from_numpy(augment_coeffs(np.zeros(2, bool), np.zeros(2, np.float32))).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        augment_images(x[:, ::2], coeffs)
