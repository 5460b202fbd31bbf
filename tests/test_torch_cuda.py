"""Tests of the port that need an NVIDIA GPU: the six CUDA kernels and the
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
from ssip_tpu_torch.ops.attention import (
    MAX_KERNEL_SEQ, attention_qkv_bwd, attention_qkv_bwd_plain, attention_qkv_plain, fused_attention_qkv,
)
from ssip_tpu_torch.ops.augment import augment_coeffs, train_augment
from ssip_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain
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


# Kernel and plain version sum in another order, so they are held to:
# float32 outputs within 2e-5 of O(1) values, bfloat16 outputs within one
# bfloat16 step of the plain value (2e-5 where a step is smaller), gradients
# within 1e-5 (float32) or 1e-2 (bfloat16) of each tensor's largest entry.
F32_ATOL = 2e-5
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_output_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    tol = torch.full_like(err, F32_ATOL)
    if ref.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
        tol = torch.maximum(tol, step)
    assert bool((err <= tol).all()), f"max |d| {err.max().item()} ({(err > tol).sum().item()} values out)"


def _assert_grad_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    assert got.dtype == ref.dtype and got.shape == ref.shape
    rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)).item()
    assert rel <= GRAD_RTOL[ref.dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,dtype",
    [(4 * 197, 768, torch.bfloat16), (4 * 197, 768, torch.float32), (128, 768, torch.float32),
     (130, 192, torch.bfloat16), (7, 384, torch.float32), (3, 1024, torch.bfloat16), (5, 8, torch.float32)],
)
def test_layer_norm_kernels_match_plain_on_cuda(cuda, n, d, dtype):
    """Forward, and the backward through autograd, at the ViT widths, a row
    count that is no multiple of the block and the narrowest width."""
    rng = np.random.default_rng(n * d)
    x = torch.from_numpy(rng.normal(0.3, 1.5, (n, d)).astype(np.float32)).to(cuda, dtype).requires_grad_()
    scale = torch.from_numpy(rng.normal(1.0, 0.2, d).astype(np.float32)).to(cuda).requires_grad_()
    bias = torch.from_numpy(rng.normal(0.0, 0.2, d).astype(np.float32)).to(cuda).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda, dtype)
    before = layer_norm.launches, layer_norm_bwd.launches
    y = layer_norm(x, scale, bias, 1e-6)
    dx, dscale, dbias = torch.autograd.grad(y, (x, scale, bias), dy)
    torch.cuda.synchronize()
    assert (layer_norm.launches, layer_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_output_close(y.detach(), layer_norm_plain(x.detach(), scale.detach(), bias.detach(), 1e-6))
    ref_dx, ref_dscale, ref_dbias = layer_norm_bwd_plain(x.detach(), scale.detach(), dy, 1e-6)
    _assert_grad_close(dx, ref_dx)
    _assert_grad_close(dscale, ref_dscale)
    _assert_grad_close(dbias, ref_dbias)
    again = layer_norm_bwd(x.detach(), scale.detach(), dy, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dscale, dbias)))  # no atomics: run to run the same


@pytest.mark.cuda
def test_layer_norm_kernel_rejects_what_it_does_not_take(cuda):
    ones = torch.ones(100, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm(torch.zeros((4, 100), dtype=torch.bfloat16, device=cuda), ones, ones)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(torch.zeros((4, 200), device=cuda)[:, ::2], ones, ones)
    with pytest.raises(ValueError, match="at most 1024"):
        layer_norm(torch.zeros((4, 2048), device=cuda), torch.ones(2048, device=cuda), torch.ones(2048, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,heads,dh,kv_len,dtype",
    [(4, 197, 12, 64, 0, torch.bfloat16), (4, 208, 12, 64, 197, torch.bfloat16),
     (2, 208, 3, 64, 197, torch.float32), (2, 197, 12, 64, 0, torch.float32),
     (3, 50, 2, 32, 37, torch.float32), (2, MAX_KERNEL_SEQ, 2, 64, 0, torch.bfloat16),
     (2, 5, 1, 32, 3, torch.bfloat16)],
)
def test_attention_kernels_match_plain_on_cuda(cuda, b, s, heads, dh, kv_len, dtype):
    """Forward, and the backward through autograd, with and without the
    ``kv_len`` key mask; pad-query rows are compared too, and ``dO`` is
    non-zero on them."""
    configure_precision("float32")  # the plain version's matmuls in true f32
    rng = np.random.default_rng(b * s * heads)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * heads * dh)).astype(np.float32)).to(cuda, dtype)
    d_o = torch.from_numpy(rng.standard_normal((b, s, heads * dh)).astype(np.float32)).to(cuda, dtype)
    before = fused_attention_qkv.launches, attention_qkv_bwd.launches
    qkv.requires_grad_()
    out = fused_attention_qkv(qkv, heads, kv_len)
    (dqkv,) = torch.autograd.grad(out, qkv, d_o)
    torch.cuda.synchronize()
    assert (fused_attention_qkv.launches, attention_qkv_bwd.launches) == (before[0] + 1, before[1] + 1)
    qkv = qkv.detach()
    _assert_output_close(out.detach(), attention_qkv_plain(qkv, heads, kv_len))
    ref = attention_qkv_bwd_plain(qkv, d_o, heads, kv_len)
    for part, name in enumerate("qkv"):
        cols = slice(part * heads * dh, (part + 1) * heads * dh)
        _assert_grad_close(dqkv[..., cols], ref[..., cols])
    if 0 < kv_len < s:  # masked keys get exactly zero gradients
        assert not dqkv[:, kv_len:, heads * dh :].any()


@pytest.mark.cuda
def test_attention_kernel_refuses_long_sequences_with_roadmap_pointer(cuda):
    qkv = torch.zeros((1, MAX_KERNEL_SEQ + 1, 3 * 64), device=cuda)
    with pytest.raises(ValueError, match=r"ROADMAP\.md, Queue 2 #5a"):
        fused_attention_qkv(qkv, 1)
    with pytest.raises(ValueError, match="head widths"):
        fused_attention_qkv(torch.zeros((1, 8, 3 * 16), device=cuda), 1)
