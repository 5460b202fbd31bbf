"""Tests of the port that need an NVIDIA GPU: the eleven CUDA kernels and the
pinned device feed against their plain versions, on the card.

They are marked ``cuda`` and skip without a card. This file imports no jax,
so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import ctypes
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ssip_tpu_torch.data.pipeline import ImageStore, iter_device_batches
from ssip_tpu_torch.ops.attention import (
    attention_bwd, attention_bwd_plain, attention_plain, attention_qkv_bwd, attention_qkv_bwd_plain,
    attention_qkv_plain, attention_qkv_residuals, attention_residuals, attention_rounded_bwd_plain,
    attention_unrounded_plain, fused_attention, fused_attention_qkv,
)
from ssip_tpu_torch.ops.augment import augment_coeffs, rotate_nearest, strong_augment, train_augment
from ssip_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain
from ssip_tpu_torch.ops.preproc import (
    PLAN_WORDS, _device_tables, _kernel_entries, preprocess_images, preprocess_quantize_images,
)
from ssip_tpu_torch.ops.qmlp import (
    _check_cuda_operands, _launch_hidden, _launch_output, qmlp_hidden_plain, qmlp_output_plain, quantized_mlp,
    quantized_mlp_plain,
)
from ssip_tpu_torch.ops.quant import QuantSite, quantize
from ssip_tpu_torch.ops.resize import IMAGENET_STD, extraction_preprocess, normalize_constants
from ssip_tpu_torch.ops.rotate import augment_images, rotate_images
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


def _pixel_kernel(x: torch.Tensor, resize: int, crop: int, out_kind: int, inv_s: float = 1.0) -> torch.Tensor:
    """The preprocess through csrc/preproc.cu's one-thread-a-pixel kernel
    (the plan of no band): the first form's schedule, for holding the band
    kernel to it bit for bit."""
    b, h, w, _ = x.shape
    out = torch.empty((b, crop, crop, 3), dtype=(torch.float32, torch.bfloat16, torch.int8)[out_kind], device=x.device)
    tables = _device_tables(h, w, resize, crop, x.device)
    off, sc = normalize_constants()
    shared = (*(t.data_ptr() for t in tables[:3]), tables[2].shape[1], *(t.data_ptr() for t in tables[3:6]),
              tables[5].shape[1], *(float(v) for v in off), *(float(v) for v in sc))
    plain, quant = _kernel_entries()
    no_band, stream = (ctypes.c_int * PLAN_WORDS)(), torch.cuda.current_stream().cuda_stream
    if out_kind == 2:
        err = quant(x.data_ptr(), out.data_ptr(), b, h, w, crop, *shared, inv_s, no_band, tables[6].data_ptr(), stream)
    else:
        err = plain(x.data_ptr(), out.data_ptr(), out_kind, b, h, w, crop, *shared, no_band, tables[6].data_ptr(),
                    stream)
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dyadic", [(1024, 1024, True), (4096, 4096, True), (300, 2048, False)])
def test_kernel_narrow_and_counted_plans_on_cuda(cuda, h, w, dyadic):
    """Sources whose band plans take counted tap loops (8 and 32 taps) and
    narrow tiles (4096²), or a long side the crop cuts (300 × 2048), at
    batch 1: bit for bit the one-thread-a-pixel schedule in all three
    outputs, and the plain version bit for bit where the taps are dyadic
    (one uint8 step elsewhere)."""
    configure_precision("float32")
    inv = float(np.float32(127.0 / 2.64))
    x = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (1, h, w, 3), dtype=np.uint8)).to(cuda)
    got = [preprocess_images(x, 256, 224, torch.float32), preprocess_images(x, 256, 224, torch.bfloat16),
           preprocess_images(x, 256, 224, quant_inv_scale=inv)]
    for kind, g in enumerate(got):
        assert torch.equal(g, _pixel_kernel(x, 256, 224, kind, inv))
    ref = extraction_preprocess(x, 256, 224, torch.float32)
    if dyadic:
        assert torch.equal(got[0], ref) and torch.equal(got[1], ref.to(torch.bfloat16))
        assert torch.equal(got[2], quantize(ref, inv))
    else:
        assert (got[0] - ref).abs().max().item() <= ONE_STEP


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
@pytest.mark.parametrize("shape,degrees", [((3, 5, 3, 3), 10.0), ((2, 37, 129, 3), 45.0), ((4, 64, 36, 3), 25.0)])
def test_augment_kernel_small_odd_and_unaligned_sizes_on_cuda(cuda, shape, degrees):
    """5 × 3; 37 × 129 at ±45° (ragged tiles, wide windows); W = 36, whose
    row pitch (432 bytes of float32, 216 of bfloat16) is no multiple of 16
    bytes in bfloat16: bitwise equal to ``train_augment``."""
    b = shape[0]
    flip, angles = augment_draws(0, "test", 0, 3, b, degrees)
    angles[:2] = np.float32([degrees, -degrees]) * np.float32(np.pi / 180.0)
    coeffs = torch.from_numpy(augment_coeffs(flip, angles)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(13).integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    ref = train_augment(x, coeffs, torch.float32)
    assert torch.equal(augment_images(x, coeffs, torch.float32), ref)
    assert torch.equal(augment_images(x, coeffs, torch.bfloat16), ref.to(torch.bfloat16))


@pytest.mark.cuda
def test_augment_kernel_gathers_from_global_memory_when_the_window_is_too_large(cuda):
    """The zoom-out coefficients of the uint8 form's test, through the float
    epilogues: the global-memory path, bitwise equal to ``train_augment``."""
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (3, 64, 160, 3), dtype=np.uint8)).to(cuda)
    coeffs = torch.tensor([[3 << 16, 2 << 16, 1 << 16], [1 << 16, -(1 << 15), 0], [1, 0, 1]], dtype=torch.int32).to(cuda)
    ref = train_augment(x, coeffs, torch.float32)
    assert torch.equal(augment_images(x, coeffs, torch.float32), ref)
    assert torch.equal(augment_images(x, coeffs, torch.bfloat16), ref.to(torch.bfloat16))


@pytest.mark.cuda
def test_augment_kernel_rejects_non_contiguous(cuda):
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    coeffs = torch.from_numpy(augment_coeffs(np.zeros(2, bool), np.zeros(2, np.float32))).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        augment_images(x[:, ::2], coeffs)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,max_degrees",
    [((8, 224, 224, 3), 10.0), ((4, 224, 160, 3), 25.0), ((3, 64, 96, 3), 10.0), ((4, 64, 36, 3), 25.0),
     ((2, 37, 129, 3), 45.0), ((2, 16, 64, 3), 180.0), ((3, 5, 3, 3), 10.0)],
)
def test_rotate_kernel_matches_plain_on_cuda(cuda, shape, max_degrees):
    """flip → rotate, uint8 in and out: bitwise equal to ``rotate_nearest``
    at drawn angles with the first two pinned at ±``max_degrees`` (up to a
    half turn: the shared window holds any angle's sources), ragged edge
    tiles and a width the TPU geometry has no block for (64 × 36) included."""
    b = shape[0]
    flip, angles = augment_draws(0, "test", 0, 1, b, max_degrees)
    angles[:2] = np.float32([max_degrees, -max_degrees]) * np.float32(np.pi / 180.0)
    coeffs = torch.from_numpy(augment_coeffs(flip, angles)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    before = rotate_images.launches
    got = rotate_images(x, coeffs)
    torch.cuda.synchronize()
    assert rotate_images.launches == before + 1
    assert got.dtype == torch.uint8 and torch.equal(got, rotate_nearest(x, coeffs))
    bare = coeffs.clone()
    bare[2] = 0  # no flip: the bare rotation of the TPU kernel
    assert torch.equal(rotate_images(x, bare), rotate_nearest(x, bare))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 36, 36, 3), (2, 200, 36, 3)])
def test_rotate_kernel_row_pitch_no_multiple_of_16_on_cuda(cuda, shape):
    """W = 36: a uint8 row is 108 bytes, so most runs start off a 16-byte
    boundary and are written byte by byte; bitwise equal to
    ``rotate_nearest``."""
    b = shape[0]
    flip, angles = augment_draws(0, "test", 0, 4, b, 25.0)
    coeffs = torch.from_numpy(augment_coeffs(flip, angles)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(14).integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    assert torch.equal(rotate_images(x, coeffs), rotate_nearest(x, coeffs))


@pytest.mark.cuda
def test_rotate_kernel_gathers_from_global_memory_when_the_window_is_too_large(cuda):
    """Coefficients that are no rotation (the map zooms out by 3) ask for a
    source window beyond the shared one: those tiles gather from global
    memory, and still equal the plain version bit for bit."""
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (3, 64, 160, 3), dtype=np.uint8)).to(cuda)
    coeffs = torch.tensor([[3 << 16, 2 << 16, 1 << 16], [1 << 16, -(1 << 15), 0], [1, 0, 1]], dtype=torch.int32).to(cuda)
    assert torch.equal(rotate_images(x, coeffs), rotate_nearest(x, coeffs))


@pytest.mark.cuda
def test_rotate_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    angles = np.float32([12.0, 0.0]) * np.float32(np.pi / 180.0)
    coeffs = torch.from_numpy(augment_coeffs(np.zeros(2, bool), angles)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rotate_images(x[:, ::2], coeffs)
    with pytest.raises(ValueError, match="coeffs"):
        rotate_images(x, coeffs.cpu())
    assert rotate_images(x[:0], coeffs[:, :0]).shape == (0, 16, 16, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strong_augment_on_cuda_matches_cpu(cuda, dtype):
    """The strong view on the card (rotation kernel, then the jitter in
    plain PyTorch) against the same view on the CPU: the mean sums in
    another order, so float32 within 1e-4 and bfloat16 within one step."""
    b = 4
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 256, (b, 96, 80, 3), dtype=np.uint8))
    flip, angles = augment_draws(0, "test", 0, 2, b, 10.0)
    coeffs = torch.from_numpy(augment_coeffs(flip, angles))
    bright = torch.from_numpy(rng.uniform(-32, 32, b).astype(np.float32))
    contrast = torch.from_numpy(rng.uniform(0.7, 1.3, b).astype(np.float32))
    before = rotate_images.launches
    got = strong_augment(x.to(cuda), coeffs.to(cuda), bright.to(cuda), contrast.to(cuda), dtype)
    assert rotate_images.launches == before + 1
    want = strong_augment(x, coeffs, bright, contrast, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-6
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0, atol=tol)


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
     (130, 192, torch.bfloat16), (7, 384, torch.float32), (3, 1024, torch.bfloat16), (5, 8, torch.float32),
     # every exact-width template in both types, at row counts below the
     # grid, below a block's warps and no multiple of the ring's depth or of
     # a warp's rows a step (4 at 192 in bf16, 2 at 192 in f32 and 384 in bf16)
     (1, 192, torch.bfloat16), (3, 192, torch.float32), (1001, 192, torch.bfloat16), (515, 192, torch.float32),
     (1, 384, torch.bfloat16), (1001, 384, torch.bfloat16), (3, 768, torch.float32), (1, 768, torch.bfloat16),
     (1, 1024, torch.float32), (515, 1024, torch.float32), (2 * 197 + 1, 1024, torch.bfloat16),
     # the main path's rows: 128 images of 197 tokens and of 208
     (128 * 197, 768, torch.bfloat16), (128 * 197, 768, torch.float32), (128 * 208, 768, torch.bfloat16),
     (128 * 208, 768, torch.float32),
     # the generic template
     (3, 8, torch.bfloat16), (1, 8, torch.float32), (257, 200, torch.bfloat16), (33, 200, torch.float32),
     (2, 1000, torch.bfloat16), (129, 1000, torch.float32), (4100, 1016, torch.bfloat16)],
)
def test_layer_norm_kernels_match_plain_on_cuda(cuda, n, d, dtype):
    """Forward, and the backward through autograd, at the ViT widths (each
    an exact-width template of the kernels), row counts that are no multiple
    of a block, a step or the ring, the main path's rows, and widths that
    take the generic template, the narrowest among them."""
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
@pytest.mark.parametrize("d,dtype", [(768, torch.bfloat16), (768, torch.float32), (200, torch.bfloat16)])
def test_layer_norm_calls_launch_their_kernels_once(cuda, d, dtype):
    """torch.profiler sees one forward kernel a forward call, and one
    backward kernel and one column sum (the blocks' partial sums added in
    block order, its own launch) a backward call, and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((1000, d)).astype(np.float32)).to(cuda, dtype)
    scale, bias = (torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(cuda) for _ in range(2))
    layer_norm(x, scale, bias)
    layer_norm_bwd(x, scale, x)
    torch.cuda.synchronize()
    for call, want in ((lambda: layer_norm(x, scale, bias), {"ln_fwd_kernel": 3}),
                       (lambda: layer_norm_bwd(x, scale, x), {"ln_bwd_kernel": 3, "ln_colsum_kernel": 3})):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        got = {frag: sum(frag in name for name in names) for frag in want}
        assert got == want and len(names) == sum(want.values()), names


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
     (3, 50, 2, 32, 37, torch.float32), (2, 256, 2, 64, 0, torch.bfloat16),
     (2, 5, 1, 32, 3, torch.bfloat16),
     # the bf16 kernels' edges: S off a multiple of 16 and across the 32- and
     # 64-row tiles, ragged last key tiles, S = 256 at 1, 3, 12 heads
     (2, 63, 2, 64, 0, torch.bfloat16), (2, 64, 2, 64, 0, torch.bfloat16), (2, 65, 2, 32, 0, torch.bfloat16),
     (2, 129, 3, 64, 0, torch.bfloat16), (2, 197, 3, 32, 0, torch.bfloat16),
     (2, 208, 2, 32, 197, torch.bfloat16), (3, 50, 2, 64, 37, torch.bfloat16), (2, 16, 2, 64, 1, torch.bfloat16),
     (1, 256, 1, 32, 0, torch.bfloat16), (1, 256, 3, 64, 0, torch.bfloat16),
     (1, 256, 12, 32, 0, torch.bfloat16), (1, 256, 12, 64, 0, torch.bfloat16),
     # the whole-head bf16 forward's edges: S across its warps' groups of 8
     # query rows and its 32-key chunks (the last chunk's live lanes), both
     # head widths, 1 to 12 heads, batch 1 and 2, pad keys down to one real key
     *[(1 + (i // 2) % 2, s, (1, 3, 6, 12)[i % 4], dh, 0, torch.bfloat16)
       for i, (s, dh) in enumerate((s, dh) for s in (1, 5, 16, 17, 33, 64, 65, 196, 197, 256) for dh in (32, 64))],
     (2, 208, 6, 64, 197, torch.bfloat16), (1, 208, 12, 32, 197, torch.bfloat16),
     (2, 208, 3, 64, 1, torch.bfloat16), (1, 208, 1, 32, 1, torch.bfloat16),
     # the streamed bf16 pair past 256 tokens, at both head widths, some with
     # pad keys: the score cache up to 1297 tokens, three sweeps over K at 2000
     *[(1, s, 2, dh, kv, torch.bfloat16) for s, kv in ((255, 0), (256, 250), (257, 0), (577, 513), (1024, 0),
                                                      (1025, 1001), (1297, 0)) for dh in (32, 64)],
     (1, 2000, 1, 64, 1999, torch.bfloat16), (1, 2000, 1, 32, 0, torch.bfloat16),
     # the float32 kernels' edges: S = 256, one real key, one key past a
     # full 64-key tile, head width 32, S across the 64-row query and key blocks
     (2, 256, 12, 64, 0, torch.float32), (1, 256, 3, 32, 0, torch.float32),
     (2, 16, 2, 64, 1, torch.float32), (2, 130, 2, 64, 65, torch.float32), (2, 197, 3, 32, 0, torch.float32),
     (2, 65, 2, 32, 1, torch.float32), (2, 5, 1, 64, 0, torch.float32),
     (2, 1, 2, 64, 0, torch.float32), (2, 65, 2, 64, 65, torch.float32), (2, 129, 2, 32, 0, torch.float32),
     (2, 129, 3, 64, 65, torch.float32), (2, 40, 2, 64, 0, torch.float32), (1, 90, 2, 32, 70, torch.float32),
     (2, 33, 2, 64, 0, torch.float32), (2, 64, 2, 32, 33, torch.float32),
     # float32 past 256 up to the JAX entries' 1024
     (1, 257, 3, 64, 0, torch.float32), (2, 577, 2, 64, 0, torch.float32), (1, 577, 2, 32, 513, torch.float32),
     (1, 1024, 2, 64, 0, torch.float32), (1, 1024, 2, 32, 1000, torch.float32),
     # and past the JAX entries' 1024
     (1, 1025, 2, 64, 1001, torch.float32), (1, 1297, 2, 32, 0, torch.float32)],
)
def test_attention_kernels_match_plain_on_cuda(cuda, b, s, heads, dh, kv_len, dtype):
    """Forward, and the backward through autograd, with and without the
    ``kv_len`` key mask; pad-query rows are compared too, and ``dO`` is
    non-zero on them. One call is one launch."""
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
def test_attention_bf16_calls_launch_their_kernels_once(cuda):
    """On bfloat16 a forward call runs ``attn_qkv_fwd_mma_kernel`` once on
    the card and a backward call ``attn_qkv_bwd_rows_kernel`` and
    ``attn_qkv_bwd_keys_kernel`` once each, and nothing else of the
    attention kernels; each call counts one."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 197, 3 * 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    d_o = torch.from_numpy(rng.standard_normal((2, 197, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    before = fused_attention_qkv.launches, attention_qkv_bwd.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused_attention_qkv(qkv, 2)
        attention_qkv_bwd(qkv, d_o, 2)
        torch.cuda.synchronize()
    assert (fused_attention_qkv.launches, attention_qkv_bwd.launches) == (before[0] + 1, before[1] + 1)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "attn" in e.name]
    assert sum("attn_qkv_fwd_mma_kernel" in n for n in names) == 1, names
    assert sum("attn_qkv_bwd_rows_kernel" in n for n in names) == 1, names
    assert sum("attn_qkv_bwd_keys_kernel" in n for n in names) == 1, names
    assert len(names) == 3, names


@pytest.mark.cuda
@pytest.mark.parametrize("s", [257, 2000])
def test_attention_bf16_past_256_streams_its_keys(cuda, s):
    """Past 256 tokens a bfloat16 forward call runs
    ``attn_qkv_fwd_stream_kernel`` once (with its score cache at 257, three
    sweeps over the keys at 2000) and nothing else of the attention kernels,
    and a backward call the same two kernels as at 197 tokens."""
    rng = np.random.default_rng(s)
    qkv = torch.from_numpy(rng.standard_normal((1, s, 3 * 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    d_o = torch.from_numpy(rng.standard_normal((1, s, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused_attention_qkv(qkv, 1)
        attention_qkv_bwd(qkv, d_o, 1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "attn" in e.name]
    for kernel in ("attn_qkv_fwd_stream_kernel", "attn_qkv_bwd_rows_kernel", "attn_qkv_bwd_keys_kernel"):
        assert sum(kernel in n for n in names) == 1, names
    assert len(names) == 3, names


@pytest.mark.cuda
def test_attention_bf16_kernel_refuses_misaligned_operands(cuda):
    flat = torch.zeros(1 + 2 * 8 * 3 * 64, dtype=torch.bfloat16, device=cuda)
    qkv = flat[1:].view(2, 8, 3 * 64)  # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        fused_attention_qkv(qkv, 1)
    with pytest.raises(ValueError, match="16-byte"):
        attention_qkv_bwd(qkv, torch.zeros((2, 8, 64), dtype=torch.bfloat16, device=cuda), 1)


@pytest.mark.cuda
def test_attention_f32_kernel_refuses_misaligned_operands(cuda):
    """The float32 forward stages rows by 16-byte cp.async too: both
    entries, forward and backward, raise on an operand 4 bytes past a
    16-byte boundary."""
    flat = torch.zeros(1 + 2 * 8 * 3 * 64, device=cuda)
    qkv = flat[1:].view(2, 8, 3 * 64)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        fused_attention_qkv(qkv, 1)
    with pytest.raises(ValueError, match="16-byte"):
        attention_qkv_bwd(qkv, torch.zeros((2, 8, 64), device=cuda), 1)
    shifted = flat[1:1 + 2 * 8 * 64].view(1, 2, 8, 64)
    aligned = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fused_attention(aligned, aligned, shifted)
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd(shifted, aligned, aligned, aligned)


@pytest.mark.cuda
def test_attention_f32_forward_launches_its_kernel_once(cuda):
    """On float32 a forward call of either entry runs ``attn_f32_fwd_kernel``
    once on the card and nothing else of the attention kernels, counts one,
    and sets up no autograd node when nothing needs a gradient."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 197, 3 * 128)).astype(np.float32)).to(cuda)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 197, 64)).astype(np.float32)).to(cuda) for _ in range(3))
    before = fused_attention_qkv.launches, fused_attention.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out_packed = fused_attention_qkv(qkv, 2)
        out = fused_attention(q, k, v)
        torch.cuda.synchronize()
    assert (fused_attention_qkv.launches, fused_attention.launches) == (before[0] + 1, before[1] + 1)
    assert out_packed.grad_fn is None and out.grad_fn is None
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "attn" in e.name]
    assert sum("attn_f32_fwd_kernel" in n for n in names) == 2 and len(names) == 2, names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_refuses_what_it_does_not_take(cuda, dtype):
    """Every sequence length is taken; head widths other than 32 and 64, a
    strided qkv or dO, and operands off a 16-byte boundary are refused."""
    with pytest.raises(ValueError, match="head widths"):
        fused_attention_qkv(torch.zeros((1, 8, 3 * 16), device=cuda, dtype=dtype), 1)
    with pytest.raises(ValueError, match="head widths"):
        attention_qkv_bwd(torch.zeros((1, 8, 3 * 16), device=cuda, dtype=dtype),
                          torch.zeros((1, 8, 16), device=cuda, dtype=dtype), 1)
    wide = torch.zeros((1, 8, 2 * 3 * 64), device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="contiguous packed qkv"):
        fused_attention_qkv(wide[..., ::2], 1)
    qkv = torch.zeros((1, 8, 3 * 64), device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="contiguous dO"):
        attention_qkv_bwd(qkv, torch.zeros((1, 8, 128), device=cuda, dtype=dtype)[..., ::2], 1)
    flat = torch.zeros(1 + 8 * 3 * 64, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fused_attention_qkv(flat[1:].view(1, 8, 3 * 64), 1)
    long = torch.zeros((1, 1100, 3 * 64), device=cuda, dtype=dtype)  # past the JAX entries' 1024: taken
    assert fused_attention_qkv(long, 1).shape == (1, 1100, 64)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,exact",
    [((4, 512, 512, 3), True), ((4, 384, 384, 3), False), ((4, 320, 448, 3), False)],
)
def test_preprocess_quantize_kernel_matches_plain_on_cuda(cuda, shape, exact):
    """The int8 epilogue: bitwise ``quantize(extraction_preprocess(u8))`` at
    the extraction size; at non-dyadic sizes one uint8 step before the
    normalize is up to ``ONE_STEP·inv_scale`` int8 steps after it."""
    configure_precision("float32")  # the plain version's matmuls in true f32
    inv = float(np.float32(127.0 / 2.64))
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    before = preprocess_quantize_images.launches, preprocess_images.launches
    got = preprocess_images(x, 256, 224, quant_inv_scale=inv)
    assert (preprocess_quantize_images.launches, preprocess_images.launches) == (before[0] + 1, before[1])
    ref = quantize(extraction_preprocess(x, 256, 224, torch.float32), inv)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    if exact:
        assert torch.equal(got, ref)
    else:
        assert (got.int() - ref.int()).abs().max().item() <= int(ONE_STEP * inv) + 1


def _mlp_block(rng, d: int, hidden: int, device) -> SimpleNamespace:
    """Two int8 sites with random kernels and scales that keep the hidden
    values O(1), as calibration would."""

    def site(cin, cout, inv_scale, mult):
        return QuantSite(
            rng.integers(-127, 128, (cin, cout)).astype(np.int8),
            (mult * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            rng.normal(0.0, 0.1, cout).astype(np.float32), np.float32(inv_scale), transposed=True,
        ).to(device)

    return SimpleNamespace(
        mlp_1=site(d, hidden, 127.0 / 4.0, 1.0 / (np.sqrt(d) * 32.0 * 73.0)),
        mlp_2=site(hidden, d, 127.0 / 4.0, 1.0 / (np.sqrt(hidden) * 25.0 * 73.0)),
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,d,hidden,dtype",
    [(300, 192, 768, torch.float32), (300, 192, 768, torch.bfloat16), (4 * 197, 768, 3072, torch.bfloat16),
     (1000, 384, 1536, torch.float32), (33, 768, 3072, torch.float32), (1, 192, 256, torch.bfloat16),
     # chip_smoke.py's ragged shapes, and 1 and 17 rows at each width
     (1001, 384, 1536, torch.float32), *[(m, d, 4 * d, dtype) for m in (1, 17) for d in (192, 384, 768)
                                          for dtype in (torch.bfloat16, torch.float32)]],
)
def test_quantized_mlp_kernel_matches_plain_on_cuda(cuda, rows, d, hidden, dtype):
    """Integer sums are exact and every float operation is the plain
    version's, so the outputs differ only where the two ``exp`` differ by an
    ulp across a ``.5`` tie: at most 1e-3 of the elements off by more than
    1e-5 (absolute and relative), none by more than ``2·127·max(m2)``."""
    rng = np.random.default_rng(rows + d)
    blk = _mlp_block(rng, d, hidden, cuda)
    y = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(cuda, dtype)
    before = quantized_mlp.launches
    got = quantized_mlp(y, blk)
    torch.cuda.synchronize()
    assert quantized_mlp.launches == before + 1
    ref = quantized_mlp_plain(y, blk) if rows > 16 else quantized_mlp_plain(y.cpu(), SimpleNamespace(
        mlp_1=blk.mlp_1.cpu(), mlp_2=blk.mlp_2.cpu())).to(cuda)  # the card's int8 product wants more than 16 rows
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = (got - ref).abs()
    off = err > 1e-5 + 1e-5 * ref.abs()
    assert off.float().mean().item() <= 1e-3, off.sum().item()
    assert err.max().item() <= 2 * 127 * blk.mlp_2.mult.max().item()
    assert ref.abs().mean().item() > 0.1  # the scales give O(1) outputs


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,hidden,dtype", [(300, 192, 768, torch.bfloat16), (1001, 384, 1536, torch.float32),
                                                 (4 * 197, 768, 3072, torch.bfloat16), (17, 768, 3072, torch.float32)])
def test_quantized_mlp_halves_match_their_plain_versions_on_cuda(cuda, rows, d, hidden, dtype):
    """Each launch against its own plain version: the int8 hidden within
    one step where the two ``exp`` part at a ``.5`` tie (at most 1e-3 of the
    values), the output kernel bitwise on the same hidden (exact integer
    sums, then the same two float operations)."""
    rng = np.random.default_rng(rows + hidden)
    blk = _mlp_block(rng, d, hidden, cuda)
    y = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(cuda, dtype)
    assert _check_cuda_operands(y, blk) == hidden
    gq = _launch_hidden(y, blk, hidden)
    out = _launch_output(gq, blk, d)
    torch.cuda.synchronize()
    ref_gq = qmlp_hidden_plain(y, blk)
    diff = (gq.int() - ref_gq.int()).abs()
    assert diff.max().item() <= 1 and diff.count_nonzero().item() <= 1e-3 * gq.numel()
    assert len(torch.unique(ref_gq)) > 100
    assert torch.equal(out, qmlp_output_plain(gq, blk))


@pytest.mark.cuda
def test_quantized_mlp_kernel_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="stream widths"):
        quantized_mlp(torch.zeros((32, 128), device=cuda), _mlp_block(rng, 128, 256, cuda))
    with pytest.raises(ValueError, match="multiples of 256"):
        quantized_mlp(torch.zeros((32, 192), device=cuda), _mlp_block(rng, 192, 384, cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quantized_mlp(torch.zeros((32, 192), device=cuda, dtype=torch.float16), _mlp_block(rng, 192, 768, cuda))
    with pytest.raises(ValueError, match="contiguous"):
        quantized_mlp(torch.zeros((32, 384), device=cuda)[:, ::2], _mlp_block(rng, 192, 768, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,heads,s,dh,dtype",
    [(4, 12, 197, 64, torch.bfloat16), (2, 12, 197, 64, torch.float32), (3, 2, 50, 32, torch.float32),
     (2, 2, 256, 64, torch.bfloat16), (2, 1, 5, 32, torch.bfloat16), (2, 3, 208, 64, torch.bfloat16),
     (1, 2, 256, 64, torch.float32),
     # the float32 kernels' edges: one token, S across the 64-row tiles, Dh 32
     *[(2, 2, s, 64, torch.float32) for s in (1, 63, 64, 65)],
     (1, 3, 256, 32, torch.float32),
     # the bf16 kernels' edges: one token, S across the 64-row tiles, and
     # past the packed pair's 256 up to the JAX entry's 1024, at both head widths
     *[(2, 2, s, dh, torch.bfloat16) for s in (1, 63, 64, 65, 577, 1024) for dh in (32, 64)],
     # the float32 kernels past 256 up to 1024, ragged edges at Dh 32
     *[(2, 2, s, dh, torch.float32) for s in (129, 257, 577, 1024) for dh in (32, 64)]],
)
def test_unpacked_attention_kernels_match_plain_on_cuda(cuda, b, heads, s, dh, dtype):
    """``fused_attention`` on q, k, v [B, H, S, Dh], and its backward through
    autograd, against the plain versions that keep ``p`` and ``ds`` in
    float32: the output within one step of the plain value (2e-5 in
    float32), the gradients within 1e-2 (1e-5) of each tensor's max and, in
    bfloat16, each element within one step too, which only a p and ds kept
    to float32 precision in the kernels' products can hold. The backward
    gives the same bits from run to run (no atomics)."""
    configure_precision("float32")  # the plain version's matmuls in true f32
    rng = np.random.default_rng(b * s * heads)
    q, k, v, d_o = (
        torch.from_numpy(rng.standard_normal((b, heads, s, dh)).astype(np.float32)).to(cuda, dtype) for _ in range(4))
    before = fused_attention.launches, attention_bwd.launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fused_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, d_o)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_output_close(out.detach(), attention_unrounded_plain(q, k, v))
    for got, ref in zip(grads, attention_bwd_plain(q, k, v, d_o)):
        _assert_grad_close(got, ref)
        if dtype == torch.bfloat16:
            _assert_output_close(got, ref)
    again = attention_bwd(q, k, v, d_o)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))  # no atomics: run to run the same


@pytest.mark.cuda
def test_unpacked_attention_bf16_calls_launch_their_kernels_once(cuda):
    """On bfloat16 a forward call runs ``attn_unpacked_fwd_kernel`` once on
    the card and a backward call ``attn_unpacked_bwd_rows_kernel`` and
    ``attn_unpacked_bwd_keys_kernel`` once each, and nothing else of the
    attention kernels; each call counts one."""
    rng = np.random.default_rng(4)
    q, k, v, d_o = (torch.from_numpy(rng.standard_normal((2, 3, 197, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
                    for _ in range(4))
    before = fused_attention.launches, attention_bwd.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused_attention(q, k, v)
        attention_bwd(q, k, v, d_o)
        torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "attn" in e.name]
    for kernel in ("attn_unpacked_fwd_kernel", "attn_unpacked_bwd_rows_kernel", "attn_unpacked_bwd_keys_kernel"):
        assert sum(kernel in n for n in names) == 1, names
    assert len(names) == 3, names


@pytest.mark.cuda
@pytest.mark.parametrize("s,dh,dtype", [(1025, 64, torch.bfloat16), (1025, 32, torch.bfloat16),
                                        (1297, 64, torch.bfloat16), (1297, 32, torch.bfloat16),
                                        (1025, 64, torch.float32), (1297, 32, torch.float32)])
def test_unpacked_attention_past_1024_matches_rounded_plain_on_cuda(cuda, s, dh, dtype):
    """Past the JAX entry's 1024 tokens ``fused_attention`` computes what
    the JAX entry computes there, ``attention_xla``, which rounds ``p``: in
    bfloat16 the packed pair's kernels run on q, k, v (``attn_qkv_*`` on the
    profiler), held to ``attention_plain`` and ``attention_rounded_bwd_plain``
    at the packed pair's gates; in float32 the same kernels as below 1024."""
    configure_precision("float32")  # the plain version's matmuls in true f32
    rng = np.random.default_rng(s * dh)
    q, k, v, d_o = (
        torch.from_numpy(rng.standard_normal((1, 2, s, dh)).astype(np.float32)).to(cuda, dtype) for _ in range(4))
    before = fused_attention.launches, attention_bwd.launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fused_attention(*leaves)
        grads = torch.autograd.grad(out, leaves, d_o)
        torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "attn" in e.name]
    prefix = "attn_qkv_" if dtype == torch.bfloat16 else "attn_f32_"
    assert len(names) == 3 and all(prefix in n for n in names), names
    _assert_output_close(out.detach(), attention_plain(q, k, v))
    for got, ref in zip(grads, attention_rounded_bwd_plain(q, k, v, d_o)):
        _assert_grad_close(got, ref)


@pytest.mark.cuda
def test_attention_f32_backward_launches_its_two_kernels_once(cuda):
    """On float32 a backward call of either entry, given the forward's
    residuals, runs ``attn_f32_bwd_rows_kernel`` and
    ``attn_f32_bwd_keys_kernel`` once each and nothing else of the attention
    kernels, and counts one; the residuals' forward counts one forward
    launch. The same call without residuals runs the forward first and gives
    the same bits."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 197, 3 * 128)).astype(np.float32)).to(cuda)
    d_o_packed = torch.from_numpy(rng.standard_normal((2, 197, 128)).astype(np.float32)).to(cuda)
    q, k, v, d_o = (torch.from_numpy(rng.standard_normal((2, 3, 197, 64)).astype(np.float32)).to(cuda)
                    for _ in range(4))
    before = fused_attention_qkv.launches, fused_attention.launches
    packed_res, res = attention_qkv_residuals(qkv, 2), attention_residuals(q, k, v)
    assert (fused_attention_qkv.launches, fused_attention.launches) == (before[0] + 1, before[1] + 1)
    assert packed_res[1].shape == (2 * 2 * 2 * 208,) and res[1].shape == (2 * 3 * 2 * 208,)
    torch.cuda.synchronize()
    before = attention_qkv_bwd.launches, attention_bwd.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        dqkv = attention_qkv_bwd(qkv, d_o_packed, 2, residuals=packed_res)
        grads = attention_bwd(q, k, v, d_o, residuals=res)
        torch.cuda.synchronize()
    assert (attention_qkv_bwd.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "attn" in e.name]
    assert sum("attn_f32_bwd_rows_kernel" in n for n in names) == 2, names
    assert sum("attn_f32_bwd_keys_kernel" in n for n in names) == 2, names
    assert len(names) == 4, names
    assert torch.equal(attention_qkv_bwd(qkv, d_o_packed, 2), dqkv)
    assert all(torch.equal(a, b) for a, b in zip(attention_bwd(q, k, v, d_o), grads))


@pytest.mark.cuda
def test_unpacked_attention_kernel_refuses_what_it_does_not_take(cuda):
    """Head widths other than 32 and 64, strided and misaligned operands;
    every sequence length is taken."""
    for dtype in (torch.bfloat16, torch.float32):
        long = torch.zeros((1, 1, 1100, 64), device=cuda, dtype=dtype)
        assert fused_attention(long, long, long).shape == long.shape
        assert attention_bwd(long, long, long, long)[0].shape == long.shape
    narrow = torch.zeros((1, 1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        fused_attention(narrow, narrow, narrow)
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(q, q, q.transpose(1, 2).contiguous().transpose(1, 2))
    flat = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(1, 2, 8, 64)  # contiguous, 2 bytes past a 16-byte boundary
    aligned = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fused_attention(aligned, shifted, aligned)
    with pytest.raises(ValueError, match="16-byte"):
        attention_bwd(aligned, aligned, aligned, shifted)


def _analysis_blobs(n=400, d=16, centers=5, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 10.0, (centers, d))
    y = rng.integers(0, centers, n)
    return (c[y] + rng.normal(0.0, 1.0, (n, d))).astype(np.float32), y


@pytest.mark.cuda
def test_analysis_on_the_card_matches_the_cpu_with_tf32_requested(cuda):
    """The analysis stack on the card against the same code on the CPU, with
    TF32 switched on by the caller: the entry points pin float32 products
    (k-means labels, DBSCAN labels and the kNN edges would move in TF32) and
    put the caller's setting back."""
    from ssip_tpu_torch.analysis import cluster_metrics, dbscan, kmeans, pca, standardize, tsne, umap
    from ssip_tpu_torch.runtime.device import float32_products

    x, y = _analysis_blobs()
    cpu = torch.device("cpu")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, want = kmeans.kmeans(x, 5, device=cuda), kmeans.kmeans(x, 5, device=cpu)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.n_iter == want.n_iter and got.inertia == pytest.approx(want.inertia, rel=1e-5)
        for eps, ms in ((4.5, 5), (6.0, 10)):
            np.testing.assert_array_equal(dbscan.dbscan(x, eps, ms, device=cuda).labels,
                                          dbscan.dbscan(x, eps, ms, device=cpu).labels)
        np.testing.assert_allclose(dbscan.k_distance_curve(x, 5, True, device=cuda),
                                   dbscan.k_distance_curve(x, 5, True, device=cpu), rtol=1e-5, atol=2e-2)
        assert cluster_metrics.silhouette_score(x, y, device=cuda) == pytest.approx(
            cluster_metrics.silhouette_score(x, y, device=cpu), rel=1e-5)
        ma, mb = pca.fit_pca(x, device=cuda), pca.fit_pca(x, device=cpu)
        np.testing.assert_allclose(ma.components[:5], mb.components[:5], atol=1e-3)
        sa, sb = standardize.fit_scaler(x, device=cuda), standardize.fit_scaler(x, device=cpu)
        np.testing.assert_allclose(sa["scale"], sb["scale"], rtol=1e-5)
        xt = torch.as_tensor(x)
        with float32_products():  # the pieces below are called past the entry points that pin it
            pa, pb = tsne._joint_p(xt.to(cuda), 30.0).cpu().numpy(), tsne._joint_p(xt, 30.0).numpy()
            ga, gb = umap._fuzzy_graph(xt.to(cuda), 15).cpu().numpy(), umap._fuzzy_graph(xt, 15).numpy()
        # P = exp(−β·d²) normalized: a d² rounded 1e-6 apart moves P by β·d² (tens) times that
        np.testing.assert_allclose(pa, pb, rtol=1e-3, atol=1e-9)
        np.testing.assert_array_equal(ga > 0, gb > 0)
        np.testing.assert_allclose(ga, gb, atol=1e-3)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_analysis_blocked_paths_on_the_card(cuda):
    """The corpus-scale paths, called directly below the limit on the card,
    against the dense ones."""
    from ssip_tpu_torch.analysis import cluster_metrics, dbscan

    x = np.random.default_rng(3).integers(-4, 5, (3000, 8)).astype(np.float32)  # exact distances
    xt = torch.as_tensor(x, device=cuda)
    eps = float(np.sqrt(30.5))
    for a, b in zip(dbscan._neighbor_lists_dense(xt, eps), dbscan._neighbor_lists_blocked(xt, eps)):
        np.testing.assert_array_equal(a, b)
    torch.testing.assert_close(dbscan._kth_distance_blocked(xt, 5, True),
                               dbscan._kth_smallest(dbscan.pairwise_d2(xt, xt, (xt * xt).sum(1), (xt * xt).sum(1)), 5))
    one_hot = torch.eye(3, device=cuda)[torch.as_tensor(np.arange(3000) % 3, device=cuda)]
    torch.testing.assert_close(cluster_metrics._silhouette_sums_blocked(xt, one_hot),
                               cluster_metrics._silhouette_sums_dense(xt, one_hot), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_identity_resample_at_the_crop_size_on_cuda(cuda, dtype):
    """The host-preproc path's preprocess: 224² → 224, a resample at scale
    1, bit for bit its plain version."""
    configure_precision("float32")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)).to(cuda)
    got = preprocess_images(x, 224, 224, dtype)
    ref = extraction_preprocess(x, 224, 224, torch.float32).to(dtype)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,routing", [("vit_moe_t16", {}), ("vit_moe_s16", {}),
                                          ("vit_moe_t16", {"router_top_k": 2}),
                                          ("vit_moe_t16", {"routing": "expert_choice"})])
def test_moe_forward_and_step_on_cuda_match_cpu(cuda, arch, routing):
    """A 2-layer MoE tower at the arch's width: the eval forward within 1e-4
    of the CPU's, one float32 train step's loss (with the aux term) within
    1e-5, the aux term within 1e-5, every gradient (the router's included)
    within 1e-3 of its tensor's max; the LayerNorm and attention kernels
    launched."""
    import copy

    from ssip_tpu_torch.models.moe import MOE_CONFIGS, MoEVisionTransformer
    from ssip_tpu_torch.ops.augment import eval_preprocess
    from ssip_tpu_torch.train.engine import TrainState, train_step

    configure_precision("float32")
    torch.manual_seed(0)
    cpu_model = MoEVisionTransformer(**{**MOE_CONFIGS[arch], "num_layers": 2}, num_classes=2, image_size=64, **routing)
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, 4).astype(np.int64))
    valid = torch.tensor([True, True, True, False])
    with torch.inference_mode():
        want = cpu_model.eval()(eval_preprocess(images, torch.float32))
        before = layer_norm.launches, fused_attention_qkv.launches
        got = gpu_model.eval()(eval_preprocess(images.to(cuda), torch.float32)).cpu()
        assert (layer_norm.launches - before[0], fused_attention_qkv.launches - before[1]) == (5, 2)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4
    results = []
    for model, dev in ((cpu_model, torch.device("cpu")), (gpu_model, cuda)):
        state = TrainState.create(model, 1e-4, 1e-4)
        loss, _ = train_step(state, images.to(dev), labels.to(dev), valid.to(dev), None)
        aux = sum((t.detach() for t in model.aux_losses()), torch.zeros((), device=dev))  # expert choice: none
        results.append((loss.cpu(), aux.cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (l_c, a_c, g_c), (l_g, a_g, g_g) = results
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c) and abs(a_g - a_c) <= 1e-5 * abs(a_c) + 1e-9
    assert any(".moe.router." in k for k in g_c)
    for name, g in g_c.items():
        assert ((g_g[name] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item() <= 1e-3, name
