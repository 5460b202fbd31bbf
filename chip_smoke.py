#!/usr/bin/env python3
"""Drive the PyTorch port's extraction and training slices once on one NVIDIA GPU,
for the ResNet family and the ViT family.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, a few output lines each; any failure raises and the script exits
non-zero without printing the final line:

1. env     the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build   nvcc builds ``ssip_tpu_torch/csrc/*.cu`` for sm_90a, one process
           per source (seconds);
3. kernels, each against its plain PyTorch version on the card, with median
   times (CUDA events) of the kernel, the plain version and, where one
   PyTorch call computes the same function, that call, beside the bound (the
   least time the card could take: bytes over 3.35 TB/s or operations over
   the data-sheet peak of their type, whichever is larger):
   kernel  ``preprocess_images``: bitwise in float32 and bfloat16 at
           [128, 512, 512, 3] → 256 → 224, one uint8 step at 384² and 320×448;
   rotate  ``augment_images`` (flip → rotate → normalize): bitwise in
           float32 and bfloat16 at [128, 224, 224, 3], [16, 224, 160, 3] and
           [8, 64, 96, 3], drawn angles in ±10° and pinned ±10°, ±25°;
   ln      ``layer_norm`` and ``layer_norm_bwd`` at [25216, 768] and
           [26624, 768] (128 images of 197 and of 208 tokens) in bfloat16 and
           float32, [128, 768] float32 (the final LayerNorm) and
           [1001, 384] (a row count that is no multiple of the block);
   attn    ``fused_attention_qkv`` and ``attention_qkv_bwd`` at
           [128, 197, 2304] and at [128, 208, 2304] with ``kv_len`` 197, in
           bfloat16 and float32, and at the 3 heads of vit_t16; pad-query
           rows are compared too and get a non-zero dO.
   Tolerances of ln and attn (kernel and plain version sum in another
   order): float32 outputs within 2e-5 of O(1) values, bfloat16 outputs
   within one bfloat16 step of the plain value (2e-5 where a step is
   smaller), gradients within 1e-5 (float32) or 1e-2 (bfloat16) of each
   tensor's largest entry;
4. slice   a seeded 1024-image uint8 512² corpus in an in-memory
           ``ImageStore`` through ``run_extraction`` on cuda (resident shape,
           batch 128, seeded init) in bfloat16 and float32, each run twice
           (the second one timed), for resnet18 (512-D) and for vit_b16
           (768-D): embeddings finite, the kernels launched (25 LayerNorm
           and 12 attention launches per vit_b16 forward), every artifact
           written, bf16 vs f32 cosine > 0.995 per image, cuda f32 vs CPU
           f32 ≤ 1e-4 relative on a subset (TF32 off); for resnet18 also the
           per-batch shape (pinned, double-buffered feed) on 263 images with
           one decode failure; for vit_b16 a ``torch.profiler`` split of the
           bfloat16 run by kernel name with the idle share of the embed loop;
5. cli     the extraction CLI on a small 512² JPEG tree (needs Pillow), with
           resnet18 and with vit_t16;
6. train   a seeded 100-image 512² JPEG tree ``avec_labels/{cancer,normal}``
           (50 + 50) through ``run_supervised`` on cuda at 224², 2 classes,
           batch 16, target recall 0.9: resnet18 for 2 epochs in float32
           (TF32 off) and bfloat16, vit_b16 for 2 epochs in bfloat16 and 1 in
           float32. Every artifact is written, the history holds finite
           losses, the ``.pt`` loads into the port's model, the split indices
           are those of the CPU split, and the kernels launched (for vit_b16
           25 + 25 LayerNorm and 12 + 12 attention launches per train step);
           then the training CLI for 1 epoch as a subprocess (resnet18,
           vit_t16);
7. step    one train step on cuda against the same step on the CPU
           (float32, TF32 off, batch 8 with one padded row, 224², same
           weights, batch and draws). resnet18: loss ≤ 1e-5 relative and BN
           running statistics ≤ 1e-5 relative at the seeded weights; every
           gradient ≤ 1e-3 relative to its tensor's max |g| (the stem conv's
           ≤ 1e-2 in L2) at kink-free weights, see ``KINK_FREE_BN_BIAS``.
           vit_b16: loss ≤ 1e-5 relative and every gradient ≤ 1e-3 of its
           tensor's max at the seeded weights themselves (no ReLU, no
           max-pool), and a step with ``remat`` equal to the plain one with
           one more forward launch of each kernel per block. Then for each
           arch the steady-state step at batch 128 in bfloat16 and float32
           (3 warm-up steps, 10 timed with CUDA events): imgs/s, ms per
           step, peak device memory, launches per step; then 10 more steps
           under ``torch.profiler``: device time by layer, the top kernels
           and the idle share;
8. imports no jax module and no module of the JAX package;
9. the kernels JSON line (all six kernels), then ``{"ok": true, "device": {...}}`` last.

Needs no network and no data: everything is made from seeds. It builds the
kernels from the checkout, so a fresh clone is enough. It imports only
``ssip_tpu_torch``, torch and numpy, and fails if the run loaded jax, flax,
optax or any module of the JAX package (``ssip_tpu``).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
N_IMAGES = 1024
SIZE = 512
BATCH = 128
RESIZE, CROP = 256, 224
N_CPU_CHECK = 16
TIMED_LAUNCHES = 20
KERNELS = {
    "preprocess_images": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/preproc.cu",
        "replaces": "ssip_tpu/ops/pallas_preproc.py:41",
    },
    "augment_images": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/augment.cu",
        "replaces": "ssip_tpu/ops/augment.py:303",
    },
    "layer_norm": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/layernorm.cu",
        "replaces": "ssip_tpu/ops/layernorm.py:55",
    },
    "layer_norm_bwd": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/layernorm.cu",
        "replaces": "ssip_tpu/ops/layernorm.py:65",
    },
    "attention_qkv": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/attention.cu",
        "replaces": "ssip_tpu/ops/attention.py:220",
    },
    "attention_qkv_bwd": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/attention.cu",
        "replaces": "ssip_tpu/ops/attention.py:256",
    },
}
# Data-sheet peaks of one H100 SXM, for the bounds: device memory rate, and
# dense operation rates by operand type (float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
VIT_ARCH, VIT_WIDTH, VIT_TOKENS, VIT_HEADS = "vit_b16", 768, 197, 12
VIT_LN_PER_FORWARD, VIT_ATTN_PER_FORWARD, VIT_BLOCKS = 25, 12, 12
VIT_N_CPU_CHECK = 8
# (rows, width, type): 128 images of 197 tokens and of 208 (the token axis
# padded to 16), the final LayerNorm, and a ragged row count
LN_SHAPES = (
    (128 * 197, 768, "bfloat16"), (128 * 197, 768, "float32"),
    (128 * 208, 768, "bfloat16"), (128 * 208, 768, "float32"),
    (128, 768, "float32"), (1001, 384, "bfloat16"),
)
# (batch, tokens, heads, kv_len, type), heads of 64
ATTN_SHAPES = (
    (128, 197, 12, 0, "bfloat16"), (128, 197, 12, 0, "float32"),
    (128, 208, 12, 197, "bfloat16"), (128, 208, 12, 197, "float32"),
    (128, 197, 3, 0, "bfloat16"),
)
F32_ATOL = 2e-5
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
AUG_SHAPES = ((128, 224, 224, 3), (16, 224, 160, 3), (8, 64, 96, 3))
PINNED_DEGREES = (10.0, -10.0, 25.0, -25.0)
TRAIN_PER_CLASS = 50  # the real labeled layout: avec_labels/{cancer,normal}, 50 + 50
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_SIZE = 16, 2, 224
STEP_CHECK_BATCH, STEP_TIMED_BATCH, STEP_WARMUP, STEP_TIMED = 8, 128, 3, 10
# The cuda-vs-CPU gradient check runs at kink-free weights: the seeded ones
# with every conv filter re-centred to zero mean and every BN bias raised by
# this much. At the seeded init (BN bias 0) half of all ReLU inputs sit at
# the kink, and a 1e-6 relative weight perturbation on the CPU alone moves
# single gradient entries by up to 15 % of their tensor's max: a few ReLU
# masks flip. Raised biases keep ReLU inputs 4 standard deviations off the
# kink; centred filters keep the next conv's outputs near zero mean, so
# E[x²] − E[x]² does not cancel. The stem conv's gradient still passes
# through the stem max-pool's argmax, where a near-tie in one of the 1.6 M
# windows reroutes one element (0.8–1.4 % of max |g| under the same
# perturbation), so it is held in L2. Loss, argmax and BN statistics are
# checked at the seeded weights themselves.
KINK_FREE_BN_BIAS = 4.0
STEM_GRAD = "conv1.weight"


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def median_ms(torch, fn, warmup: int = 3, iters: int = TIMED_LAUNCHES) -> float:
    """Median of per-launch CUDA-event times, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def timed_pair(torch, kernel, plain) -> tuple:
    """(kernel ms, plain ms): plain, kernel, kernel, plain, so drift on the
    card hits both alike; the smaller median of each."""
    times = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
        times[name].append(median_ms(torch, fn))
    return min(times["kernel"]), min(times["plain"])


def bound_ms(nbytes: float, ops: float, ops_dtype: str) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the peak rate of their type, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[ops_dtype]
    return {"bound_ms": max(by_bytes, by_ops) * 1e3, "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


class LaunchCounts:
    """The six wrappers' launch counters: set to 0 just before a path is
    driven, read just after, summed over the paths for the kernels line."""

    def __init__(self):
        from ssip_tpu_torch.ops.attention import attention_qkv_bwd, fused_attention_qkv
        from ssip_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd
        from ssip_tpu_torch.ops.preproc import preprocess_images
        from ssip_tpu_torch.ops.rotate import augment_images

        self.wrappers = {
            "preprocess_images": preprocess_images, "augment_images": augment_images,
            "layer_norm": layer_norm, "layer_norm_bwd": layer_norm_bwd,
            "attention_qkv": fused_attention_qkv, "attention_qkv_bwd": attention_qkv_bwd,
        }
        self.total = dict.fromkeys(self.wrappers, 0)

    def reset(self) -> None:
        for wrapper in self.wrappers.values():
            wrapper.launches = 0

    def read(self) -> dict:
        counts = {name: wrapper.launches for name, wrapper in self.wrappers.items()}
        for name, n in counts.items():
            self.total[name] += n
        return counts


def output_error(torch, got, ref, what: str) -> float:
    """max |got − ref|; raises outside 2e-5 (float32) or one bfloat16 step
    of the plain value (2e-5 where a step is smaller)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs {ref.dtype} {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs()
    tol = torch.full_like(err, F32_ATOL)
    if ref.dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
        tol = torch.maximum(tol, step)
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max |d| {err.max().item()}, {(err > tol).sum().item()} values out of tolerance")
    return err.max().item()


def grad_error(got, ref, dtype: str, what: str) -> float:
    """max |got − ref| over max |ref|; raises above 1e-5 (float32) or 1e-2
    (bfloat16)."""
    rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)).item()
    if got.shape != ref.shape or not rel <= GRAD_RTOL[dtype]:
        raise AssertionError(f"{what}: {rel} of the tensor's max, allowed {GRAD_RTOL[dtype]}")
    return rel


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from ssip_tpu_torch.kernels.build import build, load_library

    result = build()
    for line in result.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    load_library()
    say("build", seconds=f"{result.seconds:.2f}", reused=result.seconds == 0.0, library=result.path.name)


def phase_kernel(torch, np) -> dict:
    from ssip_tpu_torch.ops.preproc import preprocess_images, tap_table
    from ssip_tpu_torch.ops.resize import IMAGENET_STD, crop_weights, extraction_preprocess
    from ssip_tpu_torch.runtime.device import configure_precision

    configure_precision("float32")  # the plain version's matmuls in true f32
    one_step = 1.0 / (255.0 * min(IMAGENET_STD)) + 1e-6
    rng = np.random.default_rng(SEED)
    result = {}
    for shape, exact in (
        ((BATCH, SIZE, SIZE, 3), True),
        ((32, 384, 384, 3), False),
        ((32, 320, 448, 3), False),
    ):
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        k32 = preprocess_images(x, RESIZE, CROP, torch.float32)
        k16 = preprocess_images(x, RESIZE, CROP, torch.bfloat16)
        p32 = extraction_preprocess(x, RESIZE, CROP, torch.float32)
        torch.cuda.synchronize()
        err32 = (k32 - p32).abs().max().item()
        err16 = (k16.float() - p32.to(torch.bfloat16).float()).abs().max().item()
        if exact:
            if not torch.equal(k32, p32):
                raise AssertionError(f"f32 kernel not bitwise equal to plain at {shape}: max |d| {err32}")
            if not torch.equal(k16, p32.to(torch.bfloat16)):
                raise AssertionError(f"bf16 kernel not bitwise equal to plain f32 cast RNE at {shape}: {err16}")
        elif err32 > one_step:
            raise AssertionError(f"kernel off by {err32} > {one_step} at {shape}")

        def kernel(dtype):
            return lambda: preprocess_images(x, RESIZE, CROP, dtype)

        def plain(dtype):
            return lambda: extraction_preprocess(x, RESIZE, CROP, dtype)

        k_ms, p_ms = timed_pair(torch, kernel(torch.bfloat16), plain(torch.bfloat16))
        k32_ms = median_ms(torch, kernel(torch.float32))
        p32_ms = median_ms(torch, plain(torch.float32))
        # the separable resample needs 2 operations a tap and channel: the
        # horizontal taps on every source row the crop reads, then the
        # vertical taps on every output pixel
        (v_start, v_count, _), (_, h_count, _) = (tap_table(w) for w in crop_weights(shape[1], shape[2], RESIZE, CROP))
        rows_read = len(set().union(*(range(a, a + n) for a, n in zip(v_start, v_count))))
        ops = 2 * 3 * shape[0] * (rows_read * int(h_count.sum()) + CROP * int(v_count.sum()))
        bound = bound_ms(x.numel() + k16.numel() * 2, ops, "float32")
        tol = "bitwise" if exact else f"<= {one_step:.6g}"
        say("kernel", shape="x".join(map(str, shape)), tol=tol, max_abs_err_f32=err32,
            max_abs_err_bf16=err16, bf16_ms=f"{k_ms:.4f}", plain_bf16_ms=f"{p_ms:.4f}",
            f32_ms=f"{k32_ms:.4f}", plain_f32_ms=f"{p32_ms:.4f}", bound_bf16_ms=f"{bound['bound_ms']:.4f}",
            bound_by=bound["bound_by"], library="none")
        if exact:
            result = {"max_abs_err": max(err32, err16), "ms": k_ms, "plain_ms": p_ms, **bound, "library_ms": None}
        del x, k32, k16, p32
    torch.cuda.empty_cache()
    return result


def phase_rotate_kernel(torch, np) -> dict:
    """The augment kernel against the plain ``train_augment`` on the card."""
    from ssip_tpu_torch.ops.augment import augment_coeffs, train_augment
    from ssip_tpu_torch.ops.rotate import augment_images
    from ssip_tpu_torch.runtime.prng import augment_draws

    rng = np.random.default_rng(SEED + 3)
    result = {}
    for shape in AUG_SHAPES:
        b = shape[0]
        flip, angles = augment_draws(SEED, "smoke", 0, 0, b, 10.0)
        pinned = np.asarray(PINNED_DEGREES, np.float32) * np.float32(np.pi / 180.0)
        angles[: len(pinned)] = pinned[:b]
        coeffs = torch.from_numpy(augment_coeffs(flip, angles)).cuda()
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        k32 = augment_images(x, coeffs, torch.float32)
        k16 = augment_images(x, coeffs, torch.bfloat16)
        p32 = train_augment(x, coeffs, torch.float32)
        torch.cuda.synchronize()
        err32 = (k32 - p32).abs().max().item()
        err16 = (k16.float() - p32.to(torch.bfloat16).float()).abs().max().item()
        if not torch.equal(k32, p32):
            raise AssertionError(f"augment kernel f32 not bitwise equal to plain at {shape}: max |d| {err32}")
        if not torch.equal(k16, p32.to(torch.bfloat16)):
            raise AssertionError(f"augment kernel bf16 not bitwise equal to plain f32 cast RNE at {shape}: {err16}")

        def kernel(dtype):
            return lambda: augment_images(x, coeffs, dtype)

        def plain(dtype):
            return lambda: train_augment(x, coeffs, dtype)

        k_ms, p_ms = timed_pair(torch, kernel(torch.bfloat16), plain(torch.bfloat16))
        k32_ms = median_ms(torch, kernel(torch.float32))
        p32_ms = median_ms(torch, plain(torch.float32))
        # per output value: one subtraction and one multiplication (the
        # index map is integer work)
        bound = bound_ms(x.numel() + coeffs.numel() * 4 + k16.numel() * 2, 2 * k16.numel(), "float32")
        say("rotate", shape="x".join(map(str, shape)), tol="bitwise", flips=int(flip.sum()),
            max_abs_err_f32=err32, max_abs_err_bf16=err16, bf16_ms=f"{k_ms:.4f}",
            plain_bf16_ms=f"{p_ms:.4f}", f32_ms=f"{k32_ms:.4f}", plain_f32_ms=f"{p32_ms:.4f}",
            bound_bf16_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"], library="none")
        if shape == AUG_SHAPES[0]:
            result = {"max_abs_err": max(err32, err16), "ms": k_ms, "plain_ms": p_ms, **bound, "library_ms": None}
        del x, k32, k16, p32
    torch.cuda.empty_cache()
    return result


def phase_layer_norm_kernels(torch, np) -> dict:
    """``layer_norm`` and ``layer_norm_bwd`` against their plain versions
    on the card; times at the main path's shape, [25216, 768] bfloat16."""
    import torch.nn.functional as F

    from ssip_tpu_torch.ops.layernorm import (
        LN_EPS, layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain,
    )

    rng = np.random.default_rng(SEED + 6)
    result = {}
    for n, d, dtype_name in LN_SHAPES:
        dtype = getattr(torch, dtype_name)
        x = torch.from_numpy(rng.normal(0.3, 1.5, (n, d)).astype(np.float32)).cuda().to(dtype)
        dy = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda().to(dtype)
        scale = torch.from_numpy(rng.normal(1.0, 0.2, d).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(0.0, 0.2, d).astype(np.float32)).cuda()
        y = layer_norm(x, scale, bias, LN_EPS)
        dx, dscale, dbias = layer_norm_bwd(x, scale, dy, LN_EPS)
        torch.cuda.synchronize()
        tag = f"layer_norm {n}x{d} {dtype_name}"
        err_y = output_error(torch, y, layer_norm_plain(x, scale, bias, LN_EPS), tag)
        ref_dx, ref_dscale, ref_dbias = layer_norm_bwd_plain(x, scale, dy, LN_EPS)
        rel_dx = grad_error(dx, ref_dx, dtype_name, tag + " dx")
        rel_ds = grad_error(dscale, ref_dscale, "float32", tag + " dscale")
        rel_db = grad_error(dbias, ref_dbias, "float32", tag + " dbias")
        again = layer_norm_bwd(x, scale, dy, LN_EPS)
        if not all(torch.equal(a, b) for a, b in zip(again, (dx, dscale, dbias))):
            raise AssertionError(f"{tag}: the backward kernel's result changed from run to run")

        fwd_ms, fwd_plain_ms = timed_pair(
            torch, lambda: layer_norm(x, scale, bias, LN_EPS), lambda: layer_norm_plain(x, scale, bias, LN_EPS))
        bwd_ms, bwd_plain_ms = timed_pair(
            torch, lambda: layer_norm_bwd(x, scale, dy, LN_EPS), lambda: layer_norm_bwd_plain(x, scale, dy, LN_EPS))
        # the library's yardstick, timed here and called nowhere in the port
        xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, scale.to(dtype), bias.to(dtype)))
        lib_fwd_ms = median_ms(torch, lambda: F.layer_norm(xr.detach(), (d,), wr.detach(), br.detach(), LN_EPS))
        y_lib = F.layer_norm(xr, (d,), wr, br, LN_EPS)
        lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(y_lib, (xr, wr, br), dy, retain_graph=True))
        item = x.element_size()
        fwd_bound = bound_ms(2 * n * d * item + 2 * d * 4, 8 * n * d, "float32")
        bwd_bound = bound_ms(3 * n * d * item + 3 * d * 4, 20 * n * d, "float32")
        say("ln", shape=f"{n}x{d}", dtype=dtype_name, max_abs_err=err_y, dx_rel=rel_dx, dscale_rel=rel_ds,
            dbias_rel=rel_db, fwd_ms=f"{fwd_ms:.4f}", fwd_plain_ms=f"{fwd_plain_ms:.4f}",
            fwd_library_ms=f"{lib_fwd_ms:.4f}", fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}",
            bwd_ms=f"{bwd_ms:.4f}", bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_library_ms=f"{lib_bwd_ms:.4f}",
            bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", bound_by=fwd_bound["bound_by"])
        if (n, d, dtype_name) == LN_SHAPES[0]:
            result = {
                "layer_norm": {"max_abs_err": err_y, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
                               **fwd_bound, "library_ms": lib_fwd_ms},
                "layer_norm_bwd": {"max_abs_err": (dx.float() - ref_dx.float()).abs().max().item(), "ms": bwd_ms,
                                   "plain_ms": bwd_plain_ms, **bwd_bound, "library_ms": lib_bwd_ms},
            }
        del x, dy, y, dx, ref_dx, xr, y_lib
    torch.cuda.empty_cache()
    return result


def phase_attention_kernels(torch, np) -> dict:
    """``fused_attention_qkv`` and ``attention_qkv_bwd`` against their plain
    versions on the card; times at the main path's shape, [128, 197, 2304]
    bfloat16 with 12 heads."""
    import torch.nn.functional as F

    from ssip_tpu_torch.ops.attention import (
        attention_qkv_bwd, attention_qkv_bwd_plain, attention_qkv_plain, fused_attention_qkv,
    )
    from ssip_tpu_torch.runtime.device import configure_precision

    configure_precision("float32")  # the plain version's matmuls in true f32
    rng = np.random.default_rng(SEED + 7)
    dh = 64
    result = {}
    for b, s, heads, kv_len, dtype_name in ATTN_SHAPES:
        dtype = getattr(torch, dtype_name)
        d = heads * dh
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * d)).astype(np.float32)).cuda().to(dtype)
        d_o = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).cuda().to(dtype)
        out = fused_attention_qkv(qkv, heads, kv_len)
        dqkv = attention_qkv_bwd(qkv, d_o, heads, kv_len)
        torch.cuda.synchronize()
        tag = f"attention {b}x{s}x{3 * d} heads {heads} kv_len {kv_len} {dtype_name}"
        err_o = output_error(torch, out, attention_qkv_plain(qkv, heads, kv_len), tag)
        ref = attention_qkv_bwd_plain(qkv, d_o, heads, kv_len)
        rels = [grad_error(dqkv[..., i * d:(i + 1) * d], ref[..., i * d:(i + 1) * d], dtype_name, f"{tag} d{part}")
                for i, part in enumerate("qkv")]
        if 0 < kv_len < s and dqkv[:, kv_len:, d:].any():
            raise AssertionError(f"{tag}: masked keys got non-zero gradients")
        err_dqkv = (dqkv.float() - ref.float()).abs().max().item()
        del ref

        fwd_ms, fwd_plain_ms = timed_pair(
            torch, lambda: fused_attention_qkv(qkv, heads, kv_len), lambda: attention_qkv_plain(qkv, heads, kv_len))
        bwd_ms, bwd_plain_ms = timed_pair(
            torch, lambda: attention_qkv_bwd(qkv, d_o, heads, kv_len),
            lambda: attention_qkv_bwd_plain(qkv, d_o, heads, kv_len))
        # the library's yardstick on unpacked views, timed here and called
        # nowhere in the port
        kv = kv_len or s
        leaf = qkv.detach().clone().requires_grad_()
        q, k, v = (leaf.view(b, s, 3, heads, dh)[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        k, v = k[:, :, :kv], v[:, :, :kv]
        lib_fwd_ms = median_ms(
            torch, lambda: F.scaled_dot_product_attention(q.detach(), k.detach(), v.detach()))
        o_lib = F.scaled_dot_product_attention(q, k, v)
        do_view = d_o.view(b, s, heads, dh).permute(0, 2, 1, 3)
        lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(o_lib, leaf, do_view, retain_graph=True))
        item = qkv.element_size()
        fwd_bound = bound_ms((qkv.numel() + out.numel()) * item, 4 * b * heads * s * kv * dh, dtype_name)
        bwd_bound = bound_ms((2 * qkv.numel() + d_o.numel()) * item, 10 * b * heads * s * kv * dh, dtype_name)
        say("attn", shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len, dtype=dtype_name, max_abs_err=err_o,
            dq_rel=rels[0], dk_rel=rels[1], dv_rel=rels[2], fwd_ms=f"{fwd_ms:.4f}",
            fwd_plain_ms=f"{fwd_plain_ms:.4f}", fwd_library_ms=f"{lib_fwd_ms:.4f}",
            fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_library_ms=f"{lib_bwd_ms:.4f}",
            bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", bound_by=fwd_bound["bound_by"])
        if (b, s, heads, kv_len, dtype_name) == ATTN_SHAPES[0]:
            result = {
                "attention_qkv": {"max_abs_err": err_o, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
                                  **fwd_bound, "library_ms": lib_fwd_ms},
                "attention_qkv_bwd": {"max_abs_err": err_dqkv, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                                      **bwd_bound, "library_ms": lib_bwd_ms},
            }
        del qkv, d_o, out, dqkv, leaf, o_lib
        torch.cuda.empty_cache()
    return result


def _synthetic_tree(root: Path, n: int) -> None:
    """``n`` placeholder files in the dataset layout (32 + 32 labeled, the
    rest unlabeled); the pixels live in the in-memory store."""
    for i in range(n):
        if i < 64:
            d = root / "avec_labels" / ("cancer" if i < 32 else "normal")
        else:
            d = root / "sans_label"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"img_{i:04d}.u8").touch()


def make_corpus(np, tmp: Path):
    """(data dir, records, images, store): the seeded in-memory corpus that
    both extraction paths embed."""
    from ssip_tpu_torch.data.discovery import discover_image_records
    from ssip_tpu_torch.data.pipeline import ImageStore

    data = tmp / "corpus"
    _synthetic_tree(data, N_IMAGES)
    records = discover_image_records(data)
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (N_IMAGES, SIZE, SIZE, 3), dtype=np.uint8
    )
    return data, records, images, ImageStore.from_array(images, [r.absolute_path for r in records])


def _unit(np, a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def phase_slice(torch, np, tmp: Path, corpus, counts: LaunchCounts, arch: str, width: int, n_cpu: int) -> None:
    """``run_extraction`` of ``arch`` on the corpus, resident shape, bfloat16
    and float32; for the ViT a profile of the bfloat16 run, for the ResNet
    the per-batch shape too."""
    from torch.profiler import ProfilerActivity, profile

    from ssip_tpu_torch.data.pipeline import ImageStore
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.ops.preproc import preprocess_images
    from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, extract_embeddings, run_extraction
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry

    data, records, images, store = corpus
    vit = arch == VIT_ARCH
    batches = N_IMAGES // BATCH
    counts.reset()  # count only the main path's launches
    embeddings = {}
    for dtype in ("bfloat16", "float32"):
        out = tmp / f"out_{arch}_{dtype}"
        cfg = ExtractionConfig(
            data_dir=data, output_dir=out, batch_size=BATCH, device="cuda",
            compute_dtype=dtype, cache_decoded=False, arch=arch,
        )
        run_extraction(cfg, store=store)  # warm: cuDNN, cuBLAS and allocator set-up
        torch.cuda.reset_peak_memory_stats()
        summary = run_extraction(cfg, store=store)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        emb = summary.embeddings
        if emb.shape != (N_IMAGES, width) or not np.isfinite(emb).all():
            raise AssertionError(f"{arch} {dtype}: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
        reg = ArtifactRegistry(out)
        for path in (reg.embeddings_npy, reg.embeddings_csv, reg.features_metadata_json,
                     reg.feature_summary_md, reg.extraction_log):
            if not path.is_file():
                raise AssertionError(f"{arch} {dtype}: missing artifact {path}")
        meta = json.loads(reg.features_metadata_json.read_text())
        if (meta["num_images"] != N_IMAGES or meta["weights"] != "random_init:seed=42"
                or meta["embedding_dimension"] != width or meta["architecture"] != arch):
            raise AssertionError(f"{arch} {dtype}: metadata {meta['num_images']} {meta['weights']}")
        embeddings[dtype] = emb
        say("slice", arch=arch, dtype=dtype, images=N_IMAGES, batch=BATCH, embed_s=f"{summary.embed_seconds:.4f}",
            imgs_per_s=f"{N_IMAGES / summary.embed_seconds:.1f}", e2e_s=f"{summary.total_seconds:.3f}",
            peak_mem_gib=f"{peak_gib:.2f}")
    launches = counts.read()
    want = {"preprocess_images": 4 * batches}
    if vit:
        want.update(layer_norm=4 * batches * VIT_LN_PER_FORWARD, attention_qkv=4 * batches * VIT_ATTN_PER_FORWARD)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{arch}: the extraction path launched {got}, expected {want}")

    if vit:
        # the same bfloat16 run once more under the profiler: kernel time by
        # layer, and the idle share of the embed loop (the window; the one
        # fill kernel of staging before it is counted as busy, which
        # flatters the idle share by under a millisecond)
        cfg = ExtractionConfig(data_dir=data, output_dir=tmp / f"out_{arch}_profiled", batch_size=BATCH,
                               device="cuda", compute_dtype="bfloat16", cache_decoded=False, arch=arch)
        counts.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            summary = extract_embeddings(records, cfg, store=store)
        counts.read()
        _profile_breakdown(torch, prof, summary.embed_seconds * 1e3, f"{arch}_embed_bfloat16", _VIT_PROFILE_CLASSES)
    else:
        # The per-batch shape: a decode failure in the store sends the pipeline
        # down the pinned, side-stream double-buffered feed. Its embeddings must
        # match the resident run's (cuDNN may pick other algorithms for other
        # batch contents, hence a relative bound and not bit equality).
        n_sub, failed = 2 * BATCH + 7, 5
        packed_index = np.arange(n_sub) - (np.arange(n_sub) > failed)
        packed_index[failed] = -1
        sub_paths = [r.absolute_path for r in records[:n_sub]]
        sub_store = ImageStore(np.delete(images[:n_sub], failed, axis=0), packed_index, {},
                               [sub_paths[failed]], sub_paths)
        cfg = ExtractionConfig(data_dir=data, output_dir=tmp / "out_batched", batch_size=BATCH,
                               device="cuda", compute_dtype="float32", cache_decoded=False, arch=arch)
        counts.reset()
        batched = extract_embeddings(records[:n_sub], cfg, store=sub_store)
        counts.read()
        resident = np.delete(embeddings["float32"][:n_sub], failed, axis=0)
        rel_batched = float(np.abs(batched.embeddings - resident).max() / np.abs(resident).max())
        if batched.failures != [sub_paths[failed]] or rel_batched > 1e-4:
            raise AssertionError(f"per-batch shape: failures {batched.failures}, rel {rel_batched}")
        say("slice", arch=arch, shape="per-batch", images=n_sub - 1, failures=1, vs_resident_f32_rel=rel_batched,
            embed_s=f"{batched.embed_seconds:.4f}")

    cos = (_unit(np, embeddings["bfloat16"]) * _unit(np, embeddings["float32"])).sum(axis=1)
    if cos.min() <= 0.995:
        raise AssertionError(f"{arch}: bf16 vs f32 per-image cosine min {cos.min()}")

    model = build_model(arch, compute_dtype=torch.float32)
    load_flax_variables(model, seeded_init_host(arch, 42))
    with torch.inference_mode():
        x = torch.from_numpy(images[:n_cpu])
        cpu = model.eval()(preprocess_images(x, RESIZE, CROP, torch.float32)).numpy()
    gpu = embeddings["float32"][:n_cpu]
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if rel > 1e-4:
        raise AssertionError(f"{arch}: cuda f32 vs cpu f32 relative error {rel} > 1e-4 (TF32 on?)")
    say("slice", arch=arch, launches=got, cos_bf16_f32_min=f"{cos.min():.6f}", cuda_vs_cpu_f32_rel=rel,
        cpu_checked=n_cpu)


def phase_cli(np, tmp: Path) -> None:
    """The extraction CLI as a subprocess, with a ResNet and with a ViT."""
    from PIL import Image

    data = tmp / "jpegs"
    rng = np.random.default_rng(SEED + 2)
    for rel in ("avec_labels/cancer/a.jpg", "avec_labels/normal/b.jpg",
                "sans_label/c.jpg", "sans_label/d.jpg"):
        (data / rel).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(data / rel)
    for arch, width in (("resnet18", 512), ("vit_t16", 192)):
        out = tmp / f"cli_out_{arch}"
        subprocess.run(
            [sys.executable, "-m", "ssip_tpu_torch.cli.feature_extraction", "--data-dir", str(data),
             "--device", "cuda", "--batch-size", "4", "--compute-dtype", "bfloat16", "--arch", arch,
             "--output-dir", str(out)],
            cwd=Path(__file__).resolve().parent, check=True, timeout=600,
        )
        emb = np.load(out / "features" / "embeddings.npy")
        meta = json.loads((out / "features" / "metadata.json").read_text())
        if emb.shape != (4, width) or not np.isfinite(emb).all() or meta["device"] != "cuda:1":
            raise AssertionError(f"cli {arch}: embeddings {emb.shape}, device {meta['device']}")
        say("cli", arch=arch, images=4, width=width,
            csv_rows=len((out / "features" / "embeddings.csv").read_text().splitlines()) - 1)


def make_train_tree(np, tmp: Path) -> Path:
    """The seeded labeled JPEG tree both training paths read."""
    from PIL import Image

    data = tmp / "train" / "avec_labels"
    rng = np.random.default_rng(SEED + 4)
    for cls in ("cancer", "normal"):
        (data / cls).mkdir(parents=True)
        for i in range(TRAIN_PER_CLASS):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(data / cls / f"{cls}_{i:03d}.jpg")
    return data


def phase_train(torch, np, tmp: Path, data: Path, counts: LaunchCounts, arch: str, runs, cli_arch: str) -> None:
    """``run_supervised`` of ``arch`` on the JPEG tree, once per
    (compute type, epochs) of ``runs``, then the training CLI with
    ``cli_arch`` for one epoch."""
    from ssip_tpu_torch.data.discovery import labeled_folder
    from ssip_tpu_torch.data.splits import split_dict
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.pipelines.supervised import TrainingConfig, run_supervised
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
    from ssip_tpu_torch.train.checkpoints import load_checkpoint

    _, targets, _ = labeled_folder(data)
    splits = split_dict(targets, 0.2, 0.2, 42)
    want_splits = {k: v.tolist() for k, v in splits.items()}
    steps_per_epoch = -(-len(splits["train"]) // TRAIN_BATCH)

    for dtype, epochs in runs:
        out = tmp / f"train_out_{arch}_{dtype}"
        cfg = TrainingConfig(
            strong_data_dir=data, output_dir=out, device="cuda", batch_size=TRAIN_BATCH, arch=arch,
            image_size=TRAIN_SIZE, baseline_epochs=epochs, target_recall=0.9, compute_dtype=dtype,
        )
        counts.reset()  # count only the main path's launches
        t0 = time.perf_counter()
        results = run_supervised(cfg)
        seconds = time.perf_counter() - t0
        launches = counts.read()
        reg = ArtifactRegistry(out)
        for path in (reg.baseline_checkpoint, reg.results_comparison_csv, reg.training_history_json):
            if not path.is_file():
                raise AssertionError(f"train {arch} {dtype}: missing artifact {path}")
        payload = json.loads(reg.training_history_json.read_text())
        hist = payload["baseline"]
        losses = hist["train_loss"] + hist["val_loss"]
        if len(hist["train_loss"]) != epochs or not np.isfinite(losses).all():
            raise AssertionError(f"train {arch} {dtype}: history {hist}")
        if payload["splits"] != want_splits or payload["arch"] != arch or payload["image_size"] != TRAIN_SIZE:
            raise AssertionError(f"train {arch} {dtype}: splits or arch differ from the CPU split: {payload['splits']}")
        model = build_model(arch, num_classes=2)
        load_checkpoint(reg.baseline_checkpoint, model)
        steps = epochs * steps_per_epoch
        want = {"augment_images": steps}
        if arch == VIT_ARCH:
            want.update(layer_norm_bwd=steps * VIT_LN_PER_FORWARD, attention_qkv_bwd=steps * VIT_ATTN_PER_FORWARD)
            # every forward, train or eval, is 25 LayerNorm and 12 attention launches
            forwards = launches["attention_qkv"] // VIT_ATTN_PER_FORWARD
            if forwards <= steps or launches["layer_norm"] != forwards * VIT_LN_PER_FORWARD:
                raise AssertionError(f"train {arch} {dtype}: forward launches {launches}")
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"train {arch} {dtype}: the training path launched {got}, expected {want}")
        header = reg.results_comparison_csv.read_text().splitlines()[0]
        thr = results["baseline_thresholded"]
        say("train", arch=arch, dtype=dtype, images=2 * TRAIN_PER_CLASS, batch=TRAIN_BATCH, epochs=epochs,
            seconds=f"{seconds:.2f}", train_loss=f"{hist['train_loss'][-1]:.4f}",
            val_loss=f"{hist['val_loss'][-1]:.4f}", test_f1=f"{thr['f1']:.4f}",
            threshold=f"{thr['threshold']:.4f}", csv_columns=len(header.split(",")) - 1,
            launches={k: v for k, v in launches.items() if v})

    out = tmp / f"train_cli_out_{cli_arch}"
    subprocess.run(
        [sys.executable, "-m", "ssip_tpu_torch.cli.supervised_training", "--strong-data-dir", str(data),
         "--device", "cuda", "--baseline-epochs", "1", "--target-recall", "0.9", "--arch", cli_arch,
         "--output-dir", str(out)],
        cwd=Path(__file__).resolve().parent, check=True, timeout=600,
    )
    payload = json.loads((out / "notes" / "training_history.json").read_text())
    hist = payload["baseline"]
    if (len(hist["val_loss"]) != 1 or payload["arch"] != cli_arch
            or not (out / "models" / "baseline_resnet18.pt").is_file()):
        raise AssertionError(f"train cli {cli_arch}: history {hist}")
    say("train", cli="supervised_training", arch=cli_arch, epochs=1, val_loss=f"{hist['val_loss'][0]:.4f}")


def _seeded_state(torch, device, dtype, arch: str = "resnet18", kink_free: bool = False, remat: bool = False):
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.models.resnet import BatchNorm, Conv
    from ssip_tpu_torch.train.engine import TrainState

    model = build_model(arch, num_classes=2, compute_dtype=dtype, remat=remat, image_size=TRAIN_SIZE)
    load_flax_variables(model, seeded_init_host(arch, 42, num_classes=2, image_size=TRAIN_SIZE))
    if kink_free:
        with torch.no_grad():
            for module in model.modules():
                if isinstance(module, BatchNorm):
                    module.bias.add_(KINK_FREE_BN_BIAS)
                elif isinstance(module, Conv):
                    module.weight.sub_(module.weight.mean(dim=(1, 2, 3), keepdim=True))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState.create(model, 1e-4, 1e-4)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# kernel-name fragments → the layer a profile line is charged to, first match wins
_PROFILE_CLASSES = (
    ("augment kernel", ("train_augment_kernel",)),
    ("AdamW", ("multi_tensor_apply", "adam")),
    ("convolutions (cuDNN fwd + bwd)", ("conv", "cudnn", "xmma", "implicit", "gemm", "wgrad", "dgrad",
                                        "winograd", "fft", "cutlass", "sm80_", "sm90_", "nhwc", "nchw")),
    ("max-pool", ("max_pool",)),
    ("BatchNorm/ReLU/loss elementwise and reductions", ("elementwise", "reduce", "vectorized", "unrolled",
                                                        "index", "where", "softmax", "nll", "scatter")),
)


# the same for the ViT paths
_VIT_PROFILE_CLASSES = (
    ("LayerNorm kernels", ("ln_fwd_kernel", "ln_bwd_kernel")),
    ("attention kernels", ("attn_qkv",)),
    ("augment kernel", ("train_augment_kernel",)),
    ("preprocess kernel", ("preproc_taps_kernel",)),
    ("AdamW", ("multi_tensor_apply", "adam")),
    ("Dense GEMMs and patch conv (cuBLAS, cuDNN)", ("nvjet", "gemm", "cutlass", "cublas", "xmma", "sm90_", "sm80_",
                                                   "gemv", "splitk", "conv", "cudnn", "implicit", "wgrad", "dgrad")),
    ("GELU, casts, adds, bias and loss (elementwise and reductions)", ("elementwise", "reduce", "vectorized",
                                                                      "unrolled", "index", "where", "softmax",
                                                                      "nll", "scatter", "gelu", "cat", "copy")),
)


def _profile_breakdown(torch, prof, window_ms: float, tag: str, classes=_PROFILE_CLASSES) -> None:
    """Device time of the profiled steps by layer and by kernel, and the
    idle share of the window."""
    cuda = torch.autograd.DeviceType.CUDA
    # kernels only: copies between host and card (a corpus being staged) are
    # not work of the window that is measured
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == cuda and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("torch.profiler saw no kernel on the card")
    by_layer: dict = {}
    by_name: dict = {}
    for name, start, end in kernels:
        ms = (end - start) / 1000.0
        low = name.lower()
        layer = next((c for c, keys in classes if any(k in low for k in keys)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
    busy = sum(by_layer.values())
    for layer, ms in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        say("profile", run=tag, layer=repr(layer), ms=f"{ms:.3f}", share=f"{ms / busy:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say("profile", run=tag, kernel=repr(name[:90]), ms=f"{ms:.3f}")
    say("profile", run=tag, kernels=len(kernels), busy_ms=f"{busy:.3f}", window_ms=f"{window_ms:.3f}",
        idle_share=f"{1 - busy / window_ms:.4f}")


def _step_inputs(torch, np, b: int, padded_rows: int = 0):
    """(images uint8 [b, 224, 224, 3], labels, valid) on the CPU, seeded."""
    rng = np.random.default_rng(SEED + 5 + b)
    images = torch.from_numpy(rng.integers(0, 256, (b, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, b).astype(np.int64))
    valid = torch.ones(b, dtype=torch.bool)
    if padded_rows:
        valid[-padded_rows:] = False  # padded rows, left out of BN statistics and the loss
    return images, labels, valid


def _one_step(torch, arch: str, dev, batch, coeffs, kink_free: bool = False, remat: bool = False):
    """One float32 train step at the seeded weights on ``dev``: (loss,
    predictions, gradients, BN running statistics), on the CPU."""
    from ssip_tpu_torch.train.engine import train_step

    state = _seeded_state(torch, dev, torch.float32, arch, kink_free, remat)
    loss, pred = train_step(state, *(t.to(dev) for t in batch), coeffs.to(dev))
    return (loss.cpu(), pred.cpu(), {k: p.grad.cpu() for k, p in state.model.named_parameters()},
            {k: v.cpu() for k, v in state.model.state_dict().items() if "running" in k})


def _timed_steps(torch, np, arch: str, counts: LaunchCounts, classes) -> None:
    """The steady-state step at batch 128 in bfloat16 and float32: timed,
    then profiled."""
    from torch.profiler import ProfilerActivity, profile

    from ssip_tpu_torch.ops.augment import augment_coeffs
    from ssip_tpu_torch.runtime.prng import augment_draws
    from ssip_tpu_torch.train.engine import train_step

    b = STEP_TIMED_BATCH
    dev = torch.device("cuda")
    images, labels, valid = (t.to(dev) for t in _step_inputs(torch, np, b))
    n_steps = STEP_WARMUP + STEP_TIMED
    coeffs = torch.from_numpy(np.stack([
        augment_coeffs(*augment_draws(SEED, "smoke", 1, s, b)) for s in range(2 * n_steps)
    ])).to(dev)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        state = _seeded_state(torch, dev, dtype, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for s in range(STEP_WARMUP):
            train_step(state, images, labels, valid, coeffs[s])
        counts.reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(STEP_WARMUP, n_steps):
            loss, _ = train_step(state, images, labels, valid, coeffs[s])
        end.record()
        end.synchronize()
        launches = {k: v / STEP_TIMED for k, v in counts.read().items() if v}
        step_ms = start.elapsed_time(end) / STEP_TIMED
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if not torch.isfinite(loss):
            raise AssertionError(f"{arch} {dtype_name} train step loss {loss.item()}")
        want = {"augment_images": 1.0}
        if arch == VIT_ARCH:
            want.update(layer_norm=VIT_LN_PER_FORWARD, layer_norm_bwd=VIT_LN_PER_FORWARD,
                        attention_qkv=VIT_ATTN_PER_FORWARD, attention_qkv_bwd=VIT_ATTN_PER_FORWARD)
        if launches != want:
            raise AssertionError(f"{arch} {dtype_name}: launches per step {launches}, expected {want}")
        say("step", arch=arch, dtype=dtype_name, batch=b, timed_steps=STEP_TIMED, ms_per_step=f"{step_ms:.3f}",
            train_imgs_per_s=f"{b / step_ms * 1000:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
            launches_per_step=launches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for s in range(n_steps, n_steps + STEP_TIMED):
                train_step(state, images, labels, valid, coeffs[s])
            end.record()
            end.synchronize()
        _profile_breakdown(torch, prof, start.elapsed_time(end), f"{arch}_step_{dtype_name}", classes)
        del state
    torch.cuda.empty_cache()


def phase_step(torch, np, counts: LaunchCounts) -> None:
    """ResNet-18: one train step cuda vs CPU, then the steady-state step."""
    from ssip_tpu_torch.ops.augment import augment_coeffs
    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.runtime.prng import augment_draws

    configure_precision("float32")
    b = STEP_CHECK_BATCH
    batch = _step_inputs(torch, np, b, padded_rows=1)
    coeffs = torch.from_numpy(augment_coeffs(*augment_draws(SEED, "smoke", 0, 0, b)))

    def cuda_vs_cpu(kink_free: bool) -> dict:
        (l_cpu, p_cpu, g_cpu, s_cpu), (l_gpu, p_gpu, g_gpu, s_gpu) = (
            _one_step(torch, "resnet18", torch.device(dev), batch, coeffs, kink_free) for dev in ("cpu", "cuda")
        )
        return {
            "loss": l_cpu.item(), "loss_rel": _rel(l_gpu, l_cpu), "argmax_equal": torch.equal(p_gpu, p_cpu),
            "grad_rel": max(_rel(g_gpu[k], g_cpu[k]) for k in g_cpu if k != STEM_GRAD),
            "stem_l2": float((g_gpu[STEM_GRAD] - g_cpu[STEM_GRAD]).norm() / g_cpu[STEM_GRAD].norm()),
            "stat_rel": max(_rel(s_gpu[k], s_cpu[k]) for k in s_cpu),
        }

    # Loss, argmax and BN statistics at the seeded weights; gradients where
    # no ReLU input sits at the kink (KINK_FREE_BN_BIAS).
    seeded, shifted = cuda_vs_cpu(False), cuda_vs_cpu(True)
    for tag, r in (("seeded", seeded), ("kink_free", shifted)):
        say("step", arch="resnet18", check=f"cuda_vs_cpu_f32_{tag}", batch=b, padded_rows=1, **r)
    if (seeded["loss_rel"] > 1e-5 or seeded["stat_rel"] > 1e-5 or not seeded["argmax_equal"]
            or shifted["loss_rel"] > 1e-5 or shifted["grad_rel"] > 1e-3 or shifted["stem_l2"] > 1e-2):
        raise AssertionError(f"train step cuda vs cpu out of bounds: seeded {seeded}, kink-free {shifted}")
    _timed_steps(torch, np, "resnet18", counts, _PROFILE_CLASSES)


def phase_vit_step(torch, np, counts: LaunchCounts) -> None:
    """ViT-B/16: one train step cuda vs CPU at the seeded weights (no ReLU
    and no max-pool, so no kinks), the same step with ``remat``, then the
    steady-state step."""
    from ssip_tpu_torch.ops.augment import augment_coeffs
    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.runtime.prng import augment_draws

    configure_precision("float32")
    b = STEP_CHECK_BATCH
    batch = _step_inputs(torch, np, b, padded_rows=1)
    coeffs = torch.from_numpy(augment_coeffs(*augment_draws(SEED, "smoke", 0, 0, b)))
    l_cpu, p_cpu, g_cpu, _ = _one_step(torch, VIT_ARCH, torch.device("cpu"), batch, coeffs)
    counts.reset()
    l_gpu, p_gpu, g_gpu, _ = _one_step(torch, VIT_ARCH, torch.device("cuda"), batch, coeffs)
    plain = counts.read()
    counts.reset()
    l_re, _, g_re, _ = _one_step(torch, VIT_ARCH, torch.device("cuda"), batch, coeffs, remat=True)
    remat = counts.read()
    r = {
        "loss": l_cpu.item(), "loss_rel": _rel(l_gpu, l_cpu), "argmax_equal": torch.equal(p_gpu, p_cpu),
        "grad_rel": max(_rel(g_gpu[k], g_cpu[k]) for k in g_cpu),
        "remat_loss_rel": _rel(l_re, l_gpu), "remat_grad_rel": max(_rel(g_re[k], g_gpu[k]) for k in g_gpu),
    }
    say("step", arch=VIT_ARCH, check="cuda_vs_cpu_f32_seeded", batch=b, padded_rows=1, **r,
        launches={k: v for k, v in plain.items() if v}, remat_launches={k: v for k, v in remat.items() if v})
    if (r["loss_rel"] > 1e-5 or r["grad_rel"] > 1e-3 or not r["argmax_equal"]
            or r["remat_loss_rel"] > 1e-6 or r["remat_grad_rel"] > 1e-5):
        raise AssertionError(f"{VIT_ARCH} train step cuda vs cpu, or remat vs plain, out of bounds: {r}")
    # remat runs each block's forward once more in the backward pass
    want_plain = {"layer_norm": VIT_LN_PER_FORWARD, "layer_norm_bwd": VIT_LN_PER_FORWARD,
                  "attention_qkv": VIT_ATTN_PER_FORWARD, "attention_qkv_bwd": VIT_ATTN_PER_FORWARD}
    want_remat = dict(want_plain, layer_norm=VIT_LN_PER_FORWARD + 2 * VIT_BLOCKS,
                      attention_qkv=VIT_ATTN_PER_FORWARD + VIT_BLOCKS)
    for tag, got, want in (("plain", plain, want_plain), ("remat", remat, want_remat)):
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{VIT_ARCH} {tag} step launched {got}, expected {want}")
    _timed_steps(torch, np, VIT_ARCH, counts, _VIT_PROFILE_CLASSES)


def phase_imports() -> None:
    """The run loaded nothing of jax and nothing of the JAX package: the
    port keeps its own copies of the jax-free modules it needs."""
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ssip_tpu"))
    if foreign:
        raise AssertionError(f"the port loaded {foreign[:8]}")
    say("imports", jax=0, ssip_tpu_modules=0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    t0 = time.perf_counter()
    phase_env(torch)
    phase_build()
    counts = LaunchCounts()
    measured = {"preprocess_images": phase_kernel(torch, np), "augment_images": phase_rotate_kernel(torch, np),
                **phase_layer_norm_kernels(torch, np), **phase_attention_kernels(torch, np)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        corpus = make_corpus(np, tmp)
        phase_slice(torch, np, tmp, corpus, counts, "resnet18", 512, N_CPU_CHECK)
        phase_slice(torch, np, tmp, corpus, counts, VIT_ARCH, VIT_WIDTH, VIT_N_CPU_CHECK)
        del corpus
        phase_cli(np, tmp)
        train_tree = make_train_tree(np, tmp)
        phase_train(torch, np, tmp, train_tree, counts, "resnet18",
                    (("float32", TRAIN_EPOCHS), ("bfloat16", TRAIN_EPOCHS)), "resnet18")
        phase_train(torch, np, tmp, train_tree, counts, VIT_ARCH,
                    (("bfloat16", TRAIN_EPOCHS), ("float32", 1)), "vit_t16")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_step(torch, np, counts)
    phase_vit_step(torch, np, counts)
    phase_imports()
    never = [name for name, n in counts.total.items() if n == 0]
    if never:
        raise AssertionError(f"the main paths never launched {never}")
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": counts.total[name], **measured[name]} for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
