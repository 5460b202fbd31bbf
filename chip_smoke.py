#!/usr/bin/env python3
"""Drive the PyTorch port's extraction, training and semi-supervised slices once on
one NVIDIA GPU, for the ResNet family and the ViT family, int8 ViT extraction included.

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
   the data-sheet peak of their type, whichever is larger; float32
   attention products count as three TF32 products at 495 TFLOP/s;
   the float32 attention backward is timed from its forward's residuals,
   the output and row statistics autograd keeps):
   kernel  ``preprocess_images``: bitwise in float32 and bfloat16 at
           [128, 512, 512, 3] → 256 → 224, one uint8 step at 384² and 320×448;
           its int8 form (``quant_inv_scale``) bitwise at the first shape and
           within that step times the scale elsewhere;
   rotate  ``augment_images`` (flip → rotate → normalize): bitwise in
           float32 and bfloat16 at [128, 224, 224, 3], [16, 224, 160, 3] and
           [8, 64, 96, 3], drawn angles in ±10° and pinned ±10°, ±25°;
   rotate_u8  ``rotate_images`` (flip → rotate, uint8 in and out): bitwise
           against ``rotate_nearest`` at [128, 224, 224, 3], [16, 224, 160, 3],
           [8, 64, 96, 3] and [4, 64, 36, 3], with drawn angles in ±10° (two
           pinned at ±10°) and in ±25° (four pinned at ±10° and ±25°), flip
           flags mixed and all off; its time is the wrapper's call, the
           kernel's own device time is printed beside it (``torch.profiler``);
   ln      ``layer_norm`` and ``layer_norm_bwd`` at [25216, 768] and
           [26624, 768] (128 images of 197 and of 208 tokens) in bfloat16 and
           float32, [128, 768] float32 (the final LayerNorm) and
           [1001, 384] (a row count that is no multiple of the block); a
           call's time, the kernels' own device time (``torch.profiler``,
           the backward's column sum apart; fails unless it sees one
           forward kernel a forward call and two kernels a backward call),
           the wrapper's host time, the same three of ``F.layer_norm`` and
           its autograd backward, and GB/s; the kernels' registers, spills,
           shared memory and resident blocks an SM at width 768;
   attn    ``fused_attention_qkv`` and ``attention_qkv_bwd`` at
           [128, 197, 2304] and at [128, 208, 2304] with ``kv_len`` 197, in
           bfloat16 (the kernels of ``csrc/attention_mma.cu``, products on
           the tensor cores but the forward's scores) and float32 (the
           kernels of ``csrc/attention_f32_mma.cu``, 3xTF32 products on the
           tensor cores, forward and two-launch backward), at the 3 heads
           of vit_t16, and in float32 at 256 and 577 tokens (bf16's limit
           is 256); pad-query rows are compared too and get a non-zero dO;
           also bytes/s and bound/time, and ptxas's registers, shared
           memory and spills of the tensor-core kernels (the float32
           kernels' also resident blocks an SM), the float32 TF32 rates
           and times over the library's.
   qmlp    ``quantized_mlp`` at [25216, 768] (hidden 3072) in bfloat16 and
           float32, [300, 192] and [1001, 384]: at most 1e-3 of the elements
           off the plain version by more than 1e-5 (absolute and relative),
           none by more than 2·127·max(m2); the counts are printed;
   attn4   ``fused_attention`` and ``attention_bwd`` on q, k, v
           [128, 12, 197, 64] in bfloat16 (the kernels of
           ``csrc/attention_unpacked_mma.cu``, every product on the tensor
           cores, p and ds as bf16 hi/lo pairs) and float32 (the packed
           pair's float32 kernels), 3 heads, [8, 2, 50, 32], float32 at
           [128, 12, 256, 64], and in both types past 256 tokens:
           [16, 12, 577, 64] (ViT-B/16 at 384²), [4, 12, 1024, 64], and in
           bfloat16 [2, 4, 1024, 32]; at attn's tolerances, and in bfloat16 each
           element of dq, dk and dv also within the output's one step; the
           three bf16 kernels' registers, spills, shared memory a block and
           resident blocks an SM;
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
   int8    the same corpus through ``run_extraction`` with
           ``compute_dtype="int8"`` for vit_b16 (calibrated on its first 32
           images, twice, the second run timed): finite, ``weights`` ends in
           ``+int8_ptq``, cosine against the float32 run of the same weights
           above 0.98 on every image, per forward 1 preprocess-quantize, 25
           LayerNorm, 12 attention and 12 MLP launches; a profiled run;
   entry   ``fused_attention`` (no pipeline calls it, in either package)
           driven through autograd on the q, k, v of one vit_b16 attention
           sublayer at batch 128, float32 and bfloat16, against the packed
           pair on the same values;
5. cli     the extraction CLI on a small 512² JPEG tree (needs Pillow), with
           resnet18, with vit_t16 and with vit_t16 in int8;
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
8. semi    the same labeled tree plus a flat ``sans_label/`` pool of 256
           seeded 512² JPEGs through ``run_pipeline`` (baseline → pseudo-label
           → head-only pretrain → FixMatch fine-tune with an EMA teacher) on
           cuda at 224², batch 16, 2 + 1 + 2 epochs, both thresholds 0.5:
           resnet18 in float32 and bfloat16, vit_b16 in bfloat16. Every
           artifact is written, the histories are finite, pseudo-labels were
           kept and the mean keep rate is above 0, after the pretrain only
           the head differs from the seeded init while BN running means do
           differ, both ``.pt`` load, one ``rotate_images`` launch per
           FixMatch step and one ``augment_images`` launch per augmented
           step, and for vit_b16 2 × 25 LayerNorm and 2 × 12 attention
           backward launches per FixMatch step and none in the head-only
           pretrain; then the semi-supervised CLI
           for one epoch per phase as a subprocess (resnet18, vit_t16);
9. fixmatch_step  one FixMatch step on cuda against the same step on the
           CPU (float32, TF32 off, 8 labeled + 8 unlabeled, same weights and
           draws, EMA teacher): loss ≤ 1e-5 relative, gradients ≤ 1e-2 of
           each tensor's max and ≤ 1e-4 in L2 over all tensors (see
           ``FIXMATCH_GRAD_RTOL``; resnet18 at the kink-free weights, its
           stem ≤ 1e-2 in L2; vit_b16 at the seeded ones, where the final
           LayerNorm's backward kernel on each view's card ``x`` and ``dy``
           is also held to 1e-5 of max of float64, its and the plain float32
           version's errors printed beside how far the card's ``dy`` stands
           from the CPU's). Then the steady-state step at
           128 + 128 in bfloat16 and float32 (3 warm-ups, 10 timed): imgs/s
           (labeled + unlabeled), ms a step, peak memory, launches a step
           (vit_b16: 3 × 25 and 3 × 12 forward, 2 × 25 and 2 × 12 backward),
           the strong view's time alone and its share of the step, and a
           ``torch.profiler`` split with the idle share;
10. imports no jax module and no module of the JAX package;
11. the kernels JSON line (all eleven kernels), then ``{"ok": true, "device": {...}}`` last.

Needs no network and no data: everything is made from seeds. It builds the
kernels from the checkout, so a fresh clone is enough. It imports only
``ssip_tpu_torch``, torch and numpy, and fails if the run loaded jax, flax,
optax or any module of the JAX package (``ssip_tpu``).
"""

from __future__ import annotations

import json
import re
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
# what the packed pair's bf16 times below are of
ATTN_MMA_DESIGN = ("bf16, csrc/attention_mma.cu: forward float32 FMA scores in cuBLAS's order, torch-order softmax, "
                   "P.V on mma.sync m16n8k16; backward two launches, every product on mma.sync; cp.async staging")
ATTN_MMA_KERNELS = ("attn_qkv_fwd_mma_kernel", "attn_qkv_bwd_rows_kernel", "attn_qkv_bwd_keys_kernel")
# what the unpacked pair's bf16 times below are of
UNPACKED_MMA_DESIGN = ("bf16, csrc/attention_unpacked_mma.cu: every product on mma.sync m16n8k16, p and ds as bf16 "
                       "hi/lo pairs (two mma a product), keys or queries streamed in 64-row cp.async tiles, online "
                       "softmax; backward two launches (dq by query rows, dk and dv by key rows)")
UNPACKED_MMA_KERNELS = ("attn_unpacked_fwd_kernel", "attn_unpacked_bwd_rows_kernel", "attn_unpacked_bwd_keys_kernel")
# what both pairs' float32 times below are of
F32_SOURCE = "ssip_tpu_torch/csrc/attention_f32_mma.cu"
ATTN_F32_DESIGN = ("f32, csrc/attention_f32_mma.cu: 3xTF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi) on mma.sync "
                   "m16n8k8, operands, p and ds split in registers; forward K and V streamed in 64-key cp.async "
                   "tiles, online softmax, row max and 1/sum saved for autograd; backward two launches, no atomics: "
                   "dq by 32 query rows (K, V streamed in 32-key tiles, delta = dO.o), dk and dv by 32 key rows "
                   "(q, dO and row statistics streamed), p from the saved statistics, 7 products")
ATTN_F32_KERNELS = ("attn_f32_fwd_kernel", "attn_f32_bwd_rows_kernel", "attn_f32_bwd_keys_kernel")
# what the LayerNorm pair's times below are of
LN_DESIGN = ("csrc/layernorm.cu: persistent, one wave of 4-warp blocks, each warp streaming a contiguous range of "
             "rows through a cp.async ring in shared memory (2 slots forward, 4 backward: x and dy together), scale "
             "and bias in registers once a warp, exact-width templates at 192, 384, 768 and 1024; backward sums "
             "in registers, warps added in order, a column-sum launch in block order, no atomics")
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
        "replaces": "ssip_tpu/ops/layernorm.py:55", "design": LN_DESIGN,
    },
    "layer_norm_bwd": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/layernorm.cu",
        "replaces": "ssip_tpu/ops/layernorm.py:65", "design": LN_DESIGN,
    },
    "attention_qkv": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/attention_mma.cu",
        "replaces": "ssip_tpu/ops/attention.py:220", "design": ATTN_MMA_DESIGN,
        "float32_source": F32_SOURCE, "float32_design": ATTN_F32_DESIGN,
    },
    "attention_qkv_bwd": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/attention_mma.cu",
        "replaces": "ssip_tpu/ops/attention.py:256", "design": ATTN_MMA_DESIGN,
        "float32_source": F32_SOURCE, "float32_design": ATTN_F32_DESIGN,
    },
    "preprocess_quantize": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/preproc.cu",
        "replaces": "ssip_tpu/ops/pallas_preproc.py:65",
    },
    "quantized_mlp": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/qmlp.cu",
        "replaces": "ssip_tpu/ops/qmlp.py:78",
    },
    "attention": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/attention_unpacked_mma.cu",
        "replaces": "ssip_tpu/ops/attention.py:59", "design": UNPACKED_MMA_DESIGN,
        "float32_source": F32_SOURCE, "float32_design": ATTN_F32_DESIGN,
    },
    "attention_bwd": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/attention_unpacked_mma.cu",
        "replaces": "ssip_tpu/ops/attention.py:109", "design": UNPACKED_MMA_DESIGN,
        "float32_source": F32_SOURCE, "float32_design": ATTN_F32_DESIGN,
    },
    "rotate_images": {
        "route": "cuda", "source": "ssip_tpu_torch/csrc/rotate.cu",
        "replaces": "ssip_tpu/ops/augment.py:205",
    },
}
# Data-sheet peaks of one H100 SXM, for the bounds: device memory rate, and
# dense operation rates by operand type: "float32" outside the tensor cores
# (elementwise work), "tf32x3" float32-accurate products on them, three TF32
# products each (the float32 attention kernels).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32x3": 495e12 / 3}
ATTN_OPS_TYPE = {"bfloat16": "bfloat16", "float32": "tf32x3"}  # the attention rows' products by input type
VIT_ARCH, VIT_WIDTH, VIT_TOKENS, VIT_HEADS, VIT_MLP = "vit_b16", 768, 197, 12, 3072
VIT_LN_PER_FORWARD, VIT_ATTN_PER_FORWARD, VIT_BLOCKS = 25, 12, 12
INT8_COSINE_FLOOR = 0.98  # int8 vs float32 embeddings, per image (the JAX pipeline's own floor)
# a stem scale as calibration gives it: normalized pixels reach about ±2.64
QUANT_INV_SCALE = 127.0 / 2.64
# (rows, width, hidden, type): 128 images of 197 tokens, then two ragged row counts
QMLP_SHAPES = (
    (128 * 197, 768, 3072, "bfloat16"), (128 * 197, 768, 3072, "float32"),
    (300, 192, 768, "bfloat16"), (1001, 384, 1536, "float32"),
)
QMLP_ATOL = QMLP_RTOL = 1e-5
QMLP_MAX_SHARE_OFF = 1e-3
# (batch, heads, tokens, head width, type)
UNPACKED_ATTN_SHAPES = (
    (128, 12, 197, 64, "bfloat16"), (128, 12, 197, 64, "float32"), (128, 3, 197, 64, "bfloat16"),
    (8, 2, 50, 32, "float32"), (128, 12, 256, 64, "float32"),
    (16, 12, 577, 64, "bfloat16"), (4, 12, 1024, 64, "bfloat16"), (2, 4, 1024, 32, "bfloat16"),
    (16, 12, 577, 64, "float32"), (4, 12, 1024, 64, "float32"),
)
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
    (128, 197, 3, 0, "bfloat16"), (128, 256, 12, 0, "float32"), (16, 577, 12, 0, "float32"),
)
# the LayerNorm kernels of csrc/layernorm.cu, in the order of ``ssip_layer_norm_info``
LN_KERNELS = ("ln_fwd_kernel", "ln_bwd_kernel", "ln_colsum_kernel")
F32_ATOL = 2e-5
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
AUG_SHAPES = ((128, 224, 224, 3), (16, 224, 160, 3), (8, 64, 96, 3))
ROTATE_U8_SHAPES = AUG_SHAPES + ((4, 64, 36, 3),)  # 64 x 36: the TPU geometry has no block for it
PINNED_DEGREES = (10.0, -10.0, 25.0, -25.0)
POOL_IMAGES = 256  # the flat unlabeled pool of the semi-supervised runs
SEMI_EPOCHS = (2, 1, 2)  # baseline, weak pretrain, fine-tune
SEMI_THRESHOLD = 0.5  # pseudo-label and consistency thresholds: the seeded init keeps rows at 0.5
SEMI_EMA_DECAY = 0.99
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
# The FixMatch step's gradients are held to 1e-2 of each tensor's max and to
# 1e-4 in L2 over all of them together, not to the train step's 1e-3, and the
# count of tensors beyond 1e-3 is printed. The step sums two views' gradients,
# and some tensors' gradients are residues of cancelling sums. ResNet-18: at
# kink-free weights a ReLU is all but linear, so a BatchNorm that feeds a conv
# and another train-mode BatchNorm has a bias gradient that is zero but for
# rounding (the next layer's batch statistics remove a mean shift):
# layer2.0.bn1.bias differs by 3.4e-6 absolute, 7.6e-3 of a max |g| of 4.5e-4,
# while all gradients together differ by 1.1e-6 in L2. vit_b16: the final
# LayerNorm's bias, 1.45e-3 of its max (3.7e-6 in L2 over all tensors).
FIXMATCH_GRAD_RTOL = 1e-2
FIXMATCH_GRAD_L2_ALL = 1e-4
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
    """The eleven wrappers' launch counters: set to 0 just before a path is
    driven, read just after, summed over the paths for the kernels line."""

    def __init__(self):
        from ssip_tpu_torch.ops.attention import attention_bwd, attention_qkv_bwd, fused_attention, fused_attention_qkv
        from ssip_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd
        from ssip_tpu_torch.ops.preproc import preprocess_images, preprocess_quantize_images
        from ssip_tpu_torch.ops.qmlp import quantized_mlp
        from ssip_tpu_torch.ops.rotate import augment_images, rotate_images

        self.wrappers = {
            "preprocess_images": preprocess_images, "augment_images": augment_images,
            "layer_norm": layer_norm, "layer_norm_bwd": layer_norm_bwd,
            "attention_qkv": fused_attention_qkv, "attention_qkv_bwd": attention_qkv_bwd,
            "preprocess_quantize": preprocess_quantize_images, "quantized_mlp": quantized_mlp,
            "attention": fused_attention, "attention_bwd": attention_bwd, "rotate_images": rotate_images,
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
    """``preprocess_images`` in its float forms and its int8 form against
    their plain versions on the card; times at [128, 512, 512, 3]."""
    from ssip_tpu_torch.ops.preproc import preprocess_images, tap_table
    from ssip_tpu_torch.ops.quant import quantize
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
        # the int8 epilogue against quantizing the plain float32 result
        kq = preprocess_images(x, RESIZE, CROP, quant_inv_scale=QUANT_INV_SCALE)
        pq = quantize(p32, QUANT_INV_SCALE)
        torch.cuda.synchronize()
        errq = (kq.int() - pq.int()).abs().max().item()
        steps = 0 if exact else int(one_step * QUANT_INV_SCALE) + 1
        if kq.dtype != torch.int8 or kq.shape != pq.shape or errq > steps:
            raise AssertionError(f"int8 kernel off the plain version by {errq} int8 steps at {shape}, allowed {steps}")

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
        q_ms, pq_ms = timed_pair(
            torch, lambda: preprocess_images(x, RESIZE, CROP, quant_inv_scale=QUANT_INV_SCALE),
            lambda: quantize(extraction_preprocess(x, RESIZE, CROP, torch.float32), QUANT_INV_SCALE))
        # one more multiplication per output value than the float forms
        qbound = bound_ms(x.numel() + kq.numel(), ops + kq.numel(), "float32")
        say("kernel", form="int8", shape="x".join(map(str, shape)), tol="bitwise" if exact else f"<= {steps} steps",
            max_abs_err_int8=errq, int8_ms=f"{q_ms:.4f}", plain_int8_ms=f"{pq_ms:.4f}",
            bound_int8_ms=f"{qbound['bound_ms']:.4f}", bound_by=qbound["bound_by"], library="none")
        if exact:
            result = {
                "preprocess_images": {"max_abs_err": max(err32, err16), "ms": k_ms, "plain_ms": p_ms, **bound,
                                      "library_ms": None},
                "preprocess_quantize": {"max_abs_err": float(errq), "ms": q_ms, "plain_ms": pq_ms, **qbound,
                                        "library_ms": None},
            }
        del x, k32, k16, p32, kq, pq
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


def phase_rotate_u8_kernel(torch, np) -> dict:
    """``rotate_images`` against the plain ``rotate_nearest`` on the card,
    bitwise; times at [128, 224, 224, 3] within ±10°."""
    from ssip_tpu_torch.ops.augment import augment_coeffs, rotate_nearest
    from ssip_tpu_torch.ops.rotate import rotate_images
    from ssip_tpu_torch.runtime.prng import augment_draws

    rng = np.random.default_rng(SEED + 11)
    deg_to_rad = np.float32(np.pi / 180.0)
    result = {}
    for shape in ROTATE_U8_SHAPES:
        b = shape[0]
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        for max_degrees, pinned in ((10.0, PINNED_DEGREES[:2]), (25.0, PINNED_DEGREES)):
            flip, angles = augment_draws(SEED, "smoke_u8", 0, int(max_degrees), b, max_degrees)
            angles[: len(pinned)] = np.asarray(pinned, np.float32)[:b] * deg_to_rad
            coeffs = torch.from_numpy(augment_coeffs(flip, angles)).cuda()
            bare = coeffs.clone()
            bare[2] = 0  # no flip: the bare rotation of the TPU kernel
            for tag, c in (("flips mixed", coeffs), ("no flip", bare)):
                got = rotate_images(x, c)
                want = rotate_nearest(x, c)
                torch.cuda.synchronize()
                if got.dtype != torch.uint8 or not torch.equal(got, want):
                    diff = int((got != want).sum().item())
                    raise AssertionError(f"rotate kernel not bitwise equal to plain at {shape} ±{max_degrees}° "
                                         f"({tag}): {diff} values differ")
            say("rotate_u8", shape="x".join(map(str, shape)), max_degrees=max_degrees, tol="bitwise",
                flips=int(flip.sum()), pinned=list(pinned[:b]), zero_fill_share=f"{(want == 0).float().mean().item():.4f}")
        if shape == ROTATE_U8_SHAPES[0]:
            flip, angles = augment_draws(SEED, "smoke_u8", 0, 0, b, 10.0)
            coeffs = torch.from_numpy(augment_coeffs(flip, angles)).cuda()
            k_ms, p_ms = timed_pair(torch, lambda: rotate_images(x, coeffs), lambda: rotate_nearest(x, coeffs))
            # the kernel's own device time, without the wrapper's host work
            def rotate_kernels(windows):
                return [t for name, ts in windows[0].items() if "rotate_u8_kernel" in name for t in ts]

            windows = checked_device_windows(
                torch, [lambda: rotate_images(x, coeffs)],
                lambda w: None if len(rotate_kernels(w)) == TIMED_LAUNCHES else f"{len(rotate_kernels(w))} rotate kernels",
                "rotate_u8")
            device_ms = _median(rotate_kernels(windows))
            # about 25 integer operations a pixel for the index map, counted
            # at the float32 rate: far below the bytes
            bound = bound_ms(2 * x.numel() + coeffs.numel() * 4, 25 * x.numel() // 3, "float32")
            say("rotate_u8", shape="x".join(map(str, shape)), ms=f"{k_ms:.4f}", kernel_device_ms=f"{device_ms:.4f}",
                plain_ms=f"{p_ms:.4f}", bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
                gb_per_s=f"{2 * x.numel() / device_ms / 1e6:.1f}", library="none")
            result = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, **bound, "library_ms": None}
        del x
    torch.cuda.empty_cache()
    return result


def device_windows(torch, fns, iters: int = TIMED_LAUNCHES, gap_s: float = 0.05) -> list:
    """For each function of ``fns``: kernel name → the device time (ms) of
    each of its launches in ``iters`` calls, all under one ``torch.profiler``
    session (after one warm-up call each), told apart by an idle gap of
    ``gap_s`` between one function's calls and the next's: what the card
    spent, without the host's work around the launches. The session opens
    with a lead-in window of calls that is not read: on an H100 a session
    that was not the process's first has seen 0, 17 and 18 of 20 launches,
    losses taken to sit at its start. A list shorter than ``fns`` means the
    profiler lost a window's records."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in [fns[0]] + list(fns):  # the lead-in, then one window each
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(gap_s)
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    windows: list = []
    last_end = None
    for start, end, name in kernels:  # microseconds; a new window after half the gap idle
        if last_end is None or start - last_end > gap_s / 2 * 1e6:
            windows.append({})
        windows[-1].setdefault(name, []).append((end - start) / 1000.0)
        last_end = end
    return windows[-len(fns):]


def checked_device_windows(torch, fns, check, what: str) -> list:
    """``device_windows`` of ``fns``, measured again once if ``check`` (of
    the windows) names launches that the profiler did not see as timed.
    Raises if the second session misses them too."""
    for session in (1, 2):
        windows = device_windows(torch, fns)
        missing = check(windows) if len(windows) == len(fns) else f"{len(windows)} windows of {len(fns)}"
        if not missing:
            return windows
        say("profiler", what=repr(what), session=session, missing=missing)
    raise AssertionError(f"{what}: torch.profiler twice saw other launches than were timed: {missing}")


def host_ms(torch, fn, iters: int = 100) -> float:
    """Host time a call of ``fn`` takes to return (its launches enqueued),
    the mean of ``iters`` calls after one warm-up; the card is drained
    before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e3


def _median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def _kernel_device_ms(times: dict, fragment: str, others: int, iters: int = TIMED_LAUNCHES) -> tuple:
    """(median device ms of the kernels named by ``fragment``, median of
    the other kernels of the window or None), or None unless the profiler
    saw one ``fragment`` kernel a call and ``others`` other kernels a call."""
    own = [t for name, ts in times.items() if fragment in name for t in ts]
    rest = [t for name, ts in times.items() if fragment not in name for t in ts]
    if len(own) != iters or len(rest) != others * iters:
        return None
    return _median(own), (_median(rest) if rest else None)


def _library_device_ms(times: dict, iters: int = TIMED_LAUNCHES) -> tuple:
    """(device ms a call, kernels a call) of a library call: every kernel
    of the window, summed, over the calls."""
    return sum(sum(ts) for ts in times.values()) / iters, sum(map(len, times.values())) / iters


def _layer_norm_resources() -> None:
    """What the card makes of the LayerNorm kernels at width 768 in both
    types (``ssip_layer_norm_info``: registers, local bytes a thread, shared
    memory a block, resident blocks an SM) beside ptxas's spill report, and
    the column-sum kernel of the backward."""
    import ctypes

    from ssip_tpu_torch.kernels.build import build, kernel_resources, load_library

    info = load_library().ssip_layer_norm_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    resources = kernel_resources(build().log)
    for which, kernel in enumerate(LN_KERNELS):
        for dtype_name, mangled in (("bfloat16", "13__nv_bfloat16"), ("float32", "f")):
            d = VIT_WIDTH
            out = (ctypes.c_int * 4)()
            err = info(which, int(dtype_name == "bfloat16"), d, out)
            fragment = kernel if which == 2 else f"{kernel}I{mangled}Li{d}E"
            ptxas = [r for name, r in resources.items() if fragment in name]
            if err != 0 or len(ptxas) != 1:
                raise AssertionError(f"{kernel} {dtype_name} at width {d}: cudaError {err}, ptxas reported {ptxas}")
            say("ln", kernel=kernel, dtype=dtype_name if which < 2 else "float32", width=d if which < 2 else "any",
                registers=out[0], local_bytes=out[1], smem_bytes=out[2], blocks_per_sm=out[3],
                spill_stores=ptxas[0]["spill_stores"], spill_loads=ptxas[0]["spill_loads"])
            if which == 2:
                break


def phase_layer_norm_kernels(torch, np) -> dict:
    """``layer_norm`` and ``layer_norm_bwd`` against their plain versions
    on the card; times at the main path's shape, [25216, 768] bfloat16: a
    call's time (CUDA events around the wrapper), the kernels' own device
    time (``torch.profiler``; the backward's column sum apart), the wrapper's
    host time, and the same three of the library. The device times of all
    shapes come from one profiler session, which must see one forward
    kernel a forward call and a backward kernel and a column sum a backward
    call (``checked_device_windows``)."""
    import torch.nn.functional as F

    from ssip_tpu_torch.ops.layernorm import (
        LN_EPS, layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain,
    )

    _layer_norm_resources()
    rng = np.random.default_rng(SEED + 6)
    runs = []
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
        err_dx = (dx.float() - ref_dx.float()).abs().max().item()
        del y, dx, ref_dx, again

        def fwd(x=x, scale=scale, bias=bias):
            return layer_norm(x, scale, bias, LN_EPS)

        def bwd(x=x, scale=scale, dy=dy):
            return layer_norm_bwd(x, scale, dy, LN_EPS)

        # the library's yardstick, timed here and called nowhere in the port
        xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, scale.to(dtype), bias.to(dtype)))
        y_lib = F.layer_norm(xr, (d,), wr, br, LN_EPS)

        def lib_fwd(xr=xr, wr=wr, br=br, d=d):
            return F.layer_norm(xr.detach(), (d,), wr.detach(), br.detach(), LN_EPS)

        def lib_bwd(y_lib=y_lib, xr=xr, wr=wr, br=br, dy=dy):
            return torch.autograd.grad(y_lib, (xr, wr, br), dy, retain_graph=True)

        fwd_ms, fwd_plain_ms = timed_pair(torch, fwd, lambda: layer_norm_plain(x, scale, bias, LN_EPS))
        bwd_ms, bwd_plain_ms = timed_pair(torch, bwd, lambda: layer_norm_bwd_plain(x, scale, dy, LN_EPS))
        item = x.element_size()
        runs.append({
            "n": n, "d": d, "dtype": dtype_name, "calls": (fwd, bwd, lib_fwd, lib_bwd),
            "fwd_bytes": 2 * n * d * item + 2 * d * 4, "bwd_bytes": 3 * n * d * item + 3 * d * 4,
            "checks": {"max_abs_err": err_y, "dx_rel": rel_dx, "dscale_rel": rel_ds, "dbias_rel": rel_db},
            "err_dx": err_dx, "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms, "bwd_ms": bwd_ms,
            "bwd_plain_ms": bwd_plain_ms, "lib_fwd_ms": median_ms(torch, lib_fwd), "lib_bwd_ms": median_ms(torch, lib_bwd),
            "host": [host_ms(torch, fn) for fn in (fwd, bwd, lib_fwd, lib_bwd)],
        })

    def kernels_of(windows):
        return [(_kernel_device_ms(windows[4 * i], "ln_fwd_kernel", 0),
                 _kernel_device_ms(windows[4 * i + 1], "ln_bwd_kernel", 1)) for i in range(len(runs))]

    windows = checked_device_windows(
        torch, [fn for run in runs for fn in run["calls"]],
        lambda w: [f"{r['dtype']} {r['n']}x{r['d']}" for r, k in zip(runs, kernels_of(w)) if None in k], "ln")
    kernels = kernels_of(windows)
    result = {}
    for i, run in enumerate(runs):
        (fwd_dev_ms, _), (bwd_dev_ms, sum_dev_ms) = kernels[i]
        lib_fwd_dev_ms, lib_fwd_kernels = _library_device_ms(windows[4 * i + 2])
        lib_bwd_dev_ms, lib_bwd_kernels = _library_device_ms(windows[4 * i + 3])
        n, d, fwd_bytes, bwd_bytes = run["n"], run["d"], run["fwd_bytes"], run["bwd_bytes"]
        fwd_bound = bound_ms(fwd_bytes, 8 * n * d, "float32")
        bwd_bound = bound_ms(bwd_bytes, 20 * n * d, "float32")
        bwd_total_dev_ms = bwd_dev_ms + sum_dev_ms
        fwd_host, bwd_host, lib_fwd_host, lib_bwd_host = run["host"]

        def gbs(nbytes, ms):
            return f"{nbytes / ms / 1e6:.1f}"

        say("ln", shape=f"{n}x{d}", dtype=run["dtype"], **run["checks"], fwd_ms=f"{run['fwd_ms']:.4f}",
            fwd_device_ms=f"{fwd_dev_ms:.4f}", fwd_host_ms=f"{fwd_host:.4f}", fwd_plain_ms=f"{run['fwd_plain_ms']:.4f}",
            fwd_library_ms=f"{run['lib_fwd_ms']:.4f}", fwd_library_device_ms=f"{lib_fwd_dev_ms:.4f}",
            fwd_library_host_ms=f"{lib_fwd_host:.4f}", fwd_library_kernels=lib_fwd_kernels,
            fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}", fwd_gb_per_s_device=gbs(fwd_bytes, fwd_dev_ms),
            fwd_gb_per_s_call=gbs(fwd_bytes, run["fwd_ms"]),
            fwd_library_gb_per_s_device=gbs(fwd_bytes, lib_fwd_dev_ms), bound_by=fwd_bound["bound_by"])
        say("ln", shape=f"{n}x{d}", dtype=run["dtype"], bwd_ms=f"{run['bwd_ms']:.4f}",
            bwd_device_ms=f"{bwd_dev_ms:.4f}", bwd_sum_device_ms=f"{sum_dev_ms:.4f}",
            bwd_total_device_ms=f"{bwd_total_dev_ms:.4f}", bwd_host_ms=f"{bwd_host:.4f}",
            bwd_plain_ms=f"{run['bwd_plain_ms']:.4f}", bwd_library_ms=f"{run['lib_bwd_ms']:.4f}",
            bwd_library_device_ms=f"{lib_bwd_dev_ms:.4f}", bwd_library_host_ms=f"{lib_bwd_host:.4f}",
            bwd_library_kernels=lib_bwd_kernels, bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}",
            bwd_gb_per_s_device=gbs(bwd_bytes, bwd_total_dev_ms), bwd_gb_per_s_call=gbs(bwd_bytes, run["bwd_ms"]),
            bwd_library_gb_per_s_device=gbs(bwd_bytes, lib_bwd_dev_ms), bound_by=bwd_bound["bound_by"])
        if i == 0:
            result = {
                "layer_norm": {"max_abs_err": run["checks"]["max_abs_err"], "ms": run["fwd_ms"],
                               "device_ms": fwd_dev_ms, "plain_ms": run["fwd_plain_ms"], **fwd_bound,
                               "library_ms": run["lib_fwd_ms"], "library_device_ms": lib_fwd_dev_ms},
                "layer_norm_bwd": {"max_abs_err": run["err_dx"], "ms": run["bwd_ms"], "device_ms": bwd_total_dev_ms,
                                   "plain_ms": run["bwd_plain_ms"], **bwd_bound, "library_ms": run["lib_bwd_ms"],
                                   "library_device_ms": lib_bwd_dev_ms},
            }
    del runs
    torch.cuda.empty_cache()
    return result


def phase_attention_kernels(torch, np) -> dict:
    """``fused_attention_qkv`` and ``attention_qkv_bwd`` against their plain
    versions on the card; times at the main path's shape, [128, 197, 2304]
    bfloat16 with 12 heads."""
    import torch.nn.functional as F

    import ctypes

    from ssip_tpu_torch.kernels.build import build, kernel_resources, load_library
    from ssip_tpu_torch.ops.attention import (
        attention_qkv_bwd, attention_qkv_bwd_plain, attention_qkv_plain, attention_qkv_residuals, fused_attention_qkv,
    )
    from ssip_tpu_torch.runtime.device import configure_precision

    # what ptxas reported for the two tensor-core kernels (dynamic shared
    # memory is set at launch: printed per shape below)
    resources = kernel_resources(build().log)
    for fragment in ATTN_MMA_KERNELS:
        named = {name: r for name, r in resources.items() if fragment in name}
        if not named:
            raise AssertionError(f"ptxas reported nothing for {fragment}")
        for name, r in sorted(named.items()):
            # template arguments: the head width, and for the forward the key chunks of 32
            args = re.search(r"ILi(\d+)E(?:Li(\d+)E)?", name)
            say("attn", ptxas=fragment, head_width=args[1], key_chunks=args[2] or "-", **r)
    f32_info = load_library().ssip_attention_f32_info  # the float32 kernels of both pairs
    f32_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _kernel_resources("attn", f32_info, ATTN_F32_KERNELS)
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
        residuals = attention_qkv_residuals(qkv, heads, kv_len)  # what autograd keeps of the forward
        dqkv = attention_qkv_bwd(qkv, d_o, heads, kv_len, residuals)
        torch.cuda.synchronize()
        tag = f"attention {b}x{s}x{3 * d} heads {heads} kv_len {kv_len} {dtype_name}"
        if not torch.equal(residuals[0], out):
            raise AssertionError(f"{tag}: the forward that saves row statistics gave another output")
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
            torch, lambda: attention_qkv_bwd(qkv, d_o, heads, kv_len, residuals),
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
        ops_type = ATTN_OPS_TYPE[dtype_name]
        fwd_bound = bound_ms((qkv.numel() + out.numel()) * item, 4 * b * heads * s * kv * dh, ops_type)
        bwd_bound = bound_ms((2 * qkv.numel() + d_o.numel()) * item, 10 * b * heads * s * kv * dh, ops_type)
        say("attn", shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len, dtype=dtype_name, max_abs_err=err_o,
            dq_rel=rels[0], dk_rel=rels[1], dv_rel=rels[2], fwd_ms=f"{fwd_ms:.4f}",
            fwd_plain_ms=f"{fwd_plain_ms:.4f}", fwd_library_ms=f"{lib_fwd_ms:.4f}",
            fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_library_ms=f"{lib_bwd_ms:.4f}",
            bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", bound_by=fwd_bound["bound_by"])
        if dtype_name == "bfloat16":
            sp, kvp = -(-s // 16) * 16, -(-kv // 16) * 16
            say("attn", design=repr(ATTN_MMA_DESIGN), shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len,
                fwd_gbytes_per_s=f"{(qkv.numel() + out.numel()) * item / fwd_ms / 1e6:.1f}",
                fwd_bound_share=f"{fwd_bound['bound_ms'] / fwd_ms:.4f}",
                bwd_gbytes_per_s=f"{(2 * qkv.numel() + d_o.numel()) * item / bwd_ms / 1e6:.1f}",
                bwd_bound_share=f"{bwd_bound['bound_ms'] / bwd_ms:.4f}",
                fwd_smem_bytes=4 * kvp * dh + 64 * dh + max(128 * dh, 64 * (kvp + 8)),
                bwd_rows_smem_bytes=(128 + 2 * kvp) * dh * 2, bwd_keys_smem_bytes=(128 + 2 * sp) * dh * 2 + 12 * sp)
        else:
            fwd_stats_ms = median_ms(torch, lambda: attention_qkv_residuals(qkv, heads, kv_len))
            say("attn", design=repr(ATTN_F32_DESIGN), shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len,
                fwd_gbytes_per_s=f"{(qkv.numel() + out.numel()) * item / fwd_ms / 1e6:.1f}",
                **_f32_rates(fwd_ms, fwd_stats_ms, lib_fwd_ms, fwd_bound, bwd_ms, lib_bwd_ms, bwd_bound,
                             b * heads * s * kv * dh))
        if (b, s, heads, kv_len, dtype_name) == ATTN_SHAPES[0]:
            result = {
                "attention_qkv": {"max_abs_err": err_o, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
                                  **fwd_bound, "library_ms": lib_fwd_ms},
                "attention_qkv_bwd": {"max_abs_err": err_dqkv, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                                      **bwd_bound, "library_ms": lib_bwd_ms},
            }
        del qkv, d_o, out, dqkv, leaf, o_lib, residuals
        torch.cuda.empty_cache()
    return result


def _f32_rates(fwd_ms, fwd_stats_ms, lib_fwd_ms, fwd_bound, bwd_ms, lib_bwd_ms, bwd_bound, work) -> dict:
    """The float32 kernels' TF32 rates, bound shares and times over the
    library's. ``work`` is B·H·S·kv·Dh: the forward does 2 products of
    2·work, the backward 7 (dq's kernel 3, dk and dv's 4), each as three
    TF32 products; ``fwd_stats_ms`` is the forward that also saves the row
    statistics (autograd's)."""
    return {"fwd_tflops_3xtf32": f"{3 * 4 * work / fwd_ms / 1e9:.1f}",
            "fwd_bound_share": f"{fwd_bound['bound_ms'] / fwd_ms:.4f}", "fwd_vs_library": f"{fwd_ms / lib_fwd_ms:.4f}",
            "fwd_with_stats_ms": f"{fwd_stats_ms:.4f}", "bwd_tflops_3xtf32": f"{3 * 14 * work / bwd_ms / 1e9:.1f}",
            "bwd_bound_share": f"{bwd_bound['bound_ms'] / bwd_ms:.4f}", "bwd_vs_library": f"{bwd_ms / lib_bwd_ms:.4f}"}


def _qmlp_block(torch, np, rng, d: int, hidden: int):
    """Two int8 sites with seeded kernels and scales that keep the hidden
    values O(1), as calibration would, on the card."""
    from types import SimpleNamespace

    from ssip_tpu_torch.ops.quant import QuantSite

    def site(cin, cout, mult):
        return QuantSite(
            rng.integers(-127, 128, (cin, cout)).astype(np.int8),
            (mult * rng.uniform(0.5, 1.5, cout)).astype(np.float32),
            rng.normal(0.0, 0.1, cout).astype(np.float32), np.float32(127.0 / 4.0), transposed=True,
        ).cuda()

    return SimpleNamespace(mlp_1=site(d, hidden, 1.0 / (np.sqrt(d) * 32.0 * 73.0)),
                           mlp_2=site(hidden, d, 1.0 / (np.sqrt(hidden) * 25.0 * 73.0)))


def phase_qmlp_kernel(torch, np) -> dict:
    """``quantized_mlp`` against its plain version on the card; times at the
    main path's shape, [25216, 768] bfloat16 with hidden 3072. The library
    column is the plain composition itself (two ``torch._int_mm`` and the
    elementwise passes between), timed once more on its own."""
    from ssip_tpu_torch.ops.qmlp import quantized_mlp, quantized_mlp_plain

    rng = np.random.default_rng(SEED + 8)
    result = {}
    for rows, d, hidden, dtype_name in QMLP_SHAPES:
        dtype = getattr(torch, dtype_name)
        blk = _qmlp_block(torch, np, rng, d, hidden)
        y = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).cuda().to(dtype)
        got = quantized_mlp(y, blk)
        ref = quantized_mlp_plain(y, blk)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        off = int((err > QMLP_ATOL + QMLP_RTOL * ref.abs()).sum().item())
        unequal = int((got != ref).sum().item())
        worst, allowed = err.max().item(), 2 * 127 * blk.mlp_2.mult.max().item()
        tag = f"quantized_mlp {rows}x{d} hidden {hidden} {dtype_name}"
        if got.dtype != torch.float32 or got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: {got.dtype} {tuple(got.shape)}")
        if off > QMLP_MAX_SHARE_OFF * got.numel() or worst > allowed:
            raise AssertionError(f"{tag}: {off} of {got.numel()} elements off by more than 1e-5, max |d| {worst} "
                                 f"(allowed {QMLP_MAX_SHARE_OFF:g} of them and {allowed})")
        k_ms, p_ms = timed_pair(torch, lambda: quantized_mlp(y, blk), lambda: quantized_mlp_plain(y, blk))
        lib_ms = median_ms(torch, lambda: quantized_mlp_plain(y, blk))
        nbytes = rows * d * (y.element_size() + 4) + 2 * d * hidden + 2 * (d + hidden) * 4
        bound = bound_ms(nbytes, 4 * rows * d * hidden, "int8")
        say("qmlp", shape=f"{rows}x{d}", hidden=hidden, dtype=dtype_name, elements=got.numel(), off_by_1e_5=off,
            not_bit_equal=unequal, max_abs_err=worst, allowed_max=f"{allowed:.4g}", ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound['bound_ms']:.4f}",
            bound_by=bound["bound_by"], tops=f"{4 * rows * d * hidden / k_ms / 1e9:.1f}")
        if (rows, d, hidden, dtype_name) == QMLP_SHAPES[0]:
            result = {"quantized_mlp": {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, **bound,
                                        "library_ms": lib_ms}}
        del y, got, ref, err, blk
        torch.cuda.empty_cache()
    return result


def _kernel_resources(phase: str, info, fragments) -> None:
    """What the card makes of the tensor-core attention kernels named by
    ``fragments`` at both head widths: registers, local bytes a thread,
    shared memory a block (``cudaFuncGetAttributes`` and the launch's
    dynamic size), resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and ptxas's spill
    report. ``info(which, dh, out)`` is the C entry that fills ``out`` for
    kernel ``which``."""
    import ctypes

    from ssip_tpu_torch.kernels.build import build, kernel_resources

    resources = kernel_resources(build().log)
    for which, fragment in enumerate(fragments):
        for dh in (32, 64):
            out = (ctypes.c_int * 4)()
            err = info(which, dh, out)
            ptxas = [r for name, r in resources.items() if fragment in name and f"ILi{dh}E" in name]
            if err != 0 or len(ptxas) != 1:
                raise AssertionError(f"{fragment} at head width {dh}: cudaError {err}, ptxas reported {ptxas}")
            say(phase, kernel=fragment, head_width=dh, registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3], spill_stores=ptxas[0]["spill_stores"], spill_loads=ptxas[0]["spill_loads"])


def phase_unpacked_attention_kernels(torch, np) -> dict:
    """``fused_attention`` and ``attention_bwd`` on q, k, v [B, H, S, Dh]
    against their plain versions on the card; times at [128, 12, 197, 64]
    bfloat16. In bfloat16 the gradients are also held, element by element,
    to the output's one step, which a p or ds rounded to bf16 once in the
    kernels' products would break."""
    import ctypes

    import torch.nn.functional as F

    from ssip_tpu_torch.kernels.build import load_library
    from ssip_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_plain, attention_residuals, attention_unrounded_plain, fused_attention,
    )
    from ssip_tpu_torch.runtime.device import configure_precision

    info = load_library().ssip_attention_unpacked_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _kernel_resources("attn4", info, UNPACKED_MMA_KERNELS)
    configure_precision("float32")  # the plain version's matmuls in true f32
    rng = np.random.default_rng(SEED + 9)
    result = {}
    for b, heads, s, dh, dtype_name in UNPACKED_ATTN_SHAPES:
        dtype = getattr(torch, dtype_name)
        q, k, v, d_o = (torch.from_numpy(rng.standard_normal((b, heads, s, dh)).astype(np.float32)).cuda().to(dtype)
                        for _ in range(4))
        out = fused_attention(q, k, v)
        residuals = attention_residuals(q, k, v)  # what autograd keeps of the forward
        grads = attention_bwd(q, k, v, d_o, residuals)
        torch.cuda.synchronize()
        tag = f"fused_attention {b}x{heads}x{s}x{dh} {dtype_name}"
        if not torch.equal(residuals[0], out):
            raise AssertionError(f"{tag}: the forward that saves row statistics gave another output")
        err_o = output_error(torch, out, attention_unrounded_plain(q, k, v), tag)
        ref = attention_bwd_plain(q, k, v, d_o)
        rels = [grad_error(g, r, dtype_name, f"{tag} d{part}") for g, r, part in zip(grads, ref, "qkv")]
        if dtype_name == "bfloat16":  # p and ds kept to float32 precision: each element within a step
            for g, r, part in zip(grads, ref, "qkv"):
                output_error(torch, g, r, f"{tag} d{part} by element")
        err_g = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref))
        del ref

        fwd_ms, fwd_plain_ms = timed_pair(torch, lambda: fused_attention(q, k, v),
                                          lambda: attention_unrounded_plain(q, k, v))
        bwd_ms, bwd_plain_ms = timed_pair(torch, lambda: attention_bwd(q, k, v, d_o, residuals),
                                          lambda: attention_bwd_plain(q, k, v, d_o))
        # the library's yardstick, timed here and called nowhere in the port
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_fwd_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        o_lib = F.scaled_dot_product_attention(*leaves)
        lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(o_lib, leaves, d_o, retain_graph=True))
        item = q.element_size()
        ops_type = ATTN_OPS_TYPE[dtype_name]
        fwd_bound = bound_ms(4 * q.numel() * item, 4 * b * heads * s * s * dh, ops_type)
        bwd_bound = bound_ms(7 * q.numel() * item, 10 * b * heads * s * s * dh, ops_type)
        say("attn4", shape=f"{b}x{heads}x{s}x{dh}", dtype=dtype_name, max_abs_err=err_o, dq_rel=rels[0],
            dk_rel=rels[1], dv_rel=rels[2], fwd_ms=f"{fwd_ms:.4f}", fwd_plain_ms=f"{fwd_plain_ms:.4f}",
            fwd_library_ms=f"{lib_fwd_ms:.4f}", fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_library_ms=f"{lib_bwd_ms:.4f}",
            bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", bound_by=fwd_bound["bound_by"])
        if dtype_name == "bfloat16":
            say("attn4", design=repr(UNPACKED_MMA_DESIGN), shape=f"{b}x{heads}x{s}x{dh}",
                fwd_gbytes_per_s=f"{4 * q.numel() * item / fwd_ms / 1e6:.1f}",
                fwd_bound_share=f"{fwd_bound['bound_ms'] / fwd_ms:.4f}",
                bwd_gbytes_per_s=f"{7 * q.numel() * item / bwd_ms / 1e6:.1f}",
                bwd_bound_share=f"{bwd_bound['bound_ms'] / bwd_ms:.4f}")
        else:
            fwd_stats_ms = median_ms(torch, lambda: attention_residuals(q, k, v))
            say("attn4", design=repr(ATTN_F32_DESIGN), shape=f"{b}x{heads}x{s}x{dh}",
                fwd_gbytes_per_s=f"{4 * q.numel() * item / fwd_ms / 1e6:.1f}",
                **_f32_rates(fwd_ms, fwd_stats_ms, lib_fwd_ms, fwd_bound, bwd_ms, lib_bwd_ms, bwd_bound,
                             b * heads * s * s * dh))
        if (b, heads, s, dh, dtype_name) == UNPACKED_ATTN_SHAPES[0]:
            result = {
                "attention": {"max_abs_err": err_o, "ms": fwd_ms, "plain_ms": fwd_plain_ms, **fwd_bound,
                              "library_ms": lib_fwd_ms},
                "attention_bwd": {"max_abs_err": err_g, "ms": bwd_ms, "plain_ms": bwd_plain_ms, **bwd_bound,
                                  "library_ms": lib_bwd_ms},
            }
        del q, k, v, d_o, out, grads, leaves, o_lib, residuals
        torch.cuda.empty_cache()
    return result


def phase_attention_entry(torch, np, counts: LaunchCounts) -> None:
    """The public entry ``fused_attention`` as a caller uses it, through
    autograd: one vit_b16 attention sublayer at batch 128 (seeded qkv
    projection, heads split out to [B, H, S, Dh], loss = Σ o·w), forward and
    backward, in float32 and bfloat16. No pipeline of either package calls
    this entry, so this is its main path. Checked against the packed pair on
    the same values: in float32 the two are one function (2e-5, gradients
    1e-5 of max); in bfloat16 the packed pair rounds p and ds first, which
    moves an output by up to two bfloat16 steps or 2⁻⁸ of the largest, and a
    gradient by up to 2e-2 of its tensor's largest entry."""
    from ssip_tpu_torch.ops.attention import fused_attention, fused_attention_qkv

    rng = np.random.default_rng(SEED + 10)
    b, s, d, heads = BATCH, VIT_TOKENS, VIT_WIDTH, VIT_HEADS
    x32 = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).cuda()
    w32 = torch.from_numpy((rng.standard_normal((d, 3 * d)) * d**-0.5).astype(np.float32)).cuda()
    weight32 = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).cuda()
    counts.reset()  # count only this path's launches
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        qkv = (x32.to(dtype) @ w32.to(dtype)).detach().requires_grad_()
        parts = qkv.view(b, s, 3, heads, d // heads)
        q, k, v = (parts[:, :, i].permute(0, 2, 1, 3).contiguous() for i in range(3))
        o = fused_attention(q, k, v).permute(0, 2, 1, 3).reshape(b, s, d)
        (grad,) = torch.autograd.grad((o.float() * weight32).sum(), qkv)
        packed = qkv.detach().clone().requires_grad_()
        o_packed = fused_attention_qkv(packed, heads)
        (grad_packed,) = torch.autograd.grad((o_packed.float() * weight32).sum(), packed)
        torch.cuda.synchronize()
        if not (torch.isfinite(o).all() and torch.isfinite(grad).all()):
            raise AssertionError(f"fused_attention entry {dtype_name}: non-finite values")
        err = (o.float() - o_packed.float()).abs()
        if dtype_name == "float32":
            tol = torch.full_like(err, F32_ATOL)
            grad_tol = GRAD_RTOL["float32"]
        else:
            step = torch.exp2(torch.floor(torch.log2(o_packed.float().abs().clamp_min(1e-30))) - 7)
            tol = torch.maximum(2 * step, o_packed.float().abs().max() * 2.0**-8)
            grad_tol = 2e-2
        rels = [((grad[..., i * d:(i + 1) * d].float() - grad_packed[..., i * d:(i + 1) * d].float()).abs().max()
                 / grad_packed[..., i * d:(i + 1) * d].float().abs().max()).item() for i in range(3)]
        if not bool((err <= tol).all()) or max(rels) > grad_tol:
            raise AssertionError(f"fused_attention entry {dtype_name}: vs the packed pair max |d| {err.max().item()}, "
                                 f"gradients {rels} of max (allowed {grad_tol})")
        say("entry", fn="fused_attention", shape=f"{b}x{heads}x{s}x{d // heads}", dtype=dtype_name,
            vs_packed_max_abs=err.max().item(), dq_rel=rels[0], dk_rel=rels[1], dv_rel=rels[2])
        del qkv, parts, q, k, v, o, grad, packed, o_packed, grad_packed
    launches = counts.read()
    want = {"attention": 2, "attention_bwd": 2}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"the fused_attention entry launched {launches}, expected {want}")
    say("entry", launches={k: v for k, v in launches.items() if v})
    torch.cuda.empty_cache()


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


def phase_slice(torch, np, tmp: Path, corpus, counts: LaunchCounts, arch: str, width: int, n_cpu: int) -> dict:
    """``run_extraction`` of ``arch`` on the corpus, resident shape, bfloat16
    and float32; for the ViT a profile of the bfloat16 run, for the ResNet
    the per-batch shape too. Returns each type's (embeddings, imgs/s, peak
    GiB)."""
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
    embeddings, rates = {}, {}
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
        rates[dtype] = (N_IMAGES / summary.embed_seconds, peak_gib)
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
    return {dtype: (embeddings[dtype], *rates[dtype]) for dtype in embeddings}


def phase_slice_int8(torch, np, tmp: Path, corpus, counts: LaunchCounts, dense: dict) -> None:
    """``run_extraction`` of vit_b16 with ``compute_dtype="int8"`` on the
    corpus, resident shape, beside the bfloat16 and float32 runs of the same
    seeded weights (``dense``, from ``phase_slice``), then a profiled run."""
    from torch.profiler import ProfilerActivity, profile

    from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, extract_embeddings, run_extraction
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry

    data, records, _, store = corpus
    arch, batches, runs = VIT_ARCH, N_IMAGES // BATCH, 2
    out = tmp / f"out_{arch}_int8"
    cfg = ExtractionConfig(data_dir=data, output_dir=out, batch_size=BATCH, device="cuda", compute_dtype="int8",
                           cache_decoded=False, arch=arch)
    counts.reset()  # count only the main path's launches
    run_extraction(cfg, store=store)  # warm: cuBLASLt and allocator set-up
    torch.cuda.reset_peak_memory_stats()
    summary = run_extraction(cfg, store=store)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = counts.read()
    emb = summary.embeddings
    if emb.shape != (N_IMAGES, VIT_WIDTH) or not np.isfinite(emb).all():
        raise AssertionError(f"{arch} int8: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    reg = ArtifactRegistry(out)
    for path in (reg.embeddings_npy, reg.embeddings_csv, reg.features_metadata_json, reg.feature_summary_md,
                 reg.extraction_log):
        if not path.is_file():
            raise AssertionError(f"{arch} int8: missing artifact {path}")
    meta = json.loads(reg.features_metadata_json.read_text())
    if (meta["weights"] != "random_init:seed=42+int8_ptq" or summary.weights_source != meta["weights"]
            or meta["num_images"] != N_IMAGES or meta["embedding_dimension"] != VIT_WIDTH):
        raise AssertionError(f"{arch} int8: metadata {meta['weights']} {meta['num_images']}")
    # each run: one float32 calibration forward (LayerNorm and attention
    # kernels, no preprocess kernel and no MLP kernel), then a forward a batch
    want = {
        "preprocess_quantize": runs * batches, "quantized_mlp": runs * batches * VIT_BLOCKS,
        "layer_norm": runs * (batches + 1) * VIT_LN_PER_FORWARD,
        "attention_qkv": runs * (batches + 1) * VIT_ATTN_PER_FORWARD, "preprocess_images": 0,
    }
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{arch} int8: the extraction path launched {got}, expected {want}")
    f32_emb, f32_rate, f32_peak = dense["float32"]
    _, bf16_rate, bf16_peak = dense["bfloat16"]
    cos = (_unit(np, emb) * _unit(np, f32_emb)).sum(axis=1)
    if not cos.min() > INT8_COSINE_FLOOR:
        raise AssertionError(f"{arch}: int8 vs f32 per-image cosine min {cos.min()}, floor {INT8_COSINE_FLOOR}")
    rate = N_IMAGES / summary.embed_seconds
    say("int8", arch=arch, images=N_IMAGES, batch=BATCH, embed_s=f"{summary.embed_seconds:.4f}",
        imgs_per_s=f"{rate:.1f}", bf16_imgs_per_s=f"{bf16_rate:.1f}", f32_imgs_per_s=f"{f32_rate:.1f}",
        vs_bf16=f"{rate / bf16_rate:.3f}", e2e_s=f"{summary.total_seconds:.3f}", peak_mem_gib=f"{peak_gib:.2f}",
        bf16_peak_mem_gib=f"{bf16_peak:.2f}", f32_peak_mem_gib=f"{f32_peak:.2f}", weights=meta["weights"])
    say("int8", arch=arch, launches=got, per_forward={"preprocess_quantize": 1, "layer_norm": VIT_LN_PER_FORWARD,
                                                       "attention_qkv": VIT_ATTN_PER_FORWARD,
                                                       "quantized_mlp": VIT_BLOCKS},
        cos_int8_f32_min=f"{cos.min():.6f}", cos_int8_f32_mean=f"{cos.mean():.6f}", floor=INT8_COSINE_FLOOR)

    # once more under the profiler; the embed loop begins at the first
    # preprocess kernel (calibration launches none), so kernels before it are
    # left out of the shares
    cfg = ExtractionConfig(data_dir=data, output_dir=tmp / f"out_{arch}_int8_profiled", batch_size=BATCH,
                           device="cuda", compute_dtype="int8", cache_decoded=False, arch=arch)
    counts.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        summary = extract_embeddings(records, cfg, store=store)
    counts.read()
    _profile_breakdown(torch, prof, summary.embed_seconds * 1e3, f"{arch}_embed_int8", _INT8_PROFILE_CLASSES,
                       start_at="preproc_taps_kernel")


def phase_cli(np, tmp: Path) -> None:
    """The extraction CLI as a subprocess, with a ResNet and with a ViT."""
    from PIL import Image

    data = tmp / "jpegs"
    rng = np.random.default_rng(SEED + 2)
    for rel in ("avec_labels/cancer/a.jpg", "avec_labels/normal/b.jpg",
                "sans_label/c.jpg", "sans_label/d.jpg"):
        (data / rel).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(data / rel)
    for arch, width, dtype in (("resnet18", 512, "bfloat16"), ("vit_t16", 192, "bfloat16"), ("vit_t16", 192, "int8")):
        out = tmp / f"cli_out_{arch}_{dtype}"
        subprocess.run(
            [sys.executable, "-m", "ssip_tpu_torch.cli.feature_extraction", "--data-dir", str(data),
             "--device", "cuda", "--batch-size", "4", "--compute-dtype", dtype, "--arch", arch,
             "--output-dir", str(out)],
            cwd=Path(__file__).resolve().parent, check=True, timeout=600,
        )
        emb = np.load(out / "features" / "embeddings.npy")
        meta = json.loads((out / "features" / "metadata.json").read_text())
        if emb.shape != (4, width) or not np.isfinite(emb).all() or meta["device"] != "cuda:1":
            raise AssertionError(f"cli {arch} {dtype}: embeddings {emb.shape}, device {meta['device']}")
        if meta["weights"].endswith("+int8_ptq") != (dtype == "int8"):
            raise AssertionError(f"cli {arch} {dtype}: weights {meta['weights']}")
        say("cli", arch=arch, dtype=dtype, images=4, width=width, weights=meta["weights"],
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
    ("LayerNorm kernels", LN_KERNELS),
    ("attention kernels", ("attn_qkv", "attn_f32_fwd", "attn_f32_bwd")),
    ("augment kernel", ("train_augment_kernel",)),
    ("preprocess kernel", ("preproc_taps_kernel",)),
    ("AdamW", ("multi_tensor_apply", "adam")),
    ("Dense GEMMs and patch conv (cuBLAS, cuDNN)", ("nvjet", "gemm", "cutlass", "cublas", "xmma", "sm90_", "sm80_",
                                                   "gemv", "splitk", "conv", "cudnn", "implicit", "wgrad", "dgrad")),
    ("GELU, casts, adds, bias and loss (elementwise and reductions)", ("elementwise", "reduce", "vectorized",
                                                                      "unrolled", "index", "where", "softmax",
                                                                      "nll", "scatter", "gelu", "cat", "copy")),
)


# the same for the int8 embed loop: every GEMM in it is a ``torch._int_mm``
_INT8_PROFILE_CLASSES = (
    ("int8 MLP kernel", ("qmlp_kernel",)),
    ("LayerNorm kernels", ("ln_fwd_kernel",)),
    ("attention kernels", ("attn_qkv",)),
    ("preprocess kernel (int8 form)", ("preproc_taps_kernel",)),
    ("int8 GEMMs: stem, qkv, out (torch._int_mm, cuBLASLt)", _VIT_PROFILE_CLASSES[5][1] + ("imma", "igemm", "i8")),
    ("quantize, dequantize, casts and adds (elementwise)", _VIT_PROFILE_CLASSES[6][1]),
)


def _profile_breakdown(torch, prof, window_ms: float, tag: str, classes=_PROFILE_CLASSES, start_at=None) -> None:
    """Device time of the profiled steps by layer and by kernel, and the
    idle share of the window. ``start_at``: a kernel-name fragment; kernels
    before the first kernel that holds it are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    # kernels only: copies between host and card (a corpus being staged) are
    # not work of the window that is measured
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == cuda and not e.name.startswith(("Memcpy", "Memset"))), key=lambda k: k[1])
    if start_at is not None:
        first = next((i for i, k in enumerate(kernels) if start_at in k[0]), len(kernels))
        kernels = kernels[first:]
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


def make_unlabeled_pool(np, train_tree: Path) -> Path:
    """The seeded flat pool ``sans_label/`` beside the labeled tree."""
    from PIL import Image

    pool = train_tree.parent / "sans_label"
    pool.mkdir()
    rng = np.random.default_rng(SEED + 12)
    for i in range(POOL_IMAGES):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(pool / f"unlabeled_{i:04d}.jpg")
    return pool


SEMI_ARTIFACTS = (
    "models/baseline_resnet18.pt", "models/semi_resnet18.pt", "tables/results_comparison.csv",
    "tables/results_comparison_detailed.csv", "tables/unlabeled_predictions_semi.csv",
    "notes/training_history.json", "notes/operating_point.json",
)


def _check_semi_outputs(np, out: Path, arch: str, epochs, tag: str) -> dict:
    """Every artifact of a semi-supervised run, its histories and its two
    checkpoints; returns the history payload."""
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.train.checkpoints import load_checkpoint

    for rel in SEMI_ARTIFACTS:
        if not (out / rel).is_file():
            raise AssertionError(f"{tag}: missing artifact {out / rel}")
    payload = json.loads((out / "notes" / "training_history.json").read_text())
    for phase, n in zip(("baseline", "semi_pretrain", "semi_finetune"), epochs):
        hist = payload[phase]
        if len(hist["val_loss"]) != n or not np.isfinite(hist["train_loss"] + hist["val_loss"]).all():
            raise AssertionError(f"{tag}: {phase} history {hist}")
    if payload["arch"] != arch or not 0 < payload["pseudo_label_count"] <= POOL_IMAGES or "splits" not in payload:
        raise AssertionError(f"{tag}: arch {payload['arch']}, pseudo_label_count {payload['pseudo_label_count']}")
    triage_rows = len((out / "tables" / "unlabeled_predictions_semi.csv").read_text().splitlines()) - 1
    detailed_rows = len((out / "tables" / "results_comparison_detailed.csv").read_text().splitlines()) - 1
    if triage_rows != POOL_IMAGES or detailed_rows != 4:
        raise AssertionError(f"{tag}: triage rows {triage_rows}, detailed rows {detailed_rows}")
    for name in ("baseline_resnet18.pt", "semi_resnet18.pt"):
        load_checkpoint(out / "models" / name, build_model(arch, num_classes=2, image_size=TRAIN_SIZE))
    return payload


def phase_semi(torch, np, tmp: Path, data: Path, pool: Path, counts: LaunchCounts, arch: str, dtypes, cli_arch: str) -> None:
    """``run_pipeline`` of ``arch`` with the FixMatch fine-tune on the JPEG
    tree and pool, once per compute type, then the semi-supervised CLI with
    ``cli_arch`` for one epoch per phase. The pipeline's two epoch loops are
    wrapped to read what no artifact holds: the state after the weak
    pretrain, and the keep rates (cut from the history file)."""
    from ssip_tpu_torch.data.discovery import labeled_folder
    from ssip_tpu_torch.data.splits import split_dict
    from ssip_tpu_torch.pipelines import semi_supervised as semi
    from ssip_tpu_torch.pipelines.supervised import TrainingConfig
    from ssip_tpu_torch.train.engine import head_only_mask

    _, targets, _ = labeled_folder(data)
    steps_per_epoch = -(-len(split_dict(targets, 0.2, 0.2, 42)["train"]) // TRAIN_BATCH)
    real_train_model, real_train_fixmatch = semi.train_model, semi.train_fixmatch
    seen = {}

    def train_model_spy(state, *args, **kwargs):
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        result = real_train_model(state, *args, **kwargs)
        if kwargs["stream_name"] == "semi_pretrain":
            seen["mask"] = kwargs["trainable_mask"] == head_only_mask(state.model)
            after = state.model.state_dict()
            seen["moved"] = sorted(k for k in before if not torch.equal(before[k], after[k]))
        return result

    def train_fixmatch_spy(*args, **kwargs):
        state, history = real_train_fixmatch(*args, **kwargs)
        seen["keep_rate"] = float(np.mean(history["consistency_keep_rate"]))
        seen["cons_loss"] = history["consistency_loss"]
        return state, history

    for dtype in dtypes:
        out = tmp / f"semi_out_{arch}_{dtype}"
        cfg = TrainingConfig(
            strong_data_dir=data, weak_data_dir=pool, output_dir=out, device="cuda", batch_size=TRAIN_BATCH, arch=arch,
            image_size=TRAIN_SIZE, baseline_epochs=SEMI_EPOCHS[0], weak_pretrain_epochs=SEMI_EPOCHS[1],
            finetune_epochs=SEMI_EPOCHS[2], target_recall=0.9, compute_dtype=dtype,
            pseudo_label_threshold=SEMI_THRESHOLD, consistency_weight=1.0, consistency_threshold=SEMI_THRESHOLD,
            ema_decay=SEMI_EMA_DECAY,
        )
        seen.clear()
        semi.train_model, semi.train_fixmatch = train_model_spy, train_fixmatch_spy
        counts.reset()  # count only the main path's launches
        t0 = time.perf_counter()
        try:
            results = semi.run_pipeline(cfg)
        finally:
            semi.train_model, semi.train_fixmatch = real_train_model, real_train_fixmatch
        seconds = time.perf_counter() - t0
        launches = counts.read()
        tag = f"semi {arch} {dtype}"
        payload = _check_semi_outputs(np, out, arch, SEMI_EPOCHS, tag)
        if not (seen["keep_rate"] > 0 and np.isfinite(seen["cons_loss"]).all()):
            raise AssertionError(f"{tag}: keep rate {seen['keep_rate']}, consistency losses {seen['cons_loss']}")
        # after the weak pretrain: of the parameters only the head moved; a
        # ResNet's frozen backbone still moved its BatchNorm running means
        head = ("fc.", "heads.head.")
        moved_params = [k for k in seen["moved"] if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
        moved_means = [k for k in seen["moved"] if k.endswith("running_mean")]
        if not seen["mask"] or not moved_params or not all(k.startswith(head) for k in moved_params):
            raise AssertionError(f"{tag}: the weak pretrain moved {moved_params[:6]}")
        if arch != VIT_ARCH and not moved_means:
            raise AssertionError(f"{tag}: the weak pretrain left every BN running mean where it was")
        fix_steps = SEMI_EPOCHS[2] * steps_per_epoch
        pretrain_steps = SEMI_EPOCHS[1] * -(-payload["pseudo_label_count"] // TRAIN_BATCH)
        backward_steps = SEMI_EPOCHS[0] * steps_per_epoch + pretrain_steps + fix_steps
        want = {"rotate_images": fix_steps, "augment_images": backward_steps}
        if arch == VIT_ARCH:
            # a FixMatch step's backward runs through the labeled and the
            # strong view; the weak pretrain's stops at the head (the frozen
            # backbone needs no gradient), so it launches no backward kernel
            backwards = SEMI_EPOCHS[0] * steps_per_epoch + 2 * fix_steps
            want.update(layer_norm_bwd=backwards * VIT_LN_PER_FORWARD,
                        attention_qkv_bwd=backwards * VIT_ATTN_PER_FORWARD)
            forwards = launches["attention_qkv"] // VIT_ATTN_PER_FORWARD
            if forwards <= backward_steps + 2 * fix_steps or launches["layer_norm"] != forwards * VIT_LN_PER_FORWARD:
                raise AssertionError(f"{tag}: forward launches {launches}")
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{tag}: the semi-supervised path launched {got}, expected {want}")
        thr = results["semi_thresholded"]
        say("semi", arch=arch, dtype=dtype, labeled=2 * TRAIN_PER_CLASS, pool=POOL_IMAGES, batch=TRAIN_BATCH,
            epochs=SEMI_EPOCHS, seconds=f"{seconds:.2f}", pseudo_labels=payload["pseudo_label_count"],
            fixmatch_steps=fix_steps, keep_rate=f"{seen['keep_rate']:.3f}",
            cons_loss=f"{seen['cons_loss'][-1]:.4f}", val_loss=f"{payload['semi_finetune']['val_loss'][-1]:.4f}",
            test_f1=f"{thr['f1']:.4f}", threshold=f"{thr['threshold']:.4f}", pretrain_moved=len(moved_params),
            bn_means_moved=len(moved_means), launches={k: v for k, v in launches.items() if v})

    out = tmp / f"semi_cli_out_{cli_arch}"
    subprocess.run(
        [sys.executable, "-m", "ssip_tpu_torch.cli.semi_supervised_training", "--strong-data-dir", str(data),
         "--weak-data-dir", str(pool), "--device", "cuda", "--baseline-epochs", "1", "--weak-pretrain-epochs", "1",
         "--finetune-epochs", "1", "--target-recall", "0.9", "--arch", cli_arch, "--pseudo-threshold",
         str(SEMI_THRESHOLD), "--consistency-weight", "1.0", "--consistency-threshold", str(SEMI_THRESHOLD),
         "--ema-decay", str(SEMI_EMA_DECAY), "--output-dir", str(out)],
        cwd=Path(__file__).resolve().parent, check=True, timeout=600,
    )
    payload = _check_semi_outputs(np, out, cli_arch, (1, 1, 1), f"semi cli {cli_arch}")
    say("semi", cli="semi_supervised_training", arch=cli_arch, epochs=(1, 1, 1),
        pseudo_labels=payload["pseudo_label_count"], val_loss=f"{payload['semi_finetune']['val_loss'][0]:.4f}")


def _fixmatch_inputs(torch, np, b: int, padded_rows: int = 0):
    """(labeled batch, unlabeled images) on the CPU, seeded."""
    rng = np.random.default_rng(SEED + 13 + b)
    unlabeled = torch.from_numpy(rng.integers(0, 256, (b, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8))
    return _step_inputs(torch, np, b, padded_rows), unlabeled


def _one_fixmatch_step(torch, arch: str, dev, batch, unlabeled, draws, kink_free: bool = False, ln_views=None):
    """One float32 FixMatch step with an EMA teacher at the seeded weights on
    ``dev``: (losses and keep rate, gradients, BN running statistics), on
    the CPU. Given a list ``ln_views``, a ViT's final LayerNorm appends to
    it, for each view that is differentiated, its input ``x``, its ``scale``
    and the gradient ``dy`` that reaches its output."""
    from ssip_tpu_torch.train.consistency import fixmatch_step, init_ema

    state = _seeded_state(torch, dev, torch.float32, arch, kink_free)
    handle = None
    if ln_views is not None:
        def capture(module, inputs, output):
            if output.requires_grad:  # the labeled and the strong view; the teacher's runs without grad
                view = {"x": inputs[0].detach().clone(), "scale": module.weight.detach().clone()}
                output.register_hook(lambda g: view.__setitem__("dy", g.detach().clone()))
                ln_views.append(view)

        handle = state.model.encoder.ln.register_forward_hook(capture)
    try:
        out = fixmatch_step(
            state, init_ema(state.model), *(t.to(dev) for t in batch), unlabeled.to(dev), draws.to(dev),
            consistency_weight=1.0, confidence_threshold=SEMI_THRESHOLD, ema_decay=SEMI_EMA_DECAY,
        )
    finally:
        if handle is not None:
            handle.remove()
    return ([t.cpu() for t in out[:4]], {k: p.grad.cpu() for k, p in state.model.named_parameters()},
            {k: v.cpu() for k, v in state.model.state_dict().items() if "running" in k})


def _final_layer_norm_views(torch, card_views, cpu_views) -> None:
    """Where ``encoder.ln.bias`` parts between the card's and the CPU's
    FixMatch step: for each differentiated view, the LayerNorm backward
    kernel and its plain float32 version on the card's own ``x`` and ``dy``,
    each against the plain version in float64 on the same tensors, and how
    far the card's ``x`` and ``dy`` already stand from the CPU's. Raises if
    the kernel's dscale or dbias leaves 1e-5 of max of the float64 value."""
    from ssip_tpu_torch.ops.layernorm import LN_EPS, layer_norm_bwd, layer_norm_bwd_plain

    if len(card_views) != 2 or len(cpu_views) != 2:
        raise AssertionError(f"final LayerNorm captured {len(card_views)} card and {len(cpu_views)} CPU views, not 2")
    card_sum, cpu_sum = 0.0, 0.0
    for name, card, cpu in zip(("labeled", "strong"), card_views, cpu_views):
        x, scale, dy = card["x"], card["scale"], card["dy"]
        _, k_ds, k_db = layer_norm_bwd(x, scale, dy, LN_EPS)
        _, p_ds, p_db = layer_norm_bwd_plain(x, scale, dy, LN_EPS)
        # the plain version computes in float32 whatever it is given: float64 written out here
        x64, dy64 = x.double(), dy.double()
        xc = x64 - x64.mean(dim=-1, keepdim=True)
        ref_ds = (dy64 * xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)).sum(dim=0)
        ref_db = dy64.sum(dim=0)
        _, c_ds, c_db = layer_norm_bwd_plain(cpu["x"], cpu["scale"], cpu["dy"], LN_EPS)
        say("fixmatch_step", arch=VIT_ARCH, check="final_layer_norm", view=name, rows=tuple(x.shape),
            kernel_dbias_vs_f64=_rel(k_db.double(), ref_db), plain_f32_dbias_vs_f64=_rel(p_db.double(), ref_db),
            kernel_dscale_vs_f64=_rel(k_ds.double(), ref_ds), plain_f32_dscale_vs_f64=_rel(p_ds.double(), ref_ds),
            card_dy_vs_cpu=_rel(dy.cpu(), cpu["dy"]), card_x_vs_cpu=_rel(x.cpu(), cpu["x"]),
            card_dbias_vs_cpu=_rel(k_db.cpu(), c_db), card_dscale_vs_cpu=_rel(k_ds.cpu(), c_ds),
            dbias_max=c_db.abs().max().item())
        card_sum, cpu_sum = card_sum + k_db.cpu(), cpu_sum + c_db
        grad_error(k_db, ref_db.float(), "float32", f"final LayerNorm {name} view dbias against float64")
        grad_error(k_ds, ref_ds.float(), "float32", f"final LayerNorm {name} view dscale against float64")
    # the step's encoder.ln.bias gradient is the two views' sum
    say("fixmatch_step", arch=VIT_ARCH, check="final_layer_norm", view="both", dbias_max=cpu_sum.abs().max().item(),
        card_dbias_vs_cpu=_rel(card_sum, cpu_sum))


def _fixmatch_cuda_vs_cpu(torch, np, arch: str, kink_free: bool) -> dict:
    from ssip_tpu_torch.train.consistency import epoch_view_draws

    b = STEP_CHECK_BATCH
    batch, unlabeled = _fixmatch_inputs(torch, np, b, padded_rows=1)
    draws = epoch_view_draws(SEED, "smoke_fixmatch", 0, 1, b, b, torch.device("cpu"))[0]
    views = {"cpu": [], "cuda": []} if arch == VIT_ARCH else {"cpu": None, "cuda": None}
    (m_cpu, g_cpu, s_cpu), (m_gpu, g_gpu, s_gpu) = (
        _one_fixmatch_step(torch, arch, torch.device(dev), batch, unlabeled, draws, kink_free, views[dev])
        for dev in ("cpu", "cuda")
    )
    if arch == VIT_ARCH:
        _final_layer_norm_views(torch, views["cuda"], views["cpu"])
    stem = STEM_GRAD if arch == "resnet18" else None
    r = {
        "loss": m_cpu[0].item(), "cons_loss": m_cpu[2].item(), "keep_rate": m_cpu[3].item(),
        "loss_rel": _rel(m_gpu[0], m_cpu[0]), "keep_equal": torch.equal(m_gpu[3], m_cpu[3]),
        "grad_rel": max(_rel(g_gpu[k], g_cpu[k]) for k in g_cpu if k != stem),
        "grad_worst": max((k for k in g_cpu if k != stem), key=lambda k: _rel(g_gpu[k], g_cpu[k])),
        "grads_beyond_1e_3": sum(_rel(g_gpu[k], g_cpu[k]) > 1e-3 for k in g_cpu if k != stem),
        "grad_l2_all": float(sum((g_gpu[k] - g_cpu[k]).double().pow(2).sum() for k in g_cpu).sqrt()
                             / sum(g_cpu[k].double().pow(2).sum() for k in g_cpu).sqrt()),
    }
    if stem:
        r["stem_l2"] = float((g_gpu[stem] - g_cpu[stem]).norm() / g_cpu[stem].norm())
        r["stat_rel"] = max(_rel(s_gpu[k], s_cpu[k]) for k in s_cpu)
    return r


def _timed_fixmatch_steps(torch, np, arch: str, counts: LaunchCounts, classes) -> None:
    """The steady-state FixMatch step at 128 labeled + 128 unlabeled in
    bfloat16 and float32: timed, the strong view alone beside it, then
    profiled."""
    from torch.profiler import ProfilerActivity, profile

    from ssip_tpu_torch.ops.augment import strong_augment
    from ssip_tpu_torch.train.consistency import epoch_view_draws, fixmatch_step, init_ema

    b = STEP_TIMED_BATCH
    dev = torch.device("cuda")
    batch, unlabeled = _fixmatch_inputs(torch, np, b)
    images, labels, valid = (t.to(dev) for t in batch)
    unlabeled = unlabeled.to(dev)
    n_steps = STEP_WARMUP + STEP_TIMED
    draws = epoch_view_draws(SEED, "smoke_fixmatch", 1, 2 * n_steps, b, b, dev)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        state = _seeded_state(torch, dev, dtype, arch)
        ema = init_ema(state.model)

        def step(s):
            return fixmatch_step(state, ema, images, labels, valid, unlabeled, draws[s], consistency_weight=1.0,
                                 confidence_threshold=SEMI_THRESHOLD, ema_decay=SEMI_EMA_DECAY)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for s in range(STEP_WARMUP):
            step(s)
        counts.reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(STEP_WARMUP, n_steps):
            loss, _, cons, keep, _ = step(s)
        end.record()
        end.synchronize()
        launches = {k: v / STEP_TIMED for k, v in counts.read().items() if v}
        step_ms = start.elapsed_time(end) / STEP_TIMED
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if not (torch.isfinite(loss) and torch.isfinite(cons)):
            raise AssertionError(f"{arch} {dtype_name} FixMatch step loss {loss.item()}, consistency {cons.item()}")
        want = {"augment_images": 1.0, "rotate_images": 1.0}
        if arch == VIT_ARCH:
            want.update(layer_norm=3 * VIT_LN_PER_FORWARD, layer_norm_bwd=2 * VIT_LN_PER_FORWARD,
                        attention_qkv=3 * VIT_ATTN_PER_FORWARD, attention_qkv_bwd=2 * VIT_ATTN_PER_FORWARD)
        if launches != want:
            raise AssertionError(f"{arch} {dtype_name}: launches per FixMatch step {launches}, expected {want}")
        d = draws[0]
        strong_ms = median_ms(torch, lambda: strong_augment(unlabeled, d.strong_coeffs, d.brightness, d.contrast,
                                                            dtype))
        counts.reset()  # the strong view timed alone is no launch of the path
        say("fixmatch_step", arch=arch, dtype=dtype_name, labeled=b, unlabeled=b, timed_steps=STEP_TIMED,
            ms_per_step=f"{step_ms:.3f}", imgs_per_s=f"{2 * b / step_ms * 1000:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
            keep_rate=f"{keep.item():.3f}", strong_view_ms=f"{strong_ms:.4f}",
            strong_view_share=f"{strong_ms / step_ms:.5f}", launches_per_step=launches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for s in range(n_steps, n_steps + STEP_TIMED):
                step(s)
            end.record()
            end.synchronize()
        counts.read()
        _profile_breakdown(torch, prof, start.elapsed_time(end), f"{arch}_fixmatch_step_{dtype_name}", classes)
        del state, ema
    torch.cuda.empty_cache()


def phase_fixmatch_step(torch, np, counts: LaunchCounts) -> None:
    """One FixMatch step cuda vs CPU for each arch, then the steady-state
    step."""
    from ssip_tpu_torch.runtime.device import configure_precision

    configure_precision("float32")
    # ResNet-18: loss, keep mask and BN statistics at the seeded weights;
    # gradients where no ReLU input sits at the kink (KINK_FREE_BN_BIAS)
    seeded = _fixmatch_cuda_vs_cpu(torch, np, "resnet18", False)
    shifted = _fixmatch_cuda_vs_cpu(torch, np, "resnet18", True)
    for tag, r in (("seeded", seeded), ("kink_free", shifted)):
        say("fixmatch_step", arch="resnet18", check=f"cuda_vs_cpu_f32_{tag}", labeled=STEP_CHECK_BATCH,
            unlabeled=STEP_CHECK_BATCH, padded_rows=1, **r)
    if (seeded["loss_rel"] > 1e-5 or seeded["stat_rel"] > 1e-5 or not seeded["keep_equal"]
            or shifted["loss_rel"] > 1e-5 or shifted["grad_rel"] > FIXMATCH_GRAD_RTOL
            or shifted["grad_l2_all"] > FIXMATCH_GRAD_L2_ALL or shifted["stem_l2"] > 1e-2):
        raise AssertionError(f"FixMatch step cuda vs cpu out of bounds: seeded {seeded}, kink-free {shifted}")
    _timed_fixmatch_steps(torch, np, "resnet18", counts, (("rotate kernel", ("rotate_u8_kernel",)),) + _PROFILE_CLASSES)

    r = _fixmatch_cuda_vs_cpu(torch, np, VIT_ARCH, False)
    say("fixmatch_step", arch=VIT_ARCH, check="cuda_vs_cpu_f32_seeded", labeled=STEP_CHECK_BATCH,
        unlabeled=STEP_CHECK_BATCH, padded_rows=1, **r)
    if (r["loss_rel"] > 1e-5 or r["grad_rel"] > FIXMATCH_GRAD_RTOL or r["grad_l2_all"] > FIXMATCH_GRAD_L2_ALL
            or not r["keep_equal"]):
        raise AssertionError(f"{VIT_ARCH} FixMatch step cuda vs cpu out of bounds: {r}")
    _timed_fixmatch_steps(torch, np, VIT_ARCH, counts, (("rotate kernel", ("rotate_u8_kernel",)),) + _VIT_PROFILE_CLASSES)


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
    measured = {**phase_kernel(torch, np), "augment_images": phase_rotate_kernel(torch, np),
                **phase_layer_norm_kernels(torch, np), **phase_attention_kernels(torch, np),
                **phase_qmlp_kernel(torch, np), **phase_unpacked_attention_kernels(torch, np),
                "rotate_images": phase_rotate_u8_kernel(torch, np)}
    phase_attention_entry(torch, np, counts)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        corpus = make_corpus(np, tmp)
        phase_slice(torch, np, tmp, corpus, counts, "resnet18", 512, N_CPU_CHECK)
        dense = phase_slice(torch, np, tmp, corpus, counts, VIT_ARCH, VIT_WIDTH, VIT_N_CPU_CHECK)
        phase_slice_int8(torch, np, tmp, corpus, counts, dense)
        del corpus, dense
        phase_cli(np, tmp)
        train_tree = make_train_tree(np, tmp)
        phase_train(torch, np, tmp, train_tree, counts, "resnet18",
                    (("float32", TRAIN_EPOCHS), ("bfloat16", TRAIN_EPOCHS)), "resnet18")
        phase_train(torch, np, tmp, train_tree, counts, VIT_ARCH,
                    (("bfloat16", TRAIN_EPOCHS), ("float32", 1)), "vit_t16")
        pool = make_unlabeled_pool(np, train_tree)
        phase_semi(torch, np, tmp, train_tree, pool, counts, "resnet18", ("float32", "bfloat16"), "resnet18")
        phase_semi(torch, np, tmp, train_tree, pool, counts, VIT_ARCH, ("bfloat16",), "vit_t16")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_step(torch, np, counts)
    phase_vit_step(torch, np, counts)
    phase_fixmatch_step(torch, np, counts)
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
