#!/usr/bin/env python3
"""Drive the PyTorch port's extraction, training and semi-supervised slices, the
threshold sweep, the analysis stack, serving and export, and the whole workflow
once on one NVIDIA GPU, for the ResNet family, the ViT family and the MoE ViT,
int8 extraction included, with resumed training, the streamed extraction
shape, the seed and cross-validation fan-outs, FixMatch's RandAugment strong
view, the folded-BN extraction, data parallelism (FSDP, two ranks on the
card, ``--shard-size``, the sharded snapshots) and the model axis (tensor and
expert parallelism, GPipe, ring attention, on two ranks sharing the card).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, a few output lines each; any failure raises and the script exits
non-zero without printing the final line:

1. env     the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build   nvcc builds ``ssip_tpu_torch/csrc/*.cu`` for sm_90a, one process
           per source (seconds), while phase 11's analysis stack, which
           launches no hand kernel, runs on the card;
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
           within that step times the scale elsewhere; its bound counts the
           source pixels the crop's taps reach (rows read × columns read × 3
           a batch) and the output;
   rotate  ``augment_images`` (flip → rotate → normalize): bitwise in
           float32 and bfloat16 at [128, 224, 224, 3], [16, 224, 160, 3] and
           [8, 64, 96, 3], drawn angles in ±10° and pinned ±10°, ±25°;
   rotate_u8  ``rotate_images`` (flip → rotate, uint8 in and out): bitwise
           against ``rotate_nearest`` at [128, 224, 224, 3], [16, 224, 160, 3],
           [8, 64, 96, 3] and [4, 64, 36, 3], with drawn angles in ±10° (two
           pinned at ±10°) and in ±25° (four pinned at ±10° and ±25°), flip
           flags mixed and all off;
   the three print, per output type, the call's time (CUDA events around
           the wrapper), the kernel's own device time (``torch.profiler``,
           ``*_device_ms``) and the wrapper's host time (``*_host_ms``);
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
           of vit_t16, and in both types at 257, 577, 1024, 1025 and 1297
           tokens (vit_b16 at 256², 384², 512², 576²), some with pad keys,
           and bfloat16 at 256 (the whole-head kernels' longest); pad-query
           rows are compared too and get a non-zero dO; each bf16 backward
           bitwise on a second call, one kernel a call up to 256 tokens and
           the streamed two past it (``torch.profiler``); also
           bytes/s and bound/time, ptxas's registers, shared memory and
           spills of the tensor-core kernels, which bf16 forward runs at
           each shape and its resources, the float32 TF32 rates and times
           over the library's; at [128, 197, 2304] in both types the
           device time of a forward and a backward call and of the
           library's two (``torch.profiler``, every kernel of the call), in
           bfloat16 also SDPA's own backward on contiguous q, k, v;
   qmlp    ``quantized_mlp`` at [25216, 768] (hidden 3072) in bfloat16 and
           float32, [300, 192] and [1001, 384]: at most 1e-3 of the elements
           off the plain version by more than 1e-5 (absolute and relative),
           none by more than 2·127·max(m2); the counts are printed; beside
           the call's time the two kernels' device times (``torch.profiler``)
           and the two ``torch._int_mm`` products of the same GEMMs alone
           (``int_mm_ms``), and the kernels' registers, spills, shared memory
           and resident blocks an SM;
   attn4   ``fused_attention`` and ``attention_bwd`` on q, k, v
           [128, 12, 197, 64] in bfloat16 (the kernels of
           ``csrc/attention_unpacked_mma.cu``, every product on the tensor
           cores, p and ds as bf16 hi/lo pairs) and float32 (the packed
           pair's float32 kernels), 3 heads, [8, 2, 50, 32], float32 at
           [128, 12, 256, 64], and in both types past 256 tokens:
           [16, 12, 577, 64] (ViT-B/16 at 384²), [4, 12, 1024, 64], and in
           bfloat16 [2, 4, 1024, 32]; at attn's tolerances, and in bfloat16 each
           element of dq, dk and dv also within the output's one step; past
           1024 tokens (1025, 1297), where the JAX entry rounds p, held to
           ``attention_plain`` and ``attention_rounded_bwd_plain`` (the bf16
           calls run the packed pair's kernels); the three bf16 kernels'
           registers, spills, shared memory a block and resident blocks an SM;
           at [128, 12, 197, 64] in both types the device times, as attn;
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
   int8_resnet  the same corpus through ``run_extraction`` with
           ``compute_dtype="int8"`` for resnet18 (twice, the second run
           timed), the stem's operand from the preprocess kernel's int8
           epilogue: finite, ``+int8_ptq``, cosine against the float32 run
           above 0.99 on every image, one preprocess-quantize launch a batch;
           then each distinct int8 convolution of the forward (im2col and
           ``torch._int_mm``) at batch 128, card against CPU (equal
           integers), its time beside ``torch._int_mm`` alone and its bound;
   fold    the same corpus through ``run_extraction`` of resnet18 in
           bfloat16 with ``fast_inference`` (the folded-BN forward) and
           without, in the order plain, folded, folded, plain: per-image
           cosine > 0.995, the largest difference, each forward's embed-loop
           imgs/s, a profile of each loop; the folded forward in float32
           within 1e-4 of the plain one on 128 images;
   entry   ``fused_attention`` (no pipeline calls it, in either package)
           driven through autograd on the q, k, v of one vit_b16 attention
           sublayer at batch 128, float32 and bfloat16, against the packed
           pair on the same values;
5. cli     the extraction CLI on a small 512² JPEG tree (needs Pillow), with
           resnet18 in bfloat16 and with vit_t16 in int8, the two processes
           at once;
6. train   a seeded 100-image 512² JPEG tree ``avec_labels/{cancer,normal}``
           (50 + 50) through ``run_supervised`` on cuda at 224², 2 classes,
           batch 16, target recall 0.9: resnet18 for 1 epoch in float32
           (TF32 off) and bfloat16, vit_b16 for 1 epoch in bfloat16 and in
           float32, vit_t16 (width 192, 3 heads) for 1 epoch in bfloat16.
           Every artifact is written, the history holds finite
           losses, the ``.pt`` loads into the port's model, the split indices
           are those of the CPU split, and the kernels launched (for vit_b16
           25 + 25 LayerNorm and 12 + 12 attention launches per train step);
           and vit_b16 past 224² (``vit_long``): 1 epoch at 256²
           (257 tokens) and 512² (1,025) in bfloat16 and at 512² in float32,
           with the same checks (the training CLI runs in ``workflow`` and
           ``dp``);
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
           under ``torch.profiler`` (device kernels only, after a lead-in
           step and a 50 ms sleep, cut at the trace's largest gap, which
           must be the sleep: tracing the host's ops too slows the
           host-bound steps it reads): device time by layer, the top
           kernels and the idle share;
8. semi    the same labeled tree plus a flat ``sans_label/`` pool of 256
           seeded 512² JPEGs through ``run_pipeline`` (baseline → pseudo-label
           → head-only pretrain → FixMatch fine-tune with an EMA teacher) on
           cuda at 224², batch 16, 1 + 1 + 1 epochs, both thresholds 0.5:
           resnet18 in float32 and bfloat16, vit_b16 in bfloat16. Every
           artifact is written, the histories are finite, pseudo-labels were
           kept and the mean keep rate is above 0, after the pretrain only
           the head differs from the seeded init while BN running means do
           differ, both ``.pt`` load, one ``rotate_images`` launch per
           FixMatch step and one ``augment_images`` launch per augmented
           step, and for vit_b16 2 × 25 LayerNorm and 2 × 12 attention
           backward launches per FixMatch step and none in the head-only
           pretrain (the semi-supervised CLI runs in ``workflow``);
   serve   from the run directories of ``semi`` (resnet18 float32,
           vit_b16 bfloat16): the card's resize of 128 pool JPEGs 512→224
           against the CPU's, bit for bit (a value off raises; both add
           each output's taps in one order), ``ScreeningPredictor`` on
           the card against the CPU (float32, products pinned, 8 images,
           1e-4), the ``export_model`` CLI's artifact (``torch.export``,
           traced on the card) against the in-process predictor at batch 1, 3
           and 128 (float32 1e-6, bfloat16 1e-3), for vit_b16 with 25
           LayerNorm and 12 attention launches a forward inside the exported
           program, images/s at 128; the float32 artifact on the CPU (1e-5)
           and, for vit_b16, one traced on the CPU run on the card (1e-5, the
           kernels launched); an int8 resnet18 artifact against the
           float32 one (0.25); the ``serve`` CLI's server on 127.0.0.1, port
           0, answering /healthz, /manifest, 17 /predict of 512² JPEGs (urllib
           and a client with Nagle's algorithm off) and one /predict_paths,
           ms a request beside the same work in process;
9. fixmatch_step  one FixMatch step on cuda against the same step on the
           CPU (float32, TF32 off, 8 labeled + 8 unlabeled, same weights and
           draws, EMA teacher): loss ≤ 1e-5 relative, gradients ≤ 1e-3 of
           each tensor's max and ≤ 1e-4 in L2 over all tensors (resnet18 at
           the kink-free weights, its stem ≤ 1e-2 in L2; vit_b16 at the
           seeded ones), the tensors past 1e-3 named with their ratios. The
           tensors of ``FIXMATCH_F64_CHECKED`` are held instead to float64:
           each differentiated view's ``x`` and ``dy`` of their module are
           captured on both devices and each device's float32 reduction
           (the final LayerNorm's: the backward kernel's) is held to float64
           on its own tensors, printed beside how far the card's ``x`` and
           ``dy`` stand from the CPU's and the sum's conditioning; for
           resnet18 the ReLU inputs after ``layer2.0.bn1`` that lie on either
           side of 0 on the two devices are counted, and its three tensors
           recomputed in float64 without them are held to 1e-3 card vs CPU.
           A tensor past 1e-3 that the list does not name fails. Then the
           steady-state step at 128 + 128 in bfloat16 and float32 (3
           warm-ups, 10 timed): imgs/s
           (labeled + unlabeled), ms a step, peak memory, launches a step
           (vit_b16: 3 × 25 and 3 × 12 forward, 2 × 25 and 2 × 12 backward),
           the strong view's time alone and its share of the step, and a
           ``torch.profiler`` split with the idle share;
10. sweep  ``run_sweep`` on the baseline ``.pt`` of the resnet18 and vit_b16
           bfloat16 runs of ``train`` (float32 eval, TF32 off; for vit_b16 25
           LayerNorm and 12 attention launches per forward) on cuda and on the
           CPU: the same CSV rows, thresholds within 1e-4, equal confusion
           counts but where two thresholds lie within twice that, the same
           JSON line;
11. analysis  the analysis stack at the reference corpus's size, 1,506
           seeded 512-D embedding-like rows (100 labeled; 20 exact
           duplicates), each function on cuda and on the CPU on the same
           inputs, with its seconds on both (``beside_build``: taken while
           the kernels build, not the function's alone): the scaler
           (1e-5), PCA (each
           of the first 50 axes within 1e-3, axes whose variances lie within
           1 % compared as the subspace they span, the variance ratios
           within 1e-4 of the largest), t-SNE at perplexity 10,
           30, 50 (KL within 10 % and neighbour preservation within 0.05:
           a 1000-step optimization is chaotic), UMAP at 15/30/50 neighbours
           × min-dist 0/0.1 (neighbour preservation within 0.05), k-means
           for k = 2-10 with 10 restarts (ARI ≥ 0.999, inertia within 1e-4),
           silhouette (1e-4), ARI and NMI, auto-eps (1e-5) and the 27-fit
           DBSCAN grid on the unlabeled scope (labels equal, or ARI ≥ 0.99
           where a pair's distance lies within 1e-4 of eps; that count
           printed); no hand kernel runs here;
12. analysis_scale  above ``DENSE_LIMIT``: 50,000 × 512 through the
           blocked k-distance, DBSCAN (eps the 25th-percentile 4th-neighbour
           distance, which keeps neighbourhoods small) and silhouette paths and k-means (k 8, 3 restarts), t-SNE and
           UMAP at their 20,000-point cap, each with its seconds and peak
           device memory; the blocked paths held to the dense ones on 4,096
           rows;
13. workflow  ``scripts/run_full_workflow.sh`` on the port's CLIs, in its
           order and with its flags, on a seeded 512² JPEG tree at the
           reference's layout and counts (50 + 50 labeled, 1,406 unlabeled,
           four image families): audit, extraction, standardize, clustering
           (``--dbscan-auto --dbscan-scope unlabeled``), the DBSCAN cohort,
           supervised, semi-supervised on the cohort, both sweeps, the
           export of the semi model and a ``predict`` over the unlabeled
           tree (artifact and CSV checked); 1 + 1 + 1
           epochs and a pseudo-label threshold of 0.5; every artifact
           present and well formed, each stage's seconds, peak memory and
           launches. A stage that needs a host package this machine lacks
           (the audit and the figures need matplotlib) is named on its own
           line and not started: clustering then runs as
           ``cli.clustering.run_analysis``, everything but its figures. The
           supervised and semi-supervised stages write the JAX run's 4 and
           9 training figures where matplotlib is installed, and otherwise
           warn once and write none (checked either way; which of the two
           is printed before the stages);
14. moe     ``vit_moe_s16`` at full width (hidden 384, 12 layers, every
           other block an 8-expert block, 6 heads of 64, 197 tokens): the
           extraction slice as ``slice`` runs it (bf16 and f32, cuda vs CPU
           f32, 25 LayerNorm and 12 attention launches a forward, a profiled
           bf16 run; bf16 vs f32 cosine > 0.98 per image and > 0.995 on
           average, ``MOE_COSINE_FLOOR``: a top-1 choice that flips under
           bf16 sends a token to another expert, in the JAX package too;
           the tokens an image whose top-1 expert differs between bf16 and
           f32, and whether the images below 0.995 are those with flips);
           ``run_supervised`` in bf16;
           ``run_pipeline`` with the FixMatch fine-tune in bf16; the
           ``[semi]`` MoE run through ``export_model`` (f32 and bf16 against
           the in-process predictor) and ``predict``; one f32 train step
           cuda vs CPU at batch 4 (the loss with the aux term, the aux term,
           every gradient, the routers' included, at the dense ViT step
           check's bounds, and the count of router choices that differ); a
           ``vit_moe_t16`` forward (3 heads) cuda vs CPU; the steady-state
           bf16 train step and FixMatch step at 128 (+ 128), timed and
           profiled. The MoE window must launch the LayerNorm and packed
           attention pairs (rows 5, 6, 9, 10). ``ln`` and ``attn`` also time
           the kernels at the MoE width: [25216, 384] and [128, 197, 1152];
15. resume  ``--resume`` on the card under cuDNN's deterministic mode:
           ``run_supervised`` of resnet18 f32 for 4 epochs, then 2 epochs
           with snapshots and resumed to 4; the restored state equal to the
           snapshot and the resumed run to the uninterrupted one, bit for
           bit (where not, two more uninterrupted runs and the old bar:
           within twice their spread); the same for ``train_fixmatch`` (EMA
           off, 3 epochs, cut after 1); with an EMA teacher, the teacher
           after the resume equal to the ``.best`` sidecar's parameters;
   seeds   ``run_supervised`` with ``num_seeds=4`` (resnet18 f32, 224²,
           batch 16, 3 epochs), deterministic cuDNN; each lane bit for bit
           a solo ``train_model`` of its seed (where not, the old bars on
           three solo runs); ``seed_sweep.csv``
           equal to the lanes' summary, the checkpoint to the selected
           lane's state; the lanes' seconds beside four solo runs';
   cv      ``run_supervised`` with ``cv_folds=3``: ``cv_results.csv`` with
           the three folds (their validation sets a partition of the train
           + val pool), the mean and the std;
   randaug RandAugment's strong view (128 images at 224²) on the card
           against the CPU on the same draws, uint8; the resnet18 bf16
           FixMatch step at 128 + 128 with it, timed and profiled; one
           ``run_pipeline`` with ``strong_augment="randaugment"``;
16. stream  the streamed extraction shape on the workflow's 1,506-image 512²
           JPEG tree, resnet18 bf16 at batch 128, each run in a fresh
           interpreter (end-to-end imgs/s and the resident set's growth): the resident shape,
           ``streaming="always"`` and ``host_preproc`` (embeddings against
           the resident ones), ``fast_decode`` twice (equal; cosine to the
           exact path printed); the preprocess kernel at 224² → 224 (scale 1)
           bit for bit against its plain version;
17. dp      data parallelism (``ssip_tpu_torch/parallel/``): (c)
           ``--shard-size 512`` through the extraction CLI on the workflow's
           1,506 JPEGs (resnet18 f32, batch 128), then again with the last
           manifest removed: 3 shards, 2 reused, 1 recomputed, embeddings
           against the single-shot run's (bitwise expected: the same
           batches); (d) ``SSIP_SNAPSHOT_FORMAT=orbax``: resnet18 f32
           ``run_supervised`` cut after 1 of 2 epochs and resumed from a
           ``torch.distributed.checkpoint`` directory under cuDNN's
           deterministic mode, the restore bitwise and the resumed run
           bitwise an uninterrupted one, as is a resume from the file form
           at the same point; (b) two gloo ranks sharing the
           card, the resnet18 f32 step at 2 × 64 against one process at 128
           for 3 steps (losses 1e-5, BatchNorm statistics after the first
           step 1e-4, the state after the third inside the JAX
           final-parameter bound); (a) ``--fsdp`` at world size 1 over NCCL:
           the supervised CLI under ``torch.distributed.run --standalone``
           (vit_b16 and resnet18, bf16, batch 128, 1 epoch; the gathered
           ``.pt`` loads; its process runs beside (d), (b) and ``tp``), and
           in process one bf16 step at 128 with and
           without FSDP (the same contiguous parameter layout), bitwise or
           within twice the card's run-to-run spread (two plain steps),
           then each timed with its peak memory;
   tp      (inside ``dp``, its ranks beside (d) and (b), its one-process
           references after (b) while they run) the model axis: two gloo
           ranks sharing the card (data 1 ×
           model 2) run one f32 SGD step of each path at full width against
           one process at the multichip dryrun's bound (loss 1e-4 relative,
           every parameter 1e-3 relative norm): resnet-tp (224², batch 32),
           vit-tp (vit_b16, 6 heads a rank, batch 16), vit-ep (vit_moe_s16,
           4 of 8 experts a rank, router choices equal), vit-pp (vit_b16 in
           2 GPipe stages, 4 microbatches), vit-sp (vit_b16 at 512², ring
           attention); launches counted a rank; bf16 extractor features of
           vit-tp and vit-ep against one process at the cosine gates; ms a
           step beside one process's (gloo through host memory);
18. imports no jax module and no module of the JAX package;
19. a ``[seconds]`` line (each phase's seconds), the kernels JSON line (all
    eleven kernels), then ``{"ok": true, "device": {...}}`` last.

The ``host`` line, printed first after ``env``, says whether pandas and
matplotlib are installed, and whether g++ and libjpeg's header are there
(without them ``stream`` runs ``streaming="always"`` alone and names the
two native variants as not run).

Needs no network and no data: everything is made from seeds. It builds the
kernels from the checkout, so a fresh clone is enough. It imports
``ssip_tpu_torch``, torch, numpy, Pillow and scipy (UMAP's curve fit), and
pandas and matplotlib only where both are installed (the audit, the figures),
and fails if the run loaded jax, flax, optax or any module of the JAX package
(``ssip_tpu``).
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import textwrap
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
ATTN_MMA_DESIGN = ("bf16, csrc/attention_mma.cu: any length; forward float32 FMA scores in cuBLAS's order, "
                   "torch-order softmax, bf16 p, P.V on mma.sync m16n8k16: up to 256 tokens a block of 4 warps per "
                   "head, K staged whole as float32 (transposed by 4-d groups) and V as bf16 behind the block's only "
                   "barrier, each warp its own groups of 16 query rows (a last one of at most 8) from Q to the stored "
                   "output (scores in registers, a last key chunk of at most 8 real keys worked on all lanes, P.V as "
                   "vT.pT with the rows as n), past 256 a block per 32 query rows with K and V streamed in 64-key "
                   "cp.async tiles (scores cached in shared memory while they fit, else three sweeps over K); "
                   "backward every product on mma.sync with p and ds rounded to bf16: up to 256 tokens one launch, "
                   "a block of 4 warps per head (two an SM), Q, K, V and dO staged once, a row pass (16-row groups, "
                   "a row's scores and float32 p in registers, dp twice, dq from bf16(ds) at once, row statistics "
                   "to shared memory) then a key pass (16-key groups, sT and dpT again 32 query rows a step, dv and "
                   "dk), no bound check in a key or query loop, no scratch; past 256 two launches (dq by 64 query "
                   "rows, dk and dv by 64 key rows, the other operand streamed) joined by a float32 scratch")
# the packed pair's bf16 kernels (ssip_attention_rounded_info's `which` 0, 1,
# 2 and 3: the whole-head forward or the streamed one, the streamed
# backward's two, the whole-head backward)
ATTN_MMA_KERNELS = ("attn_qkv_fwd_mma_kernel", "attn_qkv_bwd_rows_kernel", "attn_qkv_bwd_keys_kernel",
                    "attn_qkv_fwd_stream_kernel", "attn_qkv_bwd_whole_kernel")
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
# what the int8 MLP's times below are of
QMLP_DESIGN = ("csrc/qmlp.cu: two launches joined by the int8 hidden [M, hidden]: qmlp_hidden_kernel (64 stream rows "
               "a block quantized once into shared memory, W1 in 256x64 tiles through a 3-stage cp.async ring, "
               "mma.sync m16n8k32 s8, affine + A&S GELU + requantize in the epilogue, the hidden width split for "
               "full waves), qmlp_output_kernel (128 x 128 output tiles, gq and W2 in 128-byte steps through a "
               "3-stage cp.async ring, the output affine in the epilogue)")
QMLP_KERNELS = ("qmlp_hidden_kernel", "qmlp_output_kernel")
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
        "route": "cuda", "source": "ssip_tpu_torch/csrc/rotation.cu",
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
        "replaces": "ssip_tpu/ops/qmlp.py:78", "design": QMLP_DESIGN,
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
        "route": "cuda", "source": "ssip_tpu_torch/csrc/rotation.cu",
        "replaces": "ssip_tpu/ops/augment.py:205",
    },
}
# Data-sheet peaks of one H100 SXM, for the bounds: device memory rate, and
# dense operation rates by operand type: "float32" outside the tensor cores
# (elementwise work), "tf32x3" float32-accurate products on them, three TF32
# products each (the float32 attention kernels).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32x3": 495e12 / 3}
# float32 FMA lanes: 132 SMs x 128 lanes x 2 operations x 1.98 GHz, the rate
# the bf16 packed forward's exact scores (a float32 FMA chain each) run at best
FP32_FMA_OPS_PER_S = 66.9e12
ATTN_OPS_TYPE = {"bfloat16": "bfloat16", "float32": "tf32x3"}  # the attention rows' products by input type
VIT_ARCH, VIT_WIDTH, VIT_TOKENS, VIT_HEADS, VIT_MLP = "vit_b16", 768, 197, 12, 3072
VIT_LN_PER_FORWARD, VIT_ATTN_PER_FORWARD, VIT_BLOCKS = 25, 12, 12
# the MoE ViT at full width: 12 layers (every other one an expert block) of
# 6 heads of 64, so 25 LayerNorm and 12 attention launches a forward too
MOE_ARCH, MOE_WIDTH, MOE_T16 = "vit_moe_s16", 384, "vit_moe_t16"
VIT_FAMILY = (VIT_ARCH, MOE_ARCH)
INT8_COSINE_FLOOR = 0.98  # int8 vs float32 embeddings, per image (the JAX pipeline's own floor)
# bf16 vs f32 embeddings of the MoE ViT, per image, and their mean: a token
# whose top-1 expert flips under bf16 rounding of the router's input takes
# another expert's MLP, so 0.995 does not hold for the model itself (the JAX
# package's vit_moe_s16 on the CPU, 16 seeded 224² images: min 0.9842, mean
# 0.9986; the port's there: min 0.9906, mean 0.9994)
MOE_COSINE_FLOOR, MOE_COSINE_MEAN_FLOOR = 0.98, 0.995
INT8_RESNET_COSINE_FLOOR = 0.99  # the int8 ResNet's, per image (tests/test_quantized.py:127-128)
SERVE_BATCH = 128  # images of the serving comparisons and timings
SERVE_CPU_CHECK = 8  # of them, predicted on the CPU too
SERVE_BATCHES = (1, 3, 128)  # exported against in-process
SERVE_CPU_ATOL = 1e-4  # float32 probabilities, card vs CPU, float32 products pinned
SERVE_EXPORT_ATOL = 1e-6  # float32, exported vs in-process on the card (tests/test_deploy.py:79)
SERVE_BF16_ATOL = 1e-3  # bfloat16, exported vs in-process on the card
SERVE_MOVED_ATOL = 1e-5  # float32, an artifact traced on one device run on the other
SERVE_TIMED = 3  # timed predict_probs calls of the 128 images
SERVE_REQUESTS = 8
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
    # past the JAX entry's 1024, where it rounds p: in bf16 the packed pair's kernels on q, k, v
    (4, 12, 1025, 64, "bfloat16"), (2, 12, 1297, 64, "bfloat16"), (4, 12, 1025, 64, "float32"),
)
VIT_N_CPU_CHECK = 8
# (rows, width, type): 128 images of 197 tokens and of 208 (the token axis
# padded to 16), the final LayerNorm, and a ragged row count
LN_SHAPES = (
    (128 * 197, 768, "bfloat16"), (128 * 197, 768, "float32"),
    (128 * 208, 768, "bfloat16"), (128 * 208, 768, "float32"),
    (128, 768, "float32"), (1001, 384, "bfloat16"),
    (128 * 197, 384, "bfloat16"),  # vit_moe_s16's stream
)
# (batch, tokens, heads, kv_len, type), heads of 64: vit_b16 at 224² (and
# its token axis padded to 16), then at 256², 384², 512² and 576² (257, 577,
# 1025, 1297 tokens) and 1024 tokens, some with pad keys
ATTN_SHAPES = (
    (128, 197, 12, 0, "bfloat16"), (128, 197, 12, 0, "float32"),
    (128, 208, 12, 197, "bfloat16"), (128, 208, 12, 197, "float32"),
    (128, 197, 3, 0, "bfloat16"), (128, 256, 12, 0, "float32"), (16, 577, 12, 0, "float32"),
    (64, 257, 12, 0, "bfloat16"), (16, 257, 12, 250, "float32"), (16, 577, 12, 0, "bfloat16"),
    (4, 1024, 12, 0, "bfloat16"), (4, 1024, 12, 1000, "float32"), (4, 1025, 12, 1001, "bfloat16"),
    (4, 1025, 12, 0, "float32"), (2, 1297, 12, 0, "bfloat16"), (2, 1297, 12, 1200, "float32"),
    (16, 256, 12, 0, "bfloat16"),  # the whole-head kernels' longest sequence
    (128, 197, 6, 0, "bfloat16"),  # vit_moe_s16: [128, 197, 1152]
)
# the streamed bf16 shapes whose device times [attn] reads too
ATTN_DEVICE_STREAMED = ((16, 577, 12, 0, "bfloat16"), (4, 1024, 12, 0, "bfloat16"))
# the rotation body's two epilogues as torch.profiler names them (csrc/rotation.cu)
AUGMENT_KERNELS = ("rotate_kernel<float>", "rotate_kernel<__nv_bfloat16>")
ROTATE_U8_KERNELS = ("rotate_kernel<unsigned char>",)
# the LayerNorm kernels of csrc/layernorm.cu, in the order of ``ssip_layer_norm_info``
LN_KERNELS = ("ln_fwd_kernel", "ln_bwd_kernel", "ln_colsum_kernel")
F32_ATOL = 2e-5
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
AUG_SHAPES = ((128, 224, 224, 3), (16, 224, 160, 3), (8, 64, 96, 3))
ROTATE_U8_SHAPES = AUG_SHAPES + ((4, 64, 36, 3),)  # 64 x 36: the TPU geometry has no block for it
PINNED_DEGREES = (10.0, -10.0, 25.0, -25.0)
POOL_IMAGES = 256  # the flat unlabeled pool of the semi-supervised runs
SEMI_EPOCHS = (1, 1, 1)  # baseline, weak pretrain, fine-tune ((2, 1, 2) until PR 15)
SEMI_THRESHOLD = 0.5  # pseudo-label and consistency thresholds: the seeded init keeps rows at 0.5
SEMI_EMA_DECAY = 0.99
TRAIN_PER_CLASS = 50  # the real labeled layout: avec_labels/{cancer,normal}, 50 + 50
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_SIZE = 16, 1, 224  # 2 epochs until PR 15
VIT_LONG_RUNS = (("bfloat16", 1, 256), ("bfloat16", 1, 512), ("float32", 1, 512))  # (type, epochs, image size)
STEP_CHECK_BATCH, STEP_TIMED_BATCH, STEP_WARMUP, STEP_TIMED = 8, 128, 3, 10
# The cuda-vs-CPU gradient check runs at kink-free weights: the seeded ones
# with every conv filter re-centred to zero mean and every BN bias raised by
# this much. At the seeded init (BN bias 0) half of all ReLU inputs sit at
# the kink, and a 1e-6 relative weight perturbation on the CPU alone moves
# single gradient entries by up to 15 % of their tensor's max: a few ReLU
# masks flip. Raised biases move ReLU inputs 4 standard deviations off the
# kink (a heavy tail still reaches it: FIXMATCH_RELU_FLIPS); centred filters
# keep the next conv's outputs near zero mean, so E[x²] − E[x]² does not
# cancel. The stem conv's gradient still passes
# through the stem max-pool's argmax, where a near-tie in one of the 1.6 M
# windows reroutes one element (0.8–1.4 % of max |g| under the same
# perturbation), so it is held in L2. Loss, argmax and BN statistics are
# checked at the seeded weights themselves.
KINK_FREE_BN_BIAS = 4.0
# The FixMatch step's gradients are held to 1e-3 of each tensor's max, as the
# train step's are, and to 1e-4 in L2 over all of them together, but for the
# tensors FIXMATCH_F64_CHECKED names, whose card-vs-CPU gap is past 1e-3.
# Each of those is held to float64 instead: on each device and for each
# differentiated view, the float32 reduction of that device's own dy (and x)
# within FIXMATCH_F64_RTOL of the sum of |terms| of its element, about ten
# times float32's error for a pairwise sum of thousands of terms (the final
# LayerNorm's bias, which the card reduces in its backward kernel: 1e-5 of the
# float64 value's max); and card vs CPU within FIXMATCH_F64_CHECKED_RTOL. A
# tensor past 1e-3 that the list does not name fails the run. Why they part:
# vit_b16's two are sums over the two views that cancel (the strong view's
# head-bias gradient all but undoes the labeled view's), so a gap of a view's
# own size is large against their sum. resnet18's three sit on either side of
# layer2.0.bn1, whose output feeds a ReLU: where an output lies within
# rounding of 0 the ReLU passes dy on one device and cuts it on the other.
# With dy set to 0 at those flips on both devices (FIXMATCH_RELU_FLIPS) the
# three are held to 1e-3 as well.
FIXMATCH_GRAD_RTOL = 1e-3
FIXMATCH_GRAD_L2_ALL = 1e-4
FIXMATCH_F64_CHECKED = {
    "resnet18": ("layer2.0.bn1.bias", "layer2.0.bn1.weight", "layer2.0.conv1.weight"),
    "vit_b16": ("encoder.ln.bias", "heads.head.bias"),
}
FIXMATCH_RELU_FLIPS = {"resnet18": ("layer2.0.conv1", "layer2.0.bn1")}
FIXMATCH_F64_RTOL = 1e-5
FIXMATCH_F64_CHECKED_RTOL = 1e-2
STEM_GRAD = "conv1.weight"

# the analysis stage at the reference corpus's size (100 labeled + 1,406 unlabeled, SURVEY.md §1)
ANALYSIS_LABELED, ANALYSIS_UNLABELED, ANALYSIS_DIM, ANALYSIS_TSNE_DIM = 100, 1406, 512, 50
ANALYSIS_CLUSTERS = 8  # the seeded features' groups
TSNE_PERPLEXITIES = (10.0, 30.0, 50.0)  # src/clustering.py's grid
UMAP_GRID = tuple((k, d) for k in (15, 30, 50) for d in (0.0, 0.1))
KMEANS_KS, DBSCAN_MIN_SAMPLES = range(2, 11), (5, 10, 15)
EMBED_KL_RTOL = 0.10  # t-SNE KL, card vs CPU: one ulp of the input moves it by percents (tests/test_torch_analysis.py)
NEIGHBOUR_ATOL = 0.05  # neighbour preservation of the 2-D maps, card vs CPU
SWEEP_PROB_TOL = 1e-4  # a sweep's thresholds (probabilities), card vs CPU
# above DENSE_LIMIT (tests/test_corpus_scale.py's 50,000 rows, at the real width), the 2-D maps at their cap
SCALE_N, SCALE_SLICE, EMBED_CAP = 50_000, 4096, 20_000
SCALE_EPS_QUANTILE = 0.25  # of the k-distance curve: DBSCAN's eps at scale
SCALE_KMEANS_K, SCALE_KMEANS_INIT = 8, 3  # few restarts: the host's k-means++ seeding dominates at 50,000 × 512
WORKFLOW_FAMILIES = 4
WORKFLOW_EPOCHS = (1, 1, 1)  # baseline, weak pretrain, fine-tune (run_full_workflow.sh leaves 10, 5, 8; (2, 1, 2) until PR 15)



_T0 = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One output line; ``t`` is the seconds since the script started."""
    fields["t"] = f"{time.perf_counter() - _T0:.1f}"
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


def phase_build(result=None) -> None:
    """Load the kernels' library, built here unless ``result`` (a
    ``BuildResult``) says it was, and print ptxas's report."""
    from ssip_tpu_torch.kernels.build import build, load_library

    result = result or build()
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

        def quant():
            return preprocess_images(x, RESIZE, CROP, quant_inv_scale=QUANT_INV_SCALE)

        k_ms, p_ms = timed_pair(torch, kernel(torch.bfloat16), plain(torch.bfloat16))
        k32_ms = median_ms(torch, kernel(torch.float32))
        p32_ms = median_ms(torch, plain(torch.float32))
        q_ms, pq_ms = timed_pair(
            torch, quant, lambda: quantize(extraction_preprocess(x, RESIZE, CROP, torch.float32), QUANT_INV_SCALE))
        # the kernel's own device time (torch.profiler) and the wrapper's host time
        (d16, name), (d32, _), (dq, _) = one_kernel_device_ms(
            torch, [kernel(torch.bfloat16), kernel(torch.float32), quant], "kernel")
        h16, hq = host_ms(torch, kernel(torch.bfloat16)), host_ms(torch, quant)
        # the separable resample needs 2 operations a tap and channel: the
        # horizontal taps on every source row the crop reads, then the
        # vertical taps on every output pixel; the bytes are the source
        # pixels the crop's taps reach (rows read x columns read x 3), read
        # once, and the output
        (v_start, v_count, _), (h_start, h_count, _) = (
            tap_table(w) for w in crop_weights(shape[1], shape[2], RESIZE, CROP))
        rows_read = len(set().union(*(range(a, a + n) for a, n in zip(v_start, v_count))))
        cols_read = len(set().union(*(range(a, a + n) for a, n in zip(h_start, h_count))))
        src_bytes = shape[0] * rows_read * cols_read * 3
        ops = 2 * 3 * shape[0] * (rows_read * int(h_count.sum()) + CROP * int(v_count.sum()))
        bound = bound_ms(src_bytes + k16.numel() * 2, ops, "float32")
        bound32 = bound_ms(src_bytes + k32.numel() * 4, ops, "float32")
        # one more multiplication per output value than the float forms
        qbound = bound_ms(src_bytes + kq.numel(), ops + kq.numel(), "float32")
        tol = "bitwise" if exact else f"<= {one_step:.6g}"
        say("kernel", shape="x".join(map(str, shape)), tol=tol, kernel=repr(name[:60]), max_abs_err_f32=err32,
            max_abs_err_bf16=err16, bf16_ms=f"{k_ms:.4f}", bf16_device_ms=f"{d16:.4f}", bf16_host_ms=f"{h16:.4f}",
            plain_bf16_ms=f"{p_ms:.4f}", f32_ms=f"{k32_ms:.4f}", f32_device_ms=f"{d32:.4f}",
            plain_f32_ms=f"{p32_ms:.4f}", rows_read=rows_read, cols_read=cols_read,
            bound_bf16_ms=f"{bound['bound_ms']:.4f}", bound_f32_ms=f"{bound32['bound_ms']:.4f}",
            bound_by=bound["bound_by"], library="none")
        say("kernel", form="int8", shape="x".join(map(str, shape)), tol="bitwise" if exact else f"<= {steps} steps",
            max_abs_err_int8=errq, int8_ms=f"{q_ms:.4f}", int8_device_ms=f"{dq:.4f}", int8_host_ms=f"{hq:.4f}",
            plain_int8_ms=f"{pq_ms:.4f}", bound_int8_ms=f"{qbound['bound_ms']:.4f}", bound_by=qbound["bound_by"],
            library="none")
        if exact:
            result = {
                "preprocess_images": {"max_abs_err": max(err32, err16), "ms": k_ms, "device_ms": d16,
                                      "host_ms": h16, "plain_ms": p_ms, **bound, "library_ms": None},
                "preprocess_quantize": {"max_abs_err": float(errq), "ms": q_ms, "device_ms": dq, "host_ms": hq,
                                        "plain_ms": pq_ms, **qbound, "library_ms": None},
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
        (d16, name), (d32, _) = one_kernel_device_ms(torch, [kernel(torch.bfloat16), kernel(torch.float32)],
                                                     "rotate")
        h16 = host_ms(torch, kernel(torch.bfloat16))
        # per output value: one subtraction and one multiplication (the
        # index map is integer work)
        bound = bound_ms(x.numel() + coeffs.numel() * 4 + k16.numel() * 2, 2 * k16.numel(), "float32")
        bound32 = bound_ms(x.numel() + coeffs.numel() * 4 + k32.numel() * 4, 2 * k32.numel(), "float32")
        say("rotate", shape="x".join(map(str, shape)), tol="bitwise", flips=int(flip.sum()), kernel=repr(name[:60]),
            max_abs_err_f32=err32, max_abs_err_bf16=err16, bf16_ms=f"{k_ms:.4f}", bf16_device_ms=f"{d16:.4f}",
            bf16_host_ms=f"{h16:.4f}", plain_bf16_ms=f"{p_ms:.4f}", f32_ms=f"{k32_ms:.4f}",
            f32_device_ms=f"{d32:.4f}", plain_f32_ms=f"{p32_ms:.4f}", bound_bf16_ms=f"{bound['bound_ms']:.4f}",
            bound_f32_ms=f"{bound32['bound_ms']:.4f}", bound_by=bound["bound_by"], library="none")
        if shape == AUG_SHAPES[0]:
            result = {"max_abs_err": max(err32, err16), "ms": k_ms, "device_ms": d16, "host_ms": h16,
                      "plain_ms": p_ms, **bound, "library_ms": None}
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
            [(device_ms, name)] = one_kernel_device_ms(torch, [lambda: rotate_images(x, coeffs)], "rotate_u8")
            call_host_ms = host_ms(torch, lambda: rotate_images(x, coeffs))
            # about 25 integer operations a pixel for the index map, counted
            # at the float32 rate: far below the bytes
            bound = bound_ms(2 * x.numel() + coeffs.numel() * 4, 25 * x.numel() // 3, "float32")
            say("rotate_u8", shape="x".join(map(str, shape)), kernel=repr(name[:60]), ms=f"{k_ms:.4f}",
                kernel_device_ms=f"{device_ms:.4f}", host_ms=f"{call_host_ms:.4f}", plain_ms=f"{p_ms:.4f}",
                bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
                gb_per_s=f"{2 * x.numel() / device_ms / 1e6:.1f}", library="none")
            result = {"max_abs_err": 0.0, "ms": k_ms, "device_ms": device_ms, "host_ms": call_host_ms,
                      "plain_ms": p_ms, **bound, "library_ms": None}
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


def one_kernel_device_ms(torch, fns, what: str) -> list:
    """For each function of ``fns``, a call of which launches one kernel:
    (the median device ms of its launches, the kernel's name), all from one
    ``torch.profiler`` session (``checked_device_windows``)."""
    def wrong(windows):
        counts = [(len(w), sum(map(len, w.values()))) for w in windows]
        return None if all(c == (1, TIMED_LAUNCHES) for c in counts) else f"(names, launches) {counts}"

    windows = checked_device_windows(torch, fns, wrong, what)
    return [(_median(next(iter(w.values()))), next(iter(w))) for w in windows]


def call_device_ms(torch, fns, what: str) -> list:
    """For each function of ``fns``: (the device ms of one call, every
    kernel of its window summed over the calls, and the kernels' names),
    all from one ``torch.profiler`` session (``checked_device_windows``),
    which is measured again where a kernel was not seen once a call."""
    def wrong(windows):
        bad = {i: {k: len(v) for k, v in w.items()} for i, w in enumerate(windows)
               if not w or any(len(ts) % TIMED_LAUNCHES for ts in w.values())}
        return None if not bad else f"launches by window {bad}"

    windows = checked_device_windows(torch, fns, wrong, what)
    return [(_library_device_ms(w)[0], sorted(name[:60] for name in w)) for w in windows]


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
        _WHOLE_MAX_SEQ, attention_qkv_bwd, attention_qkv_bwd_plain, attention_qkv_plain, attention_qkv_residuals,
        fused_attention_qkv,
    )
    from ssip_tpu_torch.runtime.device import configure_precision

    # what ptxas reported for the three bf16 kernels (dynamic shared memory
    # is set at launch: printed per shape below)
    resources = kernel_resources(build().log)
    for fragment in ATTN_MMA_KERNELS:
        named = {name: r for name, r in resources.items() if fragment in name}
        if not named:
            raise AssertionError(f"ptxas reported nothing for {fragment}")
        for name, r in sorted(named.items()):
            # template arguments: the head width, and for the forwards the key chunks of 32 and
            # whether the last holds at most 8 real keys (whole head), or whether the scores are
            # cached (streamed); for the whole-head backward the 16-key steps its registers hold
            args = re.search(r"ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", name)
            if fragment == "attn_qkv_bwd_whole_kernel":
                say("attn", ptxas=fragment, head_width=args[1], key_steps=args[2], **r)
                continue
            flag = {"narrow_tail" if args[2] else "score_cache": args[3] or "-"}
            say("attn", ptxas=fragment, head_width=args[1], key_chunks=args[2] or "-", **flag, **r)
    rounded_info = load_library().ssip_attention_rounded_info  # the bf16 kernels at a sequence and key count
    rounded_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for which, kernel in ((1, ATTN_MMA_KERNELS[1]), (2, ATTN_MMA_KERNELS[2])):  # the streamed backward's
        for dh in (32, 64):
            res = (ctypes.c_int * 5)()
            if rounded_info(which, dh, 1, 1, res) != 0:
                raise AssertionError(f"{kernel} at head width {dh}: ssip_attention_rounded_info failed")
            say("attn", kernel=kernel, head_width=dh, registers=res[0], local_bytes=res[1], smem_bytes=res[2],
                blocks_per_sm=res[3])
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
        if dtype_name == "bfloat16":
            # no atomics: a second call gives the same bits; and the profiler sees one backward kernel a
            # call up to 256 tokens, the streamed pair past it
            if not torch.equal(attention_qkv_bwd(qkv, d_o, heads, kv_len, residuals), dqkv):
                raise AssertionError(f"{tag}: a second backward call gave other bits")
            bwd_kernels = _attention_kernels_seen(
                torch, lambda: attention_qkv_bwd(qkv, d_o, heads, kv_len, residuals), f"{tag} backward kernels")
            want = (["attn_qkv_bwd_whole_kernel"] if s <= _WHOLE_MAX_SEQ
                    else ["attn_qkv_bwd_keys_kernel", "attn_qkv_bwd_rows_kernel"])
            if bwd_kernels != want:
                raise AssertionError(f"{tag}: a backward call ran {bwd_kernels}, want {want}")

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
        device = {}
        # the main shape in both types, the MoE width and the streamed bf16 shapes at 577 and 1024
        # tokens (rows 9-10's device times there)
        if (b, s, heads, kv_len, dtype_name) in ATTN_SHAPES[:2] + ATTN_SHAPES[-1:] + ATTN_DEVICE_STREAMED:
            device = _attention_device_times(
                torch, "attn", f"{b}x{s}x{3 * d}", dtype_name,
                (lambda: fused_attention_qkv(qkv, heads, kv_len),
                 lambda: attention_qkv_bwd(qkv, d_o, heads, kv_len, residuals),
                 lambda: F.scaled_dot_product_attention(q.detach(), k.detach(), v.detach()),
                 lambda: torch.autograd.grad(o_lib, leaf, do_view, retain_graph=True)),
                fwd_bound, bwd_bound)
            if dtype_name == "bfloat16":
                # SDPA's own backward on contiguous q, k, v [B, H, S, Dh] (no scatter into a packed
                # leaf): a second yardstick, timed here and called nowhere in the port
                leaves = [t.contiguous().requires_grad_() for t in (q.detach(), k.detach(), v.detach())]
                o_4 = F.scaled_dot_product_attention(*leaves)
                do_4 = do_view.contiguous()
                ((device["lib_bwd_unpacked"], names),) = call_device_ms(
                    torch, [lambda: torch.autograd.grad(o_4, leaves, do_4, retain_graph=True)],
                    f"attn {b}x{s}x{3 * d} unpacked SDPA backward")
                say("attn", shape=f"{b}x{s}x{3 * d}", dtype=dtype_name,
                    bwd_library_unpacked_device_ms=f"{device['lib_bwd_unpacked']:.4f}",
                    bwd_device_vs_library_unpacked=f"{device['bwd'] / device['lib_bwd_unpacked']:.4f}",
                    library_unpacked_kernels=names)
                del leaves, o_4, do_4
        say("attn", shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len, dtype=dtype_name, max_abs_err=err_o,
            dq_rel=rels[0], dk_rel=rels[1], dv_rel=rels[2], fwd_ms=f"{fwd_ms:.4f}",
            fwd_plain_ms=f"{fwd_plain_ms:.4f}", fwd_library_ms=f"{lib_fwd_ms:.4f}",
            fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_library_ms=f"{lib_bwd_ms:.4f}",
            bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", bound_by=fwd_bound["bound_by"])
        if dtype_name == "bfloat16":
            fwd_res = (ctypes.c_int * 5)()
            if rounded_info(0, dh, s, kv, fwd_res) != 0:
                raise AssertionError(f"{tag}: ssip_attention_rounded_info failed")
            # what the gate costs: the score FMAs (2·B·H·S·kv·Dh operations) at the card's float32 rate
            fma_floor_ms = 2 * b * heads * s * kv * dh / FP32_FMA_OPS_PER_S * 1e3
            floor = {"fwd_fma_floor_ms": f"{fma_floor_ms:.4f}"}
            if device:
                floor["fwd_fma_floor_share_of_device"] = f"{fma_floor_ms / device['fwd']:.4f}"
                floor["fwd_device_vs_library_device"] = f"{device['fwd'] / device['lib_fwd']:.4f}"
            bwd_res = (ctypes.c_int * 5)()
            if s <= _WHOLE_MAX_SEQ and rounded_info(3, dh, s, kv, bwd_res) != 0:
                raise AssertionError(f"{tag}: ssip_attention_rounded_info failed for the whole-head backward")
            whole = ({"bwd_registers": bwd_res[0], "bwd_local_bytes": bwd_res[1], "bwd_smem_bytes": bwd_res[2],
                      "bwd_blocks_per_sm": bwd_res[3]} if s <= _WHOLE_MAX_SEQ else {})
            say("attn", design=repr(ATTN_MMA_DESIGN), shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len,
                bwd_kernels=bwd_kernels, bwd_bitwise_repeat=True, **whole,
                fwd_gbytes_per_s=f"{(qkv.numel() + out.numel()) * item / fwd_ms / 1e6:.1f}", **floor,
                fwd_bound_share=f"{fwd_bound['bound_ms'] / fwd_ms:.4f}", fwd_vs_library=f"{fwd_ms / lib_fwd_ms:.4f}",
                bwd_gbytes_per_s=f"{(2 * qkv.numel() + d_o.numel()) * item / bwd_ms / 1e6:.1f}",
                bwd_bound_share=f"{bwd_bound['bound_ms'] / bwd_ms:.4f}", bwd_vs_library=f"{bwd_ms / lib_bwd_ms:.4f}",
                fwd_kernel=("three_sweeps", "stream_cached", "whole_head")[fwd_res[4]], fwd_registers=fwd_res[0],
                fwd_smem_bytes=fwd_res[2],
                fwd_blocks_per_sm=fwd_res[3])
        else:
            fwd_stats_ms = median_ms(torch, lambda: attention_qkv_residuals(qkv, heads, kv_len))
            say("attn", design=repr(ATTN_F32_DESIGN), shape=f"{b}x{s}x{3 * d}", heads=heads, kv_len=kv_len,
                fwd_gbytes_per_s=f"{(qkv.numel() + out.numel()) * item / fwd_ms / 1e6:.1f}",
                **_f32_rates(fwd_ms, fwd_stats_ms, lib_fwd_ms, fwd_bound, bwd_ms, lib_bwd_ms, bwd_bound,
                             b * heads * s * kv * dh))
        if (b, s, heads, kv_len, dtype_name) == ATTN_SHAPES[0]:
            result = {
                "attention_qkv": {"max_abs_err": err_o, "ms": fwd_ms, "device_ms": device["fwd"],
                                  "plain_ms": fwd_plain_ms, **fwd_bound, "library_ms": lib_fwd_ms,
                                  "library_device_ms": device["lib_fwd"]},
                "attention_qkv_bwd": {"max_abs_err": err_dqkv, "ms": bwd_ms, "device_ms": device["bwd"],
                                      "plain_ms": bwd_plain_ms, **bwd_bound, "library_ms": lib_bwd_ms,
                                      "library_device_ms": device["lib_bwd"],
                                      "library_unpacked_device_ms": device["lib_bwd_unpacked"]},
            }
        del qkv, d_o, out, dqkv, leaf, o_lib, residuals
        torch.cuda.empty_cache()
    return result


def _attention_kernels_seen(torch, fn, what: str) -> list:
    """The attention kernels (attn_*_kernel) a call of ``fn`` launches, by
    name, sorted: ``torch.profiler``'s window of ``TIMED_LAUNCHES`` calls
    (``checked_device_windows``, measured again once where a kernel was not
    seen once a call)."""
    def wrong(windows):
        counts = {name: len(ts) for name, ts in windows[0].items()}
        return None if all(n == TIMED_LAUNCHES for n in counts.values()) else f"launches {counts}"

    (window,) = checked_device_windows(torch, [fn], wrong, what)
    return sorted(m[0] for m in (re.search(r"attn_\w+?_kernel", name) for name in window) if m)


def _attention_device_times(torch, phase: str, shape: str, dtype_name: str, calls, fwd_bound, bwd_bound) -> dict:
    """The device ms of a forward and a backward call of an attention pair
    and of the library's two calls (``call_device_ms``: the kernels alone,
    without the wrapper's host work), printed beside the bounds."""
    names = ("fwd", "bwd", "lib_fwd", "lib_bwd")
    timed = call_device_ms(torch, list(calls), f"{phase} {shape} {dtype_name}")
    device = {name: ms for name, (ms, _) in zip(names, timed)}
    say(phase, shape=shape, dtype=dtype_name, fwd_device_ms=f"{device['fwd']:.4f}",
        bwd_device_ms=f"{device['bwd']:.4f}", fwd_library_device_ms=f"{device['lib_fwd']:.4f}",
        bwd_library_device_ms=f"{device['lib_bwd']:.4f}", fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}",
        bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", fwd_kernels=timed[0][1], bwd_kernels=timed[1][1])
    return device


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
    elementwise passes between), timed once more on its own; ``int_mm_ms``
    is the two ``torch._int_mm`` products alone, the library's time for the
    GEMM work. Device times (the two kernels, the two products) by
    ``torch.profiler``."""
    import ctypes

    from ssip_tpu_torch.kernels.build import build, kernel_resources, load_library
    from ssip_tpu_torch.ops.qmlp import qmlp_hidden_plain, quantized_mlp, quantized_mlp_plain
    from ssip_tpu_torch.ops.quant import quantize

    info = load_library().ssip_qmlp_info
    info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    resources = kernel_resources(build().log)
    for which, kernel in enumerate(QMLP_KERNELS):
        for d in (192, 384, 768):
            out = (ctypes.c_int * 4)()
            mangled = f"I13__nv_bfloat16Li{d}E" if which == 0 else f"ILi{d}E"
            ptxas = [r for name, r in resources.items() if f"{kernel}{mangled}" in name]
            if info(which, d, out) != 0 or len(ptxas) != 1:
                raise AssertionError(f"{kernel} at width {d}: ptxas reported {ptxas}")
            say("qmlp", kernel=kernel, width=d, registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3], spill_stores=ptxas[0]["spill_stores"], spill_loads=ptxas[0]["spill_loads"])
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
        xq, gq = quantize(y, blk.mlp_1.inv_scale), qmlp_hidden_plain(y, blk)

        def int_mm(xq=xq, gq=gq, blk=blk):
            return torch._int_mm(xq, blk.mlp_1.kernel), torch._int_mm(gq, blk.mlp_2.kernel)

        int_mm_ms = median_ms(torch, int_mm)

        def device(windows):
            kernel = [_kernel_device_ms(windows[0], name, 1) for name in QMLP_KERNELS]
            return None if None in kernel else kernel

        windows = checked_device_windows(
            torch, [lambda: quantized_mlp(y, blk), int_mm], lambda w: None if device(w) else "the two kernels",
            f"qmlp {rows}x{d}")
        (hid_dev_ms, _), (out_dev_ms, _) = device(windows)
        int_mm_dev_ms, int_mm_kernels = _library_device_ms(windows[1])
        ops = 4 * rows * d * hidden
        nbytes = rows * d * (y.element_size() + 4) + 2 * d * hidden + 2 * (d + hidden) * 4
        bound = bound_ms(nbytes, ops, "int8")
        say("qmlp", shape=f"{rows}x{d}", hidden=hidden, dtype=dtype_name, elements=got.numel(), off_by_1e_5=off,
            not_bit_equal=unequal, max_abs_err=worst, allowed_max=f"{allowed:.4g}", ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", library_ms=f"{lib_ms:.4f}", int_mm_ms=f"{int_mm_ms:.4f}",
            bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"], tops=f"{ops / k_ms / 1e9:.1f}",
            int_mm_tops=f"{ops / int_mm_ms / 1e9:.1f}")
        say("qmlp", design=repr(QMLP_DESIGN), shape=f"{rows}x{d}", hidden=hidden, dtype=dtype_name,
            device_ms=f"{hid_dev_ms + out_dev_ms:.4f}", hidden_device_ms=f"{hid_dev_ms:.4f}",
            output_device_ms=f"{out_dev_ms:.4f}", device_tops=f"{ops / (hid_dev_ms + out_dev_ms) / 1e9:.1f}",
            int_mm_device_ms=f"{int_mm_dev_ms:.4f}", int_mm_kernels=int_mm_kernels,
            int_mm_device_tops=f"{ops / int_mm_dev_ms / 1e9:.1f}")
        if (rows, d, hidden, dtype_name) == QMLP_SHAPES[0]:
            result = {"quantized_mlp": {"max_abs_err": worst, "ms": k_ms, "device_ms": hid_dev_ms + out_dev_ms,
                                        "plain_ms": p_ms, **bound, "library_ms": lib_ms, "int_mm_ms": int_mm_ms,
                                        "int_mm_device_ms": int_mm_dev_ms}}
        del y, got, ref, err, blk, xq, gq
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
        attention_bwd, attention_bwd_plain, attention_plain, attention_residuals, attention_rounded_bwd_plain,
        attention_unrounded_plain, fused_attention,
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
        # past 1024 tokens the function rounds p, as the JAX entry's attention_xla does there
        rounded = s > 1024
        plain, plain_bwd = ((attention_plain, attention_rounded_bwd_plain) if rounded
                            else (attention_unrounded_plain, attention_bwd_plain))
        err_o = output_error(torch, out, plain(q, k, v), tag)
        ref = plain_bwd(q, k, v, d_o)
        rels = [grad_error(g, r, dtype_name, f"{tag} d{part}") for g, r, part in zip(grads, ref, "qkv")]
        if dtype_name == "bfloat16" and not rounded:  # p and ds kept to float32 precision: each element within a step
            for g, r, part in zip(grads, ref, "qkv"):
                output_error(torch, g, r, f"{tag} d{part} by element")
        err_g = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, ref))
        del ref

        fwd_ms, fwd_plain_ms = timed_pair(torch, lambda: fused_attention(q, k, v), lambda: plain(q, k, v))
        bwd_ms, bwd_plain_ms = timed_pair(torch, lambda: attention_bwd(q, k, v, d_o, residuals),
                                          lambda: plain_bwd(q, k, v, d_o))
        # the library's yardstick, timed here and called nowhere in the port
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_fwd_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        o_lib = F.scaled_dot_product_attention(*leaves)
        lib_bwd_ms = median_ms(torch, lambda: torch.autograd.grad(o_lib, leaves, d_o, retain_graph=True))
        item = q.element_size()
        ops_type = ATTN_OPS_TYPE[dtype_name]
        fwd_bound = bound_ms(4 * q.numel() * item, 4 * b * heads * s * s * dh, ops_type)
        bwd_bound = bound_ms(7 * q.numel() * item, 10 * b * heads * s * s * dh, ops_type)
        device = {}
        if (b, heads, s, dh, dtype_name) in UNPACKED_ATTN_SHAPES[:2]:  # the main shape, both types
            device = _attention_device_times(
                torch, "attn4", f"{b}x{heads}x{s}x{dh}", dtype_name,
                (lambda: fused_attention(q, k, v), lambda: attention_bwd(q, k, v, d_o, residuals),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 lambda: torch.autograd.grad(o_lib, leaves, d_o, retain_graph=True)),
                fwd_bound, bwd_bound)
        say("attn4", shape=f"{b}x{heads}x{s}x{dh}", dtype=dtype_name, max_abs_err=err_o, dq_rel=rels[0],
            dk_rel=rels[1], dv_rel=rels[2], fwd_ms=f"{fwd_ms:.4f}", fwd_plain_ms=f"{fwd_plain_ms:.4f}",
            fwd_library_ms=f"{lib_fwd_ms:.4f}", fwd_bound_ms=f"{fwd_bound['bound_ms']:.4f}", bwd_ms=f"{bwd_ms:.4f}",
            bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_library_ms=f"{lib_bwd_ms:.4f}",
            bwd_bound_ms=f"{bwd_bound['bound_ms']:.4f}", bound_by=fwd_bound["bound_by"])
        if dtype_name == "bfloat16":
            say("attn4", design=repr(ATTN_MMA_DESIGN if rounded else UNPACKED_MMA_DESIGN), shape=f"{b}x{heads}x{s}x{dh}",
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
                "attention": {"max_abs_err": err_o, "ms": fwd_ms, "device_ms": device["fwd"], "plain_ms": fwd_plain_ms,
                              **fwd_bound, "library_ms": lib_fwd_ms, "library_device_ms": device["lib_fwd"]},
                "attention_bwd": {"max_abs_err": err_g, "ms": bwd_ms, "device_ms": device["bwd"],
                                  "plain_ms": bwd_plain_ms, **bwd_bound, "library_ms": lib_bwd_ms,
                                  "library_device_ms": device["lib_bwd"]},
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
    vit = arch in VIT_FAMILY
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
    floor, mean_floor = (MOE_COSINE_FLOOR, MOE_COSINE_MEAN_FLOOR) if arch == MOE_ARCH else (0.995, 0.995)
    if cos.min() <= floor or cos.mean() <= mean_floor:
        raise AssertionError(f"{arch}: bf16 vs f32 per-image cosine min {cos.min()}, mean {cos.mean()}")
    if arch == MOE_ARCH:
        _moe_router_flips(torch, np, images, cos)

    model = build_model(arch, compute_dtype=torch.float32)
    load_flax_variables(model, seeded_init_host(arch, 42))
    with torch.inference_mode():
        x = torch.from_numpy(images[:n_cpu])
        cpu = model.eval()(preprocess_images(x, RESIZE, CROP, torch.float32)).numpy()
    gpu = embeddings["float32"][:n_cpu]
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if rel > 1e-4:
        raise AssertionError(f"{arch}: cuda f32 vs cpu f32 relative error {rel} > 1e-4 (TF32 on?)")
    say("slice", arch=arch, launches=got, cos_bf16_f32_min=f"{cos.min():.6f}", cos_bf16_f32_mean=f"{cos.mean():.6f}",
        cuda_vs_cpu_f32_rel=rel,
        cpu_checked=n_cpu)
    return {dtype: (embeddings[dtype], *rates[dtype]) for dtype in embeddings}


def _moe_router_flips(torch, np, images, cos) -> None:
    """Queue 3 #12: the tokens of each image whose top-1 expert differs
    between the bfloat16 and the float32 extractor (every expert layer),
    and whether the images whose bf16 vs f32 cosine is below 0.995 are the
    ones with such flips."""
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.ops.preproc import preprocess_images

    flips = np.zeros(len(images), np.int64)
    tokens = 0
    models = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model(MOE_ARCH, compute_dtype=dtype)
        load_flax_variables(model, seeded_init_host(MOE_ARCH, 42))
        models[dtype] = model.cuda().eval()
    with torch.inference_mode():
        for start in range(0, len(images), BATCH):
            x = torch.from_numpy(images[start : start + BATCH]).cuda()
            seen = {}
            for dtype, model in models.items():
                seen[dtype], handles = _router_choices(torch, model)
                try:
                    model(preprocess_images(x, RESIZE, CROP, dtype))
                finally:
                    for h in handles:
                        h.remove()
            for a, c in zip(seen[torch.bfloat16], seen[torch.float32]):
                flips[start : start + len(x)] += (a != c).sum(dim=1).numpy()
            tokens = sum(int(a.shape[1]) for a in seen[torch.float32])  # routed tokens of one image
    low = cos < 0.995
    flipped = flips > 0
    say("moe", check="bf16_vs_f32_router_flips", arch=MOE_ARCH, images=len(images), tokens_per_image=tokens,
        images_with_flips=int(flipped.sum()), flipped_tokens=int(flips.sum()), max_flips_per_image=int(flips.max()),
        below_0995=int(low.sum()), below_0995_with_flips=int((low & flipped).sum()),
        cos_mean_with_flips=f"{cos[flipped].mean():.6f}" if flipped.any() else "none",
        cos_mean_without_flips=f"{cos[~flipped].mean():.6f}" if (~flipped).any() else "none",
        cos_min_without_flips=f"{cos[~flipped].min():.6f}" if (~flipped).any() else "none")


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
                       start_at="preproc_")


def _int8_conv_shapes(module, image_size: int = CROP) -> list:
    """The distinct int8 convolutions of a quantized ResNet's forward at
    ``image_size``: (site, stride, padding, input side, uses a forward)."""
    shapes: dict = {}

    def add(site, stride, pad, side):
        key = (site.kh, site.cin, site.gemm.shape[1], stride, side)
        shapes.setdefault(key, [site, stride, pad, side, 0])[4] += 1

    add(module.stem, 2, 3, image_size)
    side = image_size // 4  # after the stem and the max-pool
    for block, stride in zip(module.blocks, module.strides):
        if module.bottleneck:
            add(block.conv1, 1, 0, side)
            add(block.conv2, stride, 1, side)
            add(block.conv3, 1, 0, side // stride)
        else:
            add(block.conv1, stride, 1, side)
            add(block.conv2, 1, 1, side // stride)
        if block.downsample is not None:
            add(block.downsample, stride, 0, side)
        side //= stride
    return list(shapes.values())


def phase_int8_resnet(torch, np, tmp: Path, corpus, counts: LaunchCounts, dense: dict) -> None:
    """``run_extraction`` of resnet18 with ``compute_dtype="int8"`` on the
    corpus (the stem's operand from the preprocess kernel's int8 epilogue),
    beside the float32 and bfloat16 runs of the same seeded weights
    (``dense``); then each distinct int8 convolution of the forward at batch
    128: card against CPU (equal integers) and timed beside its
    ``torch._int_mm`` and its bound."""
    from ssip_tpu_torch.models.quantized import _qconv_raw, im2col
    from ssip_tpu_torch.pipelines import extraction
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry

    data, records, _, store = corpus
    arch, batches, runs = "resnet18", N_IMAGES // BATCH, 2
    out = tmp / f"out_{arch}_int8"
    cfg = extraction.ExtractionConfig(data_dir=data, output_dir=out, batch_size=BATCH, device="cuda",
                                      compute_dtype="int8", cache_decoded=False, arch=arch)
    built = []
    real_quantize = extraction._quantize_variables

    def keep(*args):  # the quantized module the run built, for the convolutions below
        built.append(real_quantize(*args))
        return built[-1]

    extraction._quantize_variables = keep
    counts.reset()  # count only the main path's launches
    try:
        extraction.run_extraction(cfg, store=store)  # warm: cuBLASLt and allocator set-up
        torch.cuda.reset_peak_memory_stats()
        summary = extraction.run_extraction(cfg, store=store)
    finally:
        extraction._quantize_variables = real_quantize
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = counts.read()
    emb = summary.embeddings
    if emb.shape != (N_IMAGES, 512) or not np.isfinite(emb).all():
        raise AssertionError(f"{arch} int8: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
    reg = ArtifactRegistry(out)
    for path in (reg.embeddings_npy, reg.embeddings_csv, reg.features_metadata_json, reg.feature_summary_md,
                 reg.extraction_log):
        if not path.is_file():
            raise AssertionError(f"{arch} int8: missing artifact {path}")
    meta = json.loads(reg.features_metadata_json.read_text())
    if meta["weights"] != "random_init:seed=42+int8_ptq" or meta["embedding_dimension"] != 512:
        raise AssertionError(f"{arch} int8: metadata {meta['weights']} {meta['embedding_dimension']}")
    # calibration runs the host chain and float32 convolutions: no kernel
    want = {"preprocess_quantize": runs * batches, "preprocess_images": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{arch} int8: the extraction path launched {got}, expected {want}")
    f32_emb, f32_rate, _ = dense["float32"]
    _, bf16_rate, bf16_peak = dense["bfloat16"]
    cos = (_unit(np, emb) * _unit(np, f32_emb)).sum(axis=1)
    if not cos.min() > INT8_RESNET_COSINE_FLOOR:
        raise AssertionError(f"{arch}: int8 vs f32 per-image cosine min {cos.min()}, floor {INT8_RESNET_COSINE_FLOOR}")
    rate = N_IMAGES / summary.embed_seconds
    say("int8_resnet", arch=arch, images=N_IMAGES, batch=BATCH, embed_s=f"{summary.embed_seconds:.4f}",
        imgs_per_s=f"{rate:.1f}", bf16_imgs_per_s=f"{bf16_rate:.1f}", f32_imgs_per_s=f"{f32_rate:.1f}",
        vs_bf16=f"{rate / bf16_rate:.3f}", e2e_s=f"{summary.total_seconds:.3f}", peak_mem_gib=f"{peak_gib:.2f}",
        bf16_peak_mem_gib=f"{bf16_peak:.2f}", launches=got, cos_int8_f32_min=f"{cos.min():.6f}",
        cos_int8_f32_mean=f"{cos.mean():.6f}", floor=INT8_RESNET_COSINE_FLOOR)

    module = built[-1]
    rng = np.random.default_rng(SEED + 60)
    total_ms = total_mm = total_bound = 0.0
    for site, stride, pad, side, uses in _int8_conv_shapes(module):
        x = torch.from_numpy(rng.integers(-127, 128, (BATCH, side, side, site.cin), dtype=np.int8))
        card = _qconv_raw(x.cuda(), site, stride, pad)
        cpu_site = type(site)(**site.leaves())
        cpu = _qconv_raw(x, cpu_site, stride, pad)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"int8 conv {site.kh}x{site.kh}/{stride} {side}² {site.cin}→{site.gemm.shape[1]}: "
                                 f"card and CPU differ on {(card.cpu() != cpu).sum().item()} values")
        xc = x.cuda()
        cols, _ = im2col(xc, site.kh, site.kw, stride, pad, site.gemm.shape[0])
        m, k, n = cols.shape[0], site.kh * site.kw * site.cin, site.gemm.shape[1]
        conv_ms = median_ms(torch, lambda: _qconv_raw(xc, site, stride, pad))
        mm_ms = median_ms(torch, lambda: torch._int_mm(cols, site.gemm))
        bound = bound_ms(xc.numel() + site.gemm.numel() + 4 * m * n, 2.0 * m * k * n, "int8")
        total_ms, total_mm, total_bound = total_ms + uses * conv_ms, total_mm + uses * mm_ms, \
            total_bound + uses * bound["bound_ms"]
        say("int8_resnet", conv=f"{site.kh}x{site.kw}/{stride}", input=f"[{BATCH},{side},{side},{site.cin}]",
            out_channels=n, gemm=f"[{m},{cols.shape[1]}]x[{cols.shape[1]},{n}]", uses=uses,
            card_vs_cpu="equal", ms=f"{conv_ms:.4f}", int_mm_ms=f"{mm_ms:.4f}",
            im2col_and_rest_ms=f"{conv_ms - mm_ms:.4f}", bound_ms=f"{bound['bound_ms']:.4f}",
            bound_by=bound["bound_by"])
    say("int8_resnet", forward_convs_ms=f"{total_ms:.3f}", forward_int_mm_ms=f"{total_mm:.3f}",
        forward_bound_ms=f"{total_bound:.3f}", batch=BATCH,
        embed_ms_a_batch=f"{summary.embed_seconds / batches * 1e3:.3f}")


def phase_cli(np, tmp: Path) -> None:
    """The extraction CLI as a subprocess, with a ResNet in bfloat16 and a ViT
    in int8 (the extraction CLI runs in process in ``workflow`` and ``dp``).
    The two run at once: neither times anything."""
    from PIL import Image

    data = tmp / "jpegs"
    rng = np.random.default_rng(SEED + 2)
    for rel in ("avec_labels/cancer/a.jpg", "avec_labels/normal/b.jpg",
                "sans_label/c.jpg", "sans_label/d.jpg"):
        (data / rel).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(data / rel)
    runs = (("resnet18", 512, "bfloat16"), ("vit_t16", 192, "int8"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ssip_tpu_torch.cli.feature_extraction", "--data-dir", str(data),
         "--device", "cuda", "--batch-size", "4", "--compute-dtype", dtype, "--arch", arch,
         "--output-dir", str(tmp / f"cli_out_{arch}_{dtype}")],
        cwd=Path(__file__).resolve().parent,
    ) for arch, _, dtype in runs]
    try:
        rcs = [proc.wait(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, rc in zip(procs, rcs):
        if rc != 0:
            raise subprocess.CalledProcessError(rc, proc.args)
    for arch, width, dtype in runs:
        out = tmp / f"cli_out_{arch}_{dtype}"
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


def phase_train(torch, np, tmp: Path, data: Path, counts: LaunchCounts, arch: str, runs, tag: str = "train") -> None:
    """``run_supervised`` of ``arch`` on the JPEG tree, once per
    (compute type, epochs[, image size]) of ``runs`` (224² unless given)."""
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

    for dtype, epochs, *size in runs:
        size = size[0] if size else TRAIN_SIZE
        out = tmp / f"train_out_{arch}_{dtype}_{size}"
        cfg = TrainingConfig(
            strong_data_dir=data, output_dir=out, device="cuda", batch_size=TRAIN_BATCH, arch=arch,
            image_size=size, baseline_epochs=epochs, target_recall=0.9, compute_dtype=dtype,
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
        if payload["splits"] != want_splits or payload["arch"] != arch or payload["image_size"] != size:
            raise AssertionError(f"train {arch} {dtype}: splits or arch differ from the CPU split: {payload['splits']}")
        model = build_model(arch, num_classes=2, image_size=size)
        load_checkpoint(reg.baseline_checkpoint, model)
        steps = epochs * steps_per_epoch
        want = {"augment_images": steps}
        if arch.startswith("vit"):  # every ViT the repo trains is 12 blocks deep
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
        say(tag, arch=arch, dtype=dtype, image_size=size, images=2 * TRAIN_PER_CLASS, batch=TRAIN_BATCH, epochs=epochs,
            seconds=f"{seconds:.2f}", train_loss=f"{hist['train_loss'][-1]:.4f}",
            val_loss=f"{hist['val_loss'][-1]:.4f}", test_f1=f"{thr['f1']:.4f}",
            threshold=f"{thr['threshold']:.4f}", csv_columns=len(header.split(",")) - 1,
            launches={k: v for k, v in launches.items() if v})


def _kink_free(torch, model) -> None:
    """A ResNet's seeded weights moved off the ReLU kinks, in place: every
    BatchNorm bias raised by ``KINK_FREE_BN_BIAS``, every conv filter
    re-centred (``tests/test_torch_train.py:_kink_free``)."""
    from ssip_tpu_torch.models.resnet import BatchNorm, Conv

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, BatchNorm):
                module.bias.add_(KINK_FREE_BN_BIAS)
            elif isinstance(module, Conv):
                module.weight.sub_(module.weight.mean(dim=(1, 2, 3), keepdim=True))


def _seeded_state(torch, device, dtype, arch: str = "resnet18", kink_free: bool = False, remat: bool = False):
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.train.engine import TrainState

    model = build_model(arch, num_classes=2, compute_dtype=dtype, remat=remat, image_size=TRAIN_SIZE)
    load_flax_variables(model, seeded_init_host(arch, 42, num_classes=2, image_size=TRAIN_SIZE))
    if kink_free:
        _kink_free(torch, model)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState.create(model, 1e-4, 1e-4)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# kernel-name fragments → the layer a profile line is charged to, first match wins
_PROFILE_CLASSES = (
    ("augment kernel", AUGMENT_KERNELS),
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
    # attn_qkv: the packed bf16 pair's attn_qkv_fwd_mma_kernel, attn_qkv_bwd_whole_kernel and the streamed kernels
    ("attention kernels", ("attn_qkv", "attn_f32_fwd", "attn_f32_bwd")),
    ("augment kernel", AUGMENT_KERNELS),
    ("preprocess kernel", ("preproc_",)),
    ("AdamW", ("multi_tensor_apply", "adam")),
    ("Dense GEMMs and patch conv (cuBLAS, cuDNN)", ("nvjet", "gemm", "cutlass", "cublas", "xmma", "sm90_", "sm80_",
                                                   "gemv", "splitk", "conv", "cudnn", "implicit", "wgrad", "dgrad")),
    ("GELU, casts, adds, bias and loss (elementwise and reductions)", ("elementwise", "reduce", "vectorized",
                                                                      "unrolled", "index", "where", "softmax",
                                                                      "nll", "scatter", "gelu", "cat", "copy")),
)


# the same for the int8 embed loop: every GEMM in it is a ``torch._int_mm``
_INT8_PROFILE_CLASSES = (
    ("int8 MLP kernels", QMLP_KERNELS),
    ("LayerNorm kernels", ("ln_fwd_kernel",)),
    ("attention kernels", ("attn_qkv",)),
    ("preprocess kernel (int8 form)", ("preproc_",)),
    ("int8 GEMMs: stem, qkv, out (torch._int_mm, cuBLASLt)", _VIT_PROFILE_CLASSES[5][1] + ("imma", "igemm", "i8")),
    ("quantize, dequantize, casts and adds (elementwise)", _VIT_PROFILE_CLASSES[6][1]),
)


PROFILE_LEAD_IN_GAP_S = 0.05


class LeadInCutError(AssertionError):
    """A step profile whose lead-in cut did not land on the sleep. ``kind``:
    "dropped records" (the cut is the sleep, but the kept steps hold fewer
    kernels than the lead-in step), "gap inside the steps" (a gap larger
    than the sleep, which is still there) or "no sleep"."""

    def __init__(self, message: str, kind: str):
        super().__init__(message)
        self.kind = kind


def _profile_steps(torch, step, tag: str, classes) -> None:
    """Profile the lead-in ``step(None)``, the sleep and ``STEP_TIMED``
    steps ``step(i)``, and print ``_profile_breakdown``'s reading. A trace
    whose cut did not land on the sleep because of dropped records or of a
    gap inside the steps is taken once more, its kind printed: CUPTI can
    drop records of a long window (on an H100 one run's ``vit_b16`` FixMatch
    trace kept 1,123 kernels a step of the 1,742 launched), and one run's
    ``vit_b16`` f32 FixMatch trace held a 384 ms gap inside its steps (cause
    not known). A trace with no sleep-sized gap, or a second failed trace,
    fails the run."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(2):
        torch.cuda.synchronize()
        # device kernels only: a CPU trace of the steps' host ops costs far
        # more to read than the steps take, and the breakdown reads kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(None)  # the lead-in
            torch.cuda.synchronize()
            time.sleep(PROFILE_LEAD_IN_GAP_S)
            start.record()
            for i in range(STEP_TIMED):
                step(i)
            end.record()
            end.synchronize()
        try:
            _profile_breakdown(torch, prof, start.elapsed_time(end), tag, classes, steps=STEP_TIMED)
            return
        except LeadInCutError as e:
            if attempt or e.kind == "no sleep":
                raise
            say("profile", run=tag, traced_again=repr(e.kind), reason=repr(str(e)))


def _profile_breakdown(torch, prof, window_ms: float, tag: str, classes=_PROFILE_CLASSES, start_at=None,
                       steps: int = 0) -> None:
    """Device time of the profiled steps by layer and by kernel, and the
    idle share of the window. ``start_at``: a kernel-name fragment; kernels
    before the first kernel that holds it are left out. ``steps``: the
    session opened with a lead-in step the window does not count (a session
    that is not the process's first can lose its first records), then a
    sleep of ``PROFILE_LEAD_IN_GAP_S``, then ``steps`` timed steps; kernels
    up to the trace's largest gap are left out. That gap must be the sleep:
    at least 0.9 of its length (the clocks of host and card), with no more
    kernels before it than 1.1 kept steps have (the cut did not land inside
    the timed steps; the MoE FixMatch step's count varies by about 1 %);
    the next largest gap is printed beside it."""
    cuda = torch.autograd.DeviceType.CUDA
    # kernels only: copies between host and card (a corpus being staged) are
    # not work of the window that is measured
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == cuda and not e.name.startswith(("Memcpy", "Memset"))), key=lambda k: k[1])
    if start_at is not None:
        first = next((i for i, k in enumerate(kernels) if start_at in k[0]), len(kernels))
        kernels = kernels[first:]
    if steps:  # the time ranges are in microseconds
        gaps = [kernels[i][1] - kernels[i - 1][2] for i in range(1, len(kernels))]
        cut = max(range(len(gaps)), key=gaps.__getitem__) + 1 if gaps else 0
        lead, kernels = cut, kernels[cut:]
        per_step = len(kernels) / steps
        second = sorted(gaps)[-2] if len(gaps) > 1 else 0.0
        say("profile", run=tag, lead_in_kernels=lead, kernels_per_step=f"{per_step:.1f}",
            lead_in_gap_ms=f"{gaps[cut - 1] / 1e3 if cut else 0.0:.3f}", next_gap_ms=f"{second / 1e3:.3f}")
        sleep_us = 0.9 * PROFILE_LEAD_IN_GAP_S * 1e6
        if not cut or gaps[cut - 1] < sleep_us or lead > 1.1 * per_step:
            kind = ("no sleep" if not cut or gaps[cut - 1] < sleep_us else
                    "gap inside the steps" if second >= sleep_us else "dropped records")
            raise LeadInCutError(f"{tag}: the lead-in cut did not land on the sleep (lead-in {lead} kernels, "
                                 f"{per_step:.1f} a kept step, gaps {gaps[cut - 1] if cut else 0} and {second} us)",
                                 kind)
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


def _timed_steps(torch, np, arch: str, counts: LaunchCounts, classes, dtypes=("bfloat16", "float32")) -> None:
    """The steady-state step at batch 128 in each of ``dtypes``: timed,
    then profiled."""
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
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
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
        if arch in VIT_FAMILY:
            want.update(layer_norm=VIT_LN_PER_FORWARD, layer_norm_bwd=VIT_LN_PER_FORWARD,
                        attention_qkv=VIT_ATTN_PER_FORWARD, attention_qkv_bwd=VIT_ATTN_PER_FORWARD)
        if launches != want:
            raise AssertionError(f"{arch} {dtype_name}: launches per step {launches}, expected {want}")
        say("step", arch=arch, dtype=dtype_name, batch=b, timed_steps=STEP_TIMED, ms_per_step=f"{step_ms:.3f}",
            train_imgs_per_s=f"{b / step_ms * 1000:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
            launches_per_step=launches)
        _profile_steps(torch, lambda i: train_step(state, images, labels, valid,
                                                   coeffs[n_steps - 1 if i is None else n_steps + i]),
                       f"{arch}_step_{dtype_name}", classes)
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


def phase_semi(torch, np, tmp: Path, data: Path, pool: Path, counts: LaunchCounts, arch: str, dtypes,
               strong_aug: str = "jitter", tag: str = "semi") -> None:
    """``run_pipeline`` of ``arch`` with the FixMatch fine-tune (its strong
    view ``strong_aug``) on the JPEG tree and pool, once per compute type.
    The pipeline's two epoch loops are wrapped to read what no artifact
    holds: the state after the weak pretrain, and the keep rates (cut from
    the history file)."""
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
        # the jitter runs' outputs are read again by [serve] and [moe]
        out = tmp / (f"semi_out_{arch}_{dtype}" if strong_aug == "jitter" else f"semi_out_{arch}_{dtype}_{strong_aug}")
        cfg = TrainingConfig(
            strong_data_dir=data, weak_data_dir=pool, output_dir=out, device="cuda", batch_size=TRAIN_BATCH, arch=arch,
            image_size=TRAIN_SIZE, baseline_epochs=SEMI_EPOCHS[0], weak_pretrain_epochs=SEMI_EPOCHS[1],
            finetune_epochs=SEMI_EPOCHS[2], target_recall=0.9, compute_dtype=dtype,
            pseudo_label_threshold=SEMI_THRESHOLD, consistency_weight=1.0, consistency_threshold=SEMI_THRESHOLD,
            ema_decay=SEMI_EMA_DECAY, strong_augment=strong_aug,
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
        what = f"semi {arch} {dtype} {strong_aug}"
        payload = _check_semi_outputs(np, out, arch, SEMI_EPOCHS, what)
        if not (seen["keep_rate"] > 0 and np.isfinite(seen["cons_loss"]).all()):
            raise AssertionError(f"{what}: keep rate {seen['keep_rate']}, consistency losses {seen['cons_loss']}")
        # after the weak pretrain: of the parameters only the head moved; a
        # ResNet's frozen backbone still moved its BatchNorm running means
        head = ("fc.", "heads.head.")
        moved_params = [k for k in seen["moved"] if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
        moved_means = [k for k in seen["moved"] if k.endswith("running_mean")]
        if not seen["mask"] or not moved_params or not all(k.startswith(head) for k in moved_params):
            raise AssertionError(f"{what}: the weak pretrain moved {moved_params[:6]}")
        if arch not in VIT_FAMILY and not moved_means:
            raise AssertionError(f"{what}: the weak pretrain left every BN running mean where it was")
        fix_steps = SEMI_EPOCHS[2] * steps_per_epoch
        pretrain_steps = SEMI_EPOCHS[1] * -(-payload["pseudo_label_count"] // TRAIN_BATCH)
        backward_steps = SEMI_EPOCHS[0] * steps_per_epoch + pretrain_steps + fix_steps
        want = {"rotate_images": fix_steps if strong_aug == "jitter" else 0, "augment_images": backward_steps}
        if arch in VIT_FAMILY:
            # a FixMatch step's backward runs through the labeled and the
            # strong view; the weak pretrain's stops at the head (the frozen
            # backbone needs no gradient), so it launches no backward kernel
            backwards = SEMI_EPOCHS[0] * steps_per_epoch + 2 * fix_steps
            want.update(layer_norm_bwd=backwards * VIT_LN_PER_FORWARD,
                        attention_qkv_bwd=backwards * VIT_ATTN_PER_FORWARD)
            forwards = launches["attention_qkv"] // VIT_ATTN_PER_FORWARD
            if forwards <= backward_steps + 2 * fix_steps or launches["layer_norm"] != forwards * VIT_LN_PER_FORWARD:
                raise AssertionError(f"{what}: forward launches {launches}")
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{what}: the semi-supervised path launched {got}, expected {want}")
        thr = results["semi_thresholded"]
        say(tag, arch=arch, dtype=dtype, strong_aug=strong_aug, labeled=2 * TRAIN_PER_CLASS, pool=POOL_IMAGES, batch=TRAIN_BATCH,
            epochs=SEMI_EPOCHS, seconds=f"{seconds:.2f}", pseudo_labels=payload["pseudo_label_count"],
            fixmatch_steps=fix_steps, keep_rate=f"{seen['keep_rate']:.3f}",
            cons_loss=f"{seen['cons_loss'][-1]:.4f}", val_loss=f"{payload['semi_finetune']['val_loss'][-1]:.4f}",
            test_f1=f"{thr['f1']:.4f}", threshold=f"{thr['threshold']:.4f}", pretrain_moved=len(moved_params),
            bn_means_moved=len(moved_means), launches={k: v for k, v in launches.items() if v})


def _bucket(n: int, max_batch: int = 256) -> int:
    """``ExportedModel``'s power-of-two batch for ``n`` images."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return b


def phase_serve(torch, np, tmp: Path, pool: Path, counts: LaunchCounts) -> None:
    """Serving on the card, from the run directories ``semi`` wrote
    (``resnet18`` float32, ``vit_b16`` bfloat16; their checkpoints hold
    float32 weights): the in-process predictor against the CPU's, the
    ``export_model`` CLI's artifact against the predictor at batch 1, 3 and
    128 (float32 and bfloat16, and for the ViT the launches of the LayerNorm
    and attention kernels inside the exported program), the float32 artifact
    on the CPU (and for the ViT one traced on the CPU run on the card), the
    int8 ``resnet18`` artifact against the float32 one, the ``serve`` CLI's server answering
    requests, and the card's training resize against the CPU's at 512→224."""
    from ssip_tpu_torch.cli import export_model, serve
    from ssip_tpu_torch.data.decode import decode_batch
    from ssip_tpu_torch.deploy import server as server_module
    from ssip_tpu_torch.deploy.export import ExportedModel
    from ssip_tpu_torch.runtime.device import float32_products
    from ssip_tpu_torch.serving import ScreeningPredictor
    from ssip_tpu_torch.train.data import resize_on_device

    pool_paths = sorted(pool.glob("*.jpg"))
    arrays, _ = decode_batch(pool_paths[:SERVE_BATCH], num_threads=8, convert_rgb=True)

    def timed_resize(device: str):
        t0 = time.perf_counter()
        resized = resize_on_device(arrays, TRAIN_SIZE, torch.device(device))
        torch.cuda.synchronize()
        return resized, time.perf_counter() - t0

    timed_resize("cuda")  # the first call on the card also warms it
    card_u8, card_s = timed_resize("cuda")
    cpu_u8, cpu_s = timed_resize("cpu")
    resize_diff = card_u8.cpu() != cpu_u8
    say("serve", resize=f"{SIZE}->{TRAIN_SIZE}", images=len(arrays), card_vs_cpu_values_off=int(resize_diff.sum()),
        of=resize_diff.numel(), largest_step=int((card_u8.cpu().int() - cpu_u8.int()).abs().max()),
        card_s=f"{card_s:.4f}", cpu_s=f"{cpu_s:.4f}", cpu_threads=torch.get_num_threads())
    if resize_diff.any():
        raise AssertionError(f"serve: the card's training resize is {int(resize_diff.sum())} values off the CPU's")
    images = cpu_u8.numpy()  # one set of eval-resized inputs for every comparison below

    for arch, run in (("resnet18", "semi_out_resnet18_float32"), (VIT_ARCH, "semi_out_vit_b16_bfloat16")):
        out = tmp / run
        with float32_products():
            card = ScreeningPredictor.from_artifacts(out, batch_size=BATCH, device="cuda")
            cpu = ScreeningPredictor.from_artifacts(out, batch_size=SERVE_CPU_CHECK, device="cpu")
            card_probs = card.predict_probs(images[:SERVE_CPU_CHECK])
            cpu_probs = cpu.predict_probs(images[:SERVE_CPU_CHECK])
        vs_cpu = float(np.abs(card_probs - cpu_probs).max())
        if not vs_cpu <= SERVE_CPU_ATOL:
            raise AssertionError(f"serve {arch}: card vs CPU probabilities {vs_cpu} > {SERVE_CPU_ATOL}")
        for dtype in ("float32", "bfloat16"):
            artifact = tmp / f"serve_{arch}_{dtype}.ssip.npz"
            t0 = time.perf_counter()
            export_model.main(["--output-dir", str(out), "--out", str(artifact), "--compute-dtype", dtype])
            export_s = time.perf_counter() - t0
            exported = ExportedModel.load(artifact)
            predictor = ScreeningPredictor.from_artifacts(out, compute_dtype=dtype, device="cuda")
            worst, forwards = 0.0, 0
            counts.reset()
            for n in SERVE_BATCHES:
                predictor.batch_size = _bucket(n)  # the exported model's bucket: the same shapes on both
                got = exported.predict_probs(images[:n])
                forwards += 1
                worst = max(worst, float(np.abs(got - predictor.predict_probs(images[:n])).max()))
            launches = counts.read()
            if dtype == "float32" and not worst <= SERVE_EXPORT_ATOL:
                raise AssertionError(f"serve {arch}: exported vs in-process {worst} > {SERVE_EXPORT_ATOL}")
            if dtype == "bfloat16" and not worst <= SERVE_BF16_ATOL:
                raise AssertionError(f"serve {arch} bf16: exported vs in-process {worst} > {SERVE_BF16_ATOL}")
            if arch == VIT_ARCH:
                # each batch runs once exported and once in process
                want = {"layer_norm": 2 * forwards * VIT_LN_PER_FORWARD,
                        "attention_qkv": 2 * forwards * VIT_ATTN_PER_FORWARD}
                if {k: launches[k] for k in want} != want:
                    raise AssertionError(f"serve {arch} {dtype}: launches {launches}, expected {want}")
            t0 = time.perf_counter()
            for _ in range(SERVE_TIMED):
                exported.predict_probs(images)
            rate = SERVE_TIMED * len(images) / (time.perf_counter() - t0)  # predict_probs returns host numbers
            say("serve", arch=arch, dtype=dtype, export_s=f"{export_s:.2f}", batches=SERVE_BATCHES,
                exported_vs_in_process=worst, card_vs_cpu_f32=vs_cpu, artifact_mb=f"{artifact.stat().st_size / 1e6:.1f}",
                imgs_per_s_at_128=f"{rate:.1f}", launches={k: v for k, v in launches.items() if v})

        # one artifact, both platforms: the card's float32 trace run on the
        # CPU, and for the ViT a trace made on the CPU run on the card (the
        # program moved to the device it is loaded on, where its custom
        # operators launch the kernels)
        card_traced = ExportedModel.load(tmp / f"serve_{arch}_float32.ssip.npz", device="cpu")
        on_cpu = float(np.abs(card_traced.predict_probs(images[:SERVE_CPU_CHECK]) - cpu_probs).max())
        if arch != VIT_ARCH:
            if not on_cpu <= SERVE_MOVED_ATOL:
                raise AssertionError(f"serve {arch}: card trace on the CPU {on_cpu}")
            say("serve", arch=arch, dtype="float32", card_trace_on_cpu_vs_cpu_predictor=on_cpu)
            continue
        cpu_traced = tmp / f"serve_{arch}_cpu_traced.ssip.npz"
        export_model.main(["--output-dir", str(out), "--out", str(cpu_traced), "--device", "cpu"])
        counts.reset()
        on_card = float(np.abs(ExportedModel.load(cpu_traced).predict_probs(images) - card.predict_probs(images)).max())
        launches = counts.read()
        if (launches["layer_norm"], launches["attention_qkv"]) != (
                2 * VIT_LN_PER_FORWARD, 2 * VIT_ATTN_PER_FORWARD):
            raise AssertionError(f"serve {arch}: the CPU-traced program on the card launched {launches}")
        if not (on_cpu <= SERVE_MOVED_ATOL and on_card <= SERVE_MOVED_ATOL):
            raise AssertionError(f"serve {arch}: card trace on the CPU {on_cpu}, CPU trace on the card {on_card}")
        say("serve", arch=arch, dtype="float32", card_trace_on_cpu_vs_cpu_predictor=on_cpu,
            cpu_trace_on_card_vs_card_predictor=on_card, launches={k: v for k, v in launches.items() if v})

    out = tmp / "semi_out_resnet18_float32"
    f32 = ExportedModel.load(tmp / "serve_resnet18_float32.ssip.npz")
    artifact = tmp / "serve_resnet18_int8.ssip.npz"
    export_model.main(["--output-dir", str(out), "--out", str(artifact), "--compute-dtype", "int8",
                       "--calibration-images", str(pool)])
    int8 = ExportedModel.load(artifact)
    int8_probs = int8.predict_probs(images)
    vs_f32 = float(np.abs(int8_probs - f32.predict_probs(images)).max())
    if int8.manifest["calibration_images"] != 32 or not np.isfinite(int8_probs).all() or not vs_f32 <= 0.25:
        raise AssertionError(f"serve int8: {int8.manifest['calibration_images']} calibration images, vs f32 {vs_f32}")
    t0 = time.perf_counter()
    for _ in range(SERVE_TIMED):
        int8.predict_probs(images)
    say("serve", arch="resnet18", dtype="int8", vs_f32=vs_f32, calibration_images=32,
        imgs_per_s_at_128=f"{SERVE_TIMED * len(images) / (time.perf_counter() - t0):.1f}")

    # the serve CLI's server (its model and server, as its main builds them)
    # on 127.0.0.1, port 0, in a thread of this process
    import http.client
    import socket
    import threading
    import urllib.request

    args = serve.parse_args(["--model-file", str(tmp / "serve_resnet18_float32.ssip.npz"), "--port", "0"])
    httpd = server_module.make_server(serve.build_model(args), host=args.host, port=args.port)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def call(path, body=None):
            req = urllib.request.Request(base + path, data=body, method="POST" if body is not None else "GET")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.load(r)

        health, manifest = call("/healthz"), call("/manifest")
        if health != {"status": "ok", "model": "resnet18"} or manifest["arch"] != "resnet18":
            raise AssertionError(f"serve: /healthz {health}, /manifest arch {manifest.get('arch')}")
        def call_nodelay(body):
            # a client with Nagle's algorithm off: urllib sends a body above
            # 2,920 bytes in a write of its own, which then waits for the
            # server's delayed ACK of the headers
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.request("POST", "/predict", body=body)
            answer = json.load(conn.getresponse())
            conn.close()
            return answer

        call("/predict", pool_paths[0].read_bytes())  # warm
        times, answers, in_process, in_thread, nodelay = [], [], [], [], []
        for path in pool_paths[:SERVE_REQUESTS]:
            body = path.read_bytes()
            t0 = time.perf_counter()
            answers.append(call("/predict", body))
            times.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            if call_nodelay(body) != answers[-1]:
                raise AssertionError("serve: two clients got two answers to one image")
            nodelay.append((time.perf_counter() - t0) * 1e3)
            # the same work without HTTP (decode, resize on the card, batch 1),
            # here and in a thread started for it, as the server starts one
            # a request
            def work():
                arr = server_module._decode_image_bytes(body)
                f32.predict_images(resize_on_device([arr], TRAIN_SIZE, f32.device))

            t0 = time.perf_counter()
            work()
            in_process.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            worker = threading.Thread(target=work)
            worker.start()
            worker.join()
            in_thread.append((time.perf_counter() - t0) * 1e3)
        rows = call("/predict_paths", json.dumps({"paths": [str(p) for p in pool_paths[:SERVE_REQUESTS]]}).encode())
        direct = f32.predict_paths(pool_paths[:SERVE_REQUESTS])[0]
        if (len(answers) != SERVE_REQUESTS or len(rows["rows"]) != SERVE_REQUESTS or rows["failures"]
                or max(abs(a["prob_positive"] - float(p)) for a, p in zip(answers, direct.prob_positive)) > 1e-5
                or max(abs(r["prob_positive"] - float(p)) for r, p in zip(rows["rows"], direct.prob_positive)) > 1e-5):
            raise AssertionError(f"serve: answers {answers[:2]}, rows {rows['rows'][:2]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    say("serve", server="cli.serve --model-file resnet18 float32", requests=2 + 1 + 2 * SERVE_REQUESTS + 1,
        answered="all", predict_ms_a_request=f"{sum(times) / len(times):.2f}",
        predict_ms_median=f"{_median(times):.2f}", nodelay_client_ms_median=f"{_median(nodelay):.2f}",
        same_work_in_process_ms_median=f"{_median(in_process):.2f}",
        same_work_in_a_new_thread_ms_median=f"{_median(in_thread):.2f}", jpeg=f"{SIZE}x{SIZE}")


def _fixmatch_inputs(torch, np, b: int, padded_rows: int = 0):
    """(labeled batch, unlabeled images) on the CPU, seeded."""
    rng = np.random.default_rng(SEED + 13 + b)
    unlabeled = torch.from_numpy(rng.integers(0, 256, (b, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8))
    return _step_inputs(torch, np, b, padded_rows), unlabeled


def _one_fixmatch_step(torch, arch: str, dev, batch, unlabeled, draws, kink_free: bool = False, captures=None):
    """One float32 FixMatch step with an EMA teacher at the seeded weights on
    ``dev``: (losses and keep rate, gradients, BN running statistics), on
    the CPU. ``captures`` maps module names to lists: each such module
    appends to its list, for each view that is differentiated, its input
    ``x``, its ``weight``, the BatchNorm ``mask`` it was given (a conv's
    ``stride`` and ``padding``), its output ``y`` and the gradient ``dy``
    that reaches it, on ``dev``."""
    from ssip_tpu_torch.train.consistency import fixmatch_step, init_ema

    state = _seeded_state(torch, dev, torch.float32, arch, kink_free)

    def capture(views):
        def hook(module, args, kwargs, output):
            if output.requires_grad:  # the labeled and the strong view; the teacher's runs without grad
                mask = args[1] if len(args) > 1 else kwargs.get("mask")
                view = {"x": args[0].detach().clone(), "weight": module.weight.detach().clone(),
                        "mask": None if mask is None else mask.detach().clone(),
                        "stride": getattr(module, "stride", None), "padding": getattr(module, "padding", None),
                        "y": output.detach().clone()}
                output.register_hook(lambda g: view.__setitem__("dy", g.detach().clone()))
                views.append(view)
        return hook

    handles = [state.model.get_submodule(name).register_forward_hook(capture(views), with_kwargs=True)
               for name, views in (captures or {}).items()]
    try:
        out = fixmatch_step(
            state, init_ema(state.model), *(t.to(dev) for t in batch), unlabeled.to(dev), draws.to(dev),
            consistency_weight=1.0, confidence_threshold=SEMI_THRESHOLD, ema_decay=SEMI_EMA_DECAY,
        )
    finally:
        for handle in handles:
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
        x, scale, dy = card["x"], card["weight"], card["dy"]
        _, k_ds, k_db = layer_norm_bwd(x, scale, dy, LN_EPS)
        _, p_ds, p_db = layer_norm_bwd_plain(x, scale, dy, LN_EPS)
        # the plain version computes in float32 whatever it is given: float64 written out here
        x64, dy64 = x.double(), dy.double()
        xc = x64 - x64.mean(dim=-1, keepdim=True)
        ref_ds = (dy64 * xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)).sum(dim=0)
        ref_db = dy64.sum(dim=0)
        _, c_ds, c_db = layer_norm_bwd_plain(cpu["x"], cpu["weight"], cpu["dy"], LN_EPS)
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


def _bn_normalized(torch, x, mask):
    """``models/resnet.py:BatchNorm``'s train-mode x̂ in ``x``'s type: the
    statistics of the rows ``mask`` keeps (all without one), E[x²] − E[x]²
    clamped at 0, written out as the module computes them."""
    from ssip_tpu_torch.models.resnet import BN_EPS

    axes, shape = (0, 2, 3), (1, -1, 1, 1)
    if mask is None:
        mean = x.mean(axes)
        var = (x * x).mean(axes) - mean * mean
    else:
        w = mask.to(x.dtype).view(-1, 1, 1, 1)
        count = torch.clamp(w.sum() * float(x.shape[2] * x.shape[3]), min=1.0)
        mean = (x * w).sum(axes) / count
        var = (x * x * w).sum(axes) / count - mean * mean
    return (x - mean.view(shape)) * torch.rsqrt(torch.clamp(var, min=0.0).view(shape) + BN_EPS)


def _view_grad(torch, param: str, view) -> tuple:
    """(float32, float64, Σ|term|) per element of one view's share of
    ``param``'s gradient, on the view's device: a bias's Σ dy, a
    BatchNorm weight's Σ dy·x̂ over every axis but the channel's (1), a
    conv weight's Σ x·dy over the batch and the pixels. The float32 value
    is reduced as autograd reduces it (``sum_to_size`` of a broadcast
    operand; the conv's weight gradient) on the same tensors, the float64
    one from the same ``dy`` and ``x``; Σ|term| is the sum's conditioning."""
    dy = view["dy"]
    if view["stride"] is not None:
        from torch.nn.grad import conv2d_weight

        x, shape, geometry = view["x"], view["weight"].shape, (view["stride"], view["padding"])
        return (conv2d_weight(x, shape, dy, *geometry).flatten(),
                conv2d_weight(x.double(), shape, dy.double(), *geometry).flatten(),
                conv2d_weight(x.double().abs(), shape, dy.double().abs(), *geometry).flatten())
    if param.endswith(".bias"):
        term32, term64 = dy, dy.double()
    else:
        term32 = dy * _bn_normalized(torch, view["x"], view["mask"])
        term64 = dy.double() * _bn_normalized(torch, view["x"].double(), view["mask"])
    shape = [1] * dy.dim()
    shape[1] = dy.shape[1]
    return (term32.sum_to_size(shape).flatten(), term64.sum_to_size(shape).flatten(),
            term64.abs().sum_to_size(shape).flatten())


def _bn_input_grad64(torch, view, dy64):
    """The float64 ``dx`` of a train-mode BatchNorm's backward on one
    view's own ``x``, given ``dy64``: autograd through its arithmetic."""
    x64, w64 = view["x"].double().requires_grad_(True), view["weight"].double().view(1, -1, 1, 1)
    (dx64,) = torch.autograd.grad(_bn_normalized(torch, x64, view["mask"]) * w64, x64, dy64)
    return dx64


def _relu_flip_views(torch, arch: str, conv_name: str, bn_name: str, captures, card_grads, cpu_grads) -> None:
    """Where the ResNet's listed tensors part between the card and the CPU:
    at an output of ``bn_name`` that sits within rounding of 0, the ReLU
    after it passes ``dy`` on one device and not on the other (``dy``
    exactly 0 on one side only). For each differentiated view: the number
    of such flips, the outputs there on both devices beside the largest
    card-vs-CPU gap of the other outputs, and the card-vs-CPU gap of ``dy``
    with and without them. Then ``bn_name``'s weight and bias gradients and
    the weight gradient of ``conv_name`` (the conv before it, through the
    BatchNorm's backward) recomputed in float64 on each device from its own
    tensors, with ``dy`` set to 0 at the flips on both. Raises if a flipped
    output stands further from the CPU's than the largest gap elsewhere in
    that output, or if a recomputed gradient's card-vs-CPU gap leaves
    ``FIXMATCH_GRAD_RTOL`` of its max."""
    from torch.nn.grad import conv2d_weight

    names = (f"{bn_name}.weight", f"{bn_name}.bias", f"{conv_name}.weight")
    replay = {dev: dict.fromkeys(names, 0.0) for dev in ("cuda", "cpu")}
    for i, view_name in enumerate(("labeled", "strong")):
        bn = {dev: captures[dev][bn_name][i] for dev in replay}
        dy_card, dy_cpu = bn["cuda"]["dy"].cpu(), bn["cpu"]["dy"]
        flips = (dy_card == 0) != (dy_cpu == 0)
        y_card, y_cpu = bn["cuda"]["y"].cpu(), bn["cpu"]["y"]
        y_gap = (y_card - y_cpu).abs()
        n = int(flips.sum())
        say("fixmatch_step", arch=arch, check="relu_flips", module=bn_name, view=view_name, flips=n,
            at=[tuple(int(j) for j in idx) for idx in flips.nonzero()[:4]],
            y_card=[float(v) for v in y_card[flips][:4]], y_cpu=[float(v) for v in y_cpu[flips][:4]],
            y_gap_elsewhere_max=float(y_gap[~flips].max()), card_dy_vs_cpu=_rel(dy_card, dy_cpu),
            card_dy_vs_cpu_without_flips=float((dy_card - dy_cpu)[~flips].abs().max() / dy_cpu.abs().max()))
        if n and not float(y_gap[flips].max()) <= float(y_gap[~flips].max()):
            raise AssertionError(f"{arch} {bn_name} {view_name} view: a flipped ReLU input stands "
                                 f"{float(y_gap[flips].max())} from the CPU's, further than any other output")
        for dev, view in bn.items():
            dy64 = view["dy"].double() * (~flips).to(view["dy"].device)
            replay[dev][names[0]] = replay[dev][names[0]] + (
                dy64 * _bn_normalized(torch, view["x"].double(), view["mask"])).sum((0, 2, 3))
            replay[dev][names[1]] = replay[dev][names[1]] + dy64.sum((0, 2, 3))
            conv = captures[dev][conv_name][i]
            replay[dev][names[2]] = replay[dev][names[2]] + conv2d_weight(
                conv["x"].double(), conv["weight"].shape, _bn_input_grad64(torch, view, dy64),
                conv["stride"], conv["padding"])
    for name in names:
        gap = _rel(replay["cuda"][name].cpu(), replay["cpu"][name])
        say("fixmatch_step", arch=arch, check="relu_flips", param=name, flip_free_f64_card_vs_cpu=gap,
            card_vs_cpu=_rel(card_grads[name], cpu_grads[name]))
        if not gap <= FIXMATCH_GRAD_RTOL:
            raise AssertionError(f"{arch} {name}: without the flipped ReLU inputs the card stands {gap} of the "
                                 f"gradient's max from the CPU, allowed {FIXMATCH_GRAD_RTOL}")


def _f64_gap(f32, f64, cond) -> float:
    """max over elements of |float32 − float64| / Σ|term|."""
    return float(((f32.double() - f64).abs() / cond.clamp_min(1e-300)).max())


def _reduction_views(torch, arch: str, param: str, card_views, cpu_views, card_grad, cpu_grad) -> None:
    """Where ``param`` (a BatchNorm's weight or bias, a Linear's bias or a
    conv's weight) parts between the card's and the CPU's FixMatch step.
    For each differentiated view: each device's float32 reduction against
    float64 on its own ``dy`` (and ``x``), how far the card's ``dy`` and
    ``x`` already stand from the CPU's, Σ|term| beside the largest
    |gradient| (their ratio is the sum's conditioning: a relative change
    of ``dy`` moves the gradient by up to that many times itself), and the
    gap the card's and the CPU's ``dy`` make in float64 beside the gap of
    their float32 results. Then the step's own gradient on each device
    against the two views' float64 sum. Raises where a float32 value leaves
    ``FIXMATCH_F64_RTOL`` of Σ|term| of its element."""
    if len(card_views) != 2 or len(cpu_views) != 2:
        raise AssertionError(f"{param}: captured {len(card_views)} card and {len(cpu_views)} CPU views, not 2")
    sums = {"cuda": [0.0, 0.0, 0.0], "cpu": [0.0, 0.0, 0.0]}  # float32, float64, conditioning over the views
    for view_name, card, cpu in zip(("labeled", "strong"), card_views, cpu_views):
        got = {"cuda": [t.cpu() for t in _view_grad(torch, param, card)], "cpu": _view_grad(torch, param, cpu)}
        gaps = {dev: _f64_gap(*got[dev]) for dev in got}
        for dev, values in got.items():
            sums[dev] = [a + b for a, b in zip(sums[dev], values)]
        (c32, c64, _), (p32, p64, cond) = got["cuda"], got["cpu"]
        grad_max = float(p64.abs().max())
        say("fixmatch_step", arch=arch, check="reduction_vs_f64", param=param, view=view_name,
            dy_shape=tuple(card["dy"].shape), card_f32_vs_f64=gaps["cuda"], cpu_f32_vs_f64=gaps["cpu"],
            card_dy_vs_cpu=_rel(card["dy"].cpu(), cpu["dy"]), card_x_vs_cpu=_rel(card["x"].cpu(), cpu["x"]),
            sum_abs_term_max=float(cond.max()), sum_abs_term_median=float(cond.median()), grad_max=grad_max,
            conditioning=float(cond.max()) / max(grad_max, 1e-300),
            card_vs_cpu_f64=float((c64 - p64).abs().max()) / max(grad_max, 1e-300),
            card_vs_cpu_f32=_rel(c32, p32))
        for dev, gap in gaps.items():
            if not gap <= FIXMATCH_F64_RTOL:
                raise AssertionError(f"{arch} {param} {view_name} view on {dev}: float32 {gap} of Σ|term| "
                                     f"from float64, allowed {FIXMATCH_F64_RTOL}")
    steps = {"cuda": card_grad, "cpu": cpu_grad}
    step_gaps = {dev: _f64_gap(steps[dev].flatten(), sums[dev][1], sums[dev][2]) for dev in steps}
    say("fixmatch_step", arch=arch, check="reduction_vs_f64", param=param, view="both",
        card_step_vs_f64=step_gaps["cuda"], cpu_step_vs_f64=step_gaps["cpu"],
        card_views_f32_sum_vs_step=float((sums["cuda"][0] - card_grad.flatten()).abs().max()),
        cpu_views_f32_sum_vs_step=float((sums["cpu"][0] - cpu_grad.flatten()).abs().max()),
        card_vs_cpu=_rel(card_grad, cpu_grad), grad_max=float(cpu_grad.abs().max()))
    for dev, gap in step_gaps.items():
        if not gap <= FIXMATCH_F64_RTOL:
            raise AssertionError(f"{arch} {param} step gradient on {dev}: {gap} of Σ|term| from the views' float64 "
                                 f"sum, allowed {FIXMATCH_F64_RTOL}")


def _fixmatch_cuda_vs_cpu(torch, np, arch: str, kink_free: bool, check_grads: bool) -> dict:
    """One FixMatch step on the card and on the CPU. With ``check_grads``
    each tensor of ``FIXMATCH_F64_CHECKED[arch]`` is held on each device to
    the float64 value of its own reduction (and the ResNet's ReLU flips are
    taken out, ``FIXMATCH_RELU_FLIPS``), and the result names every tensor
    past ``FIXMATCH_GRAD_RTOL`` of its max with its ratio."""
    from ssip_tpu_torch.train.consistency import epoch_view_draws

    b = STEP_CHECK_BATCH
    batch, unlabeled = _fixmatch_inputs(torch, np, b, padded_rows=1)
    draws = epoch_view_draws(SEED, "smoke_fixmatch", 0, 1, b, b, torch.device("cpu"))[0]
    checked = FIXMATCH_F64_CHECKED[arch] if check_grads else ()
    modules = sorted({param.rsplit(".", 1)[0] for param in checked})
    captures = {dev: {name: [] for name in modules} for dev in ("cpu", "cuda")}
    (m_cpu, g_cpu, s_cpu), (m_gpu, g_gpu, s_gpu) = (
        _one_fixmatch_step(torch, arch, torch.device(dev), batch, unlabeled, draws, kink_free, captures[dev])
        for dev in ("cpu", "cuda")
    )
    for param in checked:
        module = param.rsplit(".", 1)[0]
        card_views, cpu_views = captures["cuda"][module], captures["cpu"][module]
        if param == "encoder.ln.bias":  # on the card the LayerNorm backward kernel reduces it
            _final_layer_norm_views(torch, card_views, cpu_views)
        else:
            _reduction_views(torch, arch, param, card_views, cpu_views, g_gpu[param], g_cpu[param])
    if checked and arch in FIXMATCH_RELU_FLIPS:
        _relu_flip_views(torch, arch, *FIXMATCH_RELU_FLIPS[arch], captures, g_gpu, g_cpu)
    stem = STEM_GRAD if arch == "resnet18" else None
    rel = {k: _rel(g_gpu[k], g_cpu[k]) for k in g_cpu if k != stem}
    unchecked = {k: v for k, v in rel.items() if k not in checked}
    beyond = {k: v for k, v in sorted(rel.items(), key=lambda kv: -kv[1]) if v > FIXMATCH_GRAD_RTOL}
    r = {
        "loss": m_cpu[0].item(), "cons_loss": m_cpu[2].item(), "keep_rate": m_cpu[3].item(),
        "loss_rel": _rel(m_gpu[0], m_cpu[0]), "keep_equal": torch.equal(m_gpu[3], m_cpu[3]),
        "grad_rel": max(unchecked.values()), "grad_worst": max(unchecked, key=unchecked.get),
        "grads_beyond_1e_3": len(beyond),
        "grad_l2_all": float(sum((g_gpu[k] - g_cpu[k]).double().pow(2).sum() for k in g_cpu).sqrt()
                             / sum(g_cpu[k].double().pow(2).sum() for k in g_cpu).sqrt()),
    }
    if check_grads:
        r["beyond_1e_3"] = ",".join(f"{k}:{v:.3e}" for k, v in beyond.items()) or "none"
        r["checked_f64_rel"] = max((rel[k] for k in checked), default=0.0)
    if stem:
        r["stem_l2"] = float((g_gpu[stem] - g_cpu[stem]).norm() / g_cpu[stem].norm())
        r["stat_rel"] = max(_rel(s_gpu[k], s_cpu[k]) for k in s_cpu)
    return r


def _timed_fixmatch_steps(torch, np, arch: str, counts: LaunchCounts, classes,
                          dtypes=("bfloat16", "float32"), strong_aug: str = "jitter", tag: str = "fixmatch_step") -> None:
    """The steady-state FixMatch step at 128 labeled + 128 unlabeled in
    each of ``dtypes`` with the ``strong_aug`` strong view: timed, the
    strong view alone beside it, then profiled."""
    from ssip_tpu_torch.train.consistency import epoch_view_draws, fixmatch_step, init_ema, strong_view

    b = STEP_TIMED_BATCH
    dev = torch.device("cuda")
    batch, unlabeled = _fixmatch_inputs(torch, np, b)
    images, labels, valid = (t.to(dev) for t in batch)
    unlabeled = unlabeled.to(dev)
    n_steps = STEP_WARMUP + STEP_TIMED
    draws = epoch_view_draws(SEED, "smoke_fixmatch", 1, 2 * n_steps, b, b, dev, strong_aug, (TRAIN_SIZE, TRAIN_SIZE))
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
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
        # the jitter's rotation is the uint8 kernel; RandAugment's warp is plain PyTorch
        want = {"augment_images": 1.0, **({"rotate_images": 1.0} if strong_aug == "jitter" else {})}
        if arch in VIT_FAMILY:
            want.update(layer_norm=3 * VIT_LN_PER_FORWARD, layer_norm_bwd=2 * VIT_LN_PER_FORWARD,
                        attention_qkv=3 * VIT_ATTN_PER_FORWARD, attention_qkv_bwd=2 * VIT_ATTN_PER_FORWARD)
        if launches != want:
            raise AssertionError(f"{arch} {dtype_name}: launches per FixMatch step {launches}, expected {want}")
        d = draws[0]
        strong_ms = median_ms(torch, lambda: strong_view(unlabeled, d, dtype))
        counts.reset()  # the strong view timed alone is no launch of the path
        say(tag, arch=arch, dtype=dtype_name, strong_aug=strong_aug, labeled=b, unlabeled=b, timed_steps=STEP_TIMED,
            ms_per_step=f"{step_ms:.3f}", imgs_per_s=f"{2 * b / step_ms * 1000:.1f}", peak_mem_gib=f"{peak_gib:.2f}",
            keep_rate=f"{keep.item():.3f}", strong_view_ms=f"{strong_ms:.4f}",
            strong_view_share=f"{strong_ms / step_ms:.5f}", launches_per_step=launches)
        _profile_steps(torch, lambda i: step(n_steps - 1 if i is None else n_steps + i),
                       f"{arch}_fixmatch_step_{strong_aug}_{dtype_name}", classes)
        counts.read()
        del state, ema
    torch.cuda.empty_cache()


def phase_fixmatch_step(torch, np, counts: LaunchCounts) -> None:
    """One FixMatch step cuda vs CPU for each arch, then the steady-state
    step."""
    from ssip_tpu_torch.runtime.device import configure_precision

    configure_precision("float32")
    # ResNet-18: loss, keep mask and BN statistics at the seeded weights;
    # gradients at the kink-free ones (KINK_FREE_BN_BIAS)
    seeded = _fixmatch_cuda_vs_cpu(torch, np, "resnet18", False, check_grads=False)
    shifted = _fixmatch_cuda_vs_cpu(torch, np, "resnet18", True, check_grads=True)
    for tag, r in (("seeded", seeded), ("kink_free", shifted)):
        say("fixmatch_step", arch="resnet18", check=f"cuda_vs_cpu_f32_{tag}", labeled=STEP_CHECK_BATCH,
            unlabeled=STEP_CHECK_BATCH, padded_rows=1, **r)
    if (seeded["loss_rel"] > 1e-5 or seeded["stat_rel"] > 1e-5 or not seeded["keep_equal"]
            or shifted["loss_rel"] > 1e-5 or shifted["grad_rel"] > FIXMATCH_GRAD_RTOL
            or shifted["checked_f64_rel"] > FIXMATCH_F64_CHECKED_RTOL
            or shifted["grad_l2_all"] > FIXMATCH_GRAD_L2_ALL or shifted["stem_l2"] > 1e-2):
        raise AssertionError(f"FixMatch step cuda vs cpu out of bounds (a tensor past {FIXMATCH_GRAD_RTOL} that "
                             f"FIXMATCH_F64_CHECKED does not name fails): seeded {seeded}, kink-free {shifted}")
    _timed_fixmatch_steps(torch, np, "resnet18", counts, (("rotate kernel", ROTATE_U8_KERNELS),) + _PROFILE_CLASSES)

    r = _fixmatch_cuda_vs_cpu(torch, np, VIT_ARCH, False, check_grads=True)
    say("fixmatch_step", arch=VIT_ARCH, check="cuda_vs_cpu_f32_seeded", labeled=STEP_CHECK_BATCH,
        unlabeled=STEP_CHECK_BATCH, padded_rows=1, **r)
    if (r["loss_rel"] > 1e-5 or r["grad_rel"] > FIXMATCH_GRAD_RTOL or r["checked_f64_rel"] > FIXMATCH_F64_CHECKED_RTOL
            or r["grad_l2_all"] > FIXMATCH_GRAD_L2_ALL or not r["keep_equal"]):
        raise AssertionError(f"{VIT_ARCH} FixMatch step cuda vs cpu out of bounds (a tensor past "
                             f"{FIXMATCH_GRAD_RTOL} that FIXMATCH_F64_CHECKED does not name fails): {r}")
    _timed_fixmatch_steps(torch, np, VIT_ARCH, counts, (("rotate kernel", ROTATE_U8_KERNELS),) + _VIT_PROFILE_CLASSES)


def phase_host_packages() -> dict:
    """Which of the host packages the audit and the figures need are here:
    pandas (the audit's tables) and matplotlib (every figure); and whether
    the native JPEG decoder can be built (g++ and libjpeg's header), which
    ``--host-preproc`` and ``--fast-decode`` need. A stage that needs a
    missing one is not started on the card, and is named."""
    import importlib.util
    import shutil as _shutil

    found = {name: importlib.util.find_spec(name) is not None for name in ("pandas", "matplotlib")}
    missing = [name for name, ok in found.items() if not ok]
    gxx, header = _shutil.which("g++") is not None, Path("/usr/include/jpeglib.h").is_file()
    not_run = (["the audit, the clustering and training figures, scripts/generate_*"] if missing else []) + (
        [] if gxx and header else ["[stream]'s --host-preproc and --fast-decode"])
    say("host", **{name: "installed" if ok else "missing" for name, ok in found.items()},
        gxx="installed" if gxx else "missing", jpeglib_h="present" if header else "missing",
        not_run_on_this_card="; ".join(not_run) or "none")
    return {**found, "native_decoder": gxx and header}


def _csv_rows(path: Path) -> list:
    import csv

    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


SWEEP_COUNTS = ("TP", "FP", "TN", "FN")


def _sweeps_agree(np, card_rows: list, cpu_rows: list, card: dict, cpu: dict, what: str) -> tuple:
    """The card's sweep against the CPU's on the same ``.pt``: the same rows,
    thresholds within ``SWEEP_PROB_TOL``, and equal confusion counts on every
    row whose threshold lies further than twice that from its neighbours
    (closer ones may swap order); (max threshold error, rows so excused)."""
    if len(card_rows) != len(cpu_rows) or list(card_rows[0]) != list(cpu_rows[0]):
        raise AssertionError(f"{what}: {len(card_rows)} rows vs {len(cpu_rows)} on the CPU")
    thr_card = np.array([float(r["threshold"]) for r in card_rows])
    thr_cpu = np.array([float(r["threshold"]) for r in cpu_rows])
    err = float(np.abs(thr_card - thr_cpu).max())
    gaps = np.abs(np.diff(thr_cpu))
    close = np.zeros(len(thr_cpu), bool)
    close[:-1] |= gaps < 2 * SWEEP_PROB_TOL
    close[1:] |= gaps < 2 * SWEEP_PROB_TOL
    bad = [i for i, (a, b) in enumerate(zip(card_rows, cpu_rows))
           if not close[i] and any(float(a[c]) != float(b[c]) for c in SWEEP_COUNTS)]
    if err > SWEEP_PROB_TOL or bad:
        raise AssertionError(f"{what}: threshold error {err}, rows with other counts {bad}")
    if sorted(card) != sorted(cpu) or (
        "best_threshold" in cpu and (abs(card["best_threshold"] - cpu["best_threshold"]) > SWEEP_PROB_TOL or (
            not close.any() and any(card[c] != cpu[c] for c in SWEEP_COUNTS)))):
        raise AssertionError(f"{what}: JSON line {card} vs {cpu} on the CPU")
    return err, int(close.sum())


def phase_sweep(torch, np, tmp: Path, data: Path, counts: LaunchCounts) -> None:
    """``run_sweep`` on the baseline ``.pt`` that ``phase_train`` wrote for
    resnet18 and vit_b16 (bfloat16 runs, 224²), on the card (float32, TF32
    off: for vit_b16 the float32 LayerNorm and packed-attention kernels), and
    the same sweep on the CPU; the CSV rows and the JSON line agree."""
    from ssip_tpu_torch.pipelines.sweep import SweepConfig, run_sweep

    for arch in ("resnet18", VIT_ARCH):
        trained = tmp / f"train_out_{arch}_bfloat16_{TRAIN_SIZE}"
        results, rows, seconds = {}, {}, {}
        for dev in ("cuda", "cpu"):
            out = tmp / f"sweep_{arch}_{dev}"
            shutil.copytree(trained, out)
            counts.reset()
            t0 = time.perf_counter()
            results[dev] = run_sweep(SweepConfig(strong_data_dir=data, output_dir=out, model="baseline", device=dev))
            seconds[dev] = time.perf_counter() - t0
            if dev == "cuda":
                launches = counts.read()
            rows[dev] = _csv_rows(out / "tables" / "threshold_sweep_baseline.csv")
        test_size = len(json.loads((trained / "notes" / "training_history.json").read_text())["splits"]["test"])
        forwards = -(-test_size // 16)
        want = ({"layer_norm": forwards * VIT_LN_PER_FORWARD, "attention_qkv": forwards * VIT_ATTN_PER_FORWARD}
                if arch == VIT_ARCH else {})
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"sweep {arch}: launches {launches}, expected {want}")
        if any(sum(float(r[c]) for c in SWEEP_COUNTS) != test_size for r in rows["cuda"]):
            raise AssertionError(f"sweep {arch}: a row's counts do not sum to the {test_size} test images")
        err, excused = _sweeps_agree(np, rows["cuda"], rows["cpu"], results["cuda"], results["cpu"], f"sweep {arch}")
        say("sweep", arch=arch, model="baseline", test_images=test_size, rows=len(rows["cuda"]),
            threshold_max_err=f"{err:.2e}", rows_within_tol_of_a_neighbour=excused,
            best_threshold=results["cuda"].get("best_threshold"), seconds=f"{seconds['cuda']:.2f}",
            cpu_seconds=f"{seconds['cpu']:.2f}", launches={k: v for k, v in launches.items() if v})


def _seeded_features(np, n: int, d: int, seed: int, clusters: int = 8, duplicates: int = 0):
    """Embedding-like float32 features: ``clusters`` groups of unequal size
    and spread on a decaying spectrum (a few directions carry most of the
    variance, as a backbone's embeddings do), with ``duplicates`` rows
    repeated exactly, as duplicate images embed."""
    rng = np.random.default_rng(seed)
    spectrum = (np.arange(d) + 1.0) ** -0.6
    centers = rng.normal(0.0, 2.5, (clusters, d))
    sizes = rng.dirichlet(np.full(clusters, 2.0))
    y = rng.choice(clusters, n, p=sizes)
    spread = rng.uniform(0.6, 1.4, clusters)[y][:, None]
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    x = ((centers[y] + spread * rng.normal(size=(n, d))) * spectrum) @ basis
    if duplicates:
        x[n - duplicates:] = x[rng.choice(n - duplicates, duplicates, replace=False)]
    return x.astype(np.float32)


def _neighbour_preservation(torch, x, y, k: int = 10, queries=None) -> float:
    """Mean share of each query point's k nearest input neighbours that are
    also among its k nearest in the embedding (float64 distances on the card)."""
    dev = torch.device("cuda")
    xs, ys = (torch.as_tensor(a, device=dev, dtype=torch.float64) for a in (x, y))
    q = torch.arange(len(xs), device=dev) if queries is None else torch.as_tensor(queries, device=dev)
    sets = []
    for a in (xs, ys):
        d = torch.cdist(a[q], a)
        d[torch.arange(len(q), device=dev), q] = float("inf")
        sets.append(d.topk(k, dim=1, largest=False).indices)
    shared = (sets[0][:, :, None] == sets[1][:, None, :]).any(dim=2).sum()
    return float(shared) / (len(q) * k)


def _timed(torch, fn):
    """(result, seconds, peak GiB) of ``fn()`` on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _pca_deviation(np, card, cpu, n: int) -> tuple:
    """(max |Δ| over the first n principal axes taken one by one, max 1 −
    smallest principal-angle cosine over the groups of axes whose variances
    lie within 1 % of each other, where an axis is not defined alone)."""
    ev = cpu.explained_variance[:n]
    cuts = [0] + [i + 1 for i in range(n - 1) if ev[i] > ev[i + 1] * 1.01] + [n]
    axis_err, group_err = 0.0, 0.0
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi - lo == 1:
            axis_err = max(axis_err, float(np.abs(card.components[lo] - cpu.components[lo]).max()))
        else:
            cos = np.linalg.svd(card.components[lo:hi].astype(np.float64) @ cpu.components[lo:hi].T, compute_uv=False)
            group_err = max(group_err, 1.0 - float(cos.min()))
    return axis_err, group_err


def _near_radius_pairs(torch, x, eps: float) -> int:
    """Pairs whose float64 distance lies within 1e-4 of eps (relative): where
    float32 sums in another order may put a pair on the other side."""
    xs = torch.as_tensor(x, device=torch.device("cuda"), dtype=torch.float64)
    return int(((torch.cdist(xs, xs) - eps).abs() <= 1e-4 * eps).sum()) // 2


def phase_analysis(torch, np, counts: LaunchCounts, building) -> None:
    """The analysis stack at the reference corpus's size (100 labeled + 1,406
    unlabeled, 512-D), each function on the card and on the CPU on the same
    inputs: standardize, PCA, t-SNE, UMAP, k-means, auto-eps and the DBSCAN
    grid, silhouette, ARI and NMI; each function's seconds on both, with
    ``beside_build``: whether ``building`` (the kernels' build, a future)
    still ran when the timing began (then the seconds are not the
    function's alone)."""
    from ssip_tpu_torch.analysis import cluster_metrics, dbscan, kmeans, pca, standardize, tsne, umap
    from ssip_tpu_torch.analysis.pca import components_for_variance

    card, cpu = torch.device("cuda"), torch.device("cpu")
    n = ANALYSIS_LABELED + ANALYSIS_UNLABELED
    raw = _seeded_features(np, n, ANALYSIS_DIM, SEED + 30, clusters=ANALYSIS_CLUSTERS, duplicates=20)
    labeled = np.arange(n) < ANALYSIS_LABELED
    truth = np.where(np.arange(n) % 2 == 0, "cancer", "normal")
    counts.reset()

    def both(fn):
        beside = not building.done()
        card_out, card_s, card_gib = _timed(torch, lambda: fn(card))
        t0 = time.perf_counter()
        cpu_out = fn(cpu)
        return card_out, cpu_out, {"seconds": f"{card_s:.3f}", "cpu_seconds": f"{time.perf_counter() - t0:.3f}",
                                   "peak_gib": f"{card_gib:.2f}", "beside_build": beside}

    (sc, sp, t) = both(lambda dev: standardize.fit_scaler(raw, device=dev))
    err = float(np.abs(sc["scale"] - sp["scale"]).max() / sp["scale"].max())
    if err > 1e-5:
        raise AssertionError(f"analysis standardize: scale {err} of its max")
    feats = standardize.transform(raw, sp, device=cpu)
    say("analysis", fn="standardize", n=n, dim=ANALYSIS_DIM, scale_rel_err=f"{err:.2e}", **t)

    (pc, pp, t) = both(lambda dev: pca.fit_pca(feats, device=dev))
    k_cluster = max(2, components_for_variance(pp, 0.9))
    axis_err, group_err = _pca_deviation(np, pc, pp, ANALYSIS_TSNE_DIM)
    ratio_err = float(np.abs(pc.explained_variance_ratio - pp.explained_variance_ratio).max()
                      / pp.explained_variance_ratio.max())
    if axis_err > 1e-3 or group_err > 1e-3 or ratio_err > 1e-4 or components_for_variance(pc, 0.9) != (
            components_for_variance(pp, 0.9)):
        raise AssertionError(f"analysis pca: axes {axis_err}, groups {group_err}, ratio {ratio_err}")
    projected = pp.transform(feats)
    space, tsne_in = projected[:, :k_cluster], projected[:, :ANALYSIS_TSNE_DIM]
    say("analysis", fn="pca", cluster_dims=k_cluster, axis_max_err=f"{axis_err:.2e}",
        group_max_err=f"{group_err:.2e}", ratio_max_err=f"{ratio_err:.2e}", **t)

    for perplexity in TSNE_PERPLEXITIES:
        (yc, yp, t) = both(lambda dev: tsne.tsne(tsne_in, perplexity=perplexity, device=dev))
        kl_c, kl_p = (tsne.kl_divergence(tsne_in, y, perplexity, device=card) for y in (yc, yp))
        pres_c, pres_p = (_neighbour_preservation(torch, tsne_in, y) for y in (yc, yp))
        if not (np.isfinite(yc).all() and abs(kl_c / kl_p - 1) <= EMBED_KL_RTOL
                and abs(pres_c - pres_p) <= NEIGHBOUR_ATOL):
            raise AssertionError(f"analysis tsne {perplexity}: KL {kl_c} vs {kl_p}, preservation {pres_c} vs {pres_p}")
        say("analysis", fn="tsne", perplexity=perplexity, kl=f"{kl_c:.4f}", cpu_kl=f"{kl_p:.4f}",
            preservation=f"{pres_c:.3f}", cpu_preservation=f"{pres_p:.3f}", **t)

    for neighbours, min_dist in UMAP_GRID:
        (yc, yp, t) = both(lambda dev: umap.umap(tsne_in, n_neighbors=neighbours, min_dist=min_dist, device=dev))
        pres_c, pres_p = (_neighbour_preservation(torch, tsne_in, y) for y in (yc, yp))
        if not (np.isfinite(yc).all() and abs(pres_c - pres_p) <= NEIGHBOUR_ATOL):
            raise AssertionError(f"analysis umap {neighbours} {min_dist}: preservation {pres_c} vs {pres_p}")
        say("analysis", fn="umap", n_neighbors=neighbours, min_dist=min_dist, preservation=f"{pres_c:.3f}",
            cpu_preservation=f"{pres_p:.3f}", **t)

    labels = {}
    for k in KMEANS_KS:
        (kc, kp, t) = both(lambda dev: kmeans.kmeans(space, k, n_init=10, seed=42, device=dev))
        ari = cluster_metrics.adjusted_rand_index(kc.labels, kp.labels)
        inertia_err = abs(kc.inertia / kp.inertia - 1)
        if ari < 0.999 or inertia_err > 1e-4:
            raise AssertionError(f"analysis kmeans k={k}: ARI {ari}, inertia {kc.inertia} vs {kp.inertia}")
        say("analysis", fn="kmeans", k=k, n_init=10, ari_card_vs_cpu=f"{ari:.6f}", inertia_rel_err=f"{inertia_err:.2e}",
            n_iter=kc.n_iter, cpu_n_iter=kp.n_iter, **t)
        labels[k] = kp.labels

    chosen = labels[ANALYSIS_CLUSTERS]
    (sc_c, sc_p, t) = both(lambda dev: cluster_metrics.silhouette_score(space, chosen, device=dev))
    if abs(sc_c / sc_p - 1) > 1e-4:
        raise AssertionError(f"analysis silhouette: {sc_c} vs {sc_p}")
    ari = cluster_metrics.adjusted_rand_index(truth[labeled], chosen[labeled])
    nmi = cluster_metrics.normalized_mutual_info(truth[labeled], chosen[labeled])
    say("analysis", fn="silhouette", k=ANALYSIS_CLUSTERS, value=f"{sc_c:.6f}", cpu_value=f"{sc_p:.6f}", ari=f"{ari:.4f}",
        nmi=f"{nmi:.4f}", **t)

    sub = space[~labeled]
    grid = []
    for ms in DBSCAN_MIN_SAMPLES:
        (ec, ep, t) = both(lambda dev: dbscan.auto_eps_from_kdistance(sub, ms, quantile=0.98, device=dev))
        if abs(ec / ep - 1) > 1e-5:
            raise AssertionError(f"analysis auto eps ms={ms}: {ec} vs {ep}")
        say("analysis", fn="auto_eps", min_samples=ms, eps=f"{ec:.6f}", cpu_eps=f"{ep:.6f}", **t)
        grid.extend(max(1e-6, ep * f) for f in (0.8, 1.0, 1.2))
    near_total, seconds, cpu_seconds, clusters, beside = 0, 0.0, 0.0, [], False
    for eps in sorted(set(grid)):
        near = _near_radius_pairs(torch, sub, eps)
        near_total += near
        for ms in DBSCAN_MIN_SAMPLES:
            (dc, dp, t) = both(lambda dev: dbscan.dbscan(sub, eps, ms, device=dev))
            seconds, cpu_seconds = seconds + float(t["seconds"]), cpu_seconds + float(t["cpu_seconds"])
            beside = beside or t["beside_build"]
            same = np.array_equal(dc.labels, dp.labels)
            if not same and (near == 0 or cluster_metrics.adjusted_rand_index(dc.labels, dp.labels) < 0.99):
                raise AssertionError(f"analysis dbscan eps={eps} ms={ms}: labels differ with {near} pairs near eps")
            clusters.append(dc.n_clusters)
    say("analysis", fn="dbscan", scope="unlabeled", fits=len(set(grid)) * len(DBSCAN_MIN_SAMPLES),
        pairs_near_eps=near_total, clusters=clusters, seconds=f"{seconds:.3f}",
        cpu_seconds=f"{cpu_seconds:.3f}", beside_build=beside)
    launched = {k: v for k, v in counts.read().items() if v}
    if launched:
        raise AssertionError(f"analysis: the stack launched hand kernels {launched}")


def phase_analysis_scale(torch, np, building) -> None:
    """Above ``DENSE_LIMIT``: 50,000 × 512 through the blocked k-distance,
    DBSCAN and silhouette paths and k-means, t-SNE and UMAP at their
    20,000-point cap; seconds and peak memory of each. The blocked paths are
    held to the dense ones on a 4,096-row slice. ``beside_build`` as in
    ``phase_analysis``."""
    from ssip_tpu_torch.analysis import cluster_metrics, dbscan, kmeans, pca, tsne, umap
    from ssip_tpu_torch.analysis.distances import pairwise_d2

    card = torch.device("cuda")
    x = _seeded_features(np, SCALE_N, ANALYSIS_DIM, SEED + 31, duplicates=100)

    def timed(fn):  # _timed's (result, seconds, peak GiB) and whether the build ran at the start
        beside = not building.done()
        return (*_timed(torch, fn), beside)

    curve, s, gib, beside = timed(lambda: dbscan.k_distance_curve(x, 5, include_self=True, device=card))
    # the 25th-percentile 4th-neighbour distance keeps neighbourhoods to a few points
    # on these features (at the median they hold thousands, all sent to the host's BFS)
    eps = float(np.quantile(curve, SCALE_EPS_QUANTILE))
    say("analysis_scale", fn="k_distance", n=SCALE_N, k=5, seconds=f"{s:.3f}", peak_gib=f"{gib:.2f}",
        beside_build=beside)
    fit, s, gib, beside = timed(lambda: dbscan.dbscan(x, eps, 5, device=card))
    say("analysis_scale", fn="dbscan", eps=f"{eps:.4f}", eps_quantile=SCALE_EPS_QUANTILE, min_samples=5, clusters=fit.n_clusters,
        noise_rate=f"{fit.noise_rate:.4f}", seconds=f"{s:.3f}", peak_gib=f"{gib:.2f}", beside_build=beside)
    km, s, gib, beside = timed(lambda: kmeans.kmeans(x, SCALE_KMEANS_K, n_init=SCALE_KMEANS_INIT, device=card))
    say("analysis_scale", fn="kmeans", k=SCALE_KMEANS_K, n_init=SCALE_KMEANS_INIT, n_iter=km.n_iter,
        seconds=f"{s:.3f}", peak_gib=f"{gib:.2f}", beside_build=beside)
    sil, s, gib, beside = timed(lambda: cluster_metrics.silhouette_score(x, km.labels, device=card))
    if not 0 < sil <= 1:
        raise AssertionError(f"analysis_scale silhouette {sil}")
    say("analysis_scale", fn="silhouette", value=f"{sil:.4f}", seconds=f"{s:.3f}", peak_gib=f"{gib:.2f}",
        beside_build=beside)

    part = x[:SCALE_SLICE]  # below DENSE_LIMIT: both paths run on it
    xt = torch.as_tensor(part, device=card)
    sq = (xt * xt).sum(1)
    rounding = float(sq.max()) * 2.0**-21
    dense_k = np.sort(np.sqrt(dbscan._kth_smallest(pairwise_d2(xt, xt, sq, sq), 5).cpu().numpy()))
    blocked_k = np.sort(np.sqrt(dbscan._kth_distance_blocked(xt, 5, True).cpu().numpy()))
    kd_err = float(np.abs(dense_k - blocked_k).max())
    one_hot = torch.eye(SCALE_KMEANS_K, device=card)[torch.as_tensor(km.labels[:SCALE_SLICE], device=card)]
    sums_d = cluster_metrics._silhouette_sums_dense(xt, one_hot)
    sums_b = cluster_metrics._silhouette_sums_blocked(xt, one_hot)
    sil_err = float(((sums_d - sums_b).abs() / sums_d.abs().clamp_min(1.0)).max())
    dense_nb = dbscan._neighbor_lists_dense(xt, eps)
    blocked_nb = dbscan._neighbor_lists_blocked(xt, eps)
    differing = sum(len(set(a.tolist()) ^ set(b.tolist())) for a, b in zip(dense_nb, blocked_nb)) // 2
    near = _near_radius_pairs(torch, part, eps)
    if kd_err > 1e-5 * dense_k.max() + np.sqrt(rounding) or sil_err > 1e-5 or differing > near:
        raise AssertionError(f"analysis_scale blocked vs dense: k-distance {kd_err}, silhouette sums {sil_err}, "
                             f"{differing} neighbour pairs differ ({near} near eps)")
    say("analysis_scale", check="blocked_vs_dense", rows=SCALE_SLICE, k_distance_max_err=f"{kd_err:.2e}",
        silhouette_sums_rel_err=f"{sil_err:.2e}", neighbour_pairs_differing=differing, pairs_near_eps=near)

    sub = pca.fit_pca(x[:EMBED_CAP], device=card).transform(x[:EMBED_CAP], ANALYSIS_TSNE_DIM)
    emb, s, gib, beside = timed(lambda: tsne.tsne(sub, perplexity=30.0, device=card))
    kl = tsne.kl_divergence(sub, emb, 30.0, device=card)
    queries = np.random.default_rng(SEED + 32).choice(EMBED_CAP, min(2000, EMBED_CAP), replace=False)
    pres = _neighbour_preservation(torch, sub, emb, queries=queries)
    if not np.isfinite(emb).all() or not np.isfinite(kl):
        raise AssertionError("analysis_scale tsne: not finite")
    say("analysis_scale", fn="tsne", n=EMBED_CAP, perplexity=30.0, kl=f"{kl:.4f}", preservation=f"{pres:.3f}",
        seconds=f"{s:.3f}", peak_gib=f"{gib:.2f}", beside_build=beside)
    del emb
    emb, s, gib, beside = timed(lambda: umap.umap(sub, n_neighbors=15, min_dist=0.1, device=card))
    pres = _neighbour_preservation(torch, sub, emb, queries=queries)
    if not np.isfinite(emb).all():
        raise AssertionError("analysis_scale umap: not finite")
    say("analysis_scale", fn="umap", n=EMBED_CAP, n_neighbors=15, min_dist=0.1, preservation=f"{pres:.3f}",
        seconds=f"{s:.3f}", peak_gib=f"{gib:.2f}", beside_build=beside)
    torch.cuda.empty_cache()


def make_workflow_tree(np, tmp: Path) -> Path:
    """The reference layout and counts, ``avec_labels/{cancer,normal}`` 50 +
    50 and ``sans_label`` 1,406, 512² RGB JPEGs drawn from four seeded
    families (a smooth base image each plus per-image noise): cancer from
    the first, normal from the second, the pool from all four, so that
    clusters and a DBSCAN cohort exist."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    root = tmp / "workflow_data"
    rng = np.random.default_rng(SEED + 40)
    coarse = rng.integers(0, 256, (WORKFLOW_FAMILIES, 8, 8, 3), dtype=np.uint8)
    bases = [np.asarray(Image.fromarray(c).resize((SIZE, SIZE), Image.BICUBIC), np.float32) for c in coarse]
    jobs = [(f"avec_labels/cancer/c_{i:03d}.jpg", 0) for i in range(ANALYSIS_LABELED // 2)]
    jobs += [(f"avec_labels/normal/n_{i:03d}.jpg", 1) for i in range(ANALYSIS_LABELED // 2)]
    jobs += [(f"sans_label/u_{i:04d}.jpg", i % WORKFLOW_FAMILIES) for i in range(ANALYSIS_UNLABELED)]
    for rel in ("avec_labels/cancer", "avec_labels/normal", "sans_label"):
        (root / rel).mkdir(parents=True)
    seeds = rng.integers(0, 2**31, len(jobs))

    def write(job):
        (rel, family), seed = job
        noise = np.random.default_rng(seed).normal(0.0, 16.0, (SIZE, SIZE, 3))
        Image.fromarray(np.clip(bases[family] + noise, 0, 255).astype(np.uint8)).save(root / rel, quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, zip(jobs, seeds)))
    return root


def phase_workflow(torch, np, tmp: Path, counts: LaunchCounts, host: dict) -> None:
    """``scripts/run_full_workflow.sh`` on the port's CLIs, in its order and
    with its flags, on the card, through the cohort-filtered semi-supervised
    run and both threshold sweeps. Cuts: 1 + 1 + 1 training epochs (the
    script's defaults are 10 + 5 + 8) and a pseudo-label threshold of 0.5
    (seeded weights after an epoch keep their confidences near it). Without
    matplotlib the audit is not run and the clustering stage runs through
    ``cli.clustering.run_analysis`` (everything but its figures), and the
    two training stages must warn once and write no figure; with it they
    must write the JAX run's 4 and 9 figures."""
    from ssip_tpu_torch.cli import clustering, data_audit, export_unlabeled_cohort, feature_extraction
    from ssip_tpu_torch.cli import semi_supervised_training, standardize_features, supervised_training
    from ssip_tpu_torch.cli import export_model, predict, threshold_sweep

    data, out = make_workflow_tree(np, tmp), tmp / "workflow_outputs"
    o, labeled = ["--output-dir", str(out)], str(data / "avec_labels")
    feats, tables = out / "features", out / "tables"
    cohort = tables / "unlabeled_cohort_dbscan.csv"
    cluster_argv = ["--features-npz", str(feats / "standardized_features.npz"), "--output-root", str(out),
                    "--dbscan-auto", "--dbscan-scope", "unlabeled"]

    def cluster_stage():
        if host["matplotlib"]:
            clustering.main(cluster_argv)
        else:
            args = clustering.parse_args(cluster_argv)
            clustering.run_analysis(args, torch.device("cuda"))

    stages = [
        ("audit", (lambda: data_audit.main(["--data-dir", str(data), *o])) if host["matplotlib"] and host["pandas"]
         else None),
        ("extraction", lambda: feature_extraction.main(["--data-dir", str(data), *o])),
        ("standardize", lambda: standardize_features.main([
            "--embeddings-npy", str(feats / "embeddings.npy"), "--embeddings-csv", str(feats / "embeddings.csv"),
            "--output-npz", str(feats / "standardized_features.npz")])),
        ("clustering", cluster_stage),
        ("cohort", lambda: export_unlabeled_cohort.main([
            "--assignments", str(tables / "cluster_assignments.csv"), "--method", "dbscan", "--output", str(cohort)])),
        ("supervised", lambda: supervised_training.main([
            "--strong-data-dir", labeled, "--target-recall", "0.98", "--min-precision", "0.60",
            "--baseline-epochs", str(WORKFLOW_EPOCHS[0]), *o])),
        ("semi", lambda: semi_supervised_training.main([
            "--strong-data-dir", labeled, "--weak-data-dir", str(data / "sans_label"),
            "--unlabeled-cohort-csv", str(cohort), "--target-recall", "0.98", "--min-precision", "0.60",
            "--baseline-epochs", str(WORKFLOW_EPOCHS[0]), "--weak-pretrain-epochs", str(WORKFLOW_EPOCHS[1]),
            "--finetune-epochs", str(WORKFLOW_EPOCHS[2]), "--pseudo-threshold", str(SEMI_THRESHOLD), *o])),
        ("sweep_base", lambda: threshold_sweep.main(["--strong-data-dir", labeled, "--model", "baseline", *o])),
        ("sweep_semi", lambda: threshold_sweep.main(["--strong-data-dir", labeled, "--model", "semi", *o])),
        ("export", lambda: export_model.main(["--model", "semi", *o])),
        ("predict", lambda: predict.main(["--images", str(data / "sans_label"), "--model", "semi", *o,
                                          "--output", str(tables / "predictions_semi.csv")])),
    ]
    training_figures = _training_figures(out)
    figure_log = _FigureWarnings()
    say("workflow", training_figures=(
        "drawn: 4 supervised + 9 semi-supervised, matplotlib installed" if host["matplotlib"]
        else "not drawn: matplotlib missing, each training stage must warn once and write none"))
    n = ANALYSIS_LABELED + ANALYSIS_UNLABELED
    for name, run in stages:
        if run is None:
            missing = " and ".join(name for name, ok in host.items() if not ok)
            say("workflow", stage=name, run=f"not on this card: {missing} not installed here")
            continue
        counts.reset()
        torch.cuda.reset_peak_memory_stats()
        figure_log.messages.clear()
        started_ns = time.time_ns()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: v for k, v in counts.read().items() if v}
        if name == "extraction" and launched.get("preprocess_images") != -(-n // 32):
            raise AssertionError(f"workflow extraction: launches {launched}")
        figures = {}
        if name in ("supervised", "semi"):
            if not launched.get("augment_images"):
                raise AssertionError(f"workflow {name}: no augment launch: {launched}")
            written = sorted(p.name for p in out.glob("figures/*.png") if p.stat().st_mtime_ns >= started_ns)
            want = training_figures[name] if host["matplotlib"] else []
            warned = len(figure_log.messages)
            if written != want or warned != (0 if host["matplotlib"] else 1):
                raise AssertionError(f"workflow {name}: figures {written} (want {want}), {warned} warnings")
            figures = {"figures_written": len(written), "matplotlib_warnings": warned}
        say("workflow", stage=name, seconds=f"{seconds:.2f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", launches=launched, **figures)
    figure_log.close()
    say("workflow", stage="comparison, reporting, readme (scripts/generate_*), after export",
        run="not on the card: they draw with matplotlib and read the JAX package's artifact registry")
    _check_workflow_outputs(np, data, out, n)


def _training_figures(out: Path) -> dict:
    """The figure names the JAX run's supervised and semi-supervised
    pipelines write, by stage."""
    from ssip_tpu_torch.pipelines.supervised import PR_CURVES_BASELINE
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry

    reg = ArtifactRegistry(out)
    baseline = [reg.baseline_curves_png, reg.baseline_confusion_png, reg.roc_curves_png]
    semi = baseline + [
        reg.semi_curves_png, reg.baseline_confusion_thresholded_png, reg.semi_confusion_png,
        reg.semi_confusion_thresholded_png, reg.pr_curves_png, reg.metrics_comparison_png,
    ]
    return {"supervised": sorted([p.name for p in baseline] + [PR_CURVES_BASELINE]),
            "semi": sorted(p.name for p in semi)}


class _FigureWarnings(logging.Handler):
    """Collects the training pipelines' no-matplotlib warnings (the CLIs
    reset the root logger's handlers, not this logger's)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []
        self.logger = logging.getLogger("ssip_tpu_torch.pipelines.supervised")
        self.logger.addHandler(self)

    def emit(self, record):
        if "matplotlib is not installed" in record.getMessage():
            self.messages.append(record.getMessage())

    def close(self):
        self.logger.removeHandler(self)
        super().close()


def _check_workflow_outputs(np, data: Path, out: Path, n: int) -> None:
    """Every artifact of the contract the run wrote, and its form."""
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry

    reg = ArtifactRegistry(out)
    for path in (
        reg.embeddings_npy, reg.embeddings_csv, reg.features_metadata_json, reg.clustering_metrics_csv,
        reg.cluster_assignments_csv, reg.clustering_report_md, reg.tables_dir / "unlabeled_cohort_dbscan.csv",
        reg.baseline_checkpoint, reg.semi_checkpoint, reg.results_comparison_csv, reg.results_comparison_detailed_csv,
        reg.training_history_json, reg.operating_point_json, reg.triage_csv, reg.threshold_sweep_csv("baseline"),
        reg.threshold_sweep_csv("semi"), reg.features_dir / "standardized_features.npz", reg.serving_artifact("semi"),
        reg.tables_dir / "predictions_semi.csv",
    ):
        if not path.is_file() or path.stat().st_size == 0:
            raise AssertionError(f"workflow: missing artifact {path}")
    emb = np.load(reg.embeddings_npy)
    with np.load(reg.features_dir / "standardized_features.npz") as z:
        bundle_ok = z["features"].shape == (n, 512) and int(z["is_labeled"].sum()) == ANALYSIS_LABELED
    metrics = _csv_rows(reg.clustering_metrics_csv)
    methods = [r["method"] for r in metrics]
    assignments = _csv_rows(reg.cluster_assignments_csv)
    cohort = _csv_rows(reg.tables_dir / "unlabeled_cohort_dbscan.csv")
    history = json.loads(reg.training_history_json.read_text())
    test_size = len(history["splits"]["test"])
    sweeps = {m: _csv_rows(reg.threshold_sweep_csv(m)) for m in ("baseline", "semi")}
    embeddings = sorted(p.name for p in (reg.features_dir / "embeddings").glob("*.npz"))
    from ssip_tpu_torch.deploy.export import MANIFEST_VERSION, ExportedModel

    served = ExportedModel.load(reg.serving_artifact("semi"))
    predictions = _csv_rows(reg.tables_dir / "predictions_semi.csv")
    op = json.loads(reg.operating_point_json.read_text())
    checks = {
        "artifact": (served.manifest["version"], served.manifest["arch"], served.threshold) == (
            MANIFEST_VERSION, "resnet18", op["threshold"]) and served.manifest["platforms"] == ["cpu", "cuda"],
        "predictions": len(predictions) == ANALYSIS_UNLABELED and list(predictions[0]) == [
            "path", "prob_positive", "flagged"] and all(0.0 <= float(r["prob_positive"]) <= 1.0 for r in predictions)
        and all(r["flagged"] == str(bool(np.float32(r["prob_positive"]) >= op["threshold"])) for r in predictions),
        "embeddings": emb.shape == (n, 512) and bool(np.isfinite(emb).all()),
        "bundle": bundle_ok,
        "metrics": methods.count("kmeans") == len(KMEANS_KS) and methods.count("dbscan") == 27,
        "assignments": len(assignments) == n and {r["cluster_kmeans"] for r in assignments} != {"-1"},
        "embedding_npz": len(embeddings) == 3 + len(TSNE_PERPLEXITIES) + len(UMAP_GRID),
        "cohort": 0 < len(cohort) <= ANALYSIS_UNLABELED and all(r["path"].startswith("sans_label") for r in cohort),
        "histories": all(len(history[p]["val_loss"]) == e for p, e in zip(
            ("baseline", "semi_pretrain", "semi_finetune"), WORKFLOW_EPOCHS)) and history["pseudo_label_count"] > 0,
        "sweeps": all(rows and all(sum(float(r[c]) for c in SWEEP_COUNTS) == test_size for r in rows)
                      for rows in sweeps.values()),
        "triage": len(_csv_rows(reg.triage_csv)) == ANALYSIS_UNLABELED,
    }
    if not all(checks.values()):
        raise AssertionError(f"workflow outputs: {checks}")
    say("workflow", artifacts="all present and well formed", images=n, cohort=len(cohort),
        pseudo_labels=history["pseudo_label_count"],
        dbscan_clusters=len({r["cluster_dbscan"] for r in assignments} - {"-1"}), sweep_rows={m: len(rows) for m, rows in sweeps.items()})


# --------------------------------------------------------------------------
# The MoE ViTs, resume snapshots and the streamed extraction shape

# MoE routing on the card: the router's softmax, the stable sort of top-k,
# the slotting cumsum and the one-hot compares
_MOE_PROFILE_CLASSES = (
    _VIT_PROFILE_CLASSES[:5]
    + (("MoE routing (sort, cumsum, one-hot compares)", ("sort", "radix", "scan", "cumsum", "segmented", "compare",
                                                          "eq_kernel")),)
    + _VIT_PROFILE_CLASSES[5:]
)
MOE_STEP_CHECK_BATCH = 4
MOE_ROUTER_GRAD = "encoder.layers.encoder_layer_1.moe.router.weight"


def _router_choices(torch, model) -> list:
    """A forward hook on each expert layer that keeps the argmax of its
    router's logits; the list fills as the model runs."""
    import torch.nn.functional as F

    from ssip_tpu_torch.models.moe import MoEMlp

    seen, handles = [], []
    for layer in (m for m in model.modules() if isinstance(m, MoEMlp)):
        def hook(module, inputs, output):
            logits = F.linear(inputs[0].detach().float(), module.router.weight, module.router.bias)
            seen.append(logits.argmax(dim=-1).cpu())

        handles.append(layer.register_forward_hook(hook))
    return seen, handles


def phase_moe_step(torch, np, counts: LaunchCounts) -> None:
    """vit_moe_s16: one float32 train step on the card against the CPU at
    the seeded weights (the loss with the aux term, the aux term alone, the
    gradients, the routers' included, at the dense ViT step check's bounds,
    and how many router choices the two devices made differently); a
    vit_moe_t16 forward (3 heads) on the card against the CPU; then the
    steady-state train and FixMatch steps at batch 128 in bfloat16."""
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.ops.augment import augment_coeffs, eval_preprocess
    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.runtime.prng import augment_draws
    from ssip_tpu_torch.train.engine import train_step

    configure_precision("float32")
    b = MOE_STEP_CHECK_BATCH
    batch = _step_inputs(torch, np, b, padded_rows=1)
    coeffs = torch.from_numpy(augment_coeffs(*augment_draws(SEED, "smoke_moe", 0, 0, b)))

    def one(dev):
        state = _seeded_state(torch, dev, torch.float32, MOE_ARCH)
        choices, handles = _router_choices(torch, state.model)
        try:
            loss, pred = train_step(state, *(t.to(dev) for t in batch), coeffs.to(dev))
        finally:
            for h in handles:
                h.remove()
        aux = sum(t.detach() for t in state.model.aux_losses())
        return loss.cpu(), pred.cpu(), aux.cpu(), {k: p.grad.cpu() for k, p in state.model.named_parameters()}, choices

    l_cpu, p_cpu, a_cpu, g_cpu, c_cpu = one(torch.device("cpu"))
    counts.reset()
    l_gpu, p_gpu, a_gpu, g_gpu, c_gpu = one(torch.device("cuda"))
    launches = counts.read()
    r = {
        "loss": l_cpu.item(), "aux": a_cpu.item(), "loss_rel": _rel(l_gpu, l_cpu), "aux_rel": _rel(a_gpu, a_cpu),
        "argmax_equal": torch.equal(p_gpu, p_cpu), "grad_rel": max(_rel(g_gpu[k], g_cpu[k]) for k in g_cpu),
        "grad_worst": max(g_cpu, key=lambda k: _rel(g_gpu[k], g_cpu[k])),
        "router_grad_rel": _rel(g_gpu[MOE_ROUTER_GRAD], g_cpu[MOE_ROUTER_GRAD]),
        "router_choices_differ": int(sum((a != c).sum() for a, c in zip(c_gpu, c_cpu))),
        "router_choices": int(sum(c.numel() for c in c_cpu)),
    }
    say("moe", arch=MOE_ARCH, check="step_cuda_vs_cpu_f32_seeded", batch=b, padded_rows=1, **r,
        launches={k: v for k, v in launches.items() if v})
    want = {"layer_norm": VIT_LN_PER_FORWARD, "layer_norm_bwd": VIT_LN_PER_FORWARD,
            "attention_qkv": VIT_ATTN_PER_FORWARD, "attention_qkv_bwd": VIT_ATTN_PER_FORWARD}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{MOE_ARCH} step launched {launches}, expected {want}")
    if (r["loss_rel"] > 1e-5 or r["aux_rel"] > 1e-5 or r["grad_rel"] > 1e-3 or not r["argmax_equal"]
            or not r["aux"] > 0):
        raise AssertionError(f"{MOE_ARCH} train step cuda vs cpu out of bounds: {r}")

    model = build_model(MOE_T16, compute_dtype=torch.float32)
    load_flax_variables(model, seeded_init_host(MOE_T16, 42))
    x = eval_preprocess(_step_inputs(torch, np, VIT_N_CPU_CHECK)[0], torch.float32)
    with torch.inference_mode():
        cpu = model.eval()(x)
        counts.reset()
        gpu = model.cuda()(x.cuda()).cpu()
        launches = counts.read()
    rel = _rel(gpu, cpu)
    say("moe", arch=MOE_T16, check="forward_cuda_vs_cpu_f32", images=VIT_N_CPU_CHECK, heads=3, rel=rel,
        launches={k: v for k, v in launches.items() if v})
    if rel > 1e-4 or launches["attention_qkv"] != VIT_ATTN_PER_FORWARD:
        raise AssertionError(f"{MOE_T16} forward cuda vs cpu {rel}, launches {launches}")
    del model
    _timed_steps(torch, np, MOE_ARCH, counts, _MOE_PROFILE_CLASSES, dtypes=("bfloat16",))
    _timed_fixmatch_steps(torch, np, MOE_ARCH, counts, (("rotate kernel", ROTATE_U8_KERNELS),) + _MOE_PROFILE_CLASSES,
                          dtypes=("bfloat16",))


def phase_moe_serve(torch, np, tmp: Path, pool: Path) -> None:
    """The ``[semi]`` MoE run directory (bfloat16 training, float32
    checkpoint) through ``export_model`` in bfloat16, the artifact against
    the in-process predictor at batch 1, 3 and 128, then ``predict`` over
    the pool from it."""
    from ssip_tpu_torch.cli import export_model, predict
    from ssip_tpu_torch.data.decode import decode_batch
    from ssip_tpu_torch.deploy.export import ExportedModel
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
    from ssip_tpu_torch.serving import ScreeningPredictor
    from ssip_tpu_torch.train.data import resize_on_device

    out = tmp / f"semi_out_{MOE_ARCH}_bfloat16"
    arrays, _ = decode_batch(sorted(pool.glob("*.jpg"))[:SERVE_BATCH], num_threads=8, convert_rgb=True)
    images = resize_on_device(arrays, TRAIN_SIZE, torch.device("cpu")).numpy()
    reg = ArtifactRegistry(out)
    t0 = time.perf_counter()
    export_model.main(["--output-dir", str(out), "--model", "semi", "--compute-dtype", "bfloat16"])
    export_s = time.perf_counter() - t0
    exported = ExportedModel.load(reg.serving_artifact("semi"))
    predictor = ScreeningPredictor.from_artifacts(out, compute_dtype="bfloat16", device="cuda")
    worst = 0.0
    for n in SERVE_BATCHES:
        predictor.batch_size = _bucket(n)
        worst = max(worst, float(np.abs(exported.predict_probs(images[:n]) - predictor.predict_probs(images[:n])).max()))
    if not worst <= SERVE_BF16_ATOL:
        raise AssertionError(f"moe serve: exported vs in-process {worst} > {SERVE_BF16_ATOL}")
    csv_path = tmp / "moe_predictions.csv"
    predict.main(["--images", str(pool), "--output-dir", str(out), "--model", "semi", "--output", str(csv_path)])
    rows = _csv_rows(csv_path)
    ok = (len(rows) == POOL_IMAGES and exported.manifest["arch"] == MOE_ARCH
          and all(0.0 <= float(r["prob_positive"]) <= 1.0 for r in rows)
          and all(r["flagged"] == str(bool(np.float32(r["prob_positive"]) >= exported.threshold)) for r in rows))
    if not ok:
        raise AssertionError(f"moe predict: {len(rows)} rows, manifest {exported.manifest.get('arch')}")
    say("moe", arch=MOE_ARCH, serve="bfloat16", export_s=f"{export_s:.2f}", batches=SERVE_BATCHES,
        exported_vs_in_process=worst, artifact_mb=f"{reg.serving_artifact('semi').stat().st_size / 1e6:.1f}",
        predict_images=len(rows), flagged=sum(r["flagged"] == "True" for r in rows))


def _max_diff(np, a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))) if len(a) else 0.0


def _state_diff(torch, a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a if a[k].is_floating_point())


RESUME_RUNS = 3  # uninterrupted runs where a resumed one is not bitwise: the card's own run-to-run spread


def _restore_spy(torch, module, seen: dict):
    """Wrap ``module.restore_resume_state`` so that, after each restore, it
    records whether the live train state equals the snapshot file bit for
    bit (model, optimizer moments, step counts, learning rate, step)."""
    from ssip_tpu_torch.train.checkpoints import load_train_snapshot

    real = module.restore_resume_state

    def spy(path, state):
        driver, best = real(path, state)
        snap, _ = load_train_snapshot(path)
        live_opt = state.optimizer.state_dict()
        seen["restored_bitwise"] = driver is not None and state.step == snap.step and all(
            torch.equal(v.cpu(), snap.model[k]) for k, v in state.model.state_dict().items()
        ) and live_opt["param_groups"] == snap.optimizer["param_groups"] and all(
            torch.equal(t.cpu(), snap.optimizer["state"][i][name])
            for i, leaves in live_opt["state"].items() for name, t in leaves.items()
        )
        return driver, best

    module.restore_resume_state = spy
    return real


def _resume_bar(torch, np, uninterrupted: list, resumed) -> tuple:
    """(bar, got): the largest val-loss and weight distances between the
    uninterrupted runs (each a (history, state_dict)), and the median of the
    resumed run's distances to them."""
    def dist(a, b):
        return {"val_loss": _max_diff(np, a[0]["val_loss"], b[0]["val_loss"]), "weights": _state_diff(torch, a[1], b[1])}

    pairs = [dist(a, b) for i, a in enumerate(uninterrupted) for b in uninterrupted[i + 1:]]
    to_resumed = [dist(resumed, a) for a in uninterrupted]
    bar = {k: max(p[k] for p in pairs) for k in ("val_loss", "weights")}
    got = {k: float(np.median([d[k] for d in to_resumed])) for k in ("val_loss", "weights")}
    return bar, got


def _bitwise_gap(torch, np, a, b) -> dict:
    """The largest differences of two runs' histories (train and val
    losses) and final weights; all zero when they are bit for bit equal."""
    return {"history": max(_max_diff(np, a[0][k], b[0][k]) for k in ("train_loss", "val_loss")),
            "weights": _state_diff(torch, a[1], b[1])}


def _bitwise_or_spread(torch, np, run, straight, resumed) -> tuple:
    """Queue 3 #11: under cuDNN's deterministic mode a resumed (or lane)
    run is held bit for bit to one uninterrupted (or solo) run ``straight``;
    where it is not, ``RESUME_RUNS - 1`` more uninterrupted runs
    (``run()``) give the card's spread and the old bar holds it (the median
    distance within twice the largest distance between two of them).
    Returns (bar's name, the gap to ``straight``, whether the bar holds)."""
    gap = _bitwise_gap(torch, np, resumed, straight)
    if not any(gap.values()):
        return "bitwise", gap, True
    bar, got = _resume_bar(torch, np, [straight] + [run() for _ in range(RESUME_RUNS - 1)], resumed)
    return f"twice_spread {bar}, median {got}", gap, all(got[k] <= 2 * bar[k] for k in got)


def phase_resume(torch, np, tmp: Path, data: Path, pool: Path) -> None:
    """``--resume`` on the card, with cuDNN's deterministic mode on
    (Queue 3 #11). resnet18 float32 ``run_supervised``: 4 epochs without
    snapshots, then 2 epochs with ``resume`` and resumed to 4. The restored
    train state must equal the snapshot file bit for bit, and the resumed
    run the uninterrupted one (history and final checkpoint); where it is
    not bitwise the old bar takes over (``_bitwise_or_spread``: two more
    uninterrupted runs, the resumed run within twice their spread) and the
    line says so. ``train_fixmatch`` (EMA off) likewise, 3 epochs, cut
    after 1; and with an EMA teacher, the teacher at the first step after
    the resume equal to the ``.best`` sidecar's parameters."""
    from ssip_tpu_torch.pipelines.supervised import TrainingConfig, build_classifier_state, prepare_datasets, run_supervised
    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.train import consistency, engine
    from ssip_tpu_torch.train.checkpoints import load_train_snapshot
    from ssip_tpu_torch.train.data import load_unlabeled_dataset

    runs = iter(range(100))

    def supervised(name, epochs, resume):
        out = tmp / f"resume_{name}"
        cfg = TrainingConfig(strong_data_dir=data, output_dir=out, device="cuda", batch_size=TRAIN_BATCH,
                             image_size=TRAIN_SIZE, baseline_epochs=epochs, compute_dtype="float32", resume=resume)
        run_supervised(cfg)
        hist = json.loads(cfg.artifacts.training_history_json.read_text())["baseline"]
        return hist, torch.load(cfg.artifacts.baseline_checkpoint, map_location="cpu", weights_only=True)

    configure_precision("float32")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        seen: dict = {}
        t0 = time.perf_counter()
        straight = supervised("u", 4, False)
        supervised("r", 2, True)
        real = _restore_spy(torch, engine, seen)
        try:
            resumed = supervised("r", 4, True)
        finally:
            engine.restore_resume_state = real
        bar, gap, held = _bitwise_or_spread(torch, np, lambda: supervised(f"u{next(runs)}", 4, False),
                                            straight, resumed)
        say("resume", arch="resnet18", dtype="float32", run="run_supervised", epochs="2+2 vs 4",
            cudnn_deterministic=True, restored_bitwise=seen.get("restored_bitwise"), bar=bar,
            resumed_vs_uninterrupted=gap, seconds=f"{time.perf_counter() - t0:.2f}")
        if not seen.get("restored_bitwise") or len(resumed[0]["val_loss"]) != 4 or not held:
            raise AssertionError(f"resume run_supervised: restored {seen}, resumed {gap}, bar {bar}")

        cfg = TrainingConfig(strong_data_dir=data, device="cuda", batch_size=TRAIN_BATCH, image_size=TRAIN_SIZE)
        datasets, _, _ = prepare_datasets(cfg, torch.device("cuda"))
        pool_images, _ = load_unlabeled_dataset(pool, TRAIN_SIZE, torch.device("cuda"), num_threads=8)
        kw = dict(batch_size=TRAIN_BATCH, unlabeled_batch_size=TRAIN_BATCH, seed=42, stream_name="semi_finetune",
                  consistency_weight=1.0, confidence_threshold=SEMI_THRESHOLD)

        def fixmatch(epochs, resume_path=None, ema_decay=0.0):
            state = build_classifier_state(cfg, 2, 1e-4, torch.device("cuda"))
            state, hist = consistency.train_fixmatch(state, datasets["train"], datasets["val"], pool_images,
                                                     num_epochs=epochs, resume_path=resume_path, ema_decay=ema_decay,
                                                     **kw)
            return hist, {k: v.detach().cpu() for k, v in state.model.state_dict().items()}

        seen.clear()
        straight = fixmatch(3)
        snap = tmp / "resume_fixmatch" / "semi_finetune.torchsnap"
        fixmatch(1, snap)
        real = _restore_spy(torch, consistency, seen)
        try:
            resumed = fixmatch(3, snap)
        finally:
            consistency.restore_resume_state = real
        bar, gap, held = _bitwise_or_spread(torch, np, lambda: fixmatch(3), straight, resumed)
        say("resume", arch="resnet18", dtype="float32", run="train_fixmatch", ema_decay=0.0, epochs="1+2 vs 3",
            cudnn_deterministic=True, restored_bitwise=seen.get("restored_bitwise"), bar=bar,
            resumed_vs_uninterrupted=gap)
        if not seen.get("restored_bitwise") or len(resumed[0]["val_loss"]) != 3 or not held:
            raise AssertionError(f"resume train_fixmatch: restored {seen}, resumed {gap}, bar {bar}")

        snap = tmp / "resume_ema" / "semi_finetune.torchsnap"
        fixmatch(1, snap, SEMI_EMA_DECAY)
        best, _ = load_train_snapshot(str(snap) + ".best")
        teacher = []
        real_step = consistency.fixmatch_step

        def step_spy(state, ema_params, *args, **kwargs):
            if not teacher:
                teacher.append({k: v.detach().cpu().clone() for k, v in ema_params.items()})
            return real_step(state, ema_params, *args, **kwargs)

        consistency.fixmatch_step = step_spy
        try:
            fixmatch(2, snap, SEMI_EMA_DECAY)
        finally:
            consistency.fixmatch_step = real_step
    finally:
        torch.backends.cudnn.deterministic = deterministic
    equal = all(torch.equal(teacher[0][k], best.model[k]) for k in teacher[0])
    say("resume", arch="resnet18", run="train_fixmatch", ema_decay=SEMI_EMA_DECAY,
        teacher_after_resume_equals_best_sidecar=equal, parameters=len(teacher[0]))
    if not equal:
        raise AssertionError("resume with an EMA teacher: the teacher did not restart from the .best sidecar")


def _rss_run(code: str) -> dict:
    """Run ``code`` in a fresh interpreter from the repository root, after
    the card and the kernel library are initialized; ``code`` sets
    ``result`` (a dict). Returns it with the process's resident set before
    ``code`` (``rss_base_mib``) and its peak while ``code`` ran
    (``rss_peak_mib``, VmRSS sampled every 5 ms)."""
    prelude = textwrap.dedent("""
        import json, threading, time
        import torch
        from ssip_tpu_torch.kernels.build import load_library
        torch.zeros(1, device="cuda"); load_library()

        def rss_mib():
            for line in open("/proc/self/status"):
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024

        base, peak, done = rss_mib(), [0.0], threading.Event()

        def sample():
            while not done.is_set():
                peak[0] = max(peak[0], rss_mib())
                time.sleep(0.005)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
    """)
    coda = "\ndone.set(); sampler.join()\nprint(json.dumps({**result, 'rss_base_mib': base, 'rss_peak_mib': max(peak[0], rss_mib())}))\n"
    proc = subprocess.run([sys.executable, "-c", prelude + code + coda], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"stream run failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_stream(torch, np, tmp: Path, counts: LaunchCounts, host: dict) -> None:
    """The streamed extraction shape on the workflow's 1,506-image 512² JPEG
    tree, resnet18 bfloat16 at batch 128, each run in a fresh interpreter
    (end-to-end imgs/s, decode included, and how far the resident set grew): the
    resident store shape, ``streaming="always"`` and ``host_preproc``
    (embeddings against the resident ones), and ``fast_decode`` twice (the
    two equal, the cosine to the exact path printed). Then the preprocess
    kernel at 224² → 224 (the identity resample the host-preproc path runs
    on the card) bit for bit against its plain version."""
    from ssip_tpu_torch.ops.preproc import preprocess_images
    from ssip_tpu_torch.ops.resize import extraction_preprocess
    from ssip_tpu_torch.runtime.device import configure_precision

    root = tmp / "workflow_data"
    if not root.exists():
        make_workflow_tree(np, tmp)
    n = ANALYSIS_LABELED + ANALYSIS_UNLABELED
    variants = [("resident", {"streaming": "never"}), ("always", {"streaming": "always"})]
    if host["native_decoder"]:
        variants += [("host_preproc", {"host_preproc": True}), ("fast_decode", {"fast_decode": True})]
    emb = {}
    for name, kw in variants:
        out = tmp / f"stream_{name}"
        runs = 2 if name == "fast_decode" else 1
        code = textwrap.dedent(f"""
            from pathlib import Path
            import numpy as np
            from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction
            for i in range({runs}):
                cfg = ExtractionConfig(data_dir=Path({str(root)!r}), output_dir=Path({str(out)!r}) / str(i),
                                       batch_size={BATCH}, device="cuda", compute_dtype="bfloat16",
                                       cache_decoded=False, **{kw!r})
                s = run_extraction(cfg)
                np.save(Path({str(out)!r}) / f"emb{{i}}.npy", s.embeddings)
            result = {{"seconds": s.total_seconds, "images": int(s.embeddings.shape[0]),
                       "failures": len(s.failures), "embed_s": s.embed_seconds}}
        """)
        r = _rss_run(code)
        emb[name] = [np.load(out / f"emb{i}.npy") for i in range(runs)]
        if r["images"] != n or r["failures"] or not np.isfinite(emb[name][0]).all():
            raise AssertionError(f"stream {name}: {r}")
        fields = {"imgs_per_s_e2e": f"{n / r['seconds']:.1f}", "e2e_s": f"{r['seconds']:.3f}",
                  "embed_span_s": f"{r['embed_s']:.3f}", "rss_base_mib": f"{r['rss_base_mib']:.0f}",
                  "rss_peak_mib": f"{r['rss_peak_mib']:.0f}",
                  "rss_growth_mib": f"{r['rss_peak_mib'] - r['rss_base_mib']:.0f}"}
        if name != "resident":
            diff = float(np.abs(emb[name][0] - emb["resident"][0]).max())
            cos = (_unit(np, emb[name][0]) * _unit(np, emb["resident"][0])).sum(axis=1)
            fields.update(max_abs_diff_vs_resident=diff, equal_to_resident=bool(diff == 0.0),
                          cos_vs_resident_min=f"{cos.min():.6f}")
            if name in ("always", "host_preproc") and cos.min() <= 0.9999:
                raise AssertionError(f"stream {name}: cosine to the resident shape {cos.min()}")
        if name == "fast_decode":
            fields["two_runs_equal"] = bool(np.array_equal(emb[name][0], emb[name][1]))
            if not fields["two_runs_equal"]:
                raise AssertionError("fast_decode: two runs differ")
        say("stream", arch="resnet18", dtype="bfloat16", images=n, batch=BATCH, shape=name, **fields)
    if not host["native_decoder"]:
        say("stream", not_run="host_preproc, fast_decode", reason="no g++ or no /usr/include/jpeglib.h on this machine")

    configure_precision("float32")
    x = torch.from_numpy(np.random.default_rng(SEED + 50).integers(0, 256, (BATCH, CROP, CROP, 3),
                                                                     dtype=np.uint8)).cuda()
    got = {dt: preprocess_images(x, CROP, CROP, getattr(torch, dt)) for dt in ("float32", "bfloat16")}
    ref = extraction_preprocess(x, CROP, CROP, torch.float32)
    exact = torch.equal(got["float32"], ref) and torch.equal(got["bfloat16"], ref.to(torch.bfloat16))
    kernel_ms, plain_ms = timed_pair(torch, lambda: preprocess_images(x, CROP, CROP, torch.bfloat16),
                                     lambda: extraction_preprocess(x, CROP, CROP, torch.bfloat16))
    counts.reset()
    say("stream", kernel="preprocess_images", shape=f"{BATCH}x{CROP}x{CROP}x3 -> {CROP}", bitwise_f32_and_bf16=exact,
        ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    if not exact:
        raise AssertionError(f"preprocess at {CROP} -> {CROP}: not bit for bit its plain version")


SEEDS_LANES, SEEDS_EPOCHS = 4, 3
SEEDS_SOLO_RUNS = 3  # solo runs of each seed where a lane is not bitwise: the card's spread
# lane against its solo run (tests/test_multi_seed.py:180-210): the losses of
# epoch 0 and of later epochs (relative), the best weights (rtol, atol)
SEEDS_ENVELOPE = {"epoch0": 1e-4, "later": 5e-2, "weights": (5e-2, 5e-4)}
CV_FOLDS, CV_EPOCHS = 3, 2


def _within_envelope(np, torch, lane, solo) -> bool:
    ok = len(lane[0]["val_loss"]) == len(solo[0]["val_loss"])
    for key in ("train_loss", "val_loss"):
        got, want = np.asarray(lane[0][key]), np.asarray(solo[0][key])
        ok = ok and abs(got[0] - want[0]) <= SEEDS_ENVELOPE["epoch0"] * abs(want[0])
        ok = ok and bool(np.all(np.abs(got[1:] - want[1:]) <= SEEDS_ENVELOPE["later"] * np.abs(want[1:])))
    rtol, atol = SEEDS_ENVELOPE["weights"]
    return bool(ok) and all(torch.allclose(lane[1][k].double(), v.double(), rtol=rtol, atol=atol)
                            for k, v in solo[1].items() if v.is_floating_point())


def phase_seeds(torch, np, tmp: Path, data: Path, counts: LaunchCounts) -> None:
    """``run_supervised`` with ``--num-seeds 4`` (resnet18 float32 at 224²,
    batch 16, 3 epochs), its lanes read through a wrap of
    ``train_multi_seed``; then one solo ``train_model`` run of each seed on
    the same split, all with cuDNN's deterministic mode on (Queue 3 #11).
    Each lane is held bit for bit to its seed's solo run (history and
    weights); where one is not, two more solo runs of each seed are made
    and the lanes held to the older bars: to the JAX test's envelope where the
    card allows it, else the median of each lane's distances to the three
    solo runs within twice the largest distance between two of them. The
    seed sweep CSV to the lanes' summary and the saved checkpoint to the
    selected lane's state, bit for bit."""
    import csv

    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.pipelines import supervised
    from ssip_tpu_torch.pipelines.supervised import TrainingConfig, build_classifier_state, prepare_datasets
    from ssip_tpu_torch.train.checkpoints import load_checkpoint
    from ssip_tpu_torch.train.engine import train_model

    dev = torch.device("cuda")
    cfg = TrainingConfig(strong_data_dir=data, output_dir=tmp / "seeds_out", device="cuda", batch_size=TRAIN_BATCH,
                         image_size=TRAIN_SIZE, baseline_epochs=SEEDS_EPOCHS, num_seeds=SEEDS_LANES,
                         compute_dtype="float32")
    seeds = [cfg.seed + i for i in range(SEEDS_LANES)]
    real, seen = supervised.train_multi_seed, {}

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        states, histories, summary = real(*args, **kwargs)
        torch.cuda.synchronize()
        seen["seconds"] = time.perf_counter() - t0
        seen["lanes"] = [(h, {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()})
                         for h, st in zip(histories, states)]
        seen["summary"] = [dict(row) for row in summary]
        return states, histories, summary

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    supervised.train_multi_seed = spy
    counts.reset()  # count only the main path's launches
    try:
        supervised.run_supervised(cfg)
        launches = counts.read()
        datasets, _, splits = prepare_datasets(cfg, dev)
        steps = -(-len(splits["train"]) // TRAIN_BATCH)
        if launches["augment_images"] != SEEDS_LANES * SEEDS_EPOCHS * steps:
            raise AssertionError(f"seeds: the lanes launched {launches}")

        def solo(seed):
            state = build_classifier_state(cfg, 2, cfg.learning_rate, dev, seed=seed)
            t0 = time.perf_counter()
            state, hist = train_model(state, datasets["train"], datasets["val"], num_epochs=SEEDS_EPOCHS,
                                      batch_size=TRAIN_BATCH, seed=seed, stream_name="baseline", balanced=True,
                                      augment=True, early_stopping_patience=cfg.early_stopping_patience)
            torch.cuda.synchronize()
            return (hist, {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
                    time.perf_counter() - t0)

        solos = [[solo(seed)] for seed in seeds]
        gaps = [_bitwise_gap(torch, np, run, refs[0][:2]) for run, refs in zip(seen["lanes"], solos)]
        rows = [{"seed": seed, "bitwise_gap": gap} for seed, gap in zip(seeds, gaps)]
        bar = "bitwise" if not any(any(g.values()) for g in gaps) else None
        if bar is None:  # the old bars, on three solo runs of each seed
            for refs, seed in zip(solos, seeds):
                refs.extend(solo(seed) for _ in range(SEEDS_SOLO_RUNS - 1))
            for row, run, refs in zip(rows, seen["lanes"], solos):
                spread, dist = _resume_bar(torch, np, [r[:2] for r in refs], run)
                row.update(envelope=_within_envelope(np, torch, run, refs[0]),
                           within_twice_spread=all(dist[k] <= 2 * spread[k] for k in dist),
                           median_distance=dist, spread=spread)
            bar = ("envelope" if all(r["envelope"] for r in rows)
                   else "twice_spread" if all(r["within_twice_spread"] for r in rows) else None)
    finally:
        supervised.train_multi_seed = real
        torch.backends.cudnn.deterministic = deterministic
    for r in rows:
        say("seeds", lane_vs_solo=r)

    with open(cfg.artifacts.seed_sweep_csv, newline="") as fh:
        written = list(csv.DictReader(fh))
    best = int(np.argmin([row["best_val_loss"] for row in seen["summary"]]))
    want = [{k: str(v) for k, v in {**row, "selected": i == best}.items()} for i, row in enumerate(seen["summary"])]
    model = build_model("resnet18", num_classes=2)
    load_checkpoint(cfg.artifacts.baseline_checkpoint, model)
    saved = {k: v.cpu() for k, v in model.state_dict().items()}
    checkpoint_is_lane = all(torch.equal(saved[k], v) for k, v in seen["lanes"][best][1].items())
    history = json.loads(cfg.artifacts.training_history_json.read_text())
    solo_seconds = sum(refs[0][2] for refs in solos)
    say("seeds", arch="resnet18", dtype="float32", lanes=SEEDS_LANES, epochs=SEEDS_EPOCHS, batch=TRAIN_BATCH,
        bar=bar, solo_runs=len(solos[0]), envelope=SEEDS_ENVELOPE, selected_seed=seeds[best],
        csv_equals_summary=written == want, checkpoint_is_selected_lane=checkpoint_is_lane,
        history_num_seeds=history.get("num_seeds"), lanes_seconds=f"{seen['seconds']:.2f}",
        four_solo_seconds=f"{solo_seconds:.2f}", lanes_over_solo=f"{seen['seconds'] / solo_seconds:.3f}",
        launches={k: v for k, v in launches.items() if v})
    if bar is None or written != want or not checkpoint_is_lane or history.get("num_seeds") != SEEDS_LANES:
        raise AssertionError(f"seeds: lanes {rows}, csv {written} vs {want}, "
                             f"checkpoint is the lane: {checkpoint_is_lane}")


def phase_cv(torch, np, tmp: Path, data: Path, counts: LaunchCounts) -> None:
    """``run_supervised`` with ``--cv-folds 3`` (resnet18 float32 at 224²,
    batch 16, 2 epochs): ``cv_results.csv`` holds the three folds, whose
    validation sets partition the train + val pool, then their mean and
    std."""
    import csv

    from ssip_tpu_torch.pipelines.supervised import TrainingConfig, run_supervised

    cfg = TrainingConfig(strong_data_dir=data, output_dir=tmp / "cv_out", device="cuda", batch_size=TRAIN_BATCH,
                         image_size=TRAIN_SIZE, baseline_epochs=CV_EPOCHS, cv_folds=CV_FOLDS, compute_dtype="float32")
    counts.reset()  # count only the main path's launches
    t0 = time.perf_counter()
    run_supervised(cfg)
    seconds = time.perf_counter() - t0
    launches = counts.read()
    with open(cfg.artifacts.cv_results_csv, newline="") as fh:
        rows = list(csv.DictReader(fh))
    splits = json.loads(cfg.artifacts.training_history_json.read_text())["splits"]
    pool = len(splits["train"]) + len(splits["val"])
    folds = rows[:CV_FOLDS]
    stats = ("best_val_loss", "val_acc", "val_f1")
    means = {k: float(np.mean([float(r[k]) for r in folds])) for k in stats}
    ok = ([r["fold"] for r in rows] == [*map(str, range(CV_FOLDS)), "mean", "std"]
          and sum(float(r["n_val"]) for r in folds) == pool
          and all(float(r["n_train"]) + float(r["n_val"]) == pool for r in folds)
          and all(np.isfinite(float(r[k])) for r in rows for k in stats)
          and all(abs(float(rows[CV_FOLDS][k]) - means[k]) <= 1e-12 for k in stats)
          and launches["augment_images"] > 0)
    say("cv", arch="resnet18", dtype="float32", folds=CV_FOLDS, epochs=CV_EPOCHS, pool=pool,
        n_val=[r["n_val"] for r in folds], val_acc=[r["val_acc"] for r in rows],
        best_val_loss=[r["best_val_loss"] for r in rows], seconds=f"{seconds:.2f}",
        launches={k: v for k, v in launches.items() if v})
    if not ok:
        raise AssertionError(f"cv: rows {rows} for a pool of {pool}, launches {launches}")


RANDAUG_MAX_SHARE_OFF = 1e-4  # values of the card's uint8 strong view off the CPU's, each by one step at most


def phase_randaug(torch, np, tmp: Path, data: Path, pool: Path, counts: LaunchCounts) -> None:
    """FixMatch's RandAugment strong view: card against CPU on the same
    draws (128 images at 224², uint8 before the normalize), the timed
    resnet18 bf16 FixMatch step at 128 + 128 with it (``[fixmatch_step]``
    times the jitter's), and one ``run_pipeline`` with it."""
    from ssip_tpu_torch.ops.randaugment import strong_augment_randaugment, strong_view_u8
    from ssip_tpu_torch.train.consistency import epoch_view_draws

    b = STEP_TIMED_BATCH
    _, unlabeled = _fixmatch_inputs(torch, np, b)
    d = epoch_view_draws(SEED, "smoke_randaug", 0, 1, b, b, torch.device("cpu"), "randaugment",
                         (TRAIN_SIZE, TRAIN_SIZE))[0]
    cpu = strong_view_u8(unlabeled, d.randaugment, d.randaugment_geo)
    g = d.to(torch.device("cuda"))
    card_in = unlabeled.cuda()
    card = strong_view_u8(card_in, g.randaugment, g.randaugment_geo).cpu()
    off = (card.int() - cpu.int()).abs()
    n_off, worst = int((off > 0).sum()), int(off.max())
    u8_ms = median_ms(torch, lambda: strong_view_u8(card_in, g.randaugment, g.randaugment_geo))
    bf16_ms = median_ms(torch, lambda: strong_augment_randaugment(card_in, g.randaugment, torch.bfloat16,
                                                                  g.randaugment_geo))
    ops = np.bincount(d.randaugment.op.numpy().reshape(-1), minlength=14).tolist()
    say("randaug", check="card_vs_cpu_u8", images=b, size=TRAIN_SIZE, values_off=n_off, values=off.numel(),
        max_step=worst, bitwise=n_off == 0, ops_drawn=ops, view_u8_ms=f"{u8_ms:.4f}", view_bf16_ms=f"{bf16_ms:.4f}")
    if worst > 1 or n_off > RANDAUG_MAX_SHARE_OFF * off.numel():
        raise AssertionError(f"randaug: card vs CPU {n_off} values off, by up to {worst}")
    _timed_fixmatch_steps(torch, np, "resnet18", counts, (("rotate kernel", ROTATE_U8_KERNELS),) + _PROFILE_CLASSES,
                          dtypes=("bfloat16",), strong_aug="randaugment", tag="randaug")
    phase_semi(torch, np, tmp, data, pool, counts, "resnet18", ("bfloat16",), strong_aug="randaugment",
               tag="randaug")


# the folded embed loop by layer: the preprocess kernel, the convolutions
# (cuDNN), the bias, ReLU and residual adds, the max-pool
_FOLD_PROFILE_CLASSES = (
    ("preprocess kernel", ("preproc_",)),
    ("max-pool", ("max_pool",)),
    _PROFILE_CLASSES[2],
    ("BatchNorm, bias, ReLU, adds, pool (elementwise and reductions)", _PROFILE_CLASSES[4][1]),
)


def phase_fold(torch, np, tmp: Path, corpus, counts: LaunchCounts) -> None:
    """``run_extraction`` of resnet18 in bfloat16 with ``fast_inference``
    (the folded-BN forward) beside the plain forward on the corpus, resident
    shape, runs in the order plain, folded, folded, plain: per-image cosine
    > 0.995 and the largest difference, and each forward's embed-loop
    imgs/s; each loop profiled once; the folded forward computed in float32
    within 1e-4 of the plain one on 128 images."""
    from torch.profiler import ProfilerActivity, profile

    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.ops.preproc import preprocess_images
    from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, extract_embeddings, folded_forward, run_extraction
    from ssip_tpu_torch.runtime.device import configure_precision

    data, records, images, store = corpus

    def cfg(fast: bool) -> ExtractionConfig:
        return ExtractionConfig(data_dir=data, output_dir=tmp / f"fold_out_{fast}", batch_size=BATCH, device="cuda",
                                compute_dtype="bfloat16", cache_decoded=False, fast_inference=fast)

    run_extraction(cfg(True), store=store)  # warm: the folded convolutions' cuDNN set-up
    counts.reset()  # count only the main path's launches
    rates = {False: [], True: []}
    emb = {}
    for fast in (False, True, True, False):
        summary = run_extraction(cfg(fast), store=store)
        rates[fast].append(N_IMAGES / summary.embed_seconds)
        emb[fast] = summary.embeddings
    launches = counts.read()
    if launches["preprocess_images"] != 4 * (N_IMAGES // BATCH):
        raise AssertionError(f"fold: the extraction path launched {launches}")
    cos = (_unit(np, emb[True]) * _unit(np, emb[False])).sum(axis=1)
    diff = float(np.abs(emb[True] - emb[False]).max())
    for fast in (False, True):
        counts.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            summary = extract_embeddings(records, cfg(fast), store=store)
        counts.read()
        _profile_breakdown(torch, prof, summary.embed_seconds * 1e3, f"resnet18_embed_bfloat16_fold_{fast}",
                           _FOLD_PROFILE_CLASSES, start_at="preproc_")

    configure_precision("float32")  # true float32 products for the 1e-4 bound
    model = build_model("resnet18", compute_dtype=torch.float32)
    load_flax_variables(model, seeded_init_host("resnet18", 42))
    model = model.cuda().eval().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        x = preprocess_images(torch.from_numpy(images[:BATCH]).cuda(), RESIZE, CROP, torch.float32)
        plain = model(x)
        folded = folded_forward("resnet18", model, torch.float32)(x)
    rel32 = float((folded - plain).abs().max() / plain.abs().max())
    say("fold", arch="resnet18", dtype="bfloat16", images=N_IMAGES, batch=BATCH, cos_min=f"{cos.min():.6f}",
        cos_mean=f"{cos.mean():.6f}", max_abs_diff=diff, max_abs=float(np.abs(emb[False]).max()),
        plain_imgs_per_s=[f"{r:.1f}" for r in rates[False]], folded_imgs_per_s=[f"{r:.1f}" for r in rates[True]],
        folded_over_plain=f"{max(rates[True]) / max(rates[False]):.4f}", f32_folded_vs_plain_rel=rel32,
        launches={k: v for k, v in launches.items() if v})
    if cos.min() <= 0.995 or rel32 > 1e-4 or not np.isfinite(emb[True]).all():
        raise AssertionError(f"fold: cosine min {cos.min()}, float32 folded vs plain {rel32}")


DP_STEP_BATCH = 128  # (a): the step in process and through the CLI
DP_STEP_WARMUP, DP_STEP_TIMED = 2, 5
DP_GLOO_ROWS, DP_GLOO_STEPS = 64, 3  # (b): two ranks of 64 rows against one of 128
DP_SHARD_SIZE = 512  # (c)
DP_RESUME_EPOCHS = 2  # (d): cut after half


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_inputs(torch, np, b: int, steps: int):
    """(images, labels, valid, coeffs [steps, 3, b]) on the CPU, seeded."""
    from ssip_tpu_torch.ops.augment import augment_coeffs
    from ssip_tpu_torch.runtime.prng import augment_draws

    images, labels, valid = _step_inputs(torch, np, b)
    coeffs = torch.from_numpy(np.stack([augment_coeffs(*augment_draws(SEED, "smoke_dp", 0, s, b))
                                        for s in range(steps)]))
    return images, labels, valid, coeffs


def _dp_gloo_rank(index: int, world: int, init_file: str, out_file: str) -> None:
    """(b), one of two ranks sharing the card over gloo: ``DP_GLOO_STEPS``
    resnet18 float32 steps, each on this rank's 64 rows of a global batch
    of 128, through ``run_train_epoch``; rank 0 saves the step losses, the
    BatchNorm statistics and the parameters."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ssip_tpu_torch.parallel.mesh import training_mesh
    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.train.engine import DeviceDataset, run_train_epoch

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    torch.cuda.set_device(0)
    configure_precision("float32")
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=index, world_size=world)
    try:
        state = _seeded_state(torch, torch.device("cuda"), torch.float32, kink_free=True)
        state.mesh = training_mesh(device_type="cuda")
        losses, first = _dp_gloo_steps(torch, np, state, DeviceDataset, run_train_epoch)
        if index == 0:
            torch.save({"losses": losses, "first": first,
                        "state": {k: v.cpu() for k, v in state.model.state_dict().items()}}, out_file)
    finally:
        dist.destroy_process_group()


def _dp_gloo_steps(torch, np, state, dataset_cls, run_train_epoch):
    """``DP_GLOO_STEPS`` steps of the global batch of 128 (one rank's share
    under a group): (the step losses, the BatchNorm statistics after the
    first step)."""
    b = 2 * DP_GLOO_ROWS
    images, labels, valid, coeffs = _dp_inputs(torch, np, b, DP_GLOO_STEPS)
    dataset = dataset_cls.create(images.cuda(), labels.numpy())
    pidx = np.stack([np.arange(b)] * DP_GLOO_STEPS)
    valid = np.ones_like(pidx, bool)
    coeffs = coeffs.numpy()
    first_loss, _ = run_train_epoch(state, dataset, pidx[:1], valid[:1], coeffs[:1])
    first = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items() if "running" in k}
    losses, _ = run_train_epoch(state, dataset, pidx[1:], valid[1:], coeffs[1:])
    return np.concatenate([first_loss, losses]), first


def _dp_compare(torch, a: dict, b: dict) -> float:
    return max(_rel(a[k].float(), b[k].float()) for k in a if a[k].is_floating_point())


def _dp_two_ranks_on_one_card(torch, np, tmp: Path) -> None:
    """(b): two gloo ranks on the card against one process; the one place
    on the card where the BatchNorm sums and the gradients are all-reduced
    for real."""
    import torch.multiprocessing as mp

    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.train.engine import DeviceDataset, run_train_epoch

    out = tmp / "dp_gloo.pt"
    ctx = mp.start_processes(_dp_gloo_rank, args=(2, str(tmp / "dp_gloo_init"), str(out)), nprocs=2,
                             start_method="spawn", join=False)
    configure_precision("float32")
    state = _seeded_state(torch, torch.device("cuda"), torch.float32, kink_free=True)
    want_losses, want_first = _dp_gloo_steps(torch, np, state, DeviceDataset, run_train_epoch)
    want = {k: v.cpu() for k, v in state.model.state_dict().items() if v.is_floating_point()}
    while not ctx.join(timeout=300):
        pass
    got = torch.load(out, weights_only=False)
    loss_rel = float(np.max(np.abs(got["losses"] - want_losses) / np.abs(want_losses)))
    first_rel = _dp_compare(torch, got["first"], want_first)
    state_off = max(float(((got["state"][k] - v).abs() - (5e-4 + 5e-2 * v.abs())).max()) for k, v in want.items())
    say("dp", part="b", ranks=2, backend="gloo", rows_a_rank=DP_GLOO_ROWS, steps=DP_GLOO_STEPS, arch="resnet18",
        dtype="float32", losses=[f"{x:.6f}" for x in got["losses"]], one_process=[f"{x:.6f}" for x in want_losses],
        loss_rel=loss_rel, bn_stats_after_step_1_rel=first_rel,
        state_after_3_off=_dp_compare(torch, {k: got["state"][k] for k in want}, want), state_over_bound=state_off)
    # the JAX package's 1-vs-N bounds (tests/test_mesh_training.py, tests/test_torch_data_parallel.py): step losses
    # 1e-5 relative, the BatchNorm statistics of the first step 1e-4 of each tensor's max (one step: only the
    # summation order differs), parameters and statistics after the AdamW steps rtol 5e-2 atol 5e-4
    if loss_rel > 1e-5 or first_rel > 1e-4 or state_off > 0:
        raise AssertionError(f"dp (b): two ranks against one: losses {loss_rel}, BN after one step {first_rel}, "
                             f"state after {DP_GLOO_STEPS} over its bound by {state_off}")


def _dp_step_pair(torch, np, arch: str, mesh, counts: LaunchCounts) -> None:
    """(a) in process: one bf16 step at 128 with and without FSDP (world
    size 1, NCCL), and two plain steps for the card's run-to-run spread;
    then each timed, with its peak memory."""
    from ssip_tpu_torch.parallel.fsdp import contiguous_parameters, full_tensor, shard_model
    from ssip_tpu_torch.train.engine import TrainState, train_step

    steps = 1 + DP_STEP_WARMUP + DP_STEP_TIMED
    images, labels, valid, coeffs = (t.cuda() for t in _dp_inputs(torch, np, DP_STEP_BATCH, steps))
    # the same layout both ways: FSDP takes contiguous parameters only, so
    # the plain step's channels_last conv weights go back to NCHW too
    seeded = contiguous_parameters(_seeded_state(torch, torch.device("cuda"), torch.bfloat16, arch).model)

    def one(fsdp: bool):
        model = copy.deepcopy(seeded)
        state = TrainState.create(shard_model(model, mesh) if fsdp else model, 1e-4, 1e-4, mesh=mesh)
        loss, _ = train_step(state, images, labels, valid, coeffs[0])
        grads = {k: full_tensor(p.grad).detach().float().cpu() for k, p in state.model.named_parameters()}
        params = {k: full_tensor(v).detach().float().cpu() for k, v in state.model.state_dict().items()}
        return state, (loss.float().cpu(), grads, params)

    counts.reset()
    (_, again), (plain_state, plain), (fsdp_state, sharded) = one(False), one(False), one(True)
    launches = counts.read()
    del seeded

    def off(x, y):
        return {"loss": _rel(x[0], y[0]), "grads": max(_rel(x[1][k], y[1][k]) for k in y[1]),
                "params": max(_rel(x[2][k], y[2][k]) for k in y[2] if y[2][k].is_floating_point())}

    spread, got = off(again, plain), off(sharded, plain)
    bitwise = all(v == 0.0 for v in got.values())
    ok = bitwise or all(got[k] <= 2 * spread[k] for k in got)
    times = {}
    for fsdp, state in ((False, plain_state), (True, fsdp_state)):  # each steps on from its first step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for s in range(DP_STEP_WARMUP):
            train_step(state, images, labels, valid, coeffs[1 + s])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(DP_STEP_TIMED):
            train_step(state, images, labels, valid, coeffs[1 + DP_STEP_WARMUP + s])
        end.record()
        end.synchronize()
        times[fsdp] = (start.elapsed_time(end) / DP_STEP_TIMED, torch.cuda.max_memory_allocated() / 2**30)
    del plain_state, fsdp_state, state
    counts.read()
    torch.cuda.empty_cache()
    say("dp", part="a", arch=arch, dtype="bfloat16", batch=DP_STEP_BATCH, world=1, backend="nccl",
        fsdp_vs_plain=got, plain_run_to_run=spread, verdict="bitwise" if bitwise else "within 2x run-to-run spread",
        ms_per_step=f"{times[True][0]:.3f}", plain_ms_per_step=f"{times[False][0]:.3f}",
        peak_mem_gib=f"{times[True][1]:.2f}", plain_peak_mem_gib=f"{times[False][1]:.2f}",
        launches={k: v for k, v in launches.items() if v})
    if not ok:
        raise AssertionError(f"dp (a) {arch}: FSDP against plain {got}, the card's spread {spread}")


DP_CLI_ARCHS = ("vit_b16", "resnet18")


def _dp_cli_argv(train_tree: str, out_root: str, arch: str) -> list:
    return ["--strong-data-dir", train_tree, "--device", "cuda", "--arch", arch, "--compute-dtype", "bfloat16",
            "--batch-size", str(DP_STEP_BATCH), "--baseline-epochs", "1", "--fsdp",
            "--output-dir", str(Path(out_root) / f"dp_cli_{arch}")]


def dp_cli_worker(train_tree: str, out_root: str) -> int:
    """``chip_smoke.py --dp-cli TREE OUT`` under torchrun: the supervised
    CLI's ``main`` for each of ``DP_CLI_ARCHS`` in this one rank (each
    joins the launcher's group and leaves it)."""
    from ssip_tpu_torch.cli import supervised_training

    for arch in DP_CLI_ARCHS:
        supervised_training.main(_dp_cli_argv(train_tree, out_root, arch))
    return 0


def _dp_cli_start(train_tree: Path, tmp: Path) -> tuple:
    """(a) through the supervised CLI under torchrun (one launch, one
    process on the card), ``--fsdp``, bf16, batch 128, one epoch, for each
    of ``DP_CLI_ARCHS``: the launch, started; ``_dp_cli_check`` waits for
    it. (start time, process)"""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         str(Path(__file__).resolve()), "--dp-cli", str(train_tree), str(tmp)],
        cwd=Path(__file__).resolve().parent,
    )


def _dp_cli_check(np, started: tuple, tmp: Path) -> None:
    """(a)'s CLI launch, awaited: the gathered ``.pt`` loads into a plain
    model."""
    import torch

    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.train.checkpoints import load_checkpoint

    t0, proc = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise subprocess.CalledProcessError(rc, proc.args)
    seconds = time.perf_counter() - t0
    for arch in DP_CLI_ARCHS:
        out = tmp / f"dp_cli_{arch}"
        payload = json.loads((out / "notes" / "training_history.json").read_text())
        model = build_model(arch, num_classes=2)
        load_checkpoint(out / "models" / "baseline_resnet18.pt", model)
        if payload["arch"] != arch or not np.isfinite(payload["baseline"]["val_loss"]).all():
            raise AssertionError(f"dp (a) cli {arch}: {payload['baseline']}")
        say("dp", part="a", cli="torchrun supervised_training --fsdp", arch=arch, nproc=1, epochs=1,
            val_loss=f"{payload['baseline']['val_loss'][0]:.4f}",
            checkpoint_params=sum(p.numel() for p in model.parameters()), launch_seconds=f"{seconds:.2f}",
            beside="(d), (b), [tp]")


def _dp_shards(torch, np, tmp: Path, counts: LaunchCounts) -> None:
    """(c): ``--shard-size 512`` through the extraction CLI on the
    workflow's 1,506 images, then again with the last manifest gone: two
    shards reused, one recomputed; the embeddings against the single-shot
    run's (batches of 128 in both: bit for bit expected)."""
    from ssip_tpu_torch.cli import feature_extraction
    from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction

    data = tmp / "workflow_data"
    out, single = tmp / "dp_shards", tmp / "dp_single"
    argv = ["--data-dir", str(data), "--device", "cuda", "--batch-size", str(BATCH), "--output-dir", str(out),
            "--shard-size", str(DP_SHARD_SIZE)]
    counts.reset()
    t0 = time.perf_counter()
    feature_extraction.main(argv)
    first_s = time.perf_counter() - t0
    shards = out / "features" / "shards"
    manifests = sorted(shards.glob("*.manifest.json"))
    manifests[-1].unlink()
    t0 = time.perf_counter()
    feature_extraction.main(argv)
    again_s = time.perf_counter() - t0
    launches = counts.read()
    log = (out / "logs" / "feature_extraction.log").read_text().split("Extraction over")[-1]
    reused, recomputed = log.count("reusing completed shard"), log.count(": extracting ")
    ref = run_extraction(ExtractionConfig(data_dir=data, output_dir=single, device="cuda", batch_size=BATCH)).embeddings
    emb = np.load(out / "features" / "embeddings.npy")
    meta = json.loads((out / "features" / "metadata.json").read_text())
    largest = float(np.abs(emb - ref).max()) if emb.shape == ref.shape else float("inf")
    say("dp", part="c", images=int(emb.shape[0]), shard_size=DP_SHARD_SIZE, shards=len(manifests), reused=reused,
        recomputed=recomputed, weights=meta["weights"], bitwise=bool(np.array_equal(emb, ref)), largest_diff=largest,
        first_s=f"{first_s:.2f}", resumed_s=f"{again_s:.2f}", launches={k: v for k, v in launches.items() if v})
    if (len(manifests) != 3 or reused != 2 or recomputed != 1 or meta["weights"] != "sharded"
            or emb.shape != ref.shape or largest > 1e-4 * float(np.abs(ref).max())):
        raise AssertionError(f"dp (c): {len(manifests)} shards, {reused} reused, {recomputed} recomputed, "
                             f"embeddings {emb.shape} off by {largest}")


def _dp_orbax(torch, np, tmp: Path, data: Path, counts: LaunchCounts) -> None:
    """(d): ``SSIP_SNAPSHOT_FORMAT=orbax``: resnet18 float32
    ``run_supervised`` cut after 2 of 4 epochs and resumed, the restore bit
    for bit the snapshot directory. ``[resume]``'s runs differ from run to
    run on the card (cuDNN picks kernels that sum with atomics), so a
    resumed run there is held to twice their spread; here cuDNN's
    deterministic mode is on, which makes the run reproducible, and the
    resumed run must equal an uninterrupted one bit for bit (history and
    final checkpoint). A resume from the file form at the same point of the
    process must equal it too: whatever gap a resume shows in
    ``[resume]`` is the card's spread, not the snapshot's form."""
    from ssip_tpu_torch.pipelines.supervised import TrainingConfig, run_supervised
    from ssip_tpu_torch.train import engine

    def supervised(name, epochs, form=None):  # form: None (no snapshot), "file" or "orbax"
        cfg = TrainingConfig(strong_data_dir=data, output_dir=tmp / f"dp_{name}", device="cuda",
                             batch_size=TRAIN_BATCH, image_size=TRAIN_SIZE, baseline_epochs=epochs,
                             compute_dtype="float32", resume=form is not None)
        if form == "orbax":
            os.environ["SSIP_SNAPSHOT_FORMAT"] = form
        try:
            run_supervised(cfg)
        finally:
            os.environ.pop("SSIP_SNAPSHOT_FORMAT", None)
        hist = json.loads(cfg.artifacts.training_history_json.read_text())["baseline"]
        return hist, torch.load(cfg.artifacts.baseline_checkpoint, map_location="cpu", weights_only=True), cfg

    def resumed(name, form, seen):
        *_, cfg = supervised(name, DP_RESUME_EPOCHS // 2, form)
        real = _restore_spy(torch, engine, seen)
        try:
            return supervised(name, DP_RESUME_EPOCHS, form)[:2], cfg.resume_path("baseline")
        finally:
            engine.restore_resume_state = real

    def gap(a, b):
        return {"history": max(_max_diff(np, a[0][k], b[0][k]) for k in ("train_loss", "val_loss")),
                "weights": _state_diff(torch, a[1], b[1])}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    seen: dict = {}
    seen_file: dict = {}
    try:
        counts.reset()
        dcp, snap = resumed("orbax", "orbax", seen)
        launches = counts.read()
        straight = supervised("straight", DP_RESUME_EPOCHS)[:2]
        from_file, _ = resumed("file", "file", seen_file)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    to_straight, file_to_straight = gap(dcp, straight), gap(from_file, straight)
    files = sorted(p.name for p in snap.iterdir())
    say("dp", part="d", format="orbax (torch.distributed.checkpoint)", cudnn_deterministic=True,
        snapshot_is_dir=snap.is_dir(), files=files, restored_bitwise=seen.get("restored_bitwise"),
        resumed_vs_uninterrupted=to_straight, file_form_restored_bitwise=seen_file.get("restored_bitwise"),
        file_form_resumed_vs_uninterrupted=file_to_straight, launches={k: v for k, v in launches.items() if v})
    if (not snap.is_dir() or not seen.get("restored_bitwise") or not seen_file.get("restored_bitwise")
            or len(dcp[0]["val_loss"]) != DP_RESUME_EPOCHS or any(to_straight.values())
            or any(file_to_straight.values())):
        raise AssertionError(f"dp (d): restored {seen} (file form {seen_file}), resumed against uninterrupted "
                             f"{to_straight} (file form {file_to_straight}): bit for bit expected")


def phase_dp(torch, np, tmp: Path, train_tree: Path, counts: LaunchCounts) -> None:
    """Data parallelism on the card: (c) ``--shard-size``, (d) the sharded
    snapshots, (b) two gloo ranks sharing the card, (a) the FSDP step at
    world size 1 over NCCL, in process and through the CLI under torchrun
    (a process of its own, run beside (d) and (b)); and ``phase_tp``, whose
    ranks run beside (d) and (b) too."""
    import torch.distributed as dist

    from ssip_tpu_torch.parallel.mesh import training_mesh

    laps = {}

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        laps[part] = round(laps.get(part, 0.0) + time.perf_counter() - t0, 1)

    timed("c", _dp_shards, torch, np, tmp, counts)
    # the torchrun CLI and [tp]'s two ranks, processes of their own, beside (d), (b) and [tp]'s references,
    # which time nothing; (c) and (a) run with nothing beside them
    cli = _dp_cli_start(train_tree, tmp)
    try:
        tp = _tp_start(torch, tmp)
        try:
            timed("d", _dp_orbax, torch, np, tmp, train_tree, counts)
            timed("b", _dp_two_ranks_on_one_card, torch, np, tmp)
        finally:
            timed("tp", phase_tp, torch, np, tmp, counts, tp)
    finally:
        timed("a_cli", _dp_cli_check, np, cli, tmp)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = training_mesh(device_type="cuda")
        for arch in (VIT_ARCH, "resnet18"):
            timed("a_step", _dp_step_pair, torch, np, arch, mesh, counts)
    finally:
        dist.destroy_process_group()
    say("dp", seconds=laps)


# [tp]: the model axis, two gloo ranks sharing the card (data 1 × model 2)
TP_PATHS = {  # path → (arch, image size, batch)
    "resnet-tp": ("resnet18", 224, 32),
    "vit-tp": (VIT_ARCH, 224, 16),
    "vit-ep": (MOE_ARCH, 224, 16),  # 4 of 8 experts a rank
    "vit-pp": (VIT_ARCH, 224, 16),  # 2 stages of 6 blocks
    "vit-sp": (VIT_ARCH, 512, 4),  # 1,025 tokens, 513 a rank
}
TP_MICROBATCHES = 4
TP_TIMED_STEPS = 1  # after the checked step, timed (gloo through host memory: not a speed figure)
TP_LR = 1e-3  # the multichip dryrun's SGD step
TP_BF16_IMAGES = 16
TP_BF16_PATHS = ("vit-tp", "vit-ep")


def _tp_model(torch, path: str, mesh, dtype=None, num_classes=2):
    """The path's model on the card at the seeded weights: sliced over the
    mesh's model axis (TP, EP), pipelined (PP) or token-split (SP), or
    whole without a mesh."""
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.registry import build_model
    from ssip_tpu_torch.parallel import tensor
    from ssip_tpu_torch.parallel.pipeline import make_pp_apply_fn
    from ssip_tpu_torch.parallel.sequence import make_sp_apply_fn

    arch, size, _ = TP_PATHS[path]
    model = build_model(arch, num_classes=num_classes, compute_dtype=dtype or torch.float32, image_size=size)
    load_flax_variables(model, seeded_init_host(arch, 42, num_classes=num_classes, image_size=size))
    if arch.startswith("resnet"):  # a step compared by its gradients: off the ReLU kinks, as in [dp] (b)
        _kink_free(torch, model)
    model = model.cuda()
    if mesh is None:
        return model.to(memory_format=torch.channels_last) if arch.startswith("resnet") else model
    if path == "vit-pp":
        return make_pp_apply_fn(model, mesh, TP_MICROBATCHES)
    if path == "vit-sp":
        return make_sp_apply_fn(model, mesh)
    return tensor.shard_model(model, mesh)


def _tp_inputs(torch, np, path: str):
    """(images uint8, labels, valid, coeffs [1 + timed, 3, b]) on the CPU, seeded."""
    from ssip_tpu_torch.ops.augment import augment_coeffs
    from ssip_tpu_torch.runtime.prng import augment_draws

    _, size, b = TP_PATHS[path]
    rng = np.random.default_rng(SEED + 18 + b + size)
    images = torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, b).astype(np.int64))
    coeffs = torch.from_numpy(np.stack([augment_coeffs(*augment_draws(SEED, "smoke_tp", 0, s, b))
                                        for s in range(1 + TP_TIMED_STEPS)]))
    return images, labels, torch.ones(b, dtype=torch.bool), coeffs


def _tp_step(torch, np, path: str, mesh) -> dict:
    """The path's checked float32 SGD step through ``run_train_epoch``
    (the train augment kernel, the forward, the loss, the backward and the
    step), then ``TP_TIMED_STEPS`` more, timed: loss, the whole state after
    the checked step on the CPU, the router choices of an MoE, ms a step."""
    from ssip_tpu_torch.parallel.tensor import whole_state_dict
    from ssip_tpu_torch.train.engine import DeviceDataset, TrainState, run_train_epoch

    model = _tp_model(torch, path, mesh)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=TP_LR), mesh=mesh)
    images, labels, valid, coeffs = _tp_inputs(torch, np, path)
    dataset = DeviceDataset.create(images.cuda(), labels.numpy())
    b = len(labels)
    pidx, valid = np.arange(b)[None], valid.numpy()[None]
    choices, handles = _router_choices(torch, model)
    try:
        loss, _ = run_train_epoch(state, dataset, pidx, valid, coeffs[:1].numpy())
    finally:
        for h in handles:
            h.remove()
    after = {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in whole_state_dict(model).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_train_epoch(state, dataset, np.repeat(pidx, TP_TIMED_STEPS, 0), np.repeat(valid, TP_TIMED_STEPS, 0),
                    coeffs[1:].numpy())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TP_TIMED_STEPS
    del state, model
    torch.cuda.empty_cache()
    return {"loss": float(loss[0]), "state": after, "choices": [c.numpy() for c in choices], "ms": ms}


def _tp_features(torch, np, path: str, mesh):
    """The path's bfloat16 extractor (features, no head) on
    ``TP_BF16_IMAGES`` seeded images, eval mode, on the CPU as float32."""
    from ssip_tpu_torch.ops.augment import eval_preprocess

    model = _tp_model(torch, path, mesh, torch.bfloat16, num_classes=None).eval()
    images = _tp_inputs(torch, np, path)[0][:TP_BF16_IMAGES]
    with torch.inference_mode():
        out = model(eval_preprocess(images.cuda(), torch.bfloat16)).float().cpu()
    del model
    return out


def _tp_rank(index: int, world: int, init_file: str, out_dir: str) -> None:
    """One of two gloo ranks sharing the card at data 1 × model 2: every
    path's checked step and timed steps, and the bf16 forwards; each
    path's launches counted on this rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ssip_tpu_torch.parallel.mesh import training_mesh
    from ssip_tpu_torch.runtime.device import configure_precision

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    torch.cuda.set_device(0)
    configure_precision("float32")
    torch.backends.cudnn.deterministic = True  # replicated leaves computed alike on both ranks
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=index, world_size=world)
    try:
        mesh = training_mesh(1, 2, device_type="cuda")
        counts = LaunchCounts()
        out = {"steps": {}, "launches": {}, "features": {}}
        for path in TP_PATHS:
            counts.reset()
            out["steps"][path] = _tp_step(torch, np, path, mesh)
            out["launches"][path] = counts.read()
        for path in TP_BF16_PATHS:
            counts.reset()
            out["features"][path] = _tp_features(torch, np, path, mesh)
            out["launches"][path + "-bf16"] = counts.read()
        torch.save(out, Path(out_dir) / f"tp_rank{index}.pt")
    finally:
        dist.destroy_process_group()


def _rel_norm(torch, a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()).clamp_min(1e-12))


def _tp_start(torch, tmp: Path) -> tuple:
    """``phase_tp``'s two ranks, started: (start time, their context)."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    return time.perf_counter(), mp.start_processes(_tp_rank, args=(2, str(tmp / "tp_init"), str(tmp)), nprocs=2,
                                                   start_method="spawn", join=False)


def phase_tp(torch, np, tmp: Path, counts: LaunchCounts, started: tuple) -> None:
    """The model axis on the card: two gloo ranks sharing it (data 1 ×
    model 2) run each path's float32 SGD step at full width, held to the
    same step in one process at the multichip dryrun's bound (loss 1e-4
    relative, every parameter and statistic within 1e-3 relative norm):
    resnet18 (tensor parallel, 224², batch 32, kink-free seeded weights:
    at the seeded init a BatchNorm bias's gradient moves by 0.2 % with the
    convolutions' summation order), vit_b16 (tensor parallel,
    6 heads a rank, batch 16), vit_moe_s16 (4 of 8 experts a rank, batch
    16; its router choices equal to one process's), vit_b16 in 2 GPipe
    stages of 6 blocks (4 microbatches of 4) and vit_b16 at 512² with its
    1,025 tokens split 513 a rank (ring attention). Then the bf16
    extractors of vit-tp and vit-ep against one process at the bf16
    cosine gates. ms a step beside one process's: gloo through host
    memory, not a speed figure. ``started``: ``_tp_start``'s ranks, which
    ran beside ``phase_dp``'s untimed parts."""
    from ssip_tpu_torch.runtime.device import configure_precision

    t0, ctx = started
    configure_precision("float32")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:  # the one-process references while the ranks run: no figure of this phase is a speed
        wants = {path: _tp_step(torch, np, path, None) for path in TP_PATHS}
        want_features = {path: _tp_features(torch, np, path, None) for path in TP_BF16_PATHS}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        while not ctx.join(timeout=600):
            pass
    ranks = [torch.load(tmp / f"tp_rank{i}.pt", weights_only=False) for i in range(2)]
    ranks_s = time.perf_counter() - t0
    for rank in ranks:  # the main path's launches: both ranks'
        for launches in rank["launches"].values():
            for name, n in launches.items():
                counts.total[name] += n
    failures = []
    for path, (arch, size, b) in TP_PATHS.items():
        want = wants[path]
        got = [rank["steps"][path] for rank in ranks]
        loss_rel = max(abs(g["loss"] - want["loss"]) / abs(want["loss"]) for g in got)
        worst = max(((_rel_norm(torch, g["state"][k], v), k) for g in got for k, v in want["state"].items()
                     if v.is_floating_point()), default=(0.0, ""))
        ranks_equal = all(torch.equal(got[0]["state"][k], got[1]["state"][k]) for k in want["state"])
        flips = sum(int((a != c).sum()) for g in got for a, c in zip(g["choices"], want["choices"]))
        launches = [rank["launches"][path] for rank in ranks]
        say("tp", path=path, arch=arch, image=size, batch=b, ranks=2, backend="gloo", dtype="float32",
            loss=f"{got[0]['loss']:.6f}", one_process=f"{want['loss']:.6f}", loss_rel=loss_rel,
            worst_param_rel_norm=worst[0], at=worst[1], ranks_bitwise_equal=ranks_equal,
            router_choices=sum(c.size for c in want["choices"]), router_flips=flips,
            launches_per_rank=[{k: v for k, v in n.items() if v} for n in launches],
            ms_per_step=f"{got[0]['ms']:.1f}", one_process_ms=f"{want['ms']:.1f}",
            timing="gloo through host memory, not a speed figure")
        steps = 1 + TP_TIMED_STEPS
        expected = {"resnet-tp": {"augment_images": steps},
                    "vit-tp": {"attention_qkv": VIT_BLOCKS * steps, "attention_qkv_bwd": VIT_BLOCKS * steps},
                    "vit-ep": {"attention_qkv": VIT_BLOCKS * steps, "attention_qkv_bwd": VIT_BLOCKS * steps},
                    "vit-pp": {"attention_qkv": VIT_BLOCKS // 2 * TP_MICROBATCHES * steps,
                               "layer_norm": (VIT_BLOCKS * TP_MICROBATCHES + 1) * steps},
                    "vit-sp": {"layer_norm": VIT_LN_PER_FORWARD * steps, "attention_qkv": 0}}[path]
        if (loss_rel > 1e-4 or worst[0] > 1e-3 or flips
                or any({k: n[k] for k in expected} != expected for n in launches)):
            failures.append(f"{path}: loss {loss_rel}, param {worst}, router flips {flips}, launches {launches} "
                            f"(want {expected} a rank)")
    for path in TP_BF16_PATHS:
        want = want_features[path]
        floor, mean_floor = (MOE_COSINE_FLOOR, MOE_COSINE_MEAN_FLOOR) if path == "vit-ep" else (0.995, 0.995)
        for i, rank in enumerate(ranks):
            got = rank["features"][path]
            cos = (_unit(np, got.numpy()) * _unit(np, want.numpy())).sum(axis=1)
            say("tp", path=path, check="bf16 features vs one process", rank=i, images=TP_BF16_IMAGES,
                cos_min=f"{cos.min():.6f}", cos_mean=f"{cos.mean():.6f}", floor=floor, mean_floor=mean_floor,
                launches={k: v for k, v in rank["launches"][path + "-bf16"].items() if v})
            if not (cos.min() > floor and cos.mean() > mean_floor and np.isfinite(got.numpy()).all()):
                failures.append(f"{path} bf16 rank {i}: cosine min {cos.min()}, mean {cos.mean()}")
    say("tp", ranks_seconds=f"{ranks_s:.1f}", seconds=f"{time.perf_counter() - t0:.1f}")
    if failures:
        raise AssertionError("tp: " + "; ".join(failures))


def phase_imports() -> None:
    """The run loaded nothing of jax and nothing of the JAX package: the
    port keeps its own copies of the jax-free modules it needs."""
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ssip_tpu"))
    if foreign:
        raise AssertionError(f"the port loaded {foreign[:8]}")
    say("imports", jax=0, ssip_tpu_modules=0)


def main() -> int:
    if sys.argv[1:2] == ["--dp-cli"]:  # [dp]'s torchrun worker
        return dp_cli_worker(*sys.argv[2:4])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    t0 = time.perf_counter()
    laps: dict = {}

    def lap(name: str, fn, *args, **kwargs):
        """Run one phase and keep its seconds for the ``[seconds]`` line."""
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        laps[name] = round(laps.get(name, 0.0) + time.perf_counter() - start, 1)
        return result

    moe_launches: dict = {}

    def moe_lap(part: str, fn, *args, **kwargs):
        """``lap`` under ``moe``, summing the launches the part adds."""
        before = dict(counts.total)
        result = lap("moe", fn, *args, **kwargs)
        for name, n in counts.total.items():
            moe_launches[name] = moe_launches.get(name, 0) + n - before[name]
        say("moe", part=part, seconds_so_far=laps["moe"])
        return result

    lap("env", phase_env, torch)
    host = phase_host_packages()
    counts = LaunchCounts()
    # The kernels build (one nvcc a source, all started together; a minute and a half, most of it one
    # source) while the analysis stack, which launches no hand kernel, runs on the card; its CPU
    # references keep every core (on half of them they took longer still beside the compilers).
    from ssip_tpu_torch.kernels.build import build

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build)
        lap("analysis", phase_analysis, torch, np, counts, building)
        lap("analysis_scale", phase_analysis_scale, torch, np, building)
        lap("build", phase_build, building.result())
    measured = {**lap("kernel", phase_kernel, torch, np),
                "augment_images": lap("rotate", phase_rotate_kernel, torch, np),
                **lap("ln", phase_layer_norm_kernels, torch, np), **lap("attn", phase_attention_kernels, torch, np),
                **lap("qmlp", phase_qmlp_kernel, torch, np), **lap("attn4", phase_unpacked_attention_kernels, torch, np),
                "rotate_images": lap("rotate_u8", phase_rotate_u8_kernel, torch, np)}
    lap("entry", phase_attention_entry, torch, np, counts)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        corpus = make_corpus(np, tmp)
        resnet = lap("slice", phase_slice, torch, np, tmp, corpus, counts, "resnet18", 512, N_CPU_CHECK)
        dense = lap("slice", phase_slice, torch, np, tmp, corpus, counts, VIT_ARCH, VIT_WIDTH, VIT_N_CPU_CHECK)
        lap("int8", phase_slice_int8, torch, np, tmp, corpus, counts, dense)
        lap("int8_resnet", phase_int8_resnet, torch, np, tmp, corpus, counts, resnet)
        lap("fold", phase_fold, torch, np, tmp, corpus, counts)
        moe_lap("slice", phase_slice, torch, np, tmp, corpus, counts, MOE_ARCH, MOE_WIDTH, VIT_N_CPU_CHECK)
        del corpus, dense, resnet
        lap("cli", phase_cli, np, tmp)
        train_tree = make_train_tree(np, tmp)
        # the training CLIs run in [workflow] (in process) and under
        # torchrun in [dp], not as subprocesses here
        lap("train", phase_train, torch, np, tmp, train_tree, counts, "resnet18",
            (("float32", TRAIN_EPOCHS), ("bfloat16", TRAIN_EPOCHS)))
        lap("train", phase_train, torch, np, tmp, train_tree, counts, VIT_ARCH,
            (("bfloat16", TRAIN_EPOCHS), ("float32", 1)))
        # the narrow ViT (width 192, 3 heads), whose CLIs no longer run here
        lap("train", phase_train, torch, np, tmp, train_tree, counts, "vit_t16", (("bfloat16", 1),))
        # vit_b16 past 224²: 257 and 1,025 tokens, where the attention kernels
        # once refused sequences the reference trains
        lap("vit_long", phase_train, torch, np, tmp, train_tree, counts, VIT_ARCH, VIT_LONG_RUNS, tag="vit_long")
        pool = make_unlabeled_pool(np, train_tree)
        lap("semi", phase_semi, torch, np, tmp, train_tree, pool, counts, "resnet18", ("float32", "bfloat16"))
        lap("semi", phase_semi, torch, np, tmp, train_tree, pool, counts, VIT_ARCH, ("bfloat16",))
        moe_lap("train", phase_train, torch, np, tmp, train_tree, counts, MOE_ARCH, (("bfloat16", TRAIN_EPOCHS),),
                tag="moe")
        moe_lap("semi", phase_semi, torch, np, tmp, train_tree, pool, counts, MOE_ARCH, ("bfloat16",))
        moe_lap("serve", phase_moe_serve, torch, np, tmp, pool)
        lap("resume", phase_resume, torch, np, tmp, train_tree, pool)
        lap("seeds", phase_seeds, torch, np, tmp, train_tree, counts)
        lap("cv", phase_cv, torch, np, tmp, train_tree, counts)
        lap("randaug", phase_randaug, torch, np, tmp, train_tree, pool, counts)
        lap("serve", phase_serve, torch, np, tmp, pool, counts)
        lap("sweep", phase_sweep, torch, np, tmp, train_tree, counts)
        lap("workflow", phase_workflow, torch, np, tmp, counts, host)
        lap("stream", phase_stream, torch, np, tmp, counts, host)
        lap("dp", phase_dp, torch, np, tmp, train_tree, counts)  # [tp] inside it
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lap("step", phase_step, torch, np, counts)
    lap("vit_step", phase_vit_step, torch, np, counts)
    lap("fixmatch_step", phase_fixmatch_step, torch, np, counts)
    moe_lap("step", phase_moe_step, torch, np, counts)
    # the MoE window ran rows 5, 6, 9 and 10 (the LayerNorm and packed
    # attention pairs) at width 384
    moe_need = ("layer_norm", "layer_norm_bwd", "attention_qkv", "attention_qkv_bwd")
    say("moe", window_launches={k: v for k, v in moe_launches.items() if v})
    if not all(moe_launches[k] > 0 for k in moe_need):
        raise AssertionError(f"the MoE window launched {moe_launches}, needs {moe_need}")
    phase_imports()
    never = [name for name, n in counts.total.items() if n == 0]
    if never:
        raise AssertionError(f"the main paths never launched {never}")
    say("seconds", **laps)
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
