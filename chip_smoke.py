#!/usr/bin/env python3
"""Drive the PyTorch port's extraction and training slices once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one output line each; any failure raises and the script exits
non-zero without printing the final line:

1. env     the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build   nvcc builds ``ssip_tpu_torch/csrc/*.cu`` for sm_90a, one process
           per source (seconds);
3. kernel  ``preprocess_images`` (CUDA) against its plain PyTorch version on
           the card: bitwise in float32 and bfloat16 at [128, 512, 512, 3]
           → 256 → 224, one uint8 step at 384² and 320×448; median times of
           kernel and plain from CUDA events;
   rotate  ``augment_images`` (CUDA: flip → rotate → normalize) against the
           plain ``train_augment`` on the card, bitwise in float32 and
           bfloat16 at [128, 224, 224, 3], [16, 224, 160, 3] and
           [8, 64, 96, 3], with drawn angles in ±10° and angles pinned at
           ±10° and ±25°; median times of kernel and plain;
4. slice   a seeded 1024-image uint8 512² corpus in an in-memory
           ``ImageStore`` through ``run_extraction`` on cuda (resident shape,
           batch 128, seeded-init ResNet-18) in bfloat16 and float32, each
           run twice (the second one timed): embeddings [1024, 512] finite,
           the kernel launched, every artifact written, bf16 vs f32 cosine
           > 0.995 per image, cuda f32 vs CPU f32 on 16 images ≤ 1e-4
           relative (TF32 off); then the per-batch shape (pinned,
           double-buffered feed) on 263 images with one decode failure,
           ≤ 1e-4 relative to the resident f32 run;
5. cli     the extraction CLI on a small 512² JPEG tree (needs Pillow);
6. train   a seeded 100-image 512² JPEG tree ``avec_labels/{cancer,normal}``
           (50 + 50) through ``run_supervised`` on cuda: full-width
           ResNet-18, 224², 2 classes, batch 16, 2 epochs, target recall
           0.9, in float32 (TF32 off) and bfloat16. Every artifact is
           written, the history holds 2 epochs of finite losses, the ``.pt``
           loads into the port's model, the split indices are those of the
           CPU split, and the rotate kernel launched; then the training CLI
           once, for 1 epoch, as a subprocess;
7. step    one train step on cuda against the same step on the CPU
           (float32, TF32 off, batch 8 with one padded row, 224², same
           weights, batch and draws): loss ≤ 1e-5 relative and BN running
           statistics ≤ 1e-5 relative at the seeded weights; every gradient
           ≤ 1e-3 relative to its tensor's max |g| (the stem conv's ≤ 1e-2
           in L2) at kink-free weights, see ``KINK_FREE_BN_BIAS``; then
           the steady-state step at batch 128 in bfloat16 and float32 (3
           warm-up steps, 10 timed with CUDA events): imgs/s, ms per step,
           the rotate kernel's share, peak device memory; then 10 more
           steps under ``torch.profiler``: device time by layer, the top
           kernels and the idle share;
8. imports no jax module and no JAX-package module but the shared ones;
9. the kernels JSON line, then ``{"ok": true, "device": {...}}`` last.

Needs no network and no data: everything is made from seeds. It builds the
kernels from the checkout, so a fresh clone is enough. It imports only
``ssip_tpu_torch``, torch and numpy, and fails if the run loaded jax, flax,
optax or any JAX-package module beyond the jax-free ones the port shares
(``ssip_tpu.data.discovery``, ``ssip_tpu.runtime.artifacts``,
``ssip_tpu.runtime.logging``, ``ssip_tpu.pipelines.train_config`` and
``ssip_tpu.ops.thresholds``).
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
}
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
# What the port may load of the JAX package: the jax-free modules it shares.
SHARED_JAX_FREE = {
    "ssip_tpu", "ssip_tpu.data", "ssip_tpu.data.discovery",
    "ssip_tpu.runtime", "ssip_tpu.runtime.artifacts", "ssip_tpu.runtime.logging",
    "ssip_tpu.pipelines", "ssip_tpu.pipelines.train_config",
    "ssip_tpu.ops", "ssip_tpu.ops.thresholds",
}


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
    from ssip_tpu_torch.ops.preproc import preprocess_images
    from ssip_tpu_torch.ops.resize import IMAGENET_STD, extraction_preprocess
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

        # plain, kernel, kernel, plain: drift on the card hits both alike
        times = {"plain": [], "kernel": []}
        for name, make in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
            times[name].append(median_ms(torch, make(torch.bfloat16)))
        k_ms, p_ms = min(times["kernel"]), min(times["plain"])
        k32_ms = median_ms(torch, kernel(torch.float32))
        p32_ms = median_ms(torch, plain(torch.float32))
        tol = "bitwise" if exact else f"<= {one_step:.6g}"
        say("kernel", shape="x".join(map(str, shape)), tol=tol, max_abs_err_f32=err32,
            max_abs_err_bf16=err16, bf16_ms=f"{k_ms:.4f}", plain_bf16_ms=f"{p_ms:.4f}",
            f32_ms=f"{k32_ms:.4f}", plain_f32_ms=f"{p32_ms:.4f}")
        if exact:
            result = {"max_abs_err": max(err32, err16), "ms": k_ms, "plain_ms": p_ms}
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

        times = {"plain": [], "kernel": []}
        for name, make in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
            times[name].append(median_ms(torch, make(torch.bfloat16)))
        k_ms, p_ms = min(times["kernel"]), min(times["plain"])
        k32_ms = median_ms(torch, kernel(torch.float32))
        p32_ms = median_ms(torch, plain(torch.float32))
        say("rotate", shape="x".join(map(str, shape)), tol="bitwise", flips=int(flip.sum()),
            max_abs_err_f32=err32, max_abs_err_bf16=err16, bf16_ms=f"{k_ms:.4f}",
            plain_bf16_ms=f"{p_ms:.4f}", f32_ms=f"{k32_ms:.4f}", plain_f32_ms=f"{p32_ms:.4f}")
        if shape == AUG_SHAPES[0]:
            result = {"max_abs_err": max(err32, err16), "ms": k_ms, "plain_ms": p_ms}
        del x, k32, k16, p32
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


def phase_slice(torch, np, tmp: Path) -> int:
    from ssip_tpu_torch.data.pipeline import ImageStore
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.resnet import build_resnet
    from ssip_tpu_torch.ops.preproc import preprocess_images
    from ssip_tpu_torch.pipelines.extraction import (
        ArtifactRegistry, ExtractionConfig, discover_image_records, extract_embeddings, run_extraction,
    )

    data = tmp / "corpus"
    _synthetic_tree(data, N_IMAGES)
    records = discover_image_records(data)
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (N_IMAGES, SIZE, SIZE, 3), dtype=np.uint8
    )
    store = ImageStore.from_array(images, [r.absolute_path for r in records])

    preprocess_images.launches = 0  # count only the main path's launches
    embeddings = {}
    for dtype in ("bfloat16", "float32"):
        out = tmp / f"out_{dtype}"
        cfg = ExtractionConfig(
            data_dir=data, output_dir=out, batch_size=BATCH, device="cuda",
            compute_dtype=dtype, cache_decoded=False,
        )
        run_extraction(cfg, store=store)  # warm: cuDNN and allocator set-up
        torch.cuda.reset_peak_memory_stats()
        summary = run_extraction(cfg, store=store)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        emb = summary.embeddings
        if emb.shape != (N_IMAGES, 512) or not np.isfinite(emb).all():
            raise AssertionError(f"{dtype}: embeddings {emb.shape}, finite={np.isfinite(emb).all()}")
        reg = ArtifactRegistry(out)
        for path in (reg.embeddings_npy, reg.embeddings_csv, reg.features_metadata_json,
                     reg.feature_summary_md, reg.extraction_log):
            if not path.is_file():
                raise AssertionError(f"{dtype}: missing artifact {path}")
        meta = json.loads(reg.features_metadata_json.read_text())
        if meta["num_images"] != N_IMAGES or meta["weights"] != "random_init:seed=42":
            raise AssertionError(f"{dtype}: metadata {meta['num_images']} {meta['weights']}")
        embeddings[dtype] = emb
        say("slice", dtype=dtype, images=N_IMAGES, batch=BATCH, embed_s=f"{summary.embed_seconds:.4f}",
            imgs_per_s=f"{N_IMAGES / summary.embed_seconds:.1f}", e2e_s=f"{summary.total_seconds:.3f}",
            peak_mem_gib=f"{peak_gib:.2f}")

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
                           device="cuda", compute_dtype="float32", cache_decoded=False)
    batched = extract_embeddings(records[:n_sub], cfg, store=sub_store)
    want = np.delete(embeddings["float32"][:n_sub], failed, axis=0)
    rel_batched = float(np.abs(batched.embeddings - want).max() / np.abs(want).max())
    if batched.failures != [sub_paths[failed]] or rel_batched > 1e-4:
        raise AssertionError(f"per-batch shape: failures {batched.failures}, rel {rel_batched}")
    say("slice", shape="per-batch", images=n_sub - 1, failures=1, vs_resident_f32_rel=rel_batched,
        embed_s=f"{batched.embed_seconds:.4f}")
    launches = preprocess_images.launches
    if launches == 0:
        raise AssertionError("the main path never launched the preprocess kernel")

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    cos = (unit(embeddings["bfloat16"]) * unit(embeddings["float32"])).sum(axis=1)
    if cos.min() <= 0.995:
        raise AssertionError(f"bf16 vs f32 per-image cosine min {cos.min()}")

    model = build_resnet("resnet18", compute_dtype=torch.float32)
    load_flax_variables(model, seeded_init_host("resnet18", 42))
    with torch.inference_mode():
        x = torch.from_numpy(images[:N_CPU_CHECK])
        cpu = model.eval()(preprocess_images(x, RESIZE, CROP, torch.float32)).numpy()
    gpu = embeddings["float32"][:N_CPU_CHECK]
    rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if rel > 1e-4:
        raise AssertionError(f"cuda f32 vs cpu f32 relative error {rel} > 1e-4 (TF32 on?)")
    say("slice", launches=launches, cos_bf16_f32_min=f"{cos.min():.6f}", cuda_vs_cpu_f32_rel=rel)
    return launches


def phase_cli(np, tmp: Path) -> None:
    from PIL import Image

    data, out = tmp / "jpegs", tmp / "cli_out"
    rng = np.random.default_rng(SEED + 2)
    for rel in ("avec_labels/cancer/a.jpg", "avec_labels/normal/b.jpg",
                "sans_label/c.jpg", "sans_label/d.jpg"):
        (data / rel).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(data / rel)
    subprocess.run(
        [sys.executable, "-m", "ssip_tpu_torch.cli.feature_extraction", "--data-dir", str(data),
         "--device", "cuda", "--batch-size", "4", "--compute-dtype", "bfloat16",
         "--output-dir", str(out)],
        cwd=Path(__file__).resolve().parent, check=True, timeout=600,
    )
    emb = np.load(out / "features" / "embeddings.npy")
    meta = json.loads((out / "features" / "metadata.json").read_text())
    if emb.shape != (4, 512) or not np.isfinite(emb).all() or meta["device"] != "cuda:1":
        raise AssertionError(f"cli: embeddings {emb.shape}, device {meta['device']}")
    say("cli", images=4, csv_rows=len((out / "features" / "embeddings.csv").read_text().splitlines()) - 1)


def phase_train(torch, np, tmp: Path) -> int:
    """``run_supervised`` on a seeded JPEG tree in float32 and bfloat16, then
    the training CLI; returns the rotate kernel's launches in the two runs."""
    from PIL import Image

    from ssip_tpu_torch.data.splits import split_dict
    from ssip_tpu_torch.models.resnet import build_resnet
    from ssip_tpu_torch.ops.rotate import augment_images
    from ssip_tpu_torch.pipelines.supervised import ArtifactRegistry, TrainingConfig, labeled_folder, run_supervised
    from ssip_tpu_torch.train.checkpoints import load_checkpoint

    data = tmp / "train" / "avec_labels"
    rng = np.random.default_rng(SEED + 4)
    for cls in ("cancer", "normal"):
        (data / cls).mkdir(parents=True)
        for i in range(TRAIN_PER_CLASS):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(data / cls / f"{cls}_{i:03d}.jpg")
    _, targets, _ = labeled_folder(data)
    want_splits = {k: v.tolist() for k, v in split_dict(targets, 0.2, 0.2, 42).items()}

    augment_images.launches = 0  # count only the main path's launches
    for dtype in ("float32", "bfloat16"):
        out = tmp / f"train_out_{dtype}"
        cfg = TrainingConfig(
            strong_data_dir=data, output_dir=out, device="cuda", batch_size=TRAIN_BATCH,
            image_size=TRAIN_SIZE, baseline_epochs=TRAIN_EPOCHS, target_recall=0.9, compute_dtype=dtype,
        )
        t0 = time.perf_counter()
        results = run_supervised(cfg)
        seconds = time.perf_counter() - t0
        reg = ArtifactRegistry(out)
        for path in (reg.baseline_checkpoint, reg.results_comparison_csv, reg.training_history_json):
            if not path.is_file():
                raise AssertionError(f"train {dtype}: missing artifact {path}")
        payload = json.loads(reg.training_history_json.read_text())
        hist = payload["baseline"]
        losses = hist["train_loss"] + hist["val_loss"]
        if len(hist["train_loss"]) != TRAIN_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"train {dtype}: history {hist}")
        if payload["splits"] != want_splits or payload["arch"] != "resnet18" or payload["image_size"] != TRAIN_SIZE:
            raise AssertionError(f"train {dtype}: splits or arch differ from the CPU split: {payload['splits']}")
        model = build_resnet("resnet18", num_classes=2)
        load_checkpoint(reg.baseline_checkpoint, model)
        header = reg.results_comparison_csv.read_text().splitlines()[0]
        thr = results["baseline_thresholded"]
        say("train", dtype=dtype, images=2 * TRAIN_PER_CLASS, batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
            seconds=f"{seconds:.2f}", train_loss=f"{hist['train_loss'][-1]:.4f}",
            val_loss=f"{hist['val_loss'][-1]:.4f}", test_f1=f"{thr['f1']:.4f}",
            threshold=f"{thr['threshold']:.4f}", csv_columns=len(header.split(",")) - 1)
    launches = augment_images.launches
    if launches == 0:
        raise AssertionError("the training path never launched the augment kernel")

    out = tmp / "train_cli_out"
    subprocess.run(
        [sys.executable, "-m", "ssip_tpu_torch.cli.supervised_training", "--strong-data-dir", str(data),
         "--device", "cuda", "--baseline-epochs", "1", "--target-recall", "0.9", "--output-dir", str(out)],
        cwd=Path(__file__).resolve().parent, check=True, timeout=600,
    )
    hist = json.loads((out / "notes" / "training_history.json").read_text())["baseline"]
    if len(hist["val_loss"]) != 1 or not (out / "models" / "baseline_resnet18.pt").is_file():
        raise AssertionError(f"train cli: history {hist}")
    say("train", cli="supervised_training", epochs=1, val_loss=f"{hist['val_loss'][0]:.4f}", launches=launches)
    return launches


def _seeded_state(torch, device, dtype, kink_free: bool = False):
    from ssip_tpu_torch.models.host_init import seeded_init_host
    from ssip_tpu_torch.models.port import load_flax_variables
    from ssip_tpu_torch.models.resnet import BatchNorm, Conv, build_resnet
    from ssip_tpu_torch.train.engine import TrainState

    model = build_resnet("resnet18", num_classes=2, compute_dtype=dtype)
    load_flax_variables(model, seeded_init_host("resnet18", 42, num_classes=2))
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


def _profile_breakdown(torch, prof, window_ms: float, tag: str) -> None:
    """Device time of the profiled steps by layer and by kernel, and the
    idle share of the window."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == cuda]
    if not kernels:
        raise AssertionError("torch.profiler saw no kernel on the card")
    by_layer: dict = {}
    by_name: dict = {}
    for name, start, end in kernels:
        ms = (end - start) / 1000.0
        low = name.lower()
        layer = next((c for c, keys in _PROFILE_CLASSES if any(k in low for k in keys)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
    busy = sum(by_layer.values())
    for layer, ms in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        say("profile", run=tag, layer=repr(layer), ms=f"{ms:.3f}", share=f"{ms / busy:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say("profile", run=tag, kernel=repr(name[:90]), ms=f"{ms:.3f}")
    say("profile", run=tag, kernels=len(kernels), busy_ms=f"{busy:.3f}", window_ms=f"{window_ms:.3f}",
        idle_share=f"{1 - busy / window_ms:.4f}")


def phase_step(torch, np) -> None:
    """One train step cuda vs CPU, then the steady-state step at batch 128."""
    from ssip_tpu_torch.ops.augment import augment_coeffs
    from ssip_tpu_torch.ops.rotate import augment_images
    from ssip_tpu_torch.runtime.device import configure_precision
    from ssip_tpu_torch.runtime.prng import augment_draws
    from torch.profiler import ProfilerActivity, profile

    from ssip_tpu_torch.train.engine import train_step

    configure_precision("float32")
    rng = np.random.default_rng(SEED + 5)
    b = STEP_CHECK_BATCH
    images = torch.from_numpy(rng.integers(0, 256, (b, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, b).astype(np.int64))
    valid = torch.ones(b, dtype=torch.bool)
    valid[-1] = False  # one padded row, left out of BN statistics and the loss
    coeffs = torch.from_numpy(augment_coeffs(*augment_draws(SEED, "smoke", 0, 0, b)))

    def cuda_vs_cpu(kink_free: bool) -> dict:
        runs = []
        for dev in (torch.device("cpu"), torch.device("cuda")):
            state = _seeded_state(torch, dev, torch.float32, kink_free)
            loss, pred = train_step(state, images.to(dev), labels.to(dev), valid.to(dev), coeffs.to(dev))
            runs.append((loss.cpu(), pred.cpu(), {k: p.grad.cpu() for k, p in state.model.named_parameters()},
                         {k: v.cpu() for k, v in state.model.state_dict().items() if "running" in k}))
        (l_cpu, p_cpu, g_cpu, s_cpu), (l_gpu, p_gpu, g_gpu, s_gpu) = runs
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
        say("step", check=f"cuda_vs_cpu_f32_{tag}", batch=b, padded_rows=1, **r)
    if (seeded["loss_rel"] > 1e-5 or seeded["stat_rel"] > 1e-5 or not seeded["argmax_equal"]
            or shifted["loss_rel"] > 1e-5 or shifted["grad_rel"] > 1e-3 or shifted["stem_l2"] > 1e-2):
        raise AssertionError(f"train step cuda vs cpu out of bounds: seeded {seeded}, kink-free {shifted}")

    b = STEP_TIMED_BATCH
    dev = torch.device("cuda")
    images = torch.from_numpy(rng.integers(0, 256, (b, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 2, b).astype(np.int64)).to(dev)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    n_steps = STEP_WARMUP + STEP_TIMED
    coeffs = torch.from_numpy(np.stack([
        augment_coeffs(*augment_draws(SEED, "smoke", 1, s, b)) for s in range(2 * n_steps)
    ])).to(dev)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        state = _seeded_state(torch, dev, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for s in range(STEP_WARMUP):
            train_step(state, images, labels, valid, coeffs[s])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in range(STEP_WARMUP, n_steps):
            loss, _ = train_step(state, images, labels, valid, coeffs[s])
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / STEP_TIMED
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if not torch.isfinite(loss):
            raise AssertionError(f"{dtype_name} train step loss {loss.item()}")
        aug_ms = median_ms(torch, lambda: augment_images(images, coeffs[0], dtype))
        say("step", dtype=dtype_name, batch=b, timed_steps=STEP_TIMED, ms_per_step=f"{step_ms:.3f}",
            train_imgs_per_s=f"{b / step_ms * 1000:.1f}", augment_kernel_ms=f"{aug_ms:.4f}",
            augment_share=f"{aug_ms / step_ms:.4f}", peak_mem_gib=f"{peak_gib:.2f}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for s in range(n_steps, n_steps + STEP_TIMED):
                train_step(state, images, labels, valid, coeffs[s])
            end.record()
            end.synchronize()
        _profile_breakdown(torch, prof, start.elapsed_time(end), dtype_name)
        del state
    torch.cuda.empty_cache()


def phase_imports() -> None:
    """The run loaded nothing of jax and nothing of the JAX package beyond
    the jax-free modules the port shares."""
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax"))
    ssip_tpu = sorted(m for m in sys.modules if m.split(".")[0] == "ssip_tpu")
    extra = sorted(set(ssip_tpu) - SHARED_JAX_FREE)
    if jax_side or extra:
        raise AssertionError(f"the port loaded {jax_side[:5]} {extra}")
    say("imports", jax=0, ssip_tpu_modules=len(ssip_tpu))


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
    measured = {"preprocess_images": phase_kernel(torch, np), "augment_images": phase_rotate_kernel(torch, np)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        measured["preprocess_images"]["launches"] = phase_slice(torch, np, tmp)
        phase_cli(np, tmp)
        measured["augment_images"]["launches"] = phase_train(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_step(torch, np)
    phase_imports()
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": m["launches"], "max_abs_err": m["max_abs_err"],
         "ms": m["ms"], "plain_ms": m["plain_ms"]}
        for name, m in measured.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
