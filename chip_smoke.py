#!/usr/bin/env python3
"""Drive the PyTorch port's extraction slice once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one output line each; any failure raises and the script exits
non-zero without printing the final line:

1. env     the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build   nvcc builds ``ssip_tpu_torch/csrc/*.cu`` for sm_90a (seconds);
3. kernel  ``preprocess_images`` (CUDA) against its plain PyTorch version on
           the card: bitwise in float32 and bfloat16 at [128, 512, 512, 3]
           → 256 → 224, one uint8 step at 384² and 320×448; median times of
           kernel and plain from CUDA events;
4. slice   a seeded 1024-image uint8 512² corpus in an in-memory
           ``ImageStore`` through ``run_extraction`` on cuda (resident shape,
           batch 128, seeded-init ResNet-18) in bfloat16 and float32, each
           run twice (the second one timed): embeddings [1024, 512] finite,
           the kernel launched, every artifact written, bf16 vs f32 cosine
           > 0.995 per image, cuda f32 vs CPU f32 on 16 images ≤ 1e-4
           relative (TF32 off); then the per-batch shape (pinned,
           double-buffered feed) on 263 images with one decode failure,
           ≤ 1e-4 relative to the resident f32 run;
5. cli     if Pillow is installed: the CLI on a small 512² JPEG tree;
6. imports no jax module and no JAX-package module but the shared ones;
7. the kernels JSON line, then ``{"ok": true, "device": {...}}`` last.

Needs no network and no data: everything is made from seeds. It builds the
kernels from the checkout, so a fresh clone is enough. It imports only
``ssip_tpu_torch``, torch and numpy, and fails if the run loaded jax, flax,
optax or any JAX-package module beyond the three jax-free ones the port
shares (``ssip_tpu.data.discovery``, ``ssip_tpu.runtime.artifacts`` and
``ssip_tpu.runtime.logging``).
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
KERNEL_SOURCE = "ssip_tpu_torch/csrc/preproc.cu"
KERNEL_REPLACES = "ssip_tpu/ops/pallas_preproc.py:41"
# What the port may load of the JAX package: the jax-free modules it shares.
SHARED_JAX_FREE = {
    "ssip_tpu", "ssip_tpu.data", "ssip_tpu.data.discovery",
    "ssip_tpu.runtime", "ssip_tpu.runtime.artifacts", "ssip_tpu.runtime.logging",
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
    try:
        from PIL import Image
    except ImportError:
        say("cli", skipped="Pillow is not installed on this machine; the JPEG CLI phase needs it")
        return
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
    timing = phase_kernel(torch, np)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        launches = phase_slice(torch, np, tmp)
        phase_cli(np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_imports()
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [{
        "name": "preprocess_images", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, **timing,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
