"""Frozen-backbone embedding extraction — the port's main path.

Counterpart of ``ssip_tpu/pipelines/extraction.py``: the config and weight
resolution (``:59-185``), the sanity checks and neighbour probe
(``:294-343``), and the two store-backed execution shapes with the artifact
set (``:623-879``):

discovery → decode-once ``ImageStore`` → uint8 batches on the device →
``preprocess_images`` (the CUDA kernel on the card) → eval forward of the
``--arch`` backbone (ResNet-18/34/50, or ViT-T/S/B/16 with its LayerNorm and
attention kernels) → embeddings as wide as the model (512, 2048, 192, 384 or
768) → ``embeddings.npy/.csv``, ``metadata.json``, ``feature_summary.md``
and the log, at the paths ``ArtifactRegistry`` names.

Execution shapes:

- resident: the whole uint8 corpus is copied to the device once, then a
  Python loop embeds it batch by batch (taken when the corpus fits
  ``_RESIDENT_BUDGET_BYTES`` and nothing failed to decode);
- per-batch: ``iter_device_batches`` feeds padded batches through pinned
  buffers on a side stream.

Not ported yet (refused with an error naming the ROADMAP entry): the
streamed shape with its host-preproc and fast-decode variants, sharded
extraction, int8 PTQ, the folded-BN forward and the MoE archs. A corpus
that ``streaming="auto"`` would stream (above ``_HOST_STAGE_BUDGET_BYTES``
decoded, ``:410-424``) is refused the same way rather than decoded whole
into host memory.
"""

from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torch import nn

from ssip_tpu_torch.data.discovery import ImageRecord, compute_dataset_digest, discover_image_records
from ssip_tpu_torch.data.pipeline import ImageStore, iter_device_batches
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables, load_state_dict_arrays, read_torch_checkpoint
from ssip_tpu_torch.models.registry import build_model, refuse_unported_arch
from ssip_tpu_torch.ops.preproc import preprocess_images
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from ssip_tpu_torch.runtime.device import compute_dtype, configure_precision, device_label, resolve_device
from ssip_tpu_torch.runtime.logging import configure_logging, get_logger

LOGGER = get_logger(__name__)

DEFAULT_WEIGHTS_ENV = "SSIP_RESNET18_WEIGHTS"
# uint8 corpus size up to which the whole dataset is staged on the device.
# Kept at the JAX package's value (sized for a 16 GB TPU); sizing it for an
# 80 GB H100 from a measurement is a ROADMAP item.
_RESIDENT_BUDGET_BYTES = 6 * 1024**3
# Host-RAM budget of the decode-once store (the JAX package's value,
# ``ssip_tpu/pipelines/extraction.py:349``); above it the JAX package
# streams, a shape the port does not have yet.
_HOST_STAGE_BUDGET_BYTES = 4 * 1024**3
_STREAMED_NOT_PORTED = (
    "is not ported to ssip_tpu_torch yet (ROADMAP.md, Queue 1 slice 1 "
    "item 8: the streamed and sharded extraction shapes)"
)


@dataclass
class ExtractionConfig:
    data_dir: Path = Path("mri_dataset_brain_cancer_oc")
    output_dir: Path = Path("outputs")
    batch_size: int = 32
    device: str = "auto"
    verbose: bool = False
    weights: Optional[Path] = None  # torch .pt/.pth state_dict
    resize: int = 256
    crop: int = 224
    seed: int = 42
    neighbor_sample: int = 8
    compute_dtype: str = "float32"  # "float32" (parity) | "bfloat16" (throughput)
    arch: str = "resnet18"
    cache_decoded: bool = True
    num_decode_threads: int = 8
    streaming: str = "auto"  # "auto" | "never"; "always" is not ported

    def __post_init__(self) -> None:
        if self.streaming not in ("auto", "always", "never"):
            raise ValueError(f"streaming must be auto, always or never, got {self.streaming!r}")
        if self.streaming == "always":
            raise ValueError(f"--streaming always {_STREAMED_NOT_PORTED}")
        if self.compute_dtype == "int8":
            raise ValueError(
                "--compute-dtype int8 is not ported to ssip_tpu_torch yet "
                "(ROADMAP.md, Queue 1 slice 3: int8 extraction)"
            )
        compute_dtype(self.compute_dtype)  # validates the name
        if self.crop > self.resize:
            raise ValueError(
                f"--crop ({self.crop}) must be <= --resize ({self.resize}): "
                "the resized short side cannot satisfy a larger center crop"
            )
        refuse_unported_arch(self.arch)


@dataclass
class ExtractionSummary:
    embeddings: np.ndarray
    records: List[ImageRecord]
    failures: List[Path]
    stats: Dict[str, float]
    neighbor_probe: List[Dict[str, Any]]
    total_seconds: float
    per_image_seconds: List[float]
    weights_source: str
    embed_seconds: float  # the embed loop alone (CUDA events on the card)


def _resolve_weights(cfg: ExtractionConfig, model: nn.Module) -> str:
    """Load weights into ``model``; returns the ``metadata.json`` source.

    Candidates in order: ``--weights``, ``$SSIP_RESNET18_WEIGHTS``,
    ``<output_dir>/models/{arch}_imagenet1k.pt``, then the seeded init
    (bit for bit the JAX package's, so no-weights runs of both packages
    compare). A wrong-architecture checkpoint is fatal only when named by
    ``--weights``; the other candidates are skipped with a warning.
    """
    candidates: list[Path] = []
    if cfg.weights is not None:
        candidates.append(Path(cfg.weights))
    env = os.environ.get(DEFAULT_WEIGHTS_ENV)
    if env:
        candidates.append(Path(env))
    candidates.append(Path(cfg.output_dir) / "models" / f"{cfg.arch}_imagenet1k.pt")

    for path in candidates:
        explicit = cfg.weights is not None and path == Path(cfg.weights)
        if path.exists():
            LOGGER.info("Loading torch weights from %s", path)
            try:
                load_state_dict_arrays(model, read_torch_checkpoint(path), path)
            except ValueError as exc:
                if explicit:
                    raise ValueError(f"Checkpoint {path} does not match --arch {cfg.arch}: {exc}") from exc
                LOGGER.warning(
                    "Skipping candidate checkpoint %s (wrong architecture for --arch %s): %s",
                    path, cfg.arch, exc,
                )
                continue
            return f"ported:{path}"
        if explicit:
            raise FileNotFoundError(f"Weights checkpoint not found: {path}")

    LOGGER.warning(
        "No pretrained checkpoint found — using seeded random init "
        "(embeddings will NOT match the torchvision reference)."
    )
    load_flax_variables(model, seeded_init_host(cfg.arch, cfg.seed, image_size=cfg.crop))
    return f"random_init:seed={cfg.seed}"


def run_sanity_checks(embeddings: np.ndarray) -> Dict[str, float]:
    """NaN/inf fail-fast + aggregate stats (float32, like the JAX version)."""
    if np.isnan(embeddings).any():
        raise ValueError("Embedding matrix contains NaN values")
    if np.isinf(embeddings).any():
        raise ValueError("Embedding matrix contains inf values")
    arr = embeddings.astype(np.float32)
    return {
        "num_vectors": int(arr.shape[0]),
        "dimension": int(arr.shape[1]),
        "mean_abs_mean": float(np.abs(arr.mean(axis=0)).mean()),
        "mean_std": float(arr.std(axis=0).mean()),
    }


def nearest_neighbor_probe(
    embeddings: np.ndarray,
    records: List[ImageRecord],
    sample_size: int = 8,
    seed: int = 42,
) -> List[Dict[str, Any]]:
    """Cosine nearest neighbour of ``sample_size`` queries drawn with
    ``np.random.default_rng(seed).choice`` without replacement."""
    n = embeddings.shape[0]
    if n < 2:
        return []
    sample_size = min(sample_size, n - 1)
    if sample_size <= 0:
        return []
    rng = np.random.default_rng(seed)
    sample = rng.choice(n, size=sample_size, replace=False)

    emb = torch.from_numpy(np.ascontiguousarray(embeddings, dtype=np.float32))
    normalized = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True), min=1e-12)
    sims = normalized[torch.from_numpy(sample)] @ normalized.T  # [S, N]
    sims[torch.arange(sample_size), torch.from_numpy(sample)] = -torch.inf
    best_sim, neighbor_idx = torch.max(sims, dim=1)
    return [
        {
            "query": str(records[int(q)].relative_path),
            "neighbor": str(records[int(nb)].relative_path),
            "similarity": float(s),
        }
        for q, nb, s in zip(sample, neighbor_idx.tolist(), best_sim.tolist())
    ]


class _Timer:
    """Seconds between ``start`` and ``stop``: CUDA events on a card (the
    device time of the enqueued work), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            return self._start.elapsed_time(self._end) / 1e3
        return time.perf_counter() - self._t0


def _header_shape(path: Path) -> Optional[tuple[int, int, int]]:
    """Decoded shape of one image from its header, as ``decode_image``
    would give it (grayscale stacked to 3 channels); None if unreadable.
    Counterpart of ``ssip_tpu/pipelines/extraction.py:352-368``."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            w, h = img.size
            bands = len(img.getbands())
    except Exception:  # noqa: BLE001 — the probe tolerates what decode tolerates
        return None
    return h, w, 3 if bands == 1 else bands


def _refuse_streamed_corpus(cfg: ExtractionConfig, paths: List[Path], digest: str) -> None:
    """Raise where the JAX package's ``_should_stream`` (``:410-424``) would
    take the streamed shape under ``streaming="auto"``: no decode cache for
    this corpus, and first readable image's shape × corpus size above
    ``_HOST_STAGE_BUDGET_BYTES``."""
    if cfg.streaming != "auto" or not paths:
        return
    if cfg.cache_decoded:
        data_path, meta_path = ImageStore._cache_paths(Path(cfg.output_dir) / "cache", digest[:16])
        if data_path.exists() and meta_path.exists():
            return
    shape = next((s for s in map(_header_shape, paths) if s is not None), None)
    if shape is None:
        raise RuntimeError("All images failed to decode")
    corpus_bytes = int(np.prod(shape)) * len(paths)
    if corpus_bytes > _HOST_STAGE_BUDGET_BYTES:
        raise ValueError(
            f"a {corpus_bytes / 2**30:.1f} GiB decoded corpus (above the "
            f"{_HOST_STAGE_BUDGET_BYTES / 2**30:.0f} GiB host budget) needs the streamed "
            f"shape, which {_STREAMED_NOT_PORTED}"
        )


def extract_embeddings(
    records: List[ImageRecord],
    cfg: ExtractionConfig,
    store: Optional[ImageStore] = None,
) -> ExtractionSummary:
    """Embed ``records``. ``store`` may hold the corpus already decoded
    (in dataset order); otherwise it is decoded here (or read from the
    decode cache)."""
    device = resolve_device(cfg.device)
    dtype = compute_dtype(cfg.compute_dtype)
    configure_precision(cfg.compute_dtype)
    LOGGER.info("Extraction on %s (%s)", device_label(device), cfg.compute_dtype)

    model = build_model(cfg.arch, compute_dtype=dtype, image_size=cfg.crop)
    weights_source = _resolve_weights(cfg, model)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    t_start = time.perf_counter()
    if store is None:
        digest = compute_dataset_digest(records)
        paths = [r.absolute_path for r in records]
        _refuse_streamed_corpus(cfg, paths, digest)
        store = ImageStore.from_paths(
            paths,
            convert_rgb=False,  # extraction policy: no RGB conversion
            num_threads=cfg.num_decode_threads,
            cache_dir=Path(cfg.output_dir) / "cache" if cfg.cache_decoded else None,
            cache_key=digest[:16],
        )
    t_store = time.perf_counter()
    failures = list(store.failures)
    valid = store.valid_indices()
    batch = cfg.batch_size

    def embed(u8: torch.Tensor) -> torch.Tensor:
        return model(preprocess_images(u8, resize=cfg.resize, crop=cfg.crop, out_dtype=dtype))

    corpus_bytes = int(np.prod(store.image_shape)) * len(valid)
    resident = corpus_bytes <= _RESIDENT_BUDGET_BYTES and not store.failures
    timer = _Timer(device)
    per_image_times: list[float] = []
    with torch.inference_mode():
        if resident and len(valid) > 0:
            n = len(valid)
            padded = -(-n // batch) * batch
            staged = store.gather(valid)
            t_stage = time.perf_counter()
            images = torch.zeros((padded, *staged.shape[1:]), dtype=torch.uint8, device=device)
            images[:n].copy_(torch.from_numpy(np.require(staged, requirements=["C", "W"])))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            LOGGER.info(
                "Staged %d images (%.0f MB) on %s: decode %.1fs, gather %.1fs, transfer %.1fs",
                padded, images.numel() / 1e6, device, t_store - t_start,
                t_stage - t_store, time.perf_counter() - t_stage,
            )
            del staged
            feats = torch.empty((padded, model.num_features), dtype=torch.float32, device=device)
            timer.start()
            for lo in range(0, padded, batch):
                feats[lo : lo + batch] = embed(images[lo : lo + batch])
            embed_seconds = timer.stop()
            embeddings = feats[:n].cpu().numpy()
            total = time.perf_counter() - t_start
            per_image_times = [total / n] * n
        else:
            chunks: list[np.ndarray] = []
            t_batch = t_start
            embed_seconds = 0.0
            for b in iter_device_batches(store, valid, batch, device):
                timer.start()
                out = embed(b.data)[: b.valid]
                embed_seconds += timer.stop()
                chunks.append(out.cpu().numpy())
                now = time.perf_counter()
                per_image_times.extend([(now - t_batch) / b.valid] * b.valid)
                t_batch = now
            total = time.perf_counter() - t_start
            if not chunks:
                raise RuntimeError("No embeddings were generated; all images failed to decode?")
            embeddings = np.concatenate(chunks, axis=0)
    kept_records = [records[int(i)] for i in valid]
    LOGGER.info(
        "Extracted %d embeddings in %.2fs (%.1f imgs/s end-to-end, embed loop %.3fs)",
        len(embeddings), total, len(embeddings) / max(total, 1e-9), embed_seconds,
    )

    stats = run_sanity_checks(embeddings)
    probe = nearest_neighbor_probe(
        embeddings, kept_records, sample_size=cfg.neighbor_sample, seed=cfg.seed
    )
    return ExtractionSummary(
        embeddings=embeddings,
        records=kept_records,
        failures=failures,
        stats=stats,
        neighbor_probe=probe,
        total_seconds=total,
        per_image_seconds=per_image_times,
        weights_source=weights_source,
        embed_seconds=embed_seconds,
    )


def save_artifacts(
    summary: ExtractionSummary, cfg: ExtractionConfig, digest: str, device_str: str
) -> None:
    """The artifact set, with the JAX package's file names and schemas.

    ``embeddings.csv`` is written with the stdlib ``csv`` module in the bytes
    pandas writes (``index,path,bucket,label``, empty label for unlabeled
    rows, ``\\n`` line ends), so the port needs no pandas.
    """
    reg = ArtifactRegistry(Path(cfg.output_dir))
    reg.features_dir.mkdir(parents=True, exist_ok=True)
    reg.notes_dir.mkdir(parents=True, exist_ok=True)

    np.save(reg.embeddings_npy, summary.embeddings.astype(np.float32))

    with open(reg.embeddings_csv, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["index", "path", "bucket", "label"])
        for i, r in enumerate(summary.records):
            writer.writerow([i, str(r.relative_path), r.bucket, r.label or ""])

    metadata = {
        "backbone": f"ssip_tpu_torch.{cfg.arch}",
        "architecture": cfg.arch,
        "weights": summary.weights_source,
        "layer": "global_avg_pool",
        "embedding_dimension": int(summary.embeddings.shape[1]),
        "input_resize": cfg.resize,
        "input_crop": cfg.crop,
        "normalization_mean": [0.485, 0.456, 0.406],
        "normalization_std": [0.229, 0.224, 0.225],
        "channel_policy": "No conversion (assumes RGB inputs)",
        "date_utc": datetime.now(timezone.utc).isoformat(),
        "num_images": int(summary.embeddings.shape[0]),
        "failed_images": len(summary.failures),
        "device": device_str,
        "dataset_dir": str(cfg.data_dir),
        "dataset_digest": digest,
        "sanity_checks": summary.stats,
        "neighbor_probe": summary.neighbor_probe,
    }
    reg.features_metadata_json.write_text(json.dumps(metadata, indent=2))

    times = summary.per_image_seconds
    mean_latency = float(np.mean(times)) if times else float("nan")
    median_latency = float(np.median(times)) if times else float("nan")
    failure_section = "None" if not summary.failures else "\n".join(f"- {p}" for p in summary.failures)
    neighbor_lines = ["| Query | Neighbor | Cosine |", "| --- | --- | --- |"]
    for item in summary.neighbor_probe:
        neighbor_lines.append(f"| {item['query']} | {item['neighbor']} | {item['similarity']:.4f} |")
    neighbor_block = (
        "\n".join(neighbor_lines)
        if summary.neighbor_probe
        else "No neighbors computed (insufficient samples)."
    )

    reg.feature_summary_md.write_text(
        f"""# Feature Extraction Summary

- Backbone: ssip_tpu_torch.{cfg.arch} ({summary.weights_source})
- Layer: global average pooled features ({summary.embeddings.shape[1]}-D)
- Input spec: resize {cfg.resize} → center crop {cfg.crop}, ImageNet normalization
- Batch size: {cfg.batch_size}
- Device: {device_str}
- Total images processed: {summary.embeddings.shape[0]}
- Failed decodes: {len(summary.failures)}
- Mean per-image latency (s): {mean_latency:.4f}
- Median per-image latency (s): {median_latency:.4f}

## Sanity Check Statistics

- Mean of |dimension means|: {summary.stats['mean_abs_mean']:.6f}
- Mean of dimension standard deviations: {summary.stats['mean_std']:.6f}

## Nearest Neighbor Spot Check

{neighbor_block}

## Decode Failures

{failure_section}
""",
    )


def run_extraction(cfg: ExtractionConfig, store: Optional[ImageStore] = None) -> ExtractionSummary:
    """Discover, embed and write the artifact set under ``cfg.output_dir``."""
    reg = ArtifactRegistry(Path(cfg.output_dir))
    reg.logs_dir.mkdir(parents=True, exist_ok=True)
    configure_logging("DEBUG" if cfg.verbose else "INFO", log_file=reg.extraction_log)

    records = discover_image_records(Path(cfg.data_dir))
    LOGGER.info(
        "Discovered %d images (labeled=%d, unlabeled=%d)",
        len(records),
        sum(1 for r in records if r.bucket == "labeled"),
        sum(1 for r in records if r.bucket == "unlabeled"),
    )
    digest = compute_dataset_digest(records)
    summary = extract_embeddings(records, cfg, store=store)
    save_artifacts(summary, cfg, digest, device_label(resolve_device(cfg.device)))
    return summary
