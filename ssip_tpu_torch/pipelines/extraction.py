"""Frozen-backbone embedding extraction — the port's main path.

Counterpart of ``ssip_tpu/pipelines/extraction.py``: the config and weight
resolution (``:59-185``), the sanity checks and neighbour probe
(``:294-343``), and the two store-backed execution shapes with the artifact
set (``:623-879``):

discovery → decode-once ``ImageStore`` → uint8 batches on the device →
``preprocess_images`` (the CUDA kernel on the card) → eval forward of the
``--arch`` backbone (ResNet-18/34/50, ViT-T/S/B/16 or MoE ViT-T/S/16 with
their LayerNorm and attention kernels) → embeddings as wide as the model
(512, 2048, 192, 384 or 768) → ``embeddings.npy/.csv``, ``metadata.json``,
``feature_summary.md`` and the log, at the paths ``ArtifactRegistry`` names.

``compute_dtype="int8"`` (the ResNets and the dense ViTs) is post-training
quantized extraction (``:205-250, 427-485, 640-642`` there): the float32
model is calibrated on the corpus's first 32 readable images, quantized
(``models/quantized.py`` for a ResNet, ``models/quantized_vit.py`` for a
ViT), and the embed step becomes ``preprocess_images(quant_inv_scale=stem
scale)`` → the quantized forward on the prequantized int8 images (the stem's
operand comes from the preprocess kernel's int8 epilogue, as ``:240-249``
there); ``weights_source`` gains ``+int8_ptq``.

Execution shapes:

- resident: the whole uint8 corpus is copied to the device once, then a
  Python loop embeds it batch by batch (taken when the corpus fits
  ``_RESIDENT_BUDGET_BYTES`` and nothing failed to decode);
- per-batch: ``iter_device_batches`` feeds padded batches through pinned
  buffers on a side stream;
- streamed (``:352-424, 512-620`` there): no decode-once store; each batch
  is decoded on a thread pool while the previous one is copied to the card
  and the one before is embedded (``iter_streamed_decode_batches``), the
  features come back through pinned host buffers with an event each, at
  most 8 batches in flight, so host memory stays O(batch) whatever the
  corpus size. Taken with ``streaming="always"``, with ``host_preproc`` or
  ``fast_decode``, and under ``streaming="auto"`` when no decode cache
  exists and the first readable image's shape × the corpus size exceeds
  ``_HOST_STAGE_BUDGET_BYTES``. Rows are canonicalized to the majority
  shape of the corpus's leading sample, as the store packs them.
  ``host_preproc`` runs the exact resize and crop on the host (the native
  decoder's bit-for-bit PIL resample, ``native/``), so only crop² bytes
  cross the link and the card's preprocess resamples crop → crop;
  ``fast_decode`` adds the DCT-scaled JPEG decode (approximate). The two
  exclude each other, and both need the native library.

``fast_inference`` (``:85-91``, ``:488-507`` there): in bfloat16, a ResNet
embeds through its folded forward, each BatchNorm folded into the conv
before it (``models/inference.py``: ``fold_resnet_extractor``,
``make_folded_apply``); a ViT, which has no BatchNorm, keeps its plain
forward, as does every other type. The JAX package folds with its
space-to-depth stem, a TPU layout; the port computes the same function with
the plain 7×7 stride-2 stem.

Data parallelism (one process a card, ``parallel/distributed.py``): the
global batch is ``pad_to_multiple(batch_size, world)`` records (JAX
``:550, 632-697``) and each rank embeds its share of every global batch
through the same shapes as above (its own decode cache); int8 calibrates
on the corpus's first 32 images on every rank. Rank 0 gathers the rows in
record order and alone writes the artifacts and the log file.
``pipelines/sharded_extraction.py`` is the resumable ``--shard-size`` form.
int8 with an MoE arch is refused with the JAX package's own message.
"""

from __future__ import annotations

import csv
import json
import os
import time
from collections import Counter, deque
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torch import nn

from ssip_tpu_torch.data.discovery import ImageRecord, compute_dataset_digest, discover_image_records
from ssip_tpu_torch.data.decode import decode_batch, preprocess_host_exact
from ssip_tpu_torch.data.pipeline import ImageStore, iter_device_batches, iter_streamed_decode_batches
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.inference import fold_resnet_extractor, folded_to_device, make_folded_apply
from ssip_tpu_torch.models.port import (
    load_flax_variables, load_state_dict_arrays, quantized_resnet_from_tree, quantized_vit_from_tree,
    read_torch_checkpoint,
)
from ssip_tpu_torch.models.quantized import quantize_extractor
from ssip_tpu_torch.models.quantized_vit import quantize_vit_extractor
from ssip_tpu_torch.models.registry import build_model, refuse_unported_arch
from ssip_tpu_torch.models.resnet import MODEL_STAGES
from ssip_tpu_torch.models.vit import VIT_CONFIGS
from ssip_tpu_torch.ops.preproc import preprocess_images
from ssip_tpu_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD
from ssip_tpu_torch.parallel.distributed import is_primary, rank, world_size
from ssip_tpu_torch.parallel.mesh import pad_to_multiple
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
# ``ssip_tpu/pipelines/extraction.py:349``); above it ``streaming="auto"``
# takes the streamed shape.
_HOST_STAGE_BUDGET_BYTES = 4 * 1024**3
# batches whose features are still on their way to the host (``:562-576``)
_MAX_OUTSTANDING = 8


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
    compute_dtype: str = "float32"  # "float32" (parity) | "bfloat16" (throughput) | "int8" (PTQ)
    arch: str = "resnet18"
    cache_decoded: bool = True
    num_decode_threads: int = 8
    streaming: str = "auto"  # "auto" | "always" | "never"
    # the streamed shape with DCT-scaled decode and the host's resize and
    # crop (approximate: the resample numerics change)
    fast_decode: bool = False
    # the streamed shape with the exact resize and crop on the host: only
    # crop² bytes cross the link, the numerics unchanged
    host_preproc: bool = False
    # bfloat16 ResNets: the forward with BatchNorm folded into the convs
    fast_inference: bool = False

    def __post_init__(self) -> None:
        if self.streaming not in ("auto", "always", "never"):
            raise ValueError(f"streaming must be auto, always or never, got {self.streaming!r}")
        if self.fast_decode and self.host_preproc:
            raise ValueError(
                "fast_decode (approximate DCT-scaled decode) and host_preproc "
                "(exact numerics) are mutually exclusive — pick one."
            )
        if self.compute_dtype == "int8":
            if self.arch.startswith("vit_moe"):
                raise ValueError(
                    "int8 PTQ is implemented for the dense ViTs only; run "
                    f"--arch {self.arch} with --compute-dtype float32/bfloat16"
                )
        else:
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


def _probe_image_shape(paths: List[Path]) -> tuple[int, int, int]:
    """Shape of the first readable image (header read, no decode)."""
    for p in paths:
        shape = _header_shape(p)
        if shape is not None:
            return shape
    raise RuntimeError("All images failed to decode")


def _probe_majority_shape(paths: List[Path], sample_size: int = 64) -> tuple[int, int, int]:
    """Majority decoded shape over the corpus's leading sample, from the
    headers (``:370-405``): the streamed shape canonicalizes every row to
    it, as the store packs the majority shape."""
    shapes = [s for s in map(_header_shape, paths[:sample_size]) if s is not None]
    if not shapes:
        return _probe_image_shape(paths[sample_size:])
    return Counter(shapes).most_common(1)[0][0]


def _should_stream(cfg: ExtractionConfig, paths: List[Path], digest: str) -> bool:
    """``:408-424``: always for ``streaming="always"``, ``fast_decode`` and
    ``host_preproc``; under ``"auto"`` when there is no decode cache for this
    corpus and the first readable image's shape × the corpus size exceeds
    ``_HOST_STAGE_BUDGET_BYTES``."""
    if cfg.streaming == "always" or cfg.fast_decode or cfg.host_preproc:
        return True
    if cfg.streaming != "auto" or not paths:
        return False
    if cfg.cache_decoded:
        data_path, meta_path = ImageStore._cache_paths(Path(cfg.output_dir) / "cache", digest[:16])
        if data_path.exists() and meta_path.exists():
            return False
    return int(np.prod(_probe_image_shape(paths))) * len(paths) > _HOST_STAGE_BUDGET_BYTES


_CALIBRATION_IMAGES = 32


def _calibration_batch(cfg: ExtractionConfig, arrays: List[Optional[np.ndarray]]) -> torch.Tensor:
    """Normalized float32 [n, crop, crop, 3] batch for the int8 calibration:
    the readable ones of the corpus's first 32 images (discovery order, so
    deterministic; ``arrays`` holds them decoded, None where a file failed),
    through the exact host chain (short-side resize → center crop),
    normalized on the host with the JAX package's expression
    (``ssip_tpu/pipelines/extraction.py:455-458``)."""
    frames = [preprocess_host_exact(np.asarray(a), cfg.resize, cfg.crop) for a in arrays if a is not None]
    frames = [f for f in frames if f.shape == (cfg.crop, cfg.crop, 3)]
    if not frames:
        raise RuntimeError(
            "int8 calibration failed: no decodable images in the corpus's "
            f"first {_CALIBRATION_IMAGES} files"
        )
    x = np.stack(frames).astype(np.float32)
    mean = 255.0 * np.asarray(IMAGENET_MEAN, np.float32)
    inv_std = 1.0 / (255.0 * np.asarray(IMAGENET_STD, np.float32))
    return torch.from_numpy((x - mean) * inv_std)


def _quantize_variables(
    cfg: ExtractionConfig, model: nn.Module, arrays: List[Optional[np.ndarray]], device: torch.device
) -> nn.Module:
    """The float32 ResNet or dense ViT → its int8 module for this corpus, on
    ``device``, taking the images the preprocess kernel's int8 epilogue
    wrote (``stem_prequantized``)."""
    calib = _calibration_batch(cfg, arrays).to(device)
    if cfg.arch in VIT_CONFIGS:
        tree = quantize_vit_extractor(model, calib, arch=cfg.arch)
        quantized = quantized_vit_from_tree(tree, cfg.arch, stem_prequantized=True)
    else:
        tree = quantize_extractor(model, calib, MODEL_STAGES[cfg.arch], bottleneck=cfg.arch == "resnet50")
        quantized = quantized_resnet_from_tree(tree, cfg.arch, stem_prequantized=True)
    LOGGER.info("int8 PTQ: calibrated activation scales on %d images", calib.shape[0])
    return quantized.to(device).eval()


def uses_folded_forward(cfg: ExtractionConfig) -> bool:
    """``_prepare_inference``'s rule: the folded forward for a ResNet in
    bfloat16 when asked for; a ViT has no BatchNorm to fold."""
    return cfg.fast_inference and cfg.compute_dtype == "bfloat16" and not cfg.arch.startswith("vit")


def folded_forward(arch: str, model: nn.Module, dtype: torch.dtype):
    """normalized NHWC batch → float32 features of ``model`` (a ResNet, eval
    statistics) through its folded forward, computed in ``dtype``."""
    bottleneck = arch == "resnet50"
    device = next(model.parameters()).device
    folded = folded_to_device(fold_resnet_extractor(model, MODEL_STAGES[arch], bottleneck), device, dtype)
    apply = make_folded_apply(MODEL_STAGES[arch], bottleneck, compute_dtype=dtype)
    return lambda x: apply(folded, x)


def _embed_fn(cfg: ExtractionConfig, model: nn.Module, dtype: torch.dtype, resize: int):
    """uint8 batch on the model's device → float32 features: the preprocess
    kernel (to ``resize``, then the crop) and the forward; in int8 the
    kernel's epilogue writes the stem's int8 operand; with
    ``fast_inference`` the folded forward."""
    if cfg.compute_dtype == "int8":
        stem_inv_scale = model.stem.inv_scale
        return lambda u8: model(preprocess_images(u8, resize=resize, crop=cfg.crop, quant_inv_scale=stem_inv_scale))
    forward = folded_forward(cfg.arch, model, dtype) if uses_folded_forward(cfg) else model
    return lambda u8: forward(preprocess_images(u8, resize=resize, crop=cfg.crop, out_dtype=dtype))


def _extract_streaming(
    records: List[ImageRecord], cfg: ExtractionConfig, model: nn.Module, dtype: torch.dtype,
    weights_source: str, device: torch.device, calibration: List[Path],
) -> "ExtractionSummary":
    """The constant-host-memory shape: decode ∥ copy ∥ embed
    (``ssip_tpu/pipelines/extraction.py:512-620``)."""
    paths = [r.absolute_path for r in records]
    t_start = time.perf_counter()
    stream_kwargs: Dict[str, Any] = {}
    if cfg.fast_decode or cfg.host_preproc:
        # the host resizes and crops; the card's preprocess resamples
        # crop → crop, the identity, and normalizes
        shape = (cfg.crop, cfg.crop, 3)
        stream_kwargs = dict(host_resize=cfg.resize, host_crop=cfg.crop)
        if cfg.fast_decode:
            stream_kwargs["fast_scale"] = cfg.resize
        resize_for_device = cfg.crop
    else:
        shape = _probe_majority_shape(paths, sample_size=max(cfg.batch_size, 64))
        resize_for_device = cfg.resize
    if cfg.compute_dtype == "int8":
        arrays, _ = decode_batch(calibration, num_threads=cfg.num_decode_threads)
        model = _quantize_variables(cfg, model, arrays, device)
        weights_source += "+int8_ptq"
    embed = _embed_fn(cfg, model, dtype, resize_for_device)

    failures: List[Path] = []
    chunks: List[np.ndarray] = []
    kept_positions: List[int] = []
    # features on their way to the host: (device features, pinned host copy,
    # valid rows, the copy's event); the oldest is read once more than
    # _MAX_OUTSTANDING are in flight, so the loop never waits on a batch it
    # just launched
    pending: deque = deque()

    def drain(limit: int) -> None:
        while len(pending) > limit:
            _feats, host, valid, event = pending.popleft()
            if event is not None:
                event.synchronize()
            chunks.append(host[:valid].numpy())

    timer = _Timer(device)
    with torch.inference_mode():
        for i, batch in enumerate(iter_streamed_decode_batches(
            paths, cfg.batch_size, shape, device, num_threads=cfg.num_decode_threads,
            convert_rgb=False,  # extraction policy: no RGB conversion
            prefetch=2, failures=failures, **stream_kwargs,
        )):
            if i == 0:
                timer.start()
            feats = embed(batch.data)
            if device.type == "cuda":
                host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
                host.copy_(feats, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = feats, None
            pending.append((feats, host, batch.valid, event))
            kept_positions.extend(int(j) for j in batch.indices)
            drain(_MAX_OUTSTANDING)
        embed_seconds = timer.stop() if kept_positions else 0.0
        drain(0)
    total = time.perf_counter() - t_start
    if not chunks:
        raise RuntimeError("No embeddings were generated; all images failed to decode?")
    embeddings = np.concatenate(chunks, axis=0)
    kept_records = [records[i] for i in kept_positions]
    LOGGER.info(
        "Streamed %d embeddings in %.2fs (%.1f imgs/s end-to-end, overlapped "
        "decode/H2D/compute, O(batch) host memory; embed span %.3fs)",
        len(embeddings), total, len(embeddings) / max(total, 1e-9), embed_seconds,
    )
    stats = run_sanity_checks(embeddings)
    probe = nearest_neighbor_probe(embeddings, kept_records, sample_size=cfg.neighbor_sample, seed=cfg.seed)
    return ExtractionSummary(
        embeddings=embeddings, records=kept_records, failures=failures, stats=stats, neighbor_probe=probe,
        total_seconds=total, per_image_seconds=[total / len(kept_positions)] * len(kept_positions),
        weights_source=weights_source, embed_seconds=embed_seconds,
    )


def extract_embeddings(
    records: List[ImageRecord],
    cfg: ExtractionConfig,
    store: Optional[ImageStore] = None,
) -> ExtractionSummary:
    """Embed ``records``. ``store`` may hold the corpus already decoded
    (in dataset order); otherwise the corpus streams (``_should_stream``)
    or is decoded here (or read from the decode cache). Under a process
    group of more than one rank each rank embeds its share of every global
    batch and every rank returns the whole summary, in record order."""
    if world_size() > 1:
        if store is not None:
            raise ValueError("a prebuilt ImageStore holds one process's corpus: extract without it under a group")
        return _extract_data_parallel(records, cfg)
    return _extract_local(records, cfg, store)


def rank_positions(n: int, batch_size: int, ranks: int, index: int) -> np.ndarray:
    """Positions (into ``n`` records) of rank ``index``'s share: of every
    global batch of ``pad_to_multiple(batch_size, ranks)`` records, the
    ``index``-th of ``ranks`` equal slices."""
    g = pad_to_multiple(batch_size, ranks)
    per = g // ranks
    starts = np.arange(0, n, g)[:, None] + index * per + np.arange(per)[None, :]
    return starts.reshape(-1)[starts.reshape(-1) < n]


def _extract_data_parallel(records: List[ImageRecord], cfg: ExtractionConfig) -> ExtractionSummary:
    """This rank's share through ``_extract_local``, then every rank's rows
    gathered and put back in record order."""
    import dataclasses

    import torch.distributed as dist

    ranks = world_size()
    mine = rank_positions(len(records), cfg.batch_size, ranks, rank())
    local_cfg = dataclasses.replace(cfg, batch_size=pad_to_multiple(cfg.batch_size, ranks) // ranks)
    calibration = [r.absolute_path for r in records[:_CALIBRATION_IMAGES]]
    local = None  # a rank whose share is empty (a short last batch) embeds nothing
    if len(mine):
        part = _extract_local([records[int(i)] for i in mine], local_cfg, None, calibration)
        position = {str(r.absolute_path): i for i, r in enumerate(records)}
        local = (
            part.embeddings, [position[str(r.absolute_path)] for r in part.records],
            [position[str(p)] for p in part.failures], part.per_image_seconds, part.total_seconds,
            part.embed_seconds, part.weights_source,
        )
    parts: List[Any] = [None] * ranks
    dist.all_gather_object(parts, local)
    parts = [p for p in parts if p is not None]
    kept = np.concatenate([np.asarray(p[1], np.int64) for p in parts])
    order = np.argsort(kept, kind="stable")
    embeddings = np.concatenate([p[0] for p in parts], axis=0)[order]
    kept_records = [records[int(i)] for i in kept[order]]
    per_image = [t for p in parts for t in p[3]]
    per_image = [per_image[int(i)] for i in order]
    failures = [records[i].absolute_path for i in sorted(i for p in parts for i in p[2])]
    stats = run_sanity_checks(embeddings)
    probe = nearest_neighbor_probe(embeddings, kept_records, sample_size=cfg.neighbor_sample, seed=cfg.seed)
    return ExtractionSummary(
        embeddings=embeddings, records=kept_records, failures=failures, stats=stats, neighbor_probe=probe,
        total_seconds=max(p[4] for p in parts), per_image_seconds=per_image, weights_source=parts[0][6],
        embed_seconds=max(p[5] for p in parts),
    )


def _extract_local(
    records: List[ImageRecord],
    cfg: ExtractionConfig,
    store: Optional[ImageStore] = None,
    calibration: Optional[List[Path]] = None,
) -> ExtractionSummary:
    """``extract_embeddings`` in this process. ``calibration``: the int8
    calibration images (default: the first 32 of ``records``)."""
    if calibration is None:
        calibration = [r.absolute_path for r in records[:_CALIBRATION_IMAGES]]
    if cfg.fast_decode or cfg.host_preproc:
        from ssip_tpu_torch.native import decoder as native

        native.load()  # raises, naming what is missing, before any model or decode work
    device = resolve_device(cfg.device)
    int8 = cfg.compute_dtype == "int8"
    # the model that int8 calibrates and quantizes is the float32 one
    dtype = torch.float32 if int8 else compute_dtype(cfg.compute_dtype)
    configure_precision("float32" if int8 else cfg.compute_dtype)
    LOGGER.info("Extraction on %s (%s)", device_label(device), cfg.compute_dtype)

    model = build_model(cfg.arch, compute_dtype=dtype, image_size=cfg.crop)
    weights_source = _resolve_weights(cfg, model)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    if store is None and _should_stream(cfg, [r.absolute_path for r in records], compute_dataset_digest(records)):
        return _extract_streaming(records, cfg, model, dtype, weights_source, device, calibration)
    t_start = time.perf_counter()
    if store is None:
        digest = compute_dataset_digest(records)
        paths = [r.absolute_path for r in records]
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

    if int8:
        if calibration == [r.absolute_path for r in records[:_CALIBRATION_IMAGES]]:
            arrays = [store.get(int(i)) for i in valid if i < _CALIBRATION_IMAGES]
        else:
            arrays, _ = decode_batch(calibration, num_threads=cfg.num_decode_threads)
        model = _quantize_variables(cfg, model, arrays, device)
        weights_source += "+int8_ptq"
    embed = _embed_fn(cfg, model, dtype, cfg.resize)

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
    """Discover, embed and write the artifact set under ``cfg.output_dir``
    (rank 0 writes, and keeps the log file)."""
    reg = ArtifactRegistry(Path(cfg.output_dir))
    if is_primary():
        reg.logs_dir.mkdir(parents=True, exist_ok=True)
    configure_logging("DEBUG" if cfg.verbose else "INFO", log_file=reg.extraction_log if is_primary() else None)

    records = discover_image_records(Path(cfg.data_dir))
    LOGGER.info(
        "Discovered %d images (labeled=%d, unlabeled=%d)",
        len(records),
        sum(1 for r in records if r.bucket == "labeled"),
        sum(1 for r in records if r.bucket == "unlabeled"),
    )
    digest = compute_dataset_digest(records)
    summary = extract_embeddings(records, cfg, store=store)
    if is_primary():
        save_artifacts(summary, cfg, digest, device_label(resolve_device(cfg.device)))
    return summary
