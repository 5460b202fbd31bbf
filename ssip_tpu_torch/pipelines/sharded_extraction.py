"""Sharded, resumable embedding extraction (``--shard-size N``).

Counterpart of ``ssip_tpu/pipelines/sharded_extraction.py:1-179``, with its
files, keys and rules:

- the corpus (discovery order) is split into shards of ``shard_size``
  records; each shard's embeddings land in
  ``features/shards/shard_{i:05d}.npy`` beside a manifest
  (``shard_{i:05d}.manifest.json``) with ``complete``, ``digest`` (sha256
  over the members' relative paths and sizes, 16 hex digits), ``rows``,
  ``embedded_rows``, ``failures`` and ``weights``;
- a re-run reuses every shard whose manifest verifies (complete, same
  digest, same row count, an ``.npy`` of ``embedded_rows`` rows) and
  recomputes the others (a changed member, a missing or unreadable
  manifest);
- the shards merge into the standard artifact set, the one
  ``run_extraction`` writes, with ``weights`` ``"sharded"``.

Under a process group each shard is embedded data parallel
(``extraction.extract_embeddings``); rank 0 decides reuse (its decision is
sent to every rank), writes the shard files and the artifacts.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ssip_tpu_torch.data.discovery import ImageRecord, compute_dataset_digest, discover_image_records
from ssip_tpu_torch.parallel.distributed import is_primary, world_size
from ssip_tpu_torch.pipelines.extraction import (
    ExtractionConfig, ExtractionSummary, extract_embeddings, nearest_neighbor_probe, run_sanity_checks,
    save_artifacts,
)
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from ssip_tpu_torch.runtime.device import device_label, resolve_device
from ssip_tpu_torch.runtime.logging import configure_logging, get_logger

LOGGER = get_logger(__name__)


def _shard_digest(records: Sequence[ImageRecord]) -> str:
    hasher = hashlib.sha256()
    for r in records:
        stat = r.absolute_path.stat()
        hasher.update(str(r.relative_path).encode())
        hasher.update(str(stat.st_size).encode())
    return hasher.hexdigest()[:16]


def shard_paths(shards_dir: Path, index: int) -> tuple[Path, Path]:
    return (
        shards_dir / f"shard_{index:05d}.npy",
        shards_dir / f"shard_{index:05d}.manifest.json",
    )


def shard_is_complete(shards_dir: Path, index: int, records: Sequence[ImageRecord]) -> bool:
    npy, manifest_path = shard_paths(shards_dir, index)
    if not (npy.exists() and manifest_path.exists()):
        return False
    try:
        manifest = json.loads(manifest_path.read_text())
        if not manifest.get("complete"):
            return False
        if manifest.get("digest") != _shard_digest(records):
            LOGGER.warning("Shard %d digest changed — recomputing", index)
            return False
        if manifest.get("rows") != len(records):
            return False
        # shards with decode failures carry fewer embedded rows than member
        # records: check against the manifest's own count so they still resume
        arr = np.load(npy, mmap_mode="r")
        return arr.shape[0] == int(manifest.get("embedded_rows", len(records)))
    except Exception as exc:  # noqa: BLE001 — any corruption → recompute
        LOGGER.warning("Shard %d manifest unreadable (%s) — recomputing", index, exc)
        return False


def _agreed(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank."""
    if world_size() == 1:
        return flag
    import torch.distributed as dist

    box = [flag]
    dist.broadcast_object_list(box, src=0)
    return bool(box[0])


def run_sharded_extraction(cfg: ExtractionConfig, shard_size: int = 512) -> ExtractionSummary:
    """Resumable extraction; the same artifact set as ``run_extraction``."""
    if shard_size <= 0:
        raise ValueError(f"shard_size must be positive, got {shard_size}")
    reg = ArtifactRegistry(Path(cfg.output_dir))
    if is_primary():
        reg.logs_dir.mkdir(parents=True, exist_ok=True)
    configure_logging("DEBUG" if cfg.verbose else "INFO", log_file=reg.extraction_log if is_primary() else None)
    records = discover_image_records(Path(cfg.data_dir))
    digest = compute_dataset_digest(records)
    shards_dir = Path(cfg.output_dir) / "features" / "shards"
    if is_primary():
        shards_dir.mkdir(parents=True, exist_ok=True)

    shards: List[List[ImageRecord]] = [
        list(records[i : i + shard_size]) for i in range(0, len(records), shard_size)
    ]
    LOGGER.info("Extraction over %d shards of ≤%d images", len(shards), shard_size)

    all_chunks: List[np.ndarray] = []
    kept_records: List[ImageRecord] = []
    failures: List[Path] = []
    total_seconds = embed_seconds = 0.0
    per_image: List[float] = []

    for index, shard_records in enumerate(shards):
        npy, manifest_path = shard_paths(shards_dir, index)
        if _agreed(is_primary() and shard_is_complete(shards_dir, index, shard_records)):
            LOGGER.info("Shard %d/%d: reusing completed shard", index + 1, len(shards))
            manifest = json.loads(manifest_path.read_text())
            shard_failures = [str(p) for p in manifest.get("failures", [])]
            failure_set = set(shard_failures)
            all_chunks.append(np.load(npy))
            kept_records.extend(r for r in shard_records if str(r.absolute_path) not in failure_set)
            # the manifest's (ordered) list keeps feature_summary.md stable
            failures.extend(Path(p) for p in shard_failures)
            continue
        LOGGER.info("Shard %d/%d: extracting %d images", index + 1, len(shards), len(shard_records))
        summary = extract_embeddings(shard_records, cfg)
        if summary.embeddings.shape[0] != len(shard_records):
            LOGGER.warning("Shard %d: %d decode failures", index, len(summary.failures))
        if is_primary():
            np.save(npy, summary.embeddings.astype(np.float32))
            manifest_path.write_text(json.dumps({
                "complete": True,
                "digest": _shard_digest(shard_records),
                "rows": len(shard_records),
                "embedded_rows": int(summary.embeddings.shape[0]),
                "failures": [str(p) for p in summary.failures],
                "weights": summary.weights_source,
            }))
        all_chunks.append(summary.embeddings)
        kept_records.extend(summary.records)
        failures.extend(summary.failures)
        total_seconds += summary.total_seconds
        embed_seconds += summary.embed_seconds
        per_image.extend(summary.per_image_seconds)

    embeddings = np.concatenate(all_chunks, axis=0)
    stats = run_sanity_checks(embeddings)
    probe = nearest_neighbor_probe(embeddings, kept_records, sample_size=cfg.neighbor_sample, seed=cfg.seed)
    summary = ExtractionSummary(
        embeddings=embeddings,
        records=kept_records,
        failures=failures,
        stats=stats,
        neighbor_probe=probe,
        total_seconds=total_seconds,
        per_image_seconds=per_image,
        weights_source="sharded",
        embed_seconds=embed_seconds,
    )
    if is_primary():
        save_artifacts(summary, cfg, digest, device_label(resolve_device(cfg.device)))
    return summary
