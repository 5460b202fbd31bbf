"""Image discovery: the dataset's on-disk contract.

Layout convention (reference: docs/dataset.md, README): a data root holding
``avec_labels/{class}/*.jpg`` (labeled, ImageFolder-style) and
``sans_label/*.jpg`` (unlabeled, flat). Discovery order is part of the
artifact contract — ``embeddings.csv`` row order must be reproducible —
so everything is sorted (semantics: reference feature_extraction.py:125-181).

The port's own copy of ``ssip_tpu/data/discovery.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

LABELED_BUCKET = "avec_labels"
UNLABELED_BUCKET = "sans_label"
# Suffixes accepted for flat unlabeled dirs (reference common.py:152-174).
IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp"}


@dataclass(frozen=True)
class ImageRecord:
    absolute_path: Path
    relative_path: Path
    bucket: str  # "labeled" | "unlabeled"
    label: Optional[str]


def discover_image_records(data_dir: Path) -> List[ImageRecord]:
    """Labeled bucket (sorted class dirs, sorted rglob) then unlabeled."""
    data_dir = Path(data_dir)
    if not data_dir.exists():
        raise FileNotFoundError(f"Data directory not found: {data_dir}")

    records: List[ImageRecord] = []
    labeled_root = data_dir / LABELED_BUCKET
    if labeled_root.exists():
        for label_dir in sorted(p for p in labeled_root.iterdir() if p.is_dir()):
            for path in sorted(label_dir.rglob("*")):
                if path.is_file():
                    records.append(
                        ImageRecord(
                            absolute_path=path,
                            relative_path=path.relative_to(data_dir),
                            bucket="labeled",
                            label=label_dir.name,
                        )
                    )

    unlabeled_root = data_dir / UNLABELED_BUCKET
    if unlabeled_root.exists():
        for path in sorted(unlabeled_root.rglob("*")):
            if path.is_file():
                records.append(
                    ImageRecord(
                        absolute_path=path,
                        relative_path=path.relative_to(data_dir),
                        bucket="unlabeled",
                        label=None,
                    )
                )

    if not records:
        raise RuntimeError(f"No image files discovered under {data_dir}")
    return records


def labeled_folder(root: Path) -> Tuple[List[Path], List[int], List[str]]:
    """ImageFolder semantics: (paths, targets, classes).

    Classes are the sorted subdirectory names; class index = sorted position
    (so ``cancer``=0, ``normal``=1 for this dataset). Files sorted per class.
    """
    root = Path(root)
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    if not classes:
        raise RuntimeError(f"No class directories under {root}")
    paths: List[Path] = []
    targets: List[int] = []
    for idx, cls in enumerate(classes):
        for path in sorted((root / cls).rglob("*")):
            if path.is_file() and path.suffix.lower() in IMAGE_SUFFIXES:
                paths.append(path)
                targets.append(idx)
    if not paths:
        raise RuntimeError(f"No images found under {root}")
    return paths, targets, classes


def unlabeled_files(root: Path) -> List[Path]:
    """Flat unlabeled dir with suffix filter, sorted."""
    root = Path(root)
    if not root.exists():
        raise FileNotFoundError(f"Unlabeled directory not found: {root}")
    return sorted(
        p for p in root.iterdir() if p.is_file() and p.suffix.lower() in IMAGE_SUFFIXES
    )


def compute_dataset_digest(records: Sequence[ImageRecord]) -> str:
    """sha256 over (relpath, size, mtime) — dataset-drift guard.

    Byte-compatible with reference feature_extraction.py:316-331 so digests
    recorded in metadata.json are comparable across frameworks.
    """
    hasher = hashlib.sha256()
    for record in sorted(records, key=lambda r: str(r.relative_path)):
        stat = record.absolute_path.stat()
        hasher.update(str(record.relative_path).encode("utf-8"))
        hasher.update(str(stat.st_size).encode("utf-8"))
        hasher.update(str(int(stat.st_mtime)).encode("utf-8"))
    return hasher.hexdigest()
