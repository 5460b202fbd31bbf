"""Feature standardization: z-score embeddings into the clustering bundle.

Counterpart of ``ssip_tpu/analysis/standardize.py`` (reference
src/standardize_features.py:12-63): scikit-learn's StandardScaler as a mean
and a biased (ddof=0) standard deviation computed on ``device``, and the
``standardized_features.npz`` bundle with the key set the clustering stage
reads (features, paths, is_labeled, labels, scaler_mean, scaler_scale). The
embeddings CSV is read with the stdlib ``csv`` module.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ssip_tpu_torch.analysis.distances import float32_tensor
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)


def fit_scaler(features: np.ndarray, *, device: torch.device) -> Dict[str, np.ndarray]:
    x = float32_tensor(features, device)
    mean = x.mean(dim=0)
    std = (x - mean).square().mean(dim=0).sqrt()  # ddof=0 — StandardScaler's scale_
    # StandardScaler maps zero-variance dims to scale 1.0
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return {"mean": mean.cpu().numpy(), "scale": scale.cpu().numpy()}


def transform(features: np.ndarray, scaler: Dict[str, np.ndarray], *, device: torch.device) -> np.ndarray:
    x = float32_tensor(features, device)
    mean = float32_tensor(scaler["mean"], device)
    scale = float32_tensor(scaler["scale"], device)
    return ((x - mean) / scale).cpu().numpy().astype(np.float32)


def read_embeddings_csv(csv_path: Path) -> list[dict]:
    """The CSV's rows sorted by their ``index`` column."""
    with open(csv_path, newline="", encoding="utf-8") as fh:
        reader = csv.DictReader(fh)
        missing = {"index", "path", "bucket", "label"} - set(reader.fieldnames or [])
        if missing:
            raise KeyError(f"Embeddings CSV missing columns: {', '.join(sorted(missing))}")
        rows = list(reader)
    return sorted(rows, key=lambda row: int(row["index"]))


def standardize_embeddings(
    embeddings_path: Path, csv_path: Path, output_path: Path, *, device: torch.device
) -> None:
    embeddings_path, csv_path = Path(embeddings_path), Path(csv_path)
    if not embeddings_path.exists():
        raise FileNotFoundError(f"Embeddings file not found: {embeddings_path}")
    if not csv_path.exists():
        raise FileNotFoundError(f"Embeddings CSV not found: {csv_path}")

    E = np.load(embeddings_path)
    if E.ndim != 2:
        raise ValueError(f"Embeddings must be 2D [N, D], got shape {E.shape}")

    rows = read_embeddings_csv(csv_path)
    if len(rows) != E.shape[0]:
        raise ValueError(f"Row count mismatch between CSV ({len(rows)}) and embeddings ({E.shape[0]})")

    scaler = fit_scaler(E.astype(np.float32), device=device)
    Z = transform(E.astype(np.float32), scaler, device=device)

    paths = np.asarray([row["path"] for row in rows], dtype=np.str_)
    is_labeled = np.asarray([row["bucket"] == "labeled" for row in rows], dtype=bool)
    labels = np.asarray([row["label"] if lab else "" for row, lab in zip(rows, is_labeled)], dtype=np.str_)

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        output_path,
        features=Z.astype(np.float32),
        paths=paths,
        is_labeled=is_labeled,
        labels=labels,
        scaler_mean=scaler["mean"].astype(np.float32),
        scaler_scale=scaler["scale"].astype(np.float32),
    )
    LOGGER.info("Wrote standardized bundle: %s (N=%d, D=%d)", output_path, Z.shape[0], Z.shape[1])
