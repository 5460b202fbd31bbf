"""Clustering analysis pipeline: PCA space → embeddings → K-Means/DBSCAN.

Counterpart of ``ssip_tpu/analysis/clustering.py`` (reference
src/clustering.py; SURVEY.md §3.4): the heavy math — SVD, pairwise
distances, Lloyd sweeps, t-SNE/UMAP optimization, silhouette — runs on
``device`` through this package's modules; the orchestration, artifact
schema (metrics_clustering.csv, cluster_assignments.csv, per-embedding
.npz, clustering_report.md), grids, scope rules and best-config selection
(ARI, NMI, silhouette desc) are the JAX package's. The two tables are
written with the stdlib ``csv`` module in the text pandas writes.
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssip_tpu_torch.analysis.cluster_metrics import (
    adjusted_rand_index,
    normalized_mutual_info,
    silhouette_score,
)
from ssip_tpu_torch.analysis.dbscan import dbscan
from ssip_tpu_torch.analysis.kmeans import kmeans
from ssip_tpu_torch.analysis.pca import components_for_variance, fit_pca
from ssip_tpu_torch.analysis.tsne import tsne as run_tsne_single
from ssip_tpu_torch.analysis.umap import umap as run_umap_single
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)


# -- data containers (schema parity: reference clustering.py:64-109) ---------


@dataclass(frozen=True)
class FeatureBundle:
    features: np.ndarray
    paths: np.ndarray
    is_labeled: np.ndarray
    labels: np.ndarray
    scaler_mean: Optional[np.ndarray]
    scaler_scale: Optional[np.ndarray]

    @property
    def labeled_mask(self) -> np.ndarray:
        return self.is_labeled.astype(bool)

    @property
    def unlabeled_mask(self) -> np.ndarray:
        return ~self.labeled_mask


@dataclass(frozen=True)
class EmbeddingResult:
    name: str
    data: np.ndarray
    params: Dict[str, object]


@dataclass(frozen=True)
class ClusteringResult:
    method: str
    space: str
    labels: np.ndarray
    params: Dict[str, object]
    ari: float
    nmi: float
    silhouette: float
    noise_rate: float
    seed: int


@dataclass(frozen=True)
class PCAResults:
    cluster_space: EmbeddingResult
    pca_2d: EmbeddingResult
    pca_tsne_init: EmbeddingResult


# -- loading ------------------------------------------------------------------


def load_feature_bundle(path: Path) -> FeatureBundle:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Feature bundle not found: {path}")
    with np.load(path, allow_pickle=False) as data:
        required = {"features", "paths", "is_labeled", "labels"}
        missing = required - set(data.files)
        if missing:
            raise KeyError(f"Feature bundle missing keys: {sorted(missing)}")
        features = np.asarray(data["features"], np.float32)
        paths = np.asarray(data["paths"]).astype(str)
        is_labeled = np.asarray(data["is_labeled"]).astype(bool)
        labels = np.asarray(data["labels"]).astype(str)
        if not (len(features) == len(paths) == len(is_labeled) == len(labels)):
            raise ValueError("Feature bundle arrays have mismatched lengths")
        scaler_mean = (
            np.asarray(data["scaler_mean"]) if "scaler_mean" in data.files else None
        )
        scaler_scale = (
            np.asarray(data["scaler_scale"]) if "scaler_scale" in data.files else None
        )
    return FeatureBundle(features, paths, is_labeled, labels, scaler_mean, scaler_scale)


def validate_standardization(bundle: FeatureBundle) -> Dict[str, Dict[str, float]]:
    """mean|μ| / mean σ per subset — scaler correctness check
    (reference clustering.py:172-192)."""
    stats: Dict[str, Dict[str, float]] = {}
    for name, mask in (
        ("labeled", bundle.labeled_mask),
        ("unlabeled", bundle.unlabeled_mask),
    ):
        if mask.sum() == 0:
            continue
        sub = bundle.features[mask]
        stats[name] = {
            "mean_abs_mean": float(np.abs(sub.mean(axis=0)).mean()),
            "mean_std": float(sub.std(axis=0).mean()),
        }
    return stats


# -- spaces -------------------------------------------------------------------


def run_pca(
    features: np.ndarray, variance_target: float, tsne_dim: int, seed: int, *, device: torch.device
) -> PCAResults:
    model = fit_pca(features, device=device)
    projected = model.transform(features)
    k = components_for_variance(model, variance_target)
    k = max(2, min(k, projected.shape[1]))
    cumulative = float(np.cumsum(model.explained_variance_ratio)[k - 1])
    LOGGER.info(
        "Selected %d PCA components to reach %.2f%% explained variance",
        k, cumulative * 100,
    )
    tsne_components = min(tsne_dim, projected.shape[1])
    return PCAResults(
        cluster_space=EmbeddingResult(
            "pca_cluster", projected[:, :k],
            {"variance_target": variance_target, "components": k},
        ),
        pca_2d=EmbeddingResult("pca_2d", projected[:, :2], {"components": 2}),
        pca_tsne_init=EmbeddingResult(
            "pca_tsne_init", projected[:, :tsne_components],
            {"components": tsne_components},
        ),
    )


def run_tsne(
    base: EmbeddingResult, perplexities: Sequence[float], seed: int, *, device: torch.device
) -> List[EmbeddingResult]:
    results = []
    for perplexity in perplexities:
        LOGGER.info("Running t-SNE (perplexity=%s)", perplexity)
        emb = run_tsne_single(base.data, perplexity=float(perplexity), seed=seed, device=device)
        results.append(
            EmbeddingResult(
                f"tsne_perp{int(perplexity)}", emb,
                {"perplexity": float(perplexity), "seed": seed},
            )
        )
    return results


def run_umap(
    base: EmbeddingResult,
    neighbor_values: Sequence[int],
    min_dists: Sequence[float],
    seed: int,
    *,
    device: torch.device,
) -> List[EmbeddingResult]:
    results = []
    for n_neighbors in neighbor_values:
        for min_dist in min_dists:
            LOGGER.info(
                "Running UMAP (n_neighbors=%s, min_dist=%.2f)", n_neighbors, min_dist
            )
            emb = run_umap_single(
                base.data, n_neighbors=int(n_neighbors), min_dist=float(min_dist),
                seed=seed, device=device,
            )
            results.append(
                EmbeddingResult(
                    f"umap_nn{int(n_neighbors)}_md{min_dist:.2f}", emb,
                    {
                        "n_neighbors": int(n_neighbors),
                        "min_dist": float(min_dist),
                        "seed": seed,
                    },
                )
            )
    return results


# -- metrics ------------------------------------------------------------------


def compute_external_metrics(
    bundle: FeatureBundle, predicted: np.ndarray
) -> Tuple[float, float]:
    mask = bundle.labeled_mask
    if np.count_nonzero(mask) == 0:
        return float("nan"), float("nan")
    return (
        adjusted_rand_index(bundle.labels[mask], predicted[mask]),
        normalized_mutual_info(bundle.labels[mask], predicted[mask]),
    )


def compute_silhouette(space: np.ndarray, labels: np.ndarray, *, device: torch.device) -> float:
    if np.unique(labels).size < 2:
        return float("nan")
    try:
        return silhouette_score(space, labels, device=device)
    except ValueError:
        return float("nan")


# -- sweeps -------------------------------------------------------------------


def evaluate_kmeans(
    space: EmbeddingResult,
    bundle: FeatureBundle,
    k_values: Sequence[int],
    n_init: int,
    seed: int,
    *,
    device: torch.device,
) -> List[ClusteringResult]:
    results = []
    for k in k_values:
        if k < 2:
            continue
        LOGGER.info("Fitting K-Means with k=%s", k)
        model = kmeans(space.data, int(k), n_init=int(n_init), seed=seed, device=device)
        ari, nmi = compute_external_metrics(bundle, model.labels)
        results.append(
            ClusteringResult(
                method="kmeans",
                space=space.name,
                labels=model.labels,
                params={"k": int(k), "n_init": int(n_init)},
                ari=ari,
                nmi=nmi,
                silhouette=compute_silhouette(space.data, model.labels, device=device),
                noise_rate=0.0,
                seed=seed,
            )
        )
    return results


def scope_mask(bundle: FeatureBundle, scope: str) -> np.ndarray:
    """The rows a DBSCAN ``--dbscan-scope`` clusters."""
    if scope not in {"all", "labeled", "unlabeled"}:
        raise ValueError("scope must be one of: all, labeled, unlabeled")
    if scope == "labeled":
        return bundle.labeled_mask
    if scope == "unlabeled":
        return bundle.unlabeled_mask
    return np.ones(bundle.features.shape[0], dtype=bool)


def evaluate_dbscan(
    space: EmbeddingResult,
    bundle: FeatureBundle,
    eps_values: Sequence[float],
    min_samples_values: Sequence[int],
    seed: int,
    scope: str = "all",
    *,
    device: torch.device,
) -> List[ClusteringResult]:
    mask = scope_mask(bundle, scope)
    sub_space = space.data[mask]

    results = []
    for eps in eps_values:
        for min_samples in min_samples_values:
            LOGGER.info(
                "Fitting DBSCAN (scope=%s) with eps=%.3f, min_samples=%s",
                scope, eps, min_samples,
            )
            fit = dbscan(sub_space, float(eps), int(min_samples), device=device)
            labels_full = np.full(space.data.shape[0], -1, dtype=int)
            labels_full[mask] = fit.labels
            ari, nmi = compute_external_metrics(bundle, labels_full)
            results.append(
                ClusteringResult(
                    method="dbscan",
                    space=f"{space.name}:{scope}",
                    labels=labels_full,
                    params={
                        "eps": float(eps),
                        "min_samples": int(min_samples),
                        "scope": scope,
                    },
                    ari=ari,
                    nmi=nmi,
                    silhouette=compute_silhouette(sub_space, fit.labels, device=device),
                    noise_rate=fit.noise_rate,
                    seed=seed,
                )
            )
    return results


def choose_best(results: Sequence[ClusteringResult]) -> Optional[ClusteringResult]:
    """Sort by (ARI, NMI, silhouette) desc, NaN → -1 (reference :441-453)."""
    if not results:
        return None
    return max(
        results,
        key=lambda r: (
            np.nan_to_num(r.ari, nan=-1.0),
            np.nan_to_num(r.nmi, nan=-1.0),
            np.nan_to_num(r.silhouette, nan=-1.0),
        ),
    )


# -- artifacts ----------------------------------------------------------------


def save_embedding_npz(root: Path, result: EmbeddingResult) -> None:
    root.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        root / f"{result.name}.npz",
        data=result.data.astype(np.float32),
        params=json.dumps(result.params, sort_keys=True),
    )


def _csv_cell(value):
    """A value as pandas' ``to_csv`` writes it: NaN as an empty cell."""
    if isinstance(value, float) and math.isnan(value):
        return ""
    return value


def _write_table(output_path: Path, columns: Sequence[str], rows) -> None:
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([_csv_cell(v) for v in row] for row in rows)


METRICS_COLUMNS = ("method", "space", "params_json", "ARI", "NMI", "silhouette", "noise_rate", "seed")
ASSIGNMENT_COLUMNS = (
    "path", "cluster_kmeans", "cluster_dbscan", "pca_dim", "tsne_id", "umap_id", "is_labeled", "true_label",
)


def write_metrics_table(results: Sequence[ClusteringResult], output_path: Path) -> None:
    _write_table(output_path, METRICS_COLUMNS, (
        (r.method, r.space, json.dumps(r.params, sort_keys=True), float(r.ari), float(r.nmi),
         float(r.silhouette), float(r.noise_rate), r.seed)
        for r in results
    ))


def write_assignments_table(
    bundle: FeatureBundle,
    kmeans_result: ClusteringResult,
    dbscan_result: Optional[ClusteringResult],
    pca_results: PCAResults,
    tsne_choice: EmbeddingResult,
    umap_choice: EmbeddingResult,
    output_path: Path,
) -> None:
    dbscan_labels = dbscan_result.labels if dbscan_result else np.full_like(kmeans_result.labels, -1)
    pca_dim = pca_results.cluster_space.data.shape[1]
    _write_table(output_path, ASSIGNMENT_COLUMNS, (
        (path, int(km), int(db), pca_dim, tsne_choice.name, umap_choice.name, bool(lab), label)
        for path, km, db, lab, label in zip(
            bundle.paths, kmeans_result.labels, dbscan_labels, bundle.is_labeled, bundle.labels
        )
    ))


def write_report(
    output_path: Path,
    standardization_stats: Dict[str, Dict[str, float]],
    kmeans_best: ClusteringResult,
    dbscan_best: Optional[ClusteringResult],
) -> None:
    output_path.parent.mkdir(parents=True, exist_ok=True)
    lines = ["# Clustering Analysis Report", ""]
    lines.append("## Standardization Checks")
    for subset, stats in standardization_stats.items():
        formatted = ", ".join(f"{k}={v:.4f}" for k, v in stats.items())
        lines.append(f"- {subset}: {formatted}")
    lines.append("")
    lines.append("## Best K-Means Configuration")
    lines.append(f"- Params: {json.dumps(kmeans_best.params, sort_keys=True)}")
    lines.append(
        f"- ARI={kmeans_best.ari:.4f}, NMI={kmeans_best.nmi:.4f}, "
        f"silhouette={kmeans_best.silhouette:.4f}"
    )
    lines.append("")
    lines.append("## Best DBSCAN Configuration")
    if dbscan_best is not None:
        lines.append(f"- Params: {json.dumps(dbscan_best.params, sort_keys=True)}")
        lines.append(
            f"- ARI={dbscan_best.ari:.4f}, NMI={dbscan_best.nmi:.4f}, "
            f"silhouette={dbscan_best.silhouette:.4f}, "
            f"noise_rate={dbscan_best.noise_rate:.4f}"
        )
    else:
        lines.append("- No viable DBSCAN configuration identified.")
    lines.append("")
    lines.append("## Notes")
    lines.append(
        "- ARI/NMI computed on labeled subset only; silhouette on full PCA space."
    )
    lines.append("- See tables and figures under `outputs/` for further details.")
    lines.append("")
    output_path.write_text("\n".join(lines), encoding="utf-8")
