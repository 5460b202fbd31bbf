"""Clustering figures: 2-D embedding overlays and k-distance curves.

Counterpart of ``ssip_tpu/report/cluster_plots.py`` (reference
clustering.py:461-563): ``{pca2d,tsne2d,umap2d}_clusters.png`` (cluster
coloring beside the true-label overlay) and ``kdist_plot_*.png``, whose
curve is computed on ``device``. matplotlib is imported when a figure is
drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ssip_tpu_torch.analysis.clustering import EmbeddingResult, FeatureBundle
from ssip_tpu_torch.analysis.dbscan import k_distance_curve
from ssip_tpu_torch.report import pyplot

DPI = 200


def plot_embedding(
    embedding: EmbeddingResult,
    bundle: FeatureBundle,
    cluster_labels: np.ndarray,
    labeled_title: str,
    output_path: Path,
    dbscan_noise_rate: Optional[float] = None,
) -> None:
    plt = pyplot()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))

    # left: cluster coloring (noise = grey x)
    xy = embedding.data
    noise = cluster_labels == -1
    axes[0].scatter(
        xy[~noise, 0], xy[~noise, 1], c=cluster_labels[~noise],
        cmap="tab10", s=12, alpha=0.8,
    )
    if noise.any():
        axes[0].scatter(
            xy[noise, 0], xy[noise, 1], c="lightgrey", marker="x", s=12, alpha=0.6
        )
    axes[0].set_title(f"{embedding.name} — clusters")

    # right: true-label overlay (unlabeled grey background)
    mask = bundle.labeled_mask
    axes[1].scatter(
        xy[~mask, 0], xy[~mask, 1], c="lightgrey", s=8, alpha=0.4, label="unlabeled"
    )
    for value in sorted(set(bundle.labels[mask])):
        sel = mask & (bundle.labels == value)
        axes[1].scatter(xy[sel, 0], xy[sel, 1], s=16, alpha=0.9, label=value)
    axes[1].set_title(labeled_title)
    axes[1].legend(loc="best", fontsize=8)

    if dbscan_noise_rate is not None:
        fig.suptitle(f"DBSCAN noise rate: {dbscan_noise_rate:.2%}", fontsize=10)
    fig.savefig(output_path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def plot_k_distance(
    embedding: EmbeddingResult, min_samples: int, output_path: Path, *, device: torch.device
) -> None:
    plt = pyplot()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    # self-inclusive kNN semantics — the SAME curve auto_eps_from_kdistance
    # takes its quantile from, so eps can be read off this plot
    curve = k_distance_curve(
        embedding.data, max(int(min_samples), 1), include_self=True, device=device
    )
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(curve)
    ax.set_xlabel("Points (sorted)")
    ax.set_ylabel(f"{min_samples}-NN distance")
    ax.set_title("DBSCAN k-distance curve")
    ax.grid(alpha=0.3)
    fig.savefig(output_path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)
