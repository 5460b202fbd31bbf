"""Figures of the training runs: curves, confusion matrices, ROC and PR
curves, metric bars.

Counterpart of ``ssip_tpu/report/plots.py`` (reference common.py:509-644):
the same figures, sizes, labels, colour maps and layout, written as PNG at
dpi 200 under ``figures/``, with the curve data from the port's
``ops/metrics.py``. matplotlib is imported when a figure is drawn
(``report.pyplot``); ``available`` says whether it is installed, and the
training pipelines ask it once, before reading any data.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ssip_tpu_torch.ops.metrics import average_precision, confusion_matrix_2x2, pr_curve, roc_curve
from ssip_tpu_torch.report import pyplot

DPI = 200


def available() -> bool:
    """Whether matplotlib is installed (without importing it)."""
    return importlib.util.find_spec("matplotlib") is not None


def _save(fig, output_path: Path) -> None:
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=DPI)
    pyplot().close(fig)


def plot_training_curves(history: Dict[str, List[float]], output_path: Path, title: str) -> None:
    plt = pyplot()
    epochs = range(1, len(history["train_loss"]) + 1)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, metric, label in zip(axes, ("loss", "acc", "f1"), ("Loss", "Accuracy", "F1")):
        ax.plot(epochs, history[f"train_{metric}"], label="train")
        ax.plot(epochs, history[f"val_{metric}"], label="val")
        ax.set_xlabel("Epoch")
        ax.set_ylabel(label)
        ax.legend()
        ax.grid(alpha=0.3)
    fig.suptitle(f"{title} training curves")
    fig.tight_layout()
    _save(fig, output_path)


def plot_confusion_matrix(
    y_true: np.ndarray, y_pred: np.ndarray, class_names: Sequence[str], output_path: Path
) -> None:
    plt = pyplot()
    if len(class_names) == 2:
        cmat = confusion_matrix_2x2(np.asarray(y_true) == 1, np.asarray(y_pred) == 1)
    else:  # generic fallback
        k = len(class_names)
        cmat = np.zeros((k, k))
        for t, p in zip(y_true, y_pred):
            cmat[int(t), int(p)] += 1
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(cmat, cmap="Blues")
    for i in range(cmat.shape[0]):
        for j in range(cmat.shape[1]):
            ax.text(
                j, i, f"{int(cmat[i, j])}", ha="center", va="center",
                color="white" if cmat[i, j] > cmat.max() / 2 else "black",
            )
    ax.set_xticks(range(len(class_names)), class_names)
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.colorbar(im)
    fig.tight_layout()
    _save(fig, output_path)


def plot_roc_curves(curves: Dict[str, Tuple[np.ndarray, np.ndarray]], output_path: Path) -> None:
    """curves: name → (y_true_bin, y_prob)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5.5, 5))
    for name, (y_true_bin, y_prob) in curves.items():
        fpr, tpr, _ = roc_curve(y_true_bin, y_prob)
        auc = float(np.trapezoid(tpr, fpr))
        ax.plot(fpr, tpr, label=f"{name} (AUC={auc:.3f})")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.4)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC curves")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    _save(fig, output_path)


def plot_pr_curves(curves: Dict[str, Tuple[np.ndarray, np.ndarray]], output_path: Path) -> None:
    """curves: name → (y_true_bin, y_prob); AP in the legend, as the
    reference's PR figure (reference common.py:579-593)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(5.5, 5))
    for name, (y_true_bin, y_prob) in curves.items():
        precision, recall, _ = pr_curve(y_true_bin, y_prob)
        ap = average_precision(y_true_bin, y_prob)
        ax.plot(recall, precision, label=f"{name} (AP={ap:.3f})")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_title("Precision-Recall curves")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    _save(fig, output_path)


def plot_metrics_bars(metrics_map: Dict[str, Dict[str, float]], output_path: Path, keys: Sequence[str]) -> None:
    """One horizontal-bar panel per metric, the variants on the shared
    y-axis (the first on top), value labels at the bar ends."""
    plt = pyplot()
    variants = list(metrics_map.keys())
    y = np.arange(len(variants))[::-1]  # first variant on top
    n_panels = len(keys)
    fig, axes = plt.subplots(
        1, n_panels, figsize=(2.4 * n_panels + 1.2, 0.55 * len(variants) + 1.6), sharey=True,
    )
    if n_panels == 1:
        axes = [axes]
    cmap = plt.get_cmap("tab10")
    for panel, (ax, key) in enumerate(zip(axes, keys)):
        values = np.array([metrics_map[v].get(key, 0.0) or 0.0 for v in variants], float)
        ax.barh(y, values, height=0.62, color=cmap(panel % 10), alpha=0.85)
        for yi, val in zip(y, values):
            ax.annotate(
                f"{val:.2f}", (min(val, 0.84), yi), xytext=(3, 0),
                textcoords="offset points", va="center", fontsize=8,
            )
        ax.set_xlim(0.0, 1.0)
        ax.set_title(key, fontsize=10)
        ax.grid(axis="x", alpha=0.25)
        ax.tick_params(labelsize=8)
    axes[0].set_yticks(y, variants)
    fig.suptitle("Metric comparison across model variants")
    fig.tight_layout()
    _save(fig, output_path)
