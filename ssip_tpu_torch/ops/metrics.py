"""Classification metrics in numpy.

Counterpart of ``ssip_tpu/ops/metrics.py:18-164``, which computes them with
``jax.numpy``. Counts and ratios are float32 with the same operations in the
same order, so the values are the JAX package's to the bit. Semantics are
scikit-learn's binary ``precision_recall_fscore_support(average="binary",
zero_division=0)``: an undefined ratio is 0.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np

_F32 = np.float32


def _safe_div(num, den):
    num, den = _F32(num), _F32(den)
    return num / den if den > 0 else _F32(0.0)


def binary_counts(y_true_bin: np.ndarray, y_pred_bin: np.ndarray):
    """(tp, fp, tn, fn) as float32 for {0, 1} arrays."""
    t = np.asarray(y_true_bin).astype(np.int32)
    p = np.asarray(y_pred_bin).astype(np.int32)
    tp = _F32(np.sum((t == 1) & (p == 1)))
    fp = _F32(np.sum((t == 0) & (p == 1)))
    tn = _F32(np.sum((t == 0) & (p == 0)))
    fn = _F32(np.sum((t == 1) & (p == 0)))
    return tp, fp, tn, fn


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> np.float32:
    """Share of equal labels, as XLA computes ``jnp.mean`` on the CPU: the
    count times the float32 reciprocal of n (not a division, which differs
    in the last bit for some n)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.shape[-1] == 0:
        return _F32(0.0)
    return _F32(np.sum(y_true == y_pred)) * (_F32(1.0) / _F32(y_true.shape[-1]))


def precision_recall_f1(y_true_bin: np.ndarray, y_pred_bin: np.ndarray):
    """Binary precision/recall/F1 with zero_division=0 semantics."""
    tp, fp, _tn, fn = binary_counts(y_true_bin, y_pred_bin)
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    f1 = _safe_div(_F32(2) * precision * recall, precision + recall)
    return precision, recall, f1


def accuracy_f1(y_true: np.ndarray, y_pred: np.ndarray) -> tuple[float, float]:
    """(accuracy over the raw labels, F1 of class 1 as the positive)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.shape[-1] == 0:
        return 0.0, 0.0
    _, _, f1 = precision_recall_f1(y_true == 1, y_pred == 1)
    return float(accuracy(y_true, y_pred)), float(f1)


def confusion_matrix_2x2(y_true_bin: np.ndarray, y_pred_bin: np.ndarray) -> np.ndarray:
    """[[tn, fp], [fn, tp]] in float32: scikit-learn's labels=[0, 1] layout."""
    tp, fp, tn, fn = binary_counts(y_true_bin, y_pred_bin)
    return np.array([[tn, fp], [fn, tp]], np.float32)


def binary_confusion_metrics(y_true: np.ndarray, y_pred: np.ndarray, pos_index: int) -> Dict[str, float]:
    """Confusion-derived metrics, with the key set of
    ``results_comparison_detailed.csv``."""
    tp, fp, tn, fn = binary_counts(np.asarray(y_true) == pos_index, np.asarray(y_pred) == pos_index)
    tpr = _safe_div(tp, tp + fn)
    return {
        "TP": float(tp),
        "FP": float(fp),
        "TN": float(tn),
        "FN": float(fn),
        "TPR": float(tpr),
        "TNR": float(_safe_div(tn, tn + fp)),
        "FPR": float(_safe_div(fp, fp + tn)),
        "FNR": float(_safe_div(fn, fn + tp)),
        "precision": float(_safe_div(tp, tp + fp)),
        "recall": float(tpr),
        "accuracy": float((tp + tn) / max(_F32(1.0), tp + tn + fp + fn)),
    }


def _ranked(y_true_bin: np.ndarray, y_prob: np.ndarray):
    """Cumulative (tps, fps) and scores at the last index of each distinct
    score, by descending score."""
    y_true_bin = np.asarray(y_true_bin).astype(np.int32)
    y_prob = np.asarray(y_prob, dtype=np.float64)
    order = np.argsort(-y_prob, kind="stable")
    yt, ys = y_true_bin[order], y_prob[order]
    distinct = np.r_[np.nonzero(np.diff(ys))[0], yt.size - 1]
    return np.cumsum(yt)[distinct], np.cumsum(1 - yt)[distinct], ys[distinct], y_true_bin


def roc_curve(y_true_bin: np.ndarray, y_prob: np.ndarray):
    """(fpr, tpr, thresholds); a rate whose class is absent is NaN."""
    tps, fps, thr, y_true_bin = _ranked(y_true_bin, y_prob)
    tps, fps, thr = np.r_[0, tps], np.r_[0, fps], np.r_[np.inf, thr]
    p = int(y_true_bin.sum())
    n = int((1 - y_true_bin).sum())
    if p == 0 or n == 0:
        side = "positive" if p == 0 else "negative"
        warnings.warn(f"roc_curve: no {side} samples — the corresponding rate is NaN", UserWarning)
    fpr = fps / n if n else np.full(fps.shape, np.nan)
    tpr = tps / p if p else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def pr_curve(y_true_bin: np.ndarray, y_prob: np.ndarray):
    """(precision, recall, thresholds) in scikit-learn's orientation, with
    the (precision 1, recall 0) end point appended."""
    tps, fps, thr, y_true_bin = _ranked(y_true_bin, y_prob)
    denom = tps + fps
    precision = np.where(denom > 0, tps / np.maximum(denom, 1), 0.0)
    recall = tps / max(int(y_true_bin.sum()), 1)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def average_precision(y_true_bin: np.ndarray, y_prob: np.ndarray) -> float:
    """AP = Σ (Rₙ − Rₙ₋₁)·Pₙ over the PR curve, scikit-learn's
    ``average_precision_score`` (the PR figure's legend): recall falls
    along ``pr_curve``'s points, hence the sign."""
    precision, recall, _ = pr_curve(y_true_bin, y_prob)
    return float(-np.sum(np.diff(recall) * precision[:-1]))
