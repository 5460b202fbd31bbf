"""Recall-first operating-threshold calibration, vectorized over thresholds.

Re-implements the decision layer of the reference (policy semantics:
src/training/common.py:651-746; sweep: src/threshold_sweep.py:41-70) as one
``[T, N]`` broadcast instead of a Python loop over thresholds: every
candidate threshold's confusion counts are computed in a single f64 pass, and
the 3-tier policy (constrained → F-beta fallback → recall-only → min
threshold) reduces over the ``T`` axis.

Policies (names are part of the artifact contract — ``operating_point.json``
records them):
  - ``constrained``  : largest threshold meeting recall ≥ target and the
                       optional min-precision / max-FPR constraints
  - ``fbeta``        : if no feasible threshold, the (F-beta, threshold)
                       lexicographic argmax (beta>1 favors recall)
  - ``recall_only``  : if every F-beta is 0, largest threshold with
                       recall ≥ target
  - ``min_threshold``: degenerate fallback, smallest candidate
  - ``no_positives`` : validation set has no positive example

The port's own copy of ``ssip_tpu/ops/thresholds.py`` (numpy only; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

_EPS = 1e-12


def candidate_thresholds(y_prob: np.ndarray, include_one: bool = True) -> np.ndarray:
    """Sorted unique candidates: {0} ∪ probs (∪ {1})."""
    extra = [0.0, 1.0] if include_one else [0.0]
    return np.unique(np.concatenate([np.asarray(extra), np.asarray(y_prob, dtype=np.float64)]))


def stats_for_thresholds(
    y_true_bin, y_prob, thresholds
) -> Dict[str, np.ndarray]:
    """Confusion stats at every threshold in one [T, N] broadcast.

    Host numpy in FULL float64, deliberately: the decision layer is tiny
    (T, N ≤ a few thousand) and its semantics live below f32 resolution —
    the candidate thresholds ARE probability values, so the ``>=``
    predicate must distinguish probabilities that differ by less than an
    f32 ulp (a jnp [T, N] pass downcasts to f32 and collapses them,
    flipping confusion counts and with them policy feasibility), and the
    reference's 1e-12 feasibility epsilon (common.py:668-746) is
    meaningful only at f64 (ADVICE r1). The throughput-critical [T] axis
    work stays vectorized either way.
    """
    yt = np.asarray(y_true_bin).astype(bool)[None, :]                  # [1, N]
    pred = (
        np.asarray(y_prob, np.float64)[None, :]
        >= np.asarray(thresholds, np.float64)[:, None]
    )                                                                   # [T, N]
    tp = np.sum(yt & pred, axis=1).astype(np.float64)
    fp = np.sum(~yt & pred, axis=1).astype(np.float64)
    fn = np.sum(yt & ~pred, axis=1).astype(np.float64)
    tn = np.sum(~yt & ~pred, axis=1).astype(np.float64)

    def safe(num, den):
        return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)

    return {
        "TP": tp, "FP": fp, "TN": tn, "FN": fn,
        "recall": safe(tp, tp + fn),
        "precision": safe(tp, tp + fp),
        "fpr": safe(fp, fp + tn),
        "tnr": safe(tn, tn + fp),
        "accuracy": (tp + tn) / np.maximum(1.0, tp + tn + fp + fn),
    }


def find_threshold_for_target_recall(
    y_true_bin: np.ndarray, y_prob: np.ndarray, target_recall: float
) -> float:
    """Largest threshold whose recall meets the target; smallest candidate if none.

    Semantics parity: reference common.py:651-665 (candidates exclude 1.0).
    """
    y_true_bin = np.asarray(y_true_bin)
    if y_true_bin.sum() == 0:
        return 0.5
    thr = candidate_thresholds(y_prob, include_one=False)
    stats = stats_for_thresholds(y_true_bin, y_prob, thr)
    ok = stats["recall"] >= target_recall
    if ok.any():
        return float(thr[np.nonzero(ok)[0].max()])
    return float(thr[0])


def select_operating_threshold(
    y_true_bin: np.ndarray,
    y_prob: np.ndarray,
    target_recall: float,
    min_precision: Optional[float] = None,
    max_fpr: Optional[float] = None,
    f_beta: float = 2.0,
) -> Tuple[float, Dict[str, Any]]:
    """3-tier threshold policy (semantics: reference common.py:668-746)."""
    y_true_bin = np.asarray(y_true_bin)
    y_prob = np.asarray(y_prob, dtype=np.float64)
    if y_true_bin.sum() == 0:
        return 0.5, {"policy": "no_positives", "recall": 0.0, "precision": 0.0, "fpr": 0.0}

    thr = candidate_thresholds(y_prob, include_one=True)
    rates = stats_for_thresholds(y_true_bin, y_prob, thr)
    recall = rates["recall"]
    precision = rates["precision"]
    fpr = rates["fpr"]

    feasible = recall + _EPS >= target_recall
    if min_precision is not None:
        feasible &= precision + _EPS >= min_precision
    if max_fpr is not None:
        feasible &= fpr - _EPS <= max_fpr

    if feasible.any():
        i = int(np.nonzero(feasible)[0].max())  # thresholds sorted asc → max index = max thr
        return float(thr[i]), {
            "policy": "constrained",
            "recall": float(recall[i]),
            "precision": float(precision[i]),
            "fpr": float(fpr[i]),
        }

    beta2 = f_beta * f_beta
    denom = beta2 * precision + recall
    fbeta = np.where(denom > 0, (1 + beta2) * precision * recall / np.where(denom > 0, denom, 1.0), 0.0)
    # lexicographic argmax over (fbeta, threshold); thresholds ascending makes
    # the last occurrence of the max fbeta the tie-break winner.
    best = int(np.nonzero(fbeta == fbeta.max())[0].max())
    if fbeta[best] > 0:
        return float(thr[best]), {
            "policy": "fbeta",
            "fbeta": float(fbeta[best]),
            "recall": float(recall[best]),
            "precision": float(precision[best]),
            "fpr": float(fpr[best]),
        }

    recall_thr = find_threshold_for_target_recall(y_true_bin, y_prob, target_recall)
    i = int(np.searchsorted(thr, recall_thr))
    if i < thr.size and np.isclose(thr[i], recall_thr):
        return float(recall_thr), {
            "policy": "recall_only",
            "recall": float(recall[i]),
            "precision": float(precision[i]),
            "fpr": float(fpr[i]),
        }
    return float(thr[0]), {
        "policy": "min_threshold",
        "recall": float(recall[0]),
        "precision": float(precision[0]),
        "fpr": float(fpr[0]),
    }


def confusion_from_threshold(
    y_true: np.ndarray, y_prob: np.ndarray, pos_index: int, thr: float
) -> Dict[str, float]:
    """Single-threshold confusion row (schema: reference threshold_sweep.py:41-70)."""
    rows = sweep_thresholds(y_true, y_prob, pos_index, np.asarray([thr]))
    return rows[0]


def sweep_thresholds(
    y_true: np.ndarray,
    y_prob: np.ndarray,
    pos_index: int,
    thresholds: Optional[np.ndarray] = None,
) -> list[Dict[str, float]]:
    """Full descending threshold sweep, one vectorized pass.

    Returns rows with the exact ``threshold_sweep_{model}.csv`` column set
    (reference threshold_sweep.py:41-70, :137-147).
    """
    y_true_bin = (np.asarray(y_true) == pos_index).astype(np.int32)
    if thresholds is None:
        thresholds = candidate_thresholds(y_prob, include_one=True)[::-1]
    thresholds = np.asarray(thresholds, dtype=np.float64)
    host = stats_for_thresholds(y_true_bin, y_prob, thresholds)
    rows = []
    for i, t in enumerate(thresholds):
        rows.append(
            {
                "threshold": float(t),
                "TP": float(host["TP"][i]),
                "FP": float(host["FP"][i]),
                "TN": float(host["TN"][i]),
                "FN": float(host["FN"][i]),
                "TPR": float(host["recall"][i]),
                "TNR": float(host["tnr"][i]),
                "FPR": float(host["fpr"][i]),
                "precision": float(host["precision"][i]),
                "accuracy": float(host["accuracy"][i]),
            }
        )
    return rows
