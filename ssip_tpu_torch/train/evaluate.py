"""Model evaluation with optional binary thresholding.

Counterpart of ``ssip_tpu/train/evaluate.py:19-69`` (reference semantics:
common.py:439-506): positive-class softmax probabilities; predictions by
argmax or, for a binary problem with a threshold, by ``prob >= thr`` mapped
back onto class indices; metrics binarized against the positive class when
one is given. With a data-parallel ``mesh`` the forward is split over the
ranks (``run_eval_epoch``) and the metrics are the one-process ones.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from torch import nn

from ssip_tpu_torch.ops.metrics import accuracy, precision_recall_f1
from ssip_tpu_torch.train.engine import DeviceDataset, run_eval_epoch


def evaluate_model(
    model: nn.Module,
    dataset: DeviceDataset,
    batch_size: int,
    pos_index: Optional[int] = None,
    threshold: Optional[float] = None,
    mesh=None,
) -> Tuple[Dict[str, float], np.ndarray, np.ndarray, np.ndarray]:
    """(metrics, y_true, y_pred, y_prob_positive)."""
    _, y_true, y_pred_argmax, probs_full = run_eval_epoch(model, dataset, batch_size, mesh)
    num_classes = probs_full.shape[1] if probs_full.ndim == 2 else 2
    pos_col = pos_index if pos_index is not None else (1 if num_classes > 1 else 0)
    y_prob = probs_full[:, pos_col]

    if threshold is None or num_classes != 2:
        y_pred = y_pred_argmax
    else:
        y_pred = np.where(y_prob >= threshold, pos_col, 1 - pos_col)

    # Binarize w.r.t. pos_index when given; otherwise metrics use the raw
    # labels with class 1 as the binary positive (reference :486-497).
    if pos_index is not None:
        yt = (y_true == pos_index).astype(int)
        yp = (y_pred == pos_index).astype(int)
    else:
        yt, yp = y_true, y_pred

    precision, recall, f1 = precision_recall_f1(yt == 1, yp == 1)
    metrics = {
        "accuracy": float(accuracy(yt, yp)),
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
    }
    return metrics, y_true, y_pred, y_prob
