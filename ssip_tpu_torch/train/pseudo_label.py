"""Pseudo-label generation for the weak (unlabeled) pool.

Counterpart of ``ssip_tpu/train/pseudo_label.py`` (semantics: reference
semi_supervised.py:44-72): softmax the baseline model over the pool; keep
the samples whose max-class confidence ≥ threshold, labeled with the argmax
class. A batched eval-mode forward without gradients over the
device-resident pool; the selection happens on the host (its size depends
on the data). With a data-parallel mesh each batch is split over the ranks
and the probabilities are gathered in pool order, equal at any world size
(JAX ``pseudo_label.py:43-72``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ssip_tpu_torch.ops.augment import eval_preprocess
from ssip_tpu_torch.parallel.mesh import data_size
from ssip_tpu_torch.train.engine import sharded_eval_batches


@torch.no_grad()
def pool_probabilities(model: nn.Module, pool_images_u8: torch.Tensor, batch_size: int, mesh=None) -> np.ndarray:
    """Softmax probabilities float32 [N, C] over a device-resident pool.

    Eval-mode forward (running statistics) batch by batch, the last batch
    run short: in eval mode no row affects another. An empty pool is a valid
    input and gives ``[0, C]``, the class count probed from the head.
    """
    model.eval()
    n = int(pool_images_u8.shape[0])
    if n == 0:
        probe = torch.zeros((1, *pool_images_u8.shape[1:]), dtype=torch.uint8, device=pool_images_u8.device)
        num_classes = model(eval_preprocess(probe, model.compute_dtype)).shape[-1]
        return np.zeros((0, num_classes), np.float32)
    if data_size(mesh) > 1:
        return sharded_eval_batches(model, pool_images_u8, batch_size, mesh)[1].cpu().numpy()
    probs = []
    for start in range(0, n, batch_size):
        images = pool_images_u8[start : start + batch_size]
        logits = model(eval_preprocess(images, model.compute_dtype)).to(torch.float32)
        probs.append(torch.softmax(logits, dim=1))
    return torch.cat(probs).cpu().numpy()


def generate_pseudo_labels(
    model: nn.Module, pool_images_u8: torch.Tensor, batch_size: int, confidence_threshold: float, mesh=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kept indices, labels, confidences) over the pool, in pool order."""
    probs = pool_probabilities(model, pool_images_u8, batch_size, mesh)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    keep = np.nonzero(conf >= confidence_threshold)[0]
    return keep, pred[keep], conf[keep]
