"""Clustering quality metrics: ARI, NMI, silhouette.

Counterpart of ``ssip_tpu/analysis/cluster_metrics.py`` (reference
clustering.py:316-337, scikit-learn's metrics). ARI and NMI run on the
labeled subset only, silhouette on the full clustering space (the
reference's protocol). ARI and NMI come from float64 contingency tables on
the host (exact counts), as in the JAX package; silhouette takes the
pairwise distances on the device, the whole [N, N] matrix up to
``DENSE_LIMIT`` rows and one [CHUNK, N] tile at a time above it.
"""

from __future__ import annotations

import numpy as np
import torch

from ssip_tpu_torch.analysis.blocked import CHUNK, DENSE_LIMIT
from ssip_tpu_torch.analysis.distances import float32_tensor, pairwise_d2
from ssip_tpu_torch.runtime.device import float32_products


def _contingency(labels_a: np.ndarray, labels_b: np.ndarray) -> np.ndarray:
    """[Ca, Cb] float64 contingency table (host — exact counts for ARI/NMI)."""
    _, a = np.unique(labels_a, return_inverse=True)
    _, b = np.unique(labels_b, return_inverse=True)
    ca, cb = int(a.max()) + 1, int(b.max()) + 1
    table = np.zeros((ca, cb), np.float64)
    np.add.at(table, (a, b), 1.0)
    return table


def adjusted_rand_index(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """ARI from the contingency table (Hubert & Arabie)."""
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = labels_true.size
    if n < 2:
        return 1.0
    c = _contingency(labels_true, labels_pred)

    def comb2(x):
        return x * (x - 1.0) / 2.0

    sum_comb = comb2(c).sum()
    sum_a = comb2(c.sum(axis=1)).sum()
    sum_b = comb2(c.sum(axis=0)).sum()
    expected = sum_a * sum_b / comb2(float(n))
    max_index = (sum_a + sum_b) / 2.0
    denom = max_index - expected
    if denom == 0.0:
        return 1.0
    return float((sum_comb - expected) / denom)


def normalized_mutual_info(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """NMI with arithmetic-mean normalization (sklearn default)."""
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = labels_true.size
    if n == 0:
        return 0.0
    c = _contingency(labels_true, labels_pred) / n
    pa = c.sum(axis=1)
    pb = c.sum(axis=0)
    outer = pa[:, None] * pb[None, :]
    nz = c > 0
    mi = float(np.sum(np.where(nz, c * np.log(np.where(nz, c / outer, 1.0)), 0.0)))

    def entropy(p):
        nzp = p > 0
        return -float(np.sum(np.where(nzp, p * np.log(np.where(nzp, p, 1.0)), 0.0)))

    mean_h = (entropy(pa) + entropy(pb)) / 2.0
    if mean_h == 0.0:
        return 1.0
    return float(np.clip(mi / mean_h, 0.0, 1.0))


def _silhouette_sums_dense(x: torch.Tensor, one_hot: torch.Tensor) -> torch.Tensor:
    """[N, K] total distance from each sample to each cluster (full matrix)."""
    sq = (x * x).sum(dim=1)
    return pairwise_d2(x, x, sq, sq).sqrt() @ one_hot


def _silhouette_sums_blocked(x: torch.Tensor, one_hot: torch.Tensor) -> torch.Tensor:
    """Same sums with O(CHUNK·N) memory: one [CHUNK, N] distance tile at a
    time — the corpus-scale path (self-distance is 0 and contributes
    nothing, so no diagonal handling is needed)."""
    sq = (x * x).sum(dim=1)
    return torch.cat([
        pairwise_d2(x[start : start + CHUNK], x, sq[start : start + CHUNK], sq).sqrt() @ one_hot
        for start in range(0, x.shape[0], CHUNK)
    ])


@float32_products()
def silhouette_score(
    X: np.ndarray, labels: np.ndarray, sample_mask: np.ndarray | None = None, *, device: torch.device
) -> float:
    """Mean silhouette over the (optionally masked) samples.

    Cluster-mean distances per sample as one [N, K] matmul of the
    pairwise-distance matrix against cluster one-hots. Singleton clusters
    score 0 (sklearn convention). Above DENSE_LIMIT rows the distance matrix
    is computed in row blocks — bounded memory at corpus scale.
    """
    labels = np.asarray(labels)
    if sample_mask is not None:
        X = np.asarray(X)[sample_mask]
        labels = labels[sample_mask]
    uniq, dense = np.unique(labels, return_inverse=True)
    k = len(uniq)
    n = len(labels)
    if k < 2 or n < 2:
        raise ValueError("silhouette requires 2 <= n_clusters < n_samples")

    x = float32_tensor(X, device)
    dense = torch.as_tensor(dense.reshape(-1), device=device)
    one_hot = torch.eye(k, dtype=torch.float32, device=device)[dense]  # [N, K]
    counts = one_hot.sum(dim=0)  # [K]
    sums = _silhouette_sums_blocked(x, one_hot) if n > DENSE_LIMIT else _silhouette_sums_dense(x, one_hot)

    rows = torch.arange(n, device=device)
    own = counts[dense]  # [N]
    own_sum = sums[rows, dense]
    zero = torch.zeros((), device=device)
    a = torch.where(own > 1, own_sum / (own - 1).clamp_min(1), zero)

    mean_other = sums / counts.clamp_min(1)[None, :]
    mean_other[rows, dense] = float("inf")
    b = mean_other.min(dim=1).values

    s = torch.where(own > 1, (b - a) / torch.maximum(a, b).clamp_min(1e-12), zero)
    return float(s.mean())
