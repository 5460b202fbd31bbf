"""DBSCAN with the radius-neighbour query on the device.

Counterpart of ``ssip_tpu/analysis/dbscan.py`` (reference
clustering.py:376-428, scikit-learn's DBSCAN): the O(N²) radius-neighbour
query — the actual compute — is one pairwise-distance matrix on the device
(one [CHUNK, N] tile at a time above ``DENSE_LIMIT`` rows), whose
``d2 <= eps²`` entries come back to the host as index pairs; the cluster
expansion is the JAX package's host BFS in index order: core points (≥
min_samples neighbours including themselves) seed clusters in index order,
border points join the first core cluster that reaches them, the rest is
noise (-1).

Also the k-distance curve for the reference's ``--dbscan-auto`` eps
selection (98th-percentile order statistic, reference clustering.py:430-438).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ssip_tpu_torch.analysis.blocked import CHUNK as _CHUNK, DENSE_LIMIT as _DENSE_LIMIT
from ssip_tpu_torch.analysis.distances import float32_tensor, pairwise_d2
from ssip_tpu_torch.runtime.device import float32_products


@dataclass
class DBSCANResult:
    labels: np.ndarray  # [N] cluster ids, -1 = noise
    core_mask: np.ndarray  # [N] bool
    n_clusters: int
    noise_rate: float


def _neighbor_lists_dense(x: torch.Tensor, eps: float) -> List[np.ndarray]:
    """Radius-neighbour lists from the full [N, N] matrix."""
    sq = (x * x).sum(dim=1)
    return _split_pairs(pairwise_d2(x, x, sq, sq).le(_eps2(eps, x.device)).nonzero(), x.shape[0])


def _neighbor_lists_blocked(x: torch.Tensor, eps: float) -> List[np.ndarray]:
    """Corpus-scale radius query: one [CHUNK, N] distance tile at a time.

    Peak device memory is O(CHUNK·N) plus the (data-dependent, inherently
    necessary) neighbour pairs — the [N, N] matrix is never materialized on
    the device or the host.
    """
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    eps2 = _eps2(eps, x.device)
    pairs = []
    for start in range(0, n, _CHUNK):
        tile = pairwise_d2(x[start : start + _CHUNK], x, sq[start : start + _CHUNK], sq).le(eps2).nonzero()
        tile[:, 0] += start
        pairs.append(tile)
    return _split_pairs(torch.cat(pairs), n)


def _eps2(eps: float, device) -> torch.Tensor:
    """eps² rounded to float32, as the JAX package compares it."""
    return torch.tensor(float(eps) ** 2, dtype=torch.float32, device=device)


def _split_pairs(pairs: torch.Tensor, n: int) -> List[np.ndarray]:
    """(row, column) pairs in row-major order → each row's column indices,
    as ``np.nonzero`` of that row gives them."""
    pairs = pairs.cpu().numpy()
    counts = np.bincount(pairs[:, 0], minlength=n)
    return np.split(pairs[:, 1], np.cumsum(counts)[:-1])


@float32_products()
def dbscan(X: np.ndarray, eps: float, min_samples: int, *, device: torch.device) -> DBSCANResult:
    x = float32_tensor(X, device)
    n = int(x.shape[0])
    if n > _DENSE_LIMIT:
        neighbors = _neighbor_lists_blocked(x, eps)
    else:
        neighbors = _neighbor_lists_dense(x, eps)
    core = np.fromiter((len(nb) >= min_samples for nb in neighbors), bool, count=n)

    labels = np.full(n, -1, np.int64)
    cluster = 0
    for i in range(n):
        if not core[i] or labels[i] != -1:
            continue
        labels[i] = cluster
        queue = deque([i])
        while queue:
            j = queue.popleft()
            if not core[j]:
                continue
            for nb in neighbors[j]:
                if labels[nb] == -1:
                    labels[nb] = cluster
                    if core[nb]:
                        queue.append(nb)
        cluster += 1

    noise_rate = float((labels == -1).mean()) if n else 0.0
    return DBSCANResult(labels=labels, core_mask=core, n_clusters=cluster, noise_rate=noise_rate)


def _kth_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k-th smallest value (ties do not change the value)."""
    return d2.topk(k, dim=1, largest=False, sorted=True).values[:, k - 1]


def _kth_distance_blocked(x: torch.Tensor, k: int, include_self: bool) -> torch.Tensor:
    """k-th-NN squared distance per row with O(CHUNK·N) memory (corpus-scale path)."""
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    out = []
    for start in range(0, n, _CHUNK):
        d2 = pairwise_d2(x[start : start + _CHUNK], x, sq[start : start + _CHUNK], sq)
        if not include_self:
            rows = torch.arange(d2.shape[0], device=x.device)
            d2[rows, rows + start] = float("inf")
        out.append(_kth_smallest(d2, k))
    return torch.cat(out)


@float32_products()
def k_distance_curve(X: np.ndarray, k: int, include_self: bool = False, *, device: torch.device) -> np.ndarray:
    """Sorted distance to the k-th nearest neighbor.

    ``include_self=True`` reproduces sklearn NearestNeighbors(k).kneighbors
    semantics where each point's first neighbor is itself (so the curve is
    the (k-1)-th non-self distance) — what the reference's auto-eps uses.
    Large inputs take the blocked path (bounded memory) automatically. The
    square root is taken on the host, as in the JAX package.
    """
    x = float32_tensor(X, device)
    if x.shape[0] > _DENSE_LIMIT:
        kth = _kth_distance_blocked(x, int(k), bool(include_self))
    else:
        sq = (x * x).sum(dim=1)
        d2 = pairwise_d2(x, x, sq, sq)
        if not include_self:
            d2.fill_diagonal_(float("inf"))
        kth = _kth_smallest(d2, k)
    return np.sort(np.sqrt(kth.cpu().numpy()))


def auto_eps_from_kdistance(X: np.ndarray, min_samples: int, quantile: float = 0.98, *, device: torch.device) -> float:
    """eps at the quantile of the k-distance curve (k = min_samples).

    Exact reference semantics (clustering.py:430-438): the kNN query counts
    the point itself as its first neighbor, and the quantile is the order
    statistic at index round(q·(n−1)) — not an interpolated quantile.
    """
    curve = k_distance_curve(X, max(min_samples, 1), include_self=True, device=device)
    idx = int(np.clip(round(quantile * (len(curve) - 1)), 0, len(curve) - 1))
    return float(curve[idx])
