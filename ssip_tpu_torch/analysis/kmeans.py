"""K-Means: k-means++ seeding on the host, Lloyd iterations of all n_init
restarts together on the device.

Counterpart of ``ssip_tpu/analysis/kmeans.py`` (reference
clustering.py:340-373, scikit-learn's KMeans). The seeding is the JAX
package's host numpy code from the same ``host_rng`` stream, so the inits
are bit for bit its own. Each Lloyd sweep is two matmul-shaped reductions
(the [L, N, K] distance matrix and the one-hot centroid sums) over all L
restarts at once; a restart stops at scikit-learn's convergence rule
(center shift² ≤ tol · mean feature variance, or max_iter) and is frozen
from then on while the others run, as the JAX package's vmapped
``while_loop`` keeps a finished lane's carry. Whether any lane is still
running is read on the host once an iteration (one sync a sweep). Empty
clusters are re-seeded with the points farthest from their assigned centers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ssip_tpu_torch.analysis.distances import float32_tensor
from ssip_tpu_torch.runtime.device import float32_products
from ssip_tpu_torch.runtime.prng import host_rng


@dataclass
class KMeansResult:
    labels: np.ndarray  # [N]
    centers: np.ndarray  # [K, D]
    inertia: float
    n_iter: int


def _plus_plus_init(X: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding with sklearn's local-trials refinement (host)."""
    n = X.shape[0]
    n_local_trials = 2 + int(np.log(k)) if k > 1 else 1
    centers = np.empty((k, X.shape[1]), X.dtype)
    first = int(rng.integers(n))
    centers[0] = X[first]
    closest = np.sum((X - centers[0]) ** 2, axis=1)
    for c in range(1, k):
        total = closest.sum()
        if total == 0:
            centers[c:] = X[rng.integers(n, size=k - c)]
            break
        candidates = rng.choice(n, size=n_local_trials, p=closest / total)
        cand_dist = np.sum((X[None, :, :] - X[candidates, None, :]) ** 2, axis=2)
        cand_closest = np.minimum(closest[None, :], cand_dist)
        best = int(np.argmin(cand_closest.sum(axis=1)))
        centers[c] = X[candidates[best]]
        closest = cand_closest[best]
    return centers


def _assign(x: torch.Tensor, x_sq: torch.Tensor, centers: torch.Tensor):
    """(labels [L, N], clamped squared distance to the own center [L, N]);
    the first center on ties."""
    c_sq = (centers * centers).sum(dim=2)  # [L, K]
    d2 = x_sq[None, :, None] + c_sq[:, None, :] - 2.0 * (x @ centers.transpose(1, 2))
    labels = d2.argmin(dim=2)
    return labels, d2.gather(2, labels[..., None])[..., 0].clamp_min(0.0)


def _update(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor, point_d2: torch.Tensor) -> torch.Tensor:
    k = centers.shape[1]
    one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # [L, N, K]
    counts = one_hot.sum(dim=1)  # [L, K]
    sums = one_hot.transpose(1, 2) @ x  # [L, K, D]
    new_centers = sums / counts.clamp_min(1.0)[..., None]
    # relocate empty clusters to the farthest points (a stable order, as jnp.argsort)
    order = torch.argsort(-point_d2, dim=1, stable=True)
    farthest = x[order[:, :k]]  # [L, K, D]
    return torch.where((counts == 0)[..., None], farthest, new_centers)


def _lloyd_lanes(x: torch.Tensor, inits: torch.Tensor, tol: torch.Tensor, max_iter: int):
    """All restarts of Lloyd's; (centers [L, K, D], labels [L, N], inertia
    [L], n_iter [L]). A lane whose shift² fell to ``tol`` or that reached
    ``max_iter`` keeps its centers and count from then on."""
    x_sq = (x * x).sum(dim=1)
    centers = inits
    shift2 = torch.full((inits.shape[0],), float("inf"), dtype=x.dtype, device=x.device)
    n_iter = torch.zeros(inits.shape[0], dtype=torch.int64, device=x.device)
    while True:
        running = (shift2 > tol) & (n_iter < max_iter)
        if not bool(running.any()):
            break
        labels, point_d2 = _assign(x, x_sq, centers)
        new_centers = _update(x, centers, labels, point_d2)
        new_shift2 = ((new_centers - centers) ** 2).sum(dim=(1, 2))
        centers = torch.where(running[:, None, None], new_centers, centers)
        shift2 = torch.where(running, new_shift2, shift2)
        n_iter = n_iter + running.to(n_iter.dtype)
    labels, point_d2 = _assign(x, x_sq, centers)
    return centers, labels, point_d2.sum(dim=1), n_iter


@float32_products()
def kmeans(
    X: np.ndarray,
    n_clusters: int,
    *,
    device: torch.device,
    n_init: int = 10,
    seed: int = 42,
    max_iter: int = 300,
    tol: float = 1e-4,
) -> KMeansResult:
    """Best-of-n_init K-Means; deterministic in (data, seed)."""
    X = np.asarray(X, np.float32)
    rng = host_rng(seed, f"kmeans/k={n_clusters}")
    inits = np.stack([_plus_plus_init(X, n_clusters, rng) for _ in range(n_init)])

    # sklearn scales tol by the mean per-feature variance of the data
    scaled_tol = float(tol * np.mean(np.var(X, axis=0)))
    centers, labels, inertia, n_iter = _lloyd_lanes(
        float32_tensor(X, device),
        float32_tensor(inits, device),
        torch.tensor(scaled_tol, dtype=torch.float32, device=device),
        max_iter,
    )
    inertia = inertia.cpu().numpy()
    best = int(np.argmin(inertia))
    return KMeansResult(
        labels=labels[best].cpu().numpy().astype(np.int64),
        centers=centers[best].cpu().numpy(),
        inertia=float(inertia[best]),
        n_iter=int(n_iter[best]),
    )
