"""UMAP on the device — the 2-D manifold embedding.

Counterpart of ``ssip_tpu/analysis/umap_jax.py``, the JAX package's own
from-scratch construction (McInnes et al. 2018); the ``umap-learn`` package
is not needed:

  1. exact kNN graph from one pairwise-distance matrix (the k nearest by a
     stable sort, so that equal distances keep the lower index first, as
     ``jax.lax.top_k`` does: embeddings of duplicate images tie),
  2. per-point (rho, sigma): rho the nearest-neighbour distance, sigma by a
     vectorized binary search so that the smoothed neighbour cardinality
     equals log2(k),
  3. fuzzy simplicial-set symmetrization  P ∪ Pᵀ = P + Pᵀ − P∘Pᵀ,
  4. (a, b) of the low-dimensional membership curve fitted to min_dist on
     the host (scipy's ``curve_fit``),
  5. the embedding by dense gradient descent on the UMAP cross-entropy —
     attraction on edge weights, repulsion on their complement — with the
     linearly decaying learning rate and per-element gradient clipping
     (±4), PCA-initialized, one epoch a Python iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ssip_tpu_torch.analysis.blocked import check_embedding_cap
from ssip_tpu_torch.analysis.distances import float32_tensor, pairwise_d2
from ssip_tpu_torch.analysis.pca import fit_pca
from ssip_tpu_torch.runtime.device import float32_products

_F32 = np.float32


def fit_ab(min_dist: float, spread: float = 1.0) -> tuple[float, float]:
    """Fit the (a, b) low-dim membership curve 1/(1 + a·d^{2b}).

    Same least-squares construction as umap-learn's ``find_ab_params``.
    """
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv)
    return float(a), float(b)


def _fuzzy_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """Symmetrized fuzzy simplicial set as a dense [N, N] weight matrix."""
    n = x.shape[0]
    dev = x.device
    sq = (x * x).sum(dim=1)
    d = pairwise_d2(x, x, sq, sq).sqrt_().fill_diagonal_(float("inf"))

    knn_d, knn_idx = d.sort(dim=1, stable=True)
    knn_d, knn_idx = knn_d[:, :k].contiguous(), knn_idx[:, :k].contiguous()
    del d

    rho = knn_d[:, 0]
    target = torch.log2(torch.tensor(float(k), dtype=torch.float32, device=dev))
    excess = (knn_d - rho[:, None]).clamp_min(0.0)

    lo = torch.full((n,), 1e-8, device=dev)
    hi = torch.full((n,), float("inf"), device=dev)
    sigma = torch.ones((n,), device=dev)
    for _ in range(64):
        too_many = torch.exp(-(excess / sigma[:, None])).sum(dim=1) > target
        lo, hi = torch.where(too_many, lo, sigma), torch.where(too_many, sigma, hi)
        sigma = torch.where(torch.isinf(hi), lo * 2.0, (lo + hi) / 2.0)

    weights = torch.exp(-excess / sigma.clamp_min(1e-8)[:, None])  # [N, k]
    p = torch.zeros((n, n), device=dev)
    p.scatter_(1, knn_idx, weights)
    return p + p.T - p * p.T


def _optimize(p: torch.Tensor, y0: torch.Tensor, a: float, b: float, n_epochs: int, k: int) -> torch.Tensor:
    n = y0.shape[0]
    a, b = float(_F32(a)), float(_F32(b))
    rep_base = (1.0 - p).clamp_min(0.0).fill_diagonal_(0.0)
    # The dense step sums ~k per-edge updates umap-learn would apply
    # sequentially — scale the rate down by k to keep per-update magnitude
    # equivalent; repulsion mass matches negative_sample_rate (5) negatives
    # per positive edge, spread over the n-row complement.
    lr0 = _F32(0.5 / k)
    rep = rep_base * float(_F32(5.0 * k / n)) * float(_F32(2.0 * b))
    del rep_base
    y = y0
    for i in range(n_epochs):
        alpha = float(lr0 * (_F32(1.0) - _F32(i) / _F32(n_epochs)))
        diff = y[:, None, :] - y[None, :, :]  # [N, N, 2]
        d2 = diff.square().sum(dim=-1).clamp_min(1e-10)
        one_plus_pow = (a * d2**b).add_(1.0)
        attract = (p * (-2.0 * a * b * d2 ** (b - 1.0))).div_(one_plus_pow).fill_diagonal_(0.0)
        repulse = rep / ((0.001 + d2).mul_(one_plus_pow))
        coeff = attract.add_(repulse)  # [N, N]
        grad = (coeff[..., None] * diff).clamp_(-4.0, 4.0).sum(dim=1)
        y = y - alpha * grad
    return y


@float32_products()
def umap(
    X: np.ndarray,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_components: int = 2,
    n_epochs: int = 200,
    seed: int = 42,
    max_points: int = 20_000,
    *,
    device: torch.device,
) -> np.ndarray:
    """2-D UMAP embedding. Deterministic (PCA init, dense optimization).

    Fails fast above ``max_points`` — the dense optimizer holds [N, N]
    (and [N, N, 2]) tensors, a silent OOM wall at corpus scale (subsample
    for visualization instead; see analysis/blocked.py).
    """
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    check_embedding_cap(n, max_points, "UMAP")
    k = min(n_neighbors, n - 1)
    a, b = fit_ab(min_dist)

    p = _fuzzy_graph(float32_tensor(X, device), k)

    pca_model = fit_pca(X, device=device)
    y0 = pca_model.transform(X, n_components).astype(np.float32)
    y0 = y0 / max(y0.std(), 1e-12) * 10.0  # spread init like spectral-scaled

    return _optimize(p, float32_tensor(y0, device), a, b, n_epochs, k).cpu().numpy()
