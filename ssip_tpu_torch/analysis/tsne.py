"""Exact t-SNE on the device — the 2-D visualization embedding.

Counterpart of ``ssip_tpu/analysis/tsne.py`` (reference clustering.py:251-276;
visualization-only, so fidelity to the t-SNE objective matters, bitwise
parity with scikit-learn's Barnes-Hut implementation does not). Dense
linear algebra on [N, N] float32 matrices:

  - per-point conditional P by a vectorized binary search over the
    precision to hit the target perplexity (all points in parallel, 50
    steps),
  - symmetrized joint P with early exaggeration (12× for the first 250 of
    the 1000 steps),
  - gradient descent with momentum (0.5 → 0.8 at the exaggeration switch)
    and per-parameter gains, the classic van der Maaten schedule, one step
    a Python iteration.

PCA initialization (scaled to std 1e-4), matching the reference's
``init="pca"`` configuration. The gradient's ``(diag(Σ pq) − pq) @ y`` is
computed as ``Σ pq · y − pq @ y``, which needs no [N, N] diagonal matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ssip_tpu_torch.analysis.blocked import check_embedding_cap
from ssip_tpu_torch.analysis.distances import float32_tensor, pairwise_d2
from ssip_tpu_torch.analysis.pca import fit_pca
from ssip_tpu_torch.runtime.device import float32_products

_F32 = np.float32


def _conditional_p(d2: torch.Tensor, perplexity: float, iters: int = 50) -> torch.Tensor:
    """Row-stochastic conditional P matching the target perplexity per row."""
    n = d2.shape[0]
    dev = d2.device
    target = torch.log(torch.tensor(perplexity, dtype=torch.float32, device=dev))
    d2 = d2.clone()
    d2.fill_diagonal_(float("inf"))

    def entropy_and_p(beta):
        # beta: [N, 1] precision; returns (H [N], P [N, N] row-stochastic)
        logits = -d2 * beta
        logits = logits - logits.fill_diagonal_(float("-inf")).amax(dim=1, keepdim=True)
        p = logits.exp_().fill_diagonal_(0.0)
        p = p / p.sum(dim=1, keepdim=True).clamp_min(1e-30)
        h = -torch.where(p > 0, p * p.log(), 0.0).sum(dim=1)
        return h, p

    lo = torch.zeros((n, 1), device=dev)
    hi = torch.full((n, 1), float("inf"), device=dev)
    beta = torch.ones((n, 1), device=dev)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = (h > target)[:, None]  # entropy too high → increase beta
        lo, hi = torch.where(too_high, beta, lo), torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), lo * 2.0, (lo + hi) / 2.0)
    return entropy_and_p(beta)[1]


def _joint_p(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    p_cond = _conditional_p(pairwise_d2(x, x, sq, sq), perplexity)
    return ((p_cond + p_cond.T) / (2.0 * n)).clamp_min(1e-12)


def _student_t(y: torch.Tensor) -> torch.Tensor:
    """1 / (1 + ‖yᵢ − yⱼ‖²) with a zero diagonal (the distances unclamped,
    as the JAX package computes them)."""
    sq = (y * y).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (y @ y.T)
    return d2.add_(1.0).reciprocal_().fill_diagonal_(0.0)


def _gradient(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    num = _student_t(y)
    q = num / num.sum().clamp_min(1e-30)
    pq = (p - q).mul_(num)  # [N, N]
    return 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)


def _optimize(
    p_joint: torch.Tensor,
    y0: torch.Tensor,
    learning_rate: float,
    n_iter: int,
    exaggeration_iter: int,
    early_exaggeration: float = 12.0,
) -> torch.Tensor:
    p_exaggerated = p_joint * early_exaggeration
    lr = float(_F32(learning_rate))
    y, vel, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    for i in range(n_iter):
        early = i < exaggeration_iter
        momentum = 0.5 if early else 0.8
        g = _gradient(y, p_exaggerated if early else p_joint)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp_min(0.01)
        vel = momentum * vel - lr * gains * g
        y = y + vel
        y = y - y.mean(dim=0, keepdim=True)
    return y


@float32_products()
def tsne(
    X: np.ndarray,
    perplexity: float = 30.0,
    n_components: int = 2,
    n_iter: int = 1000,
    seed: int = 42,
    max_points: int = 20_000,
    *,
    device: torch.device,
) -> np.ndarray:
    """2-D embedding of X. Deterministic (PCA init).

    Fails fast above ``max_points`` — the exact formulation holds several
    [N, N] float matrices, a silent OOM wall at corpus scale (subsample
    for visualization instead; see analysis/blocked.py).
    """
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    check_embedding_cap(n, max_points, "t-SNE")
    perplexity = min(perplexity, (n - 1) / 3.0)  # sklearn guard

    p_joint = _joint_p(float32_tensor(X, device), perplexity)

    pca_model = fit_pca(X, device=device)
    y0 = pca_model.transform(X, n_components).astype(np.float32)
    y0 = y0 / max(y0[:, 0].std(), 1e-12) * 1e-4  # sklearn pca-init scaling

    # sklearn's learning_rate="auto": max(N / early_exaggeration / 4, 50)
    lr = max(n / 12.0 / 4.0, 50.0)
    y = _optimize(p_joint, float32_tensor(y0, device), lr, n_iter=n_iter, exaggeration_iter=250)
    return y.cpu().numpy()


@float32_products()
def kl_divergence(X: np.ndarray, Y: np.ndarray, perplexity: float, *, device: torch.device) -> float:
    """KL(P||Q) of an embedding — the t-SNE objective, for diagnostics."""
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    p = _joint_p(float32_tensor(X, device), min(perplexity, (n - 1) / 3.0))
    num = _student_t(float32_tensor(Y, device))
    q = (num / num.sum()).clamp_min(1e-12)
    return float((p * (p.log() - q.log())).sum())
