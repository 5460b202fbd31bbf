"""PCA by a thin SVD on the device, with scikit-learn's conventions.

Counterpart of ``ssip_tpu/analysis/pca.py`` (reference clustering.py:200-248,
scikit-learn's ``PCA(svd_solver="full")``): center → thin SVD
(``torch.linalg.svd``: cuSOLVER on the card, LAPACK on the CPU) →
scikit-learn's ``svd_flip`` on the rows of Vt (each row's largest-|.| entry
made positive). The number of components for a target explained-variance
ratio is the first prefix whose cumulative ratio reaches the target.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ssip_tpu_torch.analysis.distances import float32_tensor
from ssip_tpu_torch.runtime.device import float32_products


@dataclass
class PCAModel:
    mean: np.ndarray  # [D]
    components: np.ndarray  # [K, D] rows = principal axes
    explained_variance: np.ndarray  # [K]
    explained_variance_ratio: np.ndarray  # [K]
    device: torch.device

    @float32_products()
    def transform(self, X: np.ndarray, n_components: int | None = None) -> np.ndarray:
        comps = self.components if n_components is None else self.components[:n_components]
        x = float32_tensor(X, self.device)
        mean = torch.as_tensor(self.mean, device=self.device)
        return ((x - mean) @ torch.as_tensor(comps, device=self.device).T).cpu().numpy().astype(np.float32)


@float32_products()
def fit_pca(X: np.ndarray, *, device: torch.device) -> PCAModel:
    x = float32_tensor(X, device)
    n = x.shape[0]
    mean = x.mean(dim=0)
    x0 = x - mean
    _u, s, vt = torch.linalg.svd(x0, full_matrices=False)

    # sklearn svd_flip (v-based, sklearn ≥1.5): each row of Vt gets its
    # max-|.| entry made positive.
    max_cols = vt.abs().argmax(dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=device), max_cols])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vt = vt * signs[:, None]

    explained = (s**2) / (n - 1)
    ratio = explained / explained.sum()
    return PCAModel(
        mean=mean.cpu().numpy(),
        components=vt.cpu().numpy(),
        explained_variance=explained.cpu().numpy(),
        explained_variance_ratio=ratio.cpu().numpy(),
        device=torch.device(device),
    )


def components_for_variance(model: PCAModel, target: float) -> int:
    """Smallest K with cumulative explained-variance ratio ≥ target."""
    cumulative = np.cumsum(model.explained_variance_ratio)
    k = int(np.searchsorted(cumulative, target) + 1)
    return min(k, len(cumulative))
