"""The pairwise-distance formula of the analysis stack, and its inputs."""

from __future__ import annotations

import numpy as np
import torch


def pairwise_d2(a: torch.Tensor, b: torch.Tensor, a_sq: torch.Tensor, b_sq: torch.Tensor) -> torch.Tensor:
    """‖a‖² + ‖b‖² − 2a·b clamped at 0, [len(a), len(b)], given the rows'
    squared norms: the JAX package's formula in its order (not
    ``torch.cdist``, which switches algorithm by size and rounds
    differently)."""
    return (a_sq[:, None] + b_sq[None, :] - 2.0 * (a @ b.T)).clamp_min(0.0)


def float32_tensor(X, device: torch.device) -> torch.Tensor:
    """A float32 copy of the array ``X`` on ``device`` (a copy, so that a
    read-only array is taken as it is)."""
    return torch.from_numpy(np.array(X, dtype=np.float32)).to(device)
