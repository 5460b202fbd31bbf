"""Seeded randomness: the host half of ``ssip_tpu/runtime/prng.py``.

``_name_to_int`` and ``host_rng`` are copied bit for bit (``:23-25``,
``:37-39``): the samplers and splits draw from them, so a port run and a
JAX run of one seed shuffle and resample identically.

The augmentation draws are the one place where the JAX package uses its
device PRNG (``epoch_key(seed, f"{stream}/aug/{epoch}", step)`` feeding
``jax.random.bernoulli`` and ``jax.random.uniform``). Torch cannot reproduce
JAX's threefry streams, so ``augment_draws`` takes the same distributions
from a ``host_rng`` stream named after the same (stream, epoch, step)
instead. The draws are made on the CPU and handed to the device, so a CPU
run and a CUDA run of one seed see the same flips and angles; against the
JAX package, whole runs are held to a metric envelope, not to bits.
"""

from __future__ import annotations

import hashlib

import numpy as np

_DEG_TO_RAD = np.float32(np.pi / 180.0)


def _name_to_int(name: str) -> int:
    digest = hashlib.sha256(name.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little")


def host_rng(seed: int, name: str) -> np.random.Generator:
    """Seeded numpy Generator for host-side (non-device) randomness."""
    return np.random.default_rng(np.random.SeedSequence([seed, _name_to_int(name)]))


def augment_draws(
    seed: int, stream: str, epoch: int, step: int, batch: int, max_degrees: float = 10.0
) -> tuple[np.ndarray, np.ndarray]:
    """(flip bool[B], angles float32[B] in radians) for one train step.

    Bernoulli(0.5) flips and U(−d, d)·π/180 angles computed in float32, as
    ``ssip_tpu/ops/augment.py:24,374-376`` draws them.
    """
    rng = host_rng(seed, f"{stream}/aug/{epoch}/{step}")
    flip = rng.random(batch) < 0.5
    d = np.float32(max_degrees)
    u = rng.random(batch, dtype=np.float32)
    degrees = np.maximum(u * (d - (-d)) + (-d), -d)  # jax.random.uniform's affine + clamp
    return flip, (degrees * _DEG_TO_RAD).astype(np.float32)
