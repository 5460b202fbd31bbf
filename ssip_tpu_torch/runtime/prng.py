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
``fixmatch_draws`` does the same for the three views of a FixMatch step
(``ssip_tpu/train/consistency.py:73`` splits the step's key three ways);
with ``strong_aug="randaugment"`` the strong view's stream gives
``randaugment_draws`` (``ssip_tpu/ops/randaugment.py:282-286, 313-315,
336-337``) in place of the jitter's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields
from typing import Any, Callable, Optional

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
    return _flips_and_angles(host_rng(seed, f"{stream}/aug/{epoch}/{step}"), batch, max_degrees)


def _uniform(rng: np.random.Generator, n: int, lo: float, hi: float) -> np.ndarray:
    """float32 U(lo, hi) as ``jax.random.uniform`` shapes it: the affine map
    of a float32 U(0, 1), clamped below at ``lo``."""
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(rng.random(n, dtype=np.float32) * (hi - lo) + lo, lo)


def _flips_and_angles(rng: np.random.Generator, batch: int, max_degrees: float):
    flip = rng.random(batch) < 0.5
    return flip, (_uniform(rng, batch, -max_degrees, max_degrees) * _DEG_TO_RAD).astype(np.float32)


RANDAUGMENT_OPS = 14  # the FixMatch pool of ``ops/randaugment.py``
RANDAUGMENT_LAYERS = 2


@dataclass(frozen=True)
class RandAugmentDraws:
    """The draws of ``strong_augment_randaugment`` for a batch: numpy arrays
    on the host, or tensors (``map``), with ``L`` layers of ``B`` images,
    or stacked along a leading step axis."""

    flip: Any  # bool [B]
    op: Any  # int64 [L, B], in [0, 14)
    magnitude: Any  # float32 [L, B], U(0, 1)
    sign: Any  # float32 [L, B], ±1
    cutout_y: Any  # int64 [B], in [0, H)
    cutout_x: Any  # int64 [B], in [0, W)

    def map(self, fn: Callable[[Any], Any]) -> "RandAugmentDraws":
        return RandAugmentDraws(*(fn(getattr(self, f.name)) for f in fields(self)))


def randaugment_draws(
    rng: np.random.Generator, batch: int, height: int, width: int, num_layers: int = RANDAUGMENT_LAYERS
) -> RandAugmentDraws:
    """Per layer the op (``randint(0, 14)``), the magnitude (U(0, 1)) and the
    sign; then the flip and the cutout centre (``cy``, ``cx``): the
    distributions the JAX policy draws, from one host stream."""
    op, magnitude, sign = [], [], []
    for _ in range(num_layers):
        op.append(rng.integers(0, RANDAUGMENT_OPS, batch))
        magnitude.append(rng.random(batch, dtype=np.float32))
        sign.append(np.where(rng.random(batch) < 0.5, np.float32(1.0), np.float32(-1.0)))
    flip = rng.random(batch) < 0.5
    return RandAugmentDraws(
        flip, np.stack(op).astype(np.int64), np.stack(magnitude), np.stack(sign).astype(np.float32),
        rng.integers(0, height, batch), rng.integers(0, width, batch),
    )


@dataclass(frozen=True)
class FixMatchDraws:
    """One FixMatch step's draws, all on the host. The strong view has the
    jitter's four fields, or ``randaugment`` and the four None."""

    sup_flip: np.ndarray  # bool [B], the labeled batch's train augment
    sup_angles: np.ndarray  # float32 [B], radians
    weak_flip: np.ndarray  # bool [U]
    strong_flip: Optional[np.ndarray]  # bool [U]
    strong_angles: Optional[np.ndarray]  # float32 [U], radians
    brightness: Optional[np.ndarray]  # float32 [U], U(−32, 32)
    contrast: Optional[np.ndarray]  # float32 [U], U(0.7, 1.3)
    randaugment: Optional[RandAugmentDraws] = None


def fixmatch_draws(
    seed: int, stream: str, epoch: int, step: int, batch: int, unlabeled_batch: int, max_degrees: float = 10.0,
    strong_aug: str = "jitter", image_size: Optional[tuple] = None,
) -> FixMatchDraws:
    """The draws of ``ssip_tpu/ops/augment.py``'s ``train_augment`` (labeled
    batch), ``weak_augment`` and the strong view (unlabeled batch) for one
    step, each view from its own ``host_rng`` stream named after
    (stream, epoch, step, view). The strong view is ``strong_augment``'s
    jitter, or with ``strong_aug="randaugment"`` the RandAugment policy's
    draws for images of ``image_size`` (H, W)."""
    base = f"{stream}/aug/{epoch}/{step}"
    sup_flip, sup_angles = _flips_and_angles(host_rng(seed, f"{base}/sup"), batch, max_degrees)
    weak_flip = host_rng(seed, f"{base}/weak").random(unlabeled_batch) < 0.5
    rng = host_rng(seed, f"{base}/strong")
    if strong_aug == "randaugment":
        height, width = image_size
        return FixMatchDraws(sup_flip, sup_angles, weak_flip, None, None, None, None,
                             randaugment_draws(rng, unlabeled_batch, height, width))
    strong_flip, strong_angles = _flips_and_angles(rng, unlabeled_batch, max_degrees)
    return FixMatchDraws(
        sup_flip, sup_angles, weak_flip, strong_flip, strong_angles,
        _uniform(rng, unlabeled_batch, -32.0, 32.0), _uniform(rng, unlabeled_batch, 0.7, 1.3),
    )
