"""Stratified splits and balanced resampling, with numpy and no scikit-learn.

Counterpart of ``ssip_tpu/data/splits.py:23-49``, ``:52-82`` (the k-fold
split of ``--cv-folds``) and ``:85-104``. The JAX
package splits with scikit-learn's two-stage ``train_test_split(...,
stratify=...)``; the split indices are a persisted artifact
(``training_history.json``, read back by the threshold sweep), so the port
must give the same indices without scikit-learn. ``_stratified_shuffle``
rebuilds what ``train_test_split`` runs for a float ``test_size``:
``_validate_shuffle_split`` (``n_test = ceil(test_size·n)``), then one
iteration of ``StratifiedShuffleSplit._iter_indices`` with
``_approximate_mode`` for the per-class counts, drawing from
``np.random.RandomState(seed)`` in the same order
(``tests/test_torch_supervised.py`` holds it to scikit-learn index for index).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

from ssip_tpu_torch.runtime.prng import host_rng


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """Per-class draw counts summing to ``n_draws``; ties in the leftover
    share are broken at random (scikit-learn ``utils/extmath.py``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle(y: Sequence[int], test_size: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions into ``y``: ``train_test_split(test_size=…,
    random_state=seed, stratify=y)``'s index arithmetic."""
    y = np.asarray(y)
    n = len(y)
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the train set is empty")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few: "
            f"{classes[class_counts < 2].tolist()}"
        )
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each reach the number of classes ({len(classes)})"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_split(
    targets: Sequence[int], val_size: float, test_size: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, val, test) index arrays; exact index parity with the reference."""
    targets = np.asarray(targets)
    indices = np.arange(len(targets))
    train, temp = _stratified_shuffle(targets, val_size + test_size, seed)
    temp_idx = indices[temp]
    val, test = _stratified_shuffle(targets[temp], test_size / (val_size + test_size), seed)
    return indices[train], temp_idx[val], temp_idx[test]


def split_dict(
    targets: Sequence[int], val_size: float, test_size: float, seed: int
) -> Dict[str, np.ndarray]:
    train, val, test = stratified_split(targets, val_size, test_size, seed)
    return {"train": train, "val": val, "test": test}


def stratified_kfold_indices(targets: Sequence[int], k: int, seed: int) -> list[Tuple[np.ndarray, np.ndarray]]:
    """K stratified folds: [(train_idx, val_idx)] covering every index once.

    Per class, a seeded shuffle dealt round-robin over the folds, so each
    class spreads as evenly as it can; index for index the JAX package's.
    """
    targets = np.asarray(targets, dtype=np.int64)
    if not 2 <= k <= len(targets):
        raise ValueError(f"cv folds must be in [2, n_samples], got {k}")
    max_class = int(np.bincount(targets).max())
    if k > max_class:
        # round-robin would leave the folds past the largest class count
        # without a validation sample (NaN metrics downstream)
        raise ValueError(
            f"cv folds ({k}) exceeds the largest class count ({max_class}); "
            "every fold needs at least one validation sample"
        )
    rng = host_rng(seed, "kfold")
    fold_of = np.empty(len(targets), dtype=np.int64)
    for cls in np.unique(targets):
        idx = np.flatnonzero(targets == cls)
        idx = idx[rng.permutation(len(idx))]
        fold_of[idx] = np.arange(len(idx)) % k
    all_idx = np.arange(len(targets))
    return [(all_idx[fold_of != f], all_idx[fold_of == f]) for f in range(k)]


def balanced_sample_weights(labels: Sequence[int]) -> np.ndarray:
    """Per-sample weights 1/class-count; uniform if fewer than 2 classes."""
    labels = np.asarray(labels, dtype=np.int64)
    counts = np.bincount(labels)
    if len(np.nonzero(counts)[0]) < 2:
        return np.ones(len(labels), dtype=np.float64)
    weights = 1.0 / counts
    return weights[labels].astype(np.float64)


def balanced_epoch_indices(
    labels: Sequence[int], seed: int, epoch: int, num_samples: int | None = None
) -> np.ndarray:
    """One epoch's balanced resample (with replacement), deterministic."""
    labels = np.asarray(labels, dtype=np.int64)
    n = int(num_samples) if num_samples is not None else len(labels)
    weights = balanced_sample_weights(labels)
    p = weights / weights.sum()
    rng = host_rng(seed, f"balanced_sampler/{epoch}")
    return rng.choice(len(labels), size=n, replace=True, p=p)
