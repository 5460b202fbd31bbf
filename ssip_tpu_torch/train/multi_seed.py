"""The seed and cross-validation fan-outs: N independent training runs side by side.

Counterpart of ``ssip_tpu/train/multi_seed.py``. The contract is the JAX
module's (``:13-20``): lane ``i`` reproduces a solo
``train_model(seed=seeds[i])`` run. It gets the same ``epoch_plan`` stream
(sampling order and augmentation draws), the same plateau-LR (relative
threshold 1e-4) and early-stop control flow, and its own genuine
best-validation-loss state.

The JAX package vmaps the lanes into one program. Here the lanes run one
after another inside each epoch, each over its own plan and with its own
model and optimizer: ``run_train_epoch`` and ``run_eval_epoch`` of
``train/engine.py``, so each step goes through the same code, kernels
included, as a solo run's. ``torch.func`` would need a batching rule for
the masked BatchNorm's buffer updates and for every custom op of the ViTs.
The contract is per-lane equality, not one program, and this keeps it
exact on the CPU. A lane that stops early stops executing; its history,
best state and learning rate freeze at its stop epoch, as in the JAX
package. ``LaneControl`` keeps the per-lane decisions on the host, a numpy
copy of the JAX class.

Not in this mode, as in the JAX package: resume snapshots and the
per-improvement checkpoint callback.

With a data-parallel ``mesh`` the lanes are split over the data axis when
their count divides it (JAX ``:181-210``): each rank trains its share of
the lanes alone, then the histories and summary rows are gathered in lane
order and each lane's model state (parameters and BatchNorm statistics)
and learning rate are sent from its rank to all, so every rank holds every
lane's best model (its optimizer state stays on its rank). Otherwise the
JAX warning is logged and every rank runs every lane, unsharded.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssip_tpu_torch.ops.metrics import accuracy_f1
from ssip_tpu_torch.parallel.mesh import data_group, data_rank, data_size, model_size
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.train.checkpoints import Snapshot
from ssip_tpu_torch.train.engine import (
    DeviceDataset, TrainState, epoch_plan, get_lr, run_eval_epoch, run_train_epoch, set_lr,
)

LOGGER = get_logger(__name__)


class LaneControl:
    """Per-lane plateau, early-stop and best-val bookkeeping (``:211-263``).

    ``train_model``'s scalar control flow applied lane by lane: stopped
    lanes are inert, their best, learning rate and counters frozen.
    """

    def __init__(
        self,
        n_lanes: int,
        *,
        early_stopping_patience: int = 3,
        plateau_patience: int = 2,
        plateau_factor: float = 0.5,
    ):
        self.early_stopping_patience = early_stopping_patience
        self.plateau_patience = plateau_patience
        self.plateau_factor = plateau_factor
        self.best_val = np.full(n_lanes, math.inf)
        self.early_pat = np.zeros(n_lanes, np.int64)
        self.plateau_best = np.full(n_lanes, math.inf)
        self.plateau_bad = np.zeros(n_lanes, np.int64)
        self.stopped = np.zeros(n_lanes, bool)

    def update(self, val_loss_vec: np.ndarray, lr_vec: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One epoch's decisions: (improved, newly_stopped, new_lr_vec)."""
        active = ~self.stopped
        v = np.where(active, np.asarray(val_loss_vec, np.float64), math.inf)
        lr_vec = np.asarray(lr_vec, np.float32).copy()

        # ReduceLROnPlateau(mode=min, threshold_mode=rel 1e-4): improvement
        # means v < best*(1-1e-4); >patience bad epochs → lr *= factor.
        plateau_impr = active & (v < self.plateau_best * (1 - 1e-4))
        self.plateau_best = np.where(plateau_impr, v, self.plateau_best)
        self.plateau_bad = np.where(plateau_impr, 0, self.plateau_bad + active)
        cut = active & ~plateau_impr & (self.plateau_bad > self.plateau_patience)
        lr_vec[cut] *= self.plateau_factor
        self.plateau_bad[cut] = 0

        improved = active & (v < self.best_val)
        self.best_val = np.where(improved, v, self.best_val)
        self.early_pat = np.where(improved, 0, self.early_pat + active)
        newly_stopped = active & ~improved & (self.early_pat >= self.early_stopping_patience)
        self.stopped |= newly_stopped
        return improved, newly_stopped, lr_vec


def _lane_subset(dataset: DeviceDataset, indices: np.ndarray) -> DeviceDataset:
    idx = np.asarray(indices)
    return DeviceDataset.create(dataset.images_u8[torch.from_numpy(idx).to(dataset.images_u8.device)],
                                dataset.labels[idx])


def train_multi_seed(
    states: Sequence[TrainState],
    train_dataset: DeviceDataset,
    val_dataset: DeviceDataset,
    *,
    seeds: Sequence[int],
    num_epochs: int,
    batch_size: int,
    stream_name: str,
    balanced: bool = True,
    augment: bool = True,
    early_stopping_patience: int = 3,
    plateau_patience: int = 2,
    plateau_factor: float = 0.5,
    trainable_mask: Optional[Dict[str, bool]] = None,
    lane_train_pools: Optional[Sequence[np.ndarray]] = None,
    lane_val_pools: Optional[Sequence[np.ndarray]] = None,
    mesh=None,
    num_samples: Optional[int] = None,
) -> Tuple[List[TrainState], List[Dict[str, List[float]]], List[Dict[str, Any]]]:
    """Train ``len(seeds)`` independent models, lane ``i`` from
    ``states[i]`` with seed ``seeds[i]``.

    Returns ``(best_states, histories, summary)``: the lanes' states,
    trained in place and restored to their best validation loss; one
    history dict per lane, ended at its stop epoch; one summary row per
    lane (seed, best_val_loss, epochs_run, stopped_early, final_lr).

    ``lane_train_pools`` and ``lane_val_pools`` (together): per-lane index
    sets into ``train_dataset``, the cross-validation shape. Every lane's
    epoch has the largest fold's length, and each lane validates on its own
    indices of ``train_dataset``; ``val_dataset`` is then not read.
    ``num_samples`` overrides that epoch length (a rank's share of the
    lanes keeps the length of all of them).
    """
    n_lanes = len(states)
    kwargs = dict(
        num_epochs=num_epochs, batch_size=batch_size, stream_name=stream_name, balanced=balanced, augment=augment,
        early_stopping_patience=early_stopping_patience, plateau_patience=plateau_patience,
        plateau_factor=plateau_factor, trainable_mask=trainable_mask,
    )
    if model_size(mesh) > 1:
        raise ValueError(
            "multi-seed training repurposes the mesh data axis for the seed "
            "fan-out; tensor parallelism (mesh model axis > 1) is not "
            "combinable with num_seeds > 1"
        )
    n_data = data_size(mesh)
    if n_data > 1:
        if n_lanes % n_data == 0:
            return _train_lanes_sharded(states, train_dataset, val_dataset, seeds, lane_train_pools,
                                        lane_val_pools, mesh, kwargs)
        LOGGER.warning(
            "num_seeds=%d does not divide the mesh data axis (%d) — running "
            "the seed fan-out unsharded on the default device",
            n_lanes, n_data,
        )
    assert n_lanes == len(seeds) and n_lanes >= 1
    assert lane_train_pools is None or len(lane_train_pools) == n_lanes
    assert (lane_val_pools is None) == (lane_train_pools is None), (
        "lane_train_pools and lane_val_pools come together (CV mode)"
    )
    if lane_val_pools is not None and any(len(p) == 0 for p in lane_val_pools):
        # an empty validation fold gives a NaN loss and meaningless control flow
        raise ValueError("every lane's validation pool must be non-empty")
    train_samples = num_samples
    if train_samples is None and lane_train_pools is not None:
        train_samples = max(len(p) for p in lane_train_pools)
    if lane_val_pools is None:
        val_sets = [val_dataset] * n_lanes
    else:
        val_sets = [_lane_subset(train_dataset, p) for p in lane_val_pools]

    histories: List[Dict[str, List[float]]] = [
        {"train_loss": [], "val_loss": [], "train_acc": [], "val_acc": [], "train_f1": [], "val_f1": []}
        for _ in range(n_lanes)
    ]
    best = [Snapshot.take(state) for state in states]
    ctl = LaneControl(
        n_lanes,
        early_stopping_patience=early_stopping_patience,
        plateau_patience=plateau_patience,
        plateau_factor=plateau_factor,
    )

    for epoch in range(num_epochs):
        was_active = ~ctl.stopped
        val_loss_vec = np.full(n_lanes, math.inf)
        for s in np.flatnonzero(was_active):
            pidx, valid, coeffs = epoch_plan(
                train_dataset, seed=seeds[s], epoch=epoch, stream_name=stream_name, balanced=balanced,
                batch_size=batch_size, pool=None if lane_train_pools is None else lane_train_pools[s],
                num_samples=train_samples,
            )
            losses, preds = run_train_epoch(
                states[s], train_dataset, pidx, valid, coeffs if augment else None, trainable_mask
            )
            valid_flat = valid.reshape(-1)
            train_acc, train_f1 = accuracy_f1(
                train_dataset.labels[pidx.reshape(-1)[valid_flat]], preds.reshape(-1)[valid_flat]
            )
            val_loss, vy, vp, _ = run_eval_epoch(states[s].model, val_sets[s], batch_size)
            val_acc, val_f1 = accuracy_f1(vy, vp)
            val_loss_vec[s] = val_loss
            h = histories[s]
            h["train_loss"].append(float(np.mean(losses)))
            h["val_loss"].append(val_loss)
            h["train_acc"].append(train_acc)
            h["val_acc"].append(val_acc)
            h["train_f1"].append(train_f1)
            h["val_f1"].append(val_f1)

        lr_before = np.array([get_lr(state) for state in states], np.float32)
        improved, newly_stopped, lr_after = ctl.update(val_loss_vec, lr_before)
        for s in np.flatnonzero(lr_after != lr_before):
            # the solo driver's Python-float product, so the lane keeps its solo run's learning rate
            set_lr(states[s], get_lr(states[s]) * plateau_factor)
            LOGGER.info("Plateau (seed %d): reducing lr to %.2e", seeds[s], get_lr(states[s]))
        for s in np.flatnonzero(improved):
            best[s] = Snapshot.take(states[s])
        for s in np.flatnonzero(newly_stopped):
            LOGGER.info("Early stopping (seed %d) at epoch %d", seeds[s], epoch + 1)

        LOGGER.info(
            "Epoch %d/%d [multi-seed] %s", epoch + 1, num_epochs,
            ", ".join(f"seed {seeds[s]}: val {val_loss_vec[s]:.4f}" for s in np.flatnonzero(was_active)),
        )
        if ctl.stopped.all():
            break

    summary = [
        {
            "seed": int(seeds[s]),
            "best_val_loss": float(ctl.best_val[s]),
            "epochs_run": len(histories[s]["val_loss"]),
            "stopped_early": bool(ctl.stopped[s]),
            "final_lr": float(np.float32(get_lr(states[s]))),
        }
        for s in range(n_lanes)
    ]
    for snapshot, state in zip(best, states):
        snapshot.restore(state)
    return list(states), histories, summary


def _train_lanes_sharded(states, train_dataset, val_dataset, seeds, lane_train_pools, lane_val_pools, mesh, kwargs):
    """Each rank trains its contiguous share of the lanes; results gathered in lane order."""
    import torch.distributed as dist

    n_lanes, n_data = len(states), data_size(mesh)
    per = n_lanes // n_data
    group = data_group(mesh)
    mine = slice(data_rank(mesh) * per, (data_rank(mesh) + 1) * per)
    pick = (lambda xs: None if xs is None else list(xs)[mine])
    samples = None if lane_train_pools is None else max(len(p) for p in lane_train_pools)
    _, histories, summary = train_multi_seed(
        list(states)[mine], train_dataset, val_dataset, seeds=list(seeds)[mine],
        lane_train_pools=pick(lane_train_pools), lane_val_pools=pick(lane_val_pools),
        num_samples=samples, **kwargs,
    )
    gathered: List[Any] = [None] * n_data
    dist.all_gather_object(gathered, (histories, summary), group=group)
    histories = [h for part in gathered for h in part[0]]
    summary = [row for part in gathered for row in part[1]]
    for lane, state in enumerate(states):
        src = dist.get_global_rank(group, lane // per)
        for tensor in state.model.state_dict().values():
            dist.broadcast(tensor, src=src, group=group)
        set_lr(state, summary[lane]["final_lr"] if lane // per != data_rank(mesh) else get_lr(state))
    return list(states), histories, summary
