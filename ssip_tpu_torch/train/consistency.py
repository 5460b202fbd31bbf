"""Augmentation-consistency (FixMatch-style) semi-supervised training.

Counterpart of ``ssip_tpu/train/consistency.py``: alongside each labeled
step, an unlabeled batch contributes

    λ · CE( logits(strong_aug(u)), argmax p_weak(u) ) · 1[max p_weak ≥ τ]

where the weak view (flip only) gives the pseudo-target without gradient.
Enabled by ``--consistency-weight λ`` (τ by ``--consistency-threshold``) on
the semi-supervised CLI.

One step, in the JAX step's order of effects on the BatchNorm statistics:

1. the weak view through the model in **eval mode** (the running statistics
   as the step found them), no gradient, with the EMA parameters when
   ``ema_decay > 0``; a module mutates its buffers, so this pass runs first;
2. the labeled batch (``train_augment``) in train mode with the valid mask;
3. the strong view in train mode with no mask, from the statistics pass 2
   left: the BatchNorm momentum is applied twice a step, in that order;
4. loss = sup + λ·cons with ``cons`` divided by ``max(Σkeep, 1)``, plus the
   auxiliary terms (an MoE ViT's load-balance and router z-losses) of pass
   2 alone, as ``:86-92`` counts them once a step; backward, AdamW, then
   ``ema = d·ema + (1 − d)·params`` (parameters only: the statistics are the
   live ones).

The strong view is the JAX step's ``strong_aug`` (``:59-66``): the
jitter, whose rotation is the CUDA kernel of ``ops/rotate.py:
rotate_images`` on the card, or ``"randaugment"``, the FixMatch paper's
RandAugment + Cutout policy of ``ops/randaugment.py`` (plain PyTorch, as
the JAX package computes it in plain XLA); the labeled view's rotation is
``augment_images``. The mesh is not ported; the whole-epoch ``lax.scan``
is a Python loop of steps. ``resume_path`` snapshots the student every epoch, as
``train_model`` does (``:295-400``); with an EMA teacher the resumed run
reseeds the average from the ``.best`` sidecar, which holds the EMA
parameters, the JAX package's approximation.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssip_tpu_torch.data.splits import balanced_epoch_indices
from ssip_tpu_torch.ops.augment import augment_coeffs, strong_augment, weak_augment
from ssip_tpu_torch.ops.metrics import accuracy_f1
from ssip_tpu_torch.ops.randaugment import draws_geometry, strong_augment_randaugment
from ssip_tpu_torch.ops.rotate import augment_images
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.runtime.prng import RandAugmentDraws, fixmatch_draws, host_rng
from ssip_tpu_torch.train.checkpoints import Snapshot, check_snapshot_format, restore_resume_state, save_train_snapshot
from ssip_tpu_torch.train.engine import (
    ROTATE_DEGREES, DeviceDataset, TrainState, aux_loss_terms, get_lr, masked_cross_entropy, run_eval_epoch, set_lr,
    stacked_epoch,
)

LOGGER = get_logger(__name__)


STRONG_AUGS = ("jitter", "randaugment")


def check_strong_aug(strong_aug: str) -> None:
    if strong_aug not in STRONG_AUGS:
        raise ValueError(f"unknown strong_aug {strong_aug!r}")


@dataclass
class ViewDraws:
    """The three views' draws as tensors on the device: of one step, or
    stacked along a leading step axis (index it to get one step's). The
    strong view has the jitter's three fields, or ``randaugment`` with its
    ``randaugment_geo`` and the three None."""

    sup_coeffs: torch.Tensor  # int32 [3, B], ``augment_coeffs`` of the labeled batch
    weak_flip: torch.Tensor  # bool [U]
    strong_coeffs: Optional[torch.Tensor]  # int32 [3, U]
    brightness: Optional[torch.Tensor]  # float32 [U]
    contrast: Optional[torch.Tensor]  # float32 [U]
    randaugment: Optional[RandAugmentDraws] = None  # of tensors
    randaugment_geo: Optional[torch.Tensor] = None  # int32 [L, 6, U], ``ops/randaugment.py:geometry``

    def _map(self, fn) -> "ViewDraws":
        def one(value):
            if value is None:
                return None
            return value.map(fn) if isinstance(value, RandAugmentDraws) else fn(value)

        return ViewDraws(*(one(getattr(self, f.name)) for f in fields(self)))

    def __getitem__(self, step: int) -> "ViewDraws":
        return self._map(lambda t: t[step])

    def to(self, device: torch.device) -> "ViewDraws":
        return self._map(lambda t: t.to(device))


def epoch_view_draws(
    seed: int, stream: str, epoch: int, steps: int, batch: int, unlabeled_batch: int, device: torch.device,
    strong_aug: str = "jitter", image_size: Optional[Tuple[int, int]] = None,
) -> ViewDraws:
    """Every step's draws of one epoch (``runtime/prng.py:fixmatch_draws``),
    stacked and sent to ``device`` in one copy each. RandAugment's warp
    matrices are made here on the host, from the draws, for images of
    ``image_size`` (H, W)."""
    draws = [fixmatch_draws(seed, stream, epoch, s, batch, unlabeled_batch, ROTATE_DEGREES, strong_aug, image_size)
             for s in range(steps)]
    sup = np.stack([augment_coeffs(d.sup_flip, d.sup_angles) for d in draws])
    weak = np.stack([d.weak_flip for d in draws])
    if strong_aug == "randaugment":
        ra = RandAugmentDraws(*(np.stack(column) for column in zip(*(
            [getattr(d.randaugment, f.name) for f in fields(RandAugmentDraws)] for d in draws))))
        view = ViewDraws(torch.from_numpy(sup), torch.from_numpy(weak), None, None, None,
                         ra.map(torch.from_numpy), torch.from_numpy(draws_geometry(ra, *image_size)))
        return view.to(device)
    stacked = (
        sup, weak,
        np.stack([augment_coeffs(d.strong_flip, d.strong_angles) for d in draws]),
        np.stack([d.brightness for d in draws]),
        np.stack([d.contrast for d in draws]),
    )
    return ViewDraws(*map(torch.from_numpy, stacked)).to(device)


def strong_view(unlabeled_u8: torch.Tensor, draws: ViewDraws, dtype) -> torch.Tensor:
    """The step's strong view: RandAugment when its draws are there, else
    the jitter."""
    if draws.randaugment is not None:
        return strong_augment_randaugment(unlabeled_u8, draws.randaugment, dtype, draws.randaugment_geo)
    return strong_augment(unlabeled_u8, draws.strong_coeffs, draws.brightness, draws.contrast, dtype)


@contextmanager
def swapped_parameters(model: nn.Module, params: Optional[Dict[str, torch.Tensor]]) -> Iterator[None]:
    """Within the block the model's parameters are ``params`` (name →
    tensor; None leaves the model as it is), its buffers the live ones: the
    EMA teacher's forward, validation and snapshot without a second model."""
    if params is None:
        yield
        return
    named = dict(model.named_parameters())
    live = {name: p.data for name, p in named.items()}
    try:
        for name, p in named.items():
            p.data = params[name]
        yield
    finally:
        for name, p in named.items():
            p.data = live[name]


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The EMA average starts at the student."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], model: nn.Module, ema_decay: float) -> None:
    """``ema = d·ema + (1 − d)·params``, in place."""
    names = list(ema_params)
    live = dict(model.named_parameters())
    averages = [ema_params[name] for name in names]
    torch._foreach_mul_(averages, ema_decay)
    torch._foreach_add_(averages, [live[name].detach() for name in names], alpha=1.0 - ema_decay)


def fixmatch_step(
    state: TrainState,
    ema_params: Optional[Dict[str, torch.Tensor]],
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    unlabeled_u8: torch.Tensor,
    draws: ViewDraws,
    *,
    consistency_weight: float,
    confidence_threshold: float,
    ema_decay: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FixMatch optimizer step; returns (loss, supervised loss,
    consistency loss, keep rate, argmax predictions of the labeled batch), on
    the device. ``ema_params`` (None: the teacher is the live student) is
    updated in place after the optimizer step; gradients stay in ``.grad``."""
    model = state.model
    dtype = model.compute_dtype
    x_sup = augment_images(images_u8, draws.sup_coeffs, dtype)
    x_weak = weak_augment(unlabeled_u8, draws.weak_flip, dtype)
    x_strong = strong_view(unlabeled_u8, draws, dtype)

    model.eval()
    with torch.no_grad(), swapped_parameters(model, ema_params):
        probs_weak = torch.softmax(model(x_weak).to(torch.float32), dim=1)
    conf, pseudo = probs_weak.max(dim=1)
    keep = conf >= confidence_threshold

    model.train()
    logits_sup = model(x_sup, mask=valid)
    aux_terms = aux_loss_terms(model)  # the labeled view's; the strong view's are dropped
    sup_loss = masked_cross_entropy(logits_sup, labels, valid)
    cons_loss = masked_cross_entropy(model(x_strong), pseudo, keep)
    loss = sup_loss + consistency_weight * cons_loss
    for term in aux_terms:
        loss = loss + term
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    if ema_params is not None:
        update_ema(ema_params, model, ema_decay)
    return (loss.detach(), sup_loss.detach(), cons_loss.detach(), keep.to(torch.float32).mean(),
            logits_sup.detach().argmax(dim=1))


def train_fixmatch(
    state: TrainState,
    train_dataset: DeviceDataset,
    val_dataset: DeviceDataset,
    unlabeled_images: torch.Tensor,
    *,
    num_epochs: int,
    batch_size: int,
    unlabeled_batch_size: int,
    seed: int,
    stream_name: str,
    consistency_weight: float,
    confidence_threshold: float,
    early_stopping_patience: int = 3,
    plateau_patience: int = 2,
    plateau_factor: float = 0.5,
    ema_decay: float = 0.0,
    strong_aug: str = "jitter",
    resume_path: Optional[Path] = None,
) -> Tuple[TrainState, Dict[str, List[float]]]:
    """Epoch loop with ``train_model``'s control flow plus consistency.

    The unlabeled batches' indices are the JAX run's, index for index
    (``host_rng(seed, "<stream>/unlabeled/<epoch>")``). With
    ``ema_decay > 0`` the validation metrics, the plateau and early-stop
    signals and the returned best state are the EMA model's (the model
    FixMatch reports). Trains ``state`` in place and returns it restored to
    its best validation loss, with the per-epoch history. ``resume_path``
    as in ``train_model``; the per-epoch snapshot is the student's, and on
    resume the EMA average restarts from the ``.best`` sidecar's parameters
    (EMA parameters), an approximation that re-converges within about
    1/(1 − d) steps, as in the JAX package.
    """
    check_strong_aug(strong_aug)
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay={ema_decay} must be in [0, 1)")
    model = state.model
    dev = train_dataset.images_u8.device
    ema_params = init_ema(model) if ema_decay > 0.0 else None
    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_acc": [],
        "val_acc": [], "train_f1": [], "val_f1": [],
        "consistency_loss": [], "consistency_keep_rate": [],
    }
    best = Snapshot.take(state)
    best_val, early = math.inf, 0
    plateau_best, plateau_bad = math.inf, 0
    n_unlabeled = int(unlabeled_images.shape[0])
    epoch_start = 0

    if resume_path is not None:
        check_snapshot_format(resume_path)
        if Path(resume_path).exists():
            driver, best_r = restore_resume_state(resume_path, state)
            if driver is not None:
                best = best_r
                if ema_params is not None:  # the .best parameters are EMA parameters
                    ema_params = {name: best.model[name].detach().to(dev, copy=True) for name in ema_params}
                history = driver["history"]
                best_val = driver["best_val_loss"]
                early = driver["early_patience"]
                plateau_best = driver["plateau_best"]
                plateau_bad = driver["plateau_bad"]
                epoch_start = driver["epoch"] + 1
                LOGGER.info("Resumed '%s' from %s at epoch %d", stream_name, resume_path, epoch_start)
                if driver.get("finished"):
                    best.restore(state)
                    return state, history

    for epoch in range(epoch_start, num_epochs):
        order = balanced_epoch_indices(
            train_dataset.labels, seed=seed, epoch=epoch, num_samples=len(train_dataset)
        )
        pidx, valid = stacked_epoch(order, batch_size)
        steps = pidx.shape[0]
        u_rng = host_rng(seed, f"{stream_name}/unlabeled/{epoch}")
        u_idx = u_rng.integers(0, n_unlabeled, size=(steps, unlabeled_batch_size))
        draws = epoch_view_draws(seed, stream_name, epoch, steps, batch_size, unlabeled_batch_size, dev,
                                 strong_aug, tuple(unlabeled_images.shape[1:3]))
        pidx_dev = torch.from_numpy(pidx.astype(np.int64)).to(dev)
        valid_dev = torch.from_numpy(valid).to(dev)
        u_idx_dev = torch.from_numpy(u_idx.astype(np.int64)).to(dev)
        metrics = []
        for s in range(steps):
            idx = pidx_dev[s]
            metrics.append(fixmatch_step(
                state, ema_params, train_dataset.images_u8[idx], train_dataset.labels_dev[idx], valid_dev[s],
                unlabeled_images[u_idx_dev[s]], draws[s], consistency_weight=consistency_weight,
                confidence_threshold=confidence_threshold, ema_decay=ema_decay,
            ))
        # one copy to the host per epoch, so the step loop never waits on it
        losses, _sup, cons, keep, preds = (torch.stack(column).cpu().numpy() for column in zip(*metrics))
        train_loss = float(np.mean(losses))
        valid_flat = valid.reshape(-1)
        train_acc, train_f1 = accuracy_f1(
            train_dataset.labels[pidx.reshape(-1)[valid_flat]], preds.reshape(-1)[valid_flat]
        )
        with swapped_parameters(model, ema_params):
            val_loss, vy, vp, _ = run_eval_epoch(model, val_dataset, batch_size)
        val_acc, val_f1 = accuracy_f1(vy, vp)
        improved = val_loss < best_val
        if improved:
            # the state that was validated: taken before the plateau rule
            # below touches the learning rate, as the JAX epoch loop keeps it
            with swapped_parameters(model, ema_params):
                best = Snapshot.take(state)

        if val_loss < plateau_best * (1 - 1e-4):
            plateau_best, plateau_bad = val_loss, 0
        else:
            plateau_bad += 1
            if plateau_bad > plateau_patience:
                set_lr(state, get_lr(state) * plateau_factor)
                plateau_bad = 0

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        history["train_acc"].append(train_acc)
        history["val_acc"].append(val_acc)
        history["train_f1"].append(train_f1)
        history["val_f1"].append(val_f1)
        history["consistency_loss"].append(float(np.mean(cons)))
        history["consistency_keep_rate"].append(float(np.mean(keep)))
        LOGGER.info(
            "FixMatch epoch %d/%d - loss %.4f (cons %.4f, keep %.2f) | val loss %.4f acc %.3f",
            epoch + 1, num_epochs, train_loss, history["consistency_loss"][-1],
            history["consistency_keep_rate"][-1], val_loss, val_acc,
        )

        stopped = False
        if improved:
            best_val, early = val_loss, 0
            if resume_path is not None:
                save_train_snapshot(Path(str(resume_path) + ".best"), best, {"epoch": epoch})
        else:
            early += 1
            if early >= early_stopping_patience:
                LOGGER.info("Early stopping triggered at epoch %d", epoch + 1)
                stopped = True

        if resume_path is not None:
            save_train_snapshot(resume_path, Snapshot.take(state), {
                "epoch": epoch, "history": history, "best_val_loss": best_val, "early_patience": early,
                "plateau_best": plateau_best, "plateau_bad": plateau_bad, "finished": stopped,
            })
        if stopped:
            break

    best.restore(state)
    return state, history
