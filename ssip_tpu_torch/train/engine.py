"""Training and eval engine with the reference's epoch-driver semantics.

Counterpart of ``ssip_tpu/train/engine.py``: the train state and optimizer
(``:38-86``), the step (``_step_core``, ``:89-142``), the epoch plan
(``:253-347``), the eval epoch (``:379-419``) and the epoch driver
(``train_model``, ``:422-610``).

- One step: train augment (the CUDA kernel of ``ops/rotate.py`` on the
  card) or the eval normalize, the train-mode forward (masked BatchNorm in
  a ResNet; a ViT has no batch statistics and ignores the mask, the
  counterpart of ``:138-139`` and ``:393-397``), the masked mean
  cross-entropy ``Σ(ce·w)/max(Σw, 1)``, autograd backward (cuDNN and cuBLAS
  on the card, and the LayerNorm and attention backward kernels for a ViT)
  and AdamW.
- The dataset stays on the device as resized uint8; an epoch's batch
  indices, valid masks and augmentation coefficients go to the device in
  one copy each, and the per-step losses and predictions come back in one
  copy at the end of the epoch, so the step loop never waits on the host.
- The driver keeps torch's control semantics exactly (``CLAUDE.md``):
  ReduceLROnPlateau (factor 0.5, patience 2, relative threshold 1e-4) on
  the validation loss, early stopping (patience 3), and the best-val-loss
  state returned. The best state is a *copy* (cloned tensors): a
  ``state_dict()`` aliases the live tensors, which is the reference bug
  ``ssip_tpu/train/engine.py:449-458`` documents.

Not in this slice: ``trainable_mask`` (weak pretrain), the mesh and FSDP,
``resume_path`` snapshots, and the fused whole-epoch program (a Python loop
over steps takes its place).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.data.splits import balanced_epoch_indices
from ssip_tpu_torch.ops.augment import augment_coeffs, eval_preprocess
from ssip_tpu_torch.ops.metrics import accuracy_f1
from ssip_tpu_torch.ops.rotate import augment_images
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.runtime.prng import augment_draws, host_rng

LOGGER = get_logger(__name__)

ROTATE_DEGREES = 10.0  # torchvision RandomRotation(10), the train transform


@dataclass
class TrainState:
    """The model, its AdamW optimizer and the count of optimizer steps."""

    model: nn.Module  # a ported arch of models/registry.py
    optimizer: torch.optim.AdamW
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, learning_rate: float, weight_decay: float) -> "TrainState":
        """AdamW with torch's default betas and eps, decay on every
        parameter (``make_optimizer``, ``ssip_tpu/train/engine.py:58-69``)."""
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        return cls(model, optimizer)


def get_lr(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_lr(state: TrainState, lr: float) -> None:
    for group in state.optimizer.param_groups:
        group["lr"] = lr


@dataclass
class DeviceDataset:
    """Device-resident, eval-resized uint8 images and their labels."""

    images_u8: torch.Tensor  # [N, S, S, 3] uint8 on the device
    labels: np.ndarray  # [N] int64, host copy for metrics and sampling
    labels_dev: torch.Tensor  # [N] int64 on the device

    @classmethod
    def create(cls, images_u8: torch.Tensor, labels) -> "DeviceDataset":
        labels = np.asarray(labels, dtype=np.int64)
        return cls(images_u8, labels, torch.from_numpy(labels).to(images_u8.device))

    def __len__(self) -> int:
        return int(self.images_u8.shape[0])


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the valid rows: ``Σ(ce·w)/max(Σw, 1)``."""
    w = valid.to(torch.float32)
    ce = F.cross_entropy(logits.to(torch.float32), labels, reduction="none")
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def train_step(
    state: TrainState,
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    coeffs: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step; returns (loss, argmax predictions), on the device.

    ``coeffs`` is the int32 [3, B] augmentation of ``ops/augment.py:
    augment_coeffs`` on the images' device, or None for no augmentation
    (the eval normalize). The model runs in train mode with ``mask=valid``;
    parameter gradients are left in ``.grad`` after the step.
    """
    model = state.model
    model.train()
    if coeffs is None:
        x = eval_preprocess(images_u8, model.compute_dtype)
    else:
        x = augment_images(images_u8, coeffs, model.compute_dtype)
    logits = model(x, mask=valid)
    loss = masked_cross_entropy(logits, labels, valid)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach(), logits.detach().argmax(dim=1)


def stacked_epoch(order: np.ndarray, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """[steps, batch] index and valid arrays; padding rows are invalid
    (``_stacked_epoch``, ``ssip_tpu/train/engine.py:270-291``)."""
    order = np.asarray(order)
    steps = max(1, (len(order) + batch_size - 1) // batch_size)
    pidx = np.zeros((steps, batch_size), order.dtype if order.size else np.int64)
    valid = np.zeros((steps, batch_size), bool)
    for s in range(steps):
        chunk = order[s * batch_size : (s + 1) * batch_size]
        pidx[s, : len(chunk)] = chunk
        valid[s, : len(chunk)] = True
    return pidx, valid


def epoch_plan(
    train_dataset: DeviceDataset,
    *,
    seed: int,
    epoch: int,
    stream_name: str,
    balanced: bool,
    batch_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One epoch's plan: (pidx [steps, B], valid [steps, B], coeffs
    int32 [steps, 3, B]).

    The index and valid arrays are ``ssip_tpu``'s ``epoch_plan``'s, bit for
    bit; the augmentation keys become ``runtime/prng.py:augment_draws`` of
    the same (seed, stream, epoch, step).
    """
    labels = train_dataset.labels
    if balanced:
        order = balanced_epoch_indices(labels, seed=seed, epoch=epoch, num_samples=len(labels))
    else:
        order = host_rng(seed, f"shuffle/{stream_name}/{epoch}").permutation(len(labels))
    pidx, valid = stacked_epoch(order, batch_size)
    coeffs = np.stack([
        augment_coeffs(*augment_draws(seed, stream_name, epoch, step, batch_size, ROTATE_DEGREES))
        for step in range(pidx.shape[0])
    ])
    return pidx, valid, coeffs


def run_train_epoch(
    state: TrainState, dataset: DeviceDataset, pidx: np.ndarray, valid: np.ndarray,
    coeffs: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Every step of one epoch plan; (per-step losses, predictions [steps, B])."""
    dev = dataset.images_u8.device
    pidx_dev = torch.from_numpy(pidx.astype(np.int64)).to(dev)
    valid_dev = torch.from_numpy(valid).to(dev)
    coeffs_dev = None if coeffs is None else torch.from_numpy(coeffs).to(dev)
    losses, preds = [], []
    for s in range(pidx.shape[0]):
        idx = pidx_dev[s]
        loss, pred = train_step(
            state, dataset.images_u8[idx], dataset.labels_dev[idx], valid_dev[s],
            None if coeffs_dev is None else coeffs_dev[s],
        )
        losses.append(loss)
        preds.append(pred)
    return torch.stack(losses).cpu().numpy(), torch.stack(preds).cpu().numpy()


@torch.no_grad()
def run_eval_epoch(
    model: nn.Module, dataset: DeviceDataset, batch_size: int
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
    """(avg_loss, y_true, y_pred, y_prob [N, C]) over the dataset in order.

    Eval-mode forward (running statistics) batch by batch; the loss is the
    mean of the per-batch mean losses, as the reference averages it
    (``ssip_tpu/train/engine.py:379-419``). The last batch is run short
    rather than padded: in eval mode no row affects another.
    """
    model.eval()
    losses, preds, probs = [], [], []
    for start in range(0, len(dataset), batch_size):
        images = dataset.images_u8[start : start + batch_size]
        labels = dataset.labels_dev[start : start + batch_size]
        logits = model(eval_preprocess(images, model.compute_dtype)).to(torch.float32)
        losses.append(F.cross_entropy(logits, labels))
        preds.append(logits.argmax(dim=1))
        probs.append(torch.softmax(logits, dim=1))
    avg_loss = float(torch.stack(losses).mean())
    return avg_loss, dataset.labels.copy(), torch.cat(preds).cpu().numpy(), torch.cat(probs).cpu().numpy()


@dataclass
class _Snapshot:
    """A copy of the train state, taken at a new best validation loss."""

    step: int
    model: Dict[str, torch.Tensor]
    optimizer: dict

    @classmethod
    def take(cls, state: TrainState) -> "_Snapshot":
        return cls(
            state.step,
            {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            copy.deepcopy(state.optimizer.state_dict()),
        )

    def restore(self, state: TrainState) -> None:
        state.model.load_state_dict(self.model)
        state.optimizer.load_state_dict(self.optimizer)
        state.step = self.step


def train_model(
    state: TrainState,
    train_dataset: DeviceDataset,
    val_dataset: DeviceDataset,
    *,
    num_epochs: int,
    batch_size: int,
    seed: int,
    stream_name: str,
    balanced: bool = True,
    augment: bool = True,
    early_stopping_patience: int = 3,
    plateau_patience: int = 2,
    plateau_factor: float = 0.5,
    checkpoint_fn: Optional[Callable[[TrainState], None]] = None,
) -> Tuple[TrainState, Dict[str, List[float]]]:
    """Epoch driver with reference-parity control flow (common.py:345-432).

    Trains ``state`` in place and returns it restored to its best
    validation loss (parameters, BN statistics where the model has them, optimizer moments and
    learning rate, step count), with the per-epoch history.
    ``checkpoint_fn(state)`` runs at each new best, as in the JAX package.
    """
    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_acc": [],
        "val_acc": [], "train_f1": [], "val_f1": [],
    }
    best = _Snapshot.take(state)
    best_val_loss = math.inf
    early_patience = 0
    plateau_best = math.inf
    plateau_bad = 0

    for epoch in range(num_epochs):
        pidx, valid, coeffs = epoch_plan(
            train_dataset, seed=seed, epoch=epoch, stream_name=stream_name,
            balanced=balanced, batch_size=batch_size,
        )
        losses, preds = run_train_epoch(state, train_dataset, pidx, valid, coeffs if augment else None)
        train_loss = float(np.mean(losses))
        valid_flat = valid.reshape(-1)
        train_acc, train_f1 = accuracy_f1(
            train_dataset.labels[pidx.reshape(-1)[valid_flat]], preds.reshape(-1)[valid_flat]
        )

        val_loss, vy, vp, _ = run_eval_epoch(state.model, val_dataset, batch_size)
        val_acc, val_f1 = accuracy_f1(vy, vp)

        # ReduceLROnPlateau(mode=min, threshold_mode=rel 1e-4): improvement
        # means val_loss < best*(1-1e-4); >patience bad epochs → lr *= factor.
        if val_loss < plateau_best * (1 - 1e-4):
            plateau_best = val_loss
            plateau_bad = 0
        else:
            plateau_bad += 1
            if plateau_bad > plateau_patience:
                new_lr = get_lr(state) * plateau_factor
                LOGGER.info("Plateau: reducing lr to %.2e", new_lr)
                set_lr(state, new_lr)
                plateau_bad = 0

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        history["train_acc"].append(train_acc)
        history["val_acc"].append(val_acc)
        history["train_f1"].append(train_f1)
        history["val_f1"].append(val_f1)

        LOGGER.info(
            "Epoch %d/%d - train loss %.4f acc %.3f f1 %.3f | val loss %.4f acc %.3f f1 %.3f",
            epoch + 1, num_epochs, train_loss, train_acc, train_f1,
            val_loss, val_acc, val_f1,
        )

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            best = _Snapshot.take(state)
            early_patience = 0
            if checkpoint_fn is not None:
                checkpoint_fn(state)
        else:
            early_patience += 1
            if early_patience >= early_stopping_patience:
                LOGGER.info("Early stopping triggered at epoch %d", epoch + 1)
                break

    best.restore(state)
    return state, history
