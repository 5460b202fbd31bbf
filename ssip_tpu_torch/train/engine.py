"""Training and eval engine with the reference's epoch-driver semantics.

Counterpart of ``ssip_tpu/train/engine.py``: the train state and optimizer
(``:38-86``), the step (``_step_core``, ``:89-142``), the epoch plan
(``:253-347``), the eval epoch (``:379-419``) and the epoch driver
(``train_model``, ``:422-610``). ``train/multi_seed.py`` runs several
such drivers side by side.

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

- ``trainable_mask`` (parameter name → bool, ``head_only_mask`` for the
  weak pretrain) freezes by gradient, not by eval mode, as ``_step_core``
  does: the model stays in train mode, so a frozen backbone's BatchNorm
  running statistics still move, while a frozen parameter gets no gradient
  and hence no AdamW update and no decoupled weight decay.
- The loss adds every auxiliary term the train-mode forward left
  (``aux_loss_terms``: an MoE ViT's load-balance and router z-losses,
  ``models/moe.py``), as ``:113-117`` adds every sown ``"aux"`` leaf.
- ``resume_path``: a snapshot of the train state and the driver every
  epoch, and a ``.best`` sidecar at each new best; an existing snapshot
  restores the run mid-stream (``train/checkpoints.py``, ``:488-606``).

- Data parallelism (``TrainState.mesh``, one process a card over
  ``torch.distributed``): the JAX step sees the global batch, so the port
  rebuilds its semantics by hand. Every rank builds the same global
  ``epoch_plan`` (the batch padded to a multiple of the data axis, the
  augmentation drawn for the batch's rows and the identity for the
  padding) and takes its rows (``parallel/mesh.py:local_rows``). The masked
  BatchNorm sums its statistics over the ranks with autograd and the MoE
  layers their routing statistics (``synced_batch``); the cross-entropy is
  the global ``Σ(ce·w)/max(Σw, 1)``, each rank's loss its share of it; the
  gradients are summed over the ranks by hand after the backward (a
  wrapper's reducer would fix its gradient set at wrap time, and the
  head-only pretrain changes it each stage), so they equal the
  single-process gradient, and every rank's AdamW takes the same step.
  Predictions are gathered in order at the end of the epoch.
  ``run_eval_epoch`` shards each batch the same way. With ``--fsdp`` the
  model is FSDP2-sharded (``parallel/fsdp.py``) and only the parameters it
  keeps whole need the hand sum.
- The model axis (``--mesh-model``, a mesh of data × model processes):
  ``TrainState.create`` slices the model over it (``parallel/tensor.py``),
  the ranks of one model group hold the same rows, and every statistic,
  gradient sum, loss and prediction above is over the data group only.
  A leaf the model axis does not slice is computed alike on every model
  rank (its gradient too: ``tests/test_torch_tensor_parallel.py`` holds
  them equal); a sliced one has this rank's slice of the gradient, and
  AdamW steps each rank's slices. A sequence-parallel ViT
  (``parallel/sequence.py``) lists the leaves whose gradients are
  partial sums over the model axis (``model_axis_partial``); they are
  summed over it first.

Not ported: the fused whole-epoch program (a Python loop over steps takes
its place).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.data.splits import balanced_epoch_indices
from ssip_tpu_torch.ops.augment import augment_coeffs, eval_preprocess
from ssip_tpu_torch.ops.metrics import accuracy_f1
from ssip_tpu_torch.ops.rotate import augment_images
from ssip_tpu_torch.parallel.distributed import gather_rows, synced_batch
from ssip_tpu_torch.parallel.fsdp import replicated_params
from ssip_tpu_torch.parallel.mesh import data_group, data_size, local_rows, pad_to_multiple
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.runtime.prng import augment_draws, host_rng
from ssip_tpu_torch.train.checkpoints import Snapshot, restore_resume_state, save_train_snapshot, snapshot_exists

LOGGER = get_logger(__name__)

ROTATE_DEGREES = 10.0  # torchvision RandomRotation(10), the train transform


@dataclass
class TrainState:
    """The model, its AdamW optimizer and the count of optimizer steps;
    ``mesh`` is the data-parallel ``DeviceMesh`` (None: one process)."""

    model: nn.Module  # a ported arch of models/registry.py
    optimizer: torch.optim.AdamW
    step: int = 0
    mesh: Any = None

    @classmethod
    def create(cls, model: nn.Module, learning_rate: float, weight_decay: float, mesh=None) -> "TrainState":
        """AdamW with torch's default betas and eps, decay on every
        parameter (``make_optimizer``, ``ssip_tpu/train/engine.py:58-69``).
        Under FSDP ``model`` is sharded already, so the moments are too; its
        sharded and its whole parameters are two parameter groups (the same
        settings), since a foreach kernel takes one kind of tensor. On a
        mesh with a model axis the model is sliced over it first, unless it
        is already (``parallel/tensor.py:shard_model``)."""
        from torch.distributed.tensor import DTensor

        from ssip_tpu_torch.parallel.tensor import shard_model

        model = shard_model(model, mesh)
        params = list(model.parameters())
        sharded = [p for p in params if isinstance(p, DTensor)]
        groups = [sharded, [p for p in params if not isinstance(p, DTensor)]] if sharded else [params]
        optimizer = torch.optim.AdamW(
            [{"params": g} for g in groups if g], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        return cls(model, optimizer, mesh=mesh)

    @property
    def group(self):
        """The data axis' group when it spans more than one process, else None."""
        return data_group(self.mesh) if data_size(self.mesh) > 1 else None


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


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, total=None
) -> torch.Tensor:
    """Mean cross-entropy over the valid rows: ``Σ(ce·w)/max(Σw, 1)``.
    ``total``: the global batch's ``Σw`` (a number or a tensor) under data
    parallelism, where this rank's rows give its share of the global mean."""
    w = valid.to(torch.float32)
    ce = F.cross_entropy(logits.to(torch.float32), labels, reduction="none")
    if total is None:
        total = w.sum()
    return (ce * w).sum() / torch.clamp(torch.as_tensor(total, dtype=torch.float32, device=w.device), min=1.0)


def _sum_gradients(params, group) -> None:
    """Sum the gradients of ``params`` over ``group``, in one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def sync_gradients(state: "TrainState") -> None:
    """Sum the gradients over the data axis: all of them under data
    parallelism, those FSDP keeps whole under ``--fsdp`` (it
    reduce-scatters the others itself). Before that, the gradients a
    model lists as partial over the model axis (``model_axis_partial``)
    are summed over it. A no-op for one process."""
    partial = model_axis_partial(state.model)
    if partial:
        from ssip_tpu_torch.parallel.mesh import model_group

        _sum_gradients(partial, model_group(state.mesh))
    if state.group is not None:
        _sum_gradients(replicated_params(state.model), state.group)


def model_axis_partial(model: nn.Module) -> List[nn.Parameter]:
    """The parameters whose gradient each model rank holds a part of (a
    sequence-parallel ViT's: each rank's tokens give part of it); none for
    any other model."""
    return list(getattr(model, "_ssip_model_partial", ()))


def aux_loss_terms(model: nn.Module) -> List[torch.Tensor]:
    """The auxiliary loss terms of ``model``'s last train-mode forward
    (coefficient-scaled already); none for a model without them."""
    aux_losses = getattr(model, "aux_losses", None)
    return [] if aux_losses is None else aux_losses()


HEAD_PREFIXES = ("fc.", "heads.head.")  # a ResNet's classifier, a ViT's


def head_only_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → trainable, true for the classifier head alone: the
    JAX pipeline's mask "top-level key ``fc``"
    (``ssip_tpu/pipelines/semi_supervised.py:259-262``); its ViT names the
    head ``fc`` too, which the port carries as ``heads.head``."""
    mask = {name: name.startswith(HEAD_PREFIXES) for name, _ in model.named_parameters()}
    if not any(mask.values()):
        raise ValueError("the model has no classifier head (fc or heads.head) to train")
    return mask


@contextmanager
def only_trainable(model: nn.Module, trainable_mask: Optional[Dict[str, bool]]) -> Iterator[None]:
    """Within the block the parameters whose mask entry is false record no
    gradient (``requires_grad`` off, restored after), so the backward pass
    skips them and AdamW, which skips a parameter without a gradient, leaves
    them bit for bit as they were: no update, no weight decay."""
    if trainable_mask is None:
        yield
        return
    named = dict(model.named_parameters())
    if set(named) != set(trainable_mask):
        raise ValueError("trainable_mask must name exactly the model's parameters")
    before = {name: p.requires_grad for name, p in named.items()}
    try:
        for name, p in named.items():
            p.requires_grad_(bool(trainable_mask[name]))
        yield
    finally:
        for name, p in named.items():
            p.requires_grad_(before[name])


def train_step(
    state: TrainState,
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    coeffs: Optional[torch.Tensor],
    trainable_mask: Optional[Dict[str, bool]] = None,
    n_valid: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step; returns (loss, argmax predictions), on the device.
    The loss is the masked cross-entropy plus the model's auxiliary terms.
    Under data parallelism the arguments are this rank's rows, ``n_valid``
    the global batch's valid count, and the loss returned is this rank's
    share (summed over the ranks, the global loss).

    ``coeffs`` is the int32 [3, B] augmentation of ``ops/augment.py:
    augment_coeffs`` on the images' device, or None for no augmentation
    (the eval normalize). The model runs in train mode with ``mask=valid``;
    parameter gradients are left in ``.grad`` after the step (None for a
    parameter that ``trainable_mask`` freezes).
    """
    model = state.model
    model.train()
    if coeffs is None:
        x = eval_preprocess(images_u8, model.compute_dtype)
    else:
        x = augment_images(images_u8, coeffs, model.compute_dtype)
    with only_trainable(model, trainable_mask), synced_batch(state.group):
        logits = model(x, mask=valid)
        loss = masked_cross_entropy(logits, labels, valid, n_valid)
        for term in aux_loss_terms(model):
            loss = loss + term
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    sync_gradients(state)
    state.optimizer.step()
    state.step += 1
    return loss.detach(), logits.detach().argmax(dim=1)


def stacked_epoch(
    order: np.ndarray, batch_size: int, row_width: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """[steps, row] index and valid arrays; padding rows are invalid
    (``_stacked_epoch``, ``ssip_tpu/train/engine.py:270-291``).
    ``row_width`` (>= batch_size) pads every step to a multiple of the
    data axis."""
    order = np.asarray(order)
    row = batch_size if row_width is None else row_width
    steps = max(1, (len(order) + batch_size - 1) // batch_size)
    pidx = np.zeros((steps, row), order.dtype if order.size else np.int64)
    valid = np.zeros((steps, row), bool)
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
    pool: Optional[np.ndarray] = None,
    num_samples: Optional[int] = None,
    row_width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One epoch's plan: (pidx [steps, R], valid [steps, R], coeffs
    int32 [steps, 3, R]), R the batch or ``row_width`` (the batch padded to
    a multiple of the data axis; the padding rows get the identity
    augmentation, so the real rows are the one-process plan's).

    The index and valid arrays are ``ssip_tpu``'s ``epoch_plan``'s, bit for
    bit; the augmentation keys become ``runtime/prng.py:augment_draws`` of
    the same (seed, stream, epoch, step).

    ``pool``: sample only these dataset indices (a cross-validation fold of
    one shared dataset); the returned ``pidx`` are dataset indices.
    ``num_samples``: the epoch's length in place of the pool's (the CV
    fan-out gives every fold the largest fold's length).
    """
    labels = train_dataset.labels if pool is None else train_dataset.labels[pool]
    n = len(labels) if num_samples is None else int(num_samples)
    if balanced:
        order = balanced_epoch_indices(labels, seed=seed, epoch=epoch, num_samples=n)
    else:
        order = host_rng(seed, f"shuffle/{stream_name}/{epoch}").permutation(len(labels))
        if num_samples is not None:
            order = np.resize(order, n)  # truncated or cycled to n
    if pool is not None:
        order = np.asarray(pool)[order]
    pidx, valid = stacked_epoch(order, batch_size, row_width)
    pad = pidx.shape[1] - batch_size
    identity = augment_coeffs(np.zeros(pad, bool), np.zeros(pad, np.float32))
    coeffs = np.stack([
        np.concatenate([augment_coeffs(*augment_draws(seed, stream_name, epoch, step, batch_size, ROTATE_DEGREES)),
                        identity], axis=1)
        for step in range(pidx.shape[0])
    ])
    return pidx, valid, coeffs


def gather_steps(x: torch.Tensor, group) -> torch.Tensor:
    """[steps, local, ...] of every rank → [steps, ranks·local, ...], the
    rows of each step in global order."""
    g = gather_rows(x, group)  # [ranks, steps, local, ...]
    return g.transpose(0, 1).reshape(x.shape[0], -1, *x.shape[2:])


def run_train_epoch(
    state: TrainState, dataset: DeviceDataset, pidx: np.ndarray, valid: np.ndarray,
    coeffs: Optional[np.ndarray], trainable_mask: Optional[Dict[str, bool]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every step of one epoch plan; (per-step losses, predictions [steps, R]).

    Under data parallelism the plan is the global one: each rank steps on
    its rows, and the losses and predictions come back whole, in one
    collective each at the end of the epoch."""
    dev = dataset.images_u8.device
    group = state.group
    totals = [None] * pidx.shape[0]
    if group is not None:
        rows = local_rows(state.mesh, pidx.shape[1])
        totals = [float(v) for v in valid.sum(axis=1)]
        pidx, valid = pidx[:, rows], valid[:, rows]
        coeffs = None if coeffs is None else coeffs[:, :, rows]
    pidx_dev = torch.from_numpy(pidx.astype(np.int64)).to(dev)
    valid_dev = torch.from_numpy(valid).to(dev)
    coeffs_dev = None if coeffs is None else torch.from_numpy(np.ascontiguousarray(coeffs)).to(dev)
    losses, preds = [], []
    for s in range(pidx.shape[0]):
        idx = pidx_dev[s]
        loss, pred = train_step(
            state, dataset.images_u8[idx], dataset.labels_dev[idx], valid_dev[s],
            None if coeffs_dev is None else coeffs_dev[s], trainable_mask, totals[s],
        )
        losses.append(loss)
        preds.append(pred)
    losses, preds = torch.stack(losses), torch.stack(preds)
    if group is not None:
        torch.distributed.all_reduce(losses, group=group)
        preds = gather_steps(preds, group)
    return losses.cpu().numpy(), preds.cpu().numpy()


def sharded_eval_batches(
    model: nn.Module, images_u8: torch.Tensor, batch_size: int, mesh, labels: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], np.ndarray]:
    """Eval-mode forward of ``images_u8`` in batches of ``batch_size``, each
    padded to a multiple of the data axis and split over it (JAX
    ``run_eval_epoch`` with a mesh): (predictions [N], probabilities
    [N, C], the per-batch cross-entropy sums against ``labels`` [batches]
    or None, the per-batch valid counts), gathered on every rank in input
    order. Every rank runs every batch (FSDP gathers its parameters in
    each forward)."""
    group = data_group(mesh)
    n = int(images_u8.shape[0])
    pidx, valid = stacked_epoch(np.arange(n), batch_size, pad_to_multiple(batch_size, data_size(mesh)))
    rows = local_rows(mesh, pidx.shape[1])
    dev = images_u8.device
    pidx_dev = torch.from_numpy(pidx[:, rows].astype(np.int64)).to(dev)
    valid_dev = torch.from_numpy(valid[:, rows]).to(dev)
    sums, preds, probs = [], [], []
    for b in range(pidx.shape[0]):
        idx = pidx_dev[b]
        logits = model(eval_preprocess(images_u8[idx], model.compute_dtype)).to(torch.float32)
        if labels is not None:
            ce = F.cross_entropy(logits, labels[idx], reduction="none")
            sums.append((ce * valid_dev[b].to(torch.float32)).sum())
        preds.append(logits.argmax(dim=1))
        probs.append(torch.softmax(logits, dim=1))
    keep = torch.from_numpy(valid.reshape(-1)).to(dev)
    preds = gather_steps(torch.stack(preds), group).reshape(-1)[keep]
    probs = gather_steps(torch.stack(probs), group)
    probs = probs.reshape(-1, probs.shape[-1])[keep]
    ce_sums = None
    if labels is not None:
        ce_sums = torch.stack(sums)
        torch.distributed.all_reduce(ce_sums, group=group)
    return preds, probs, ce_sums, valid.sum(axis=1)


@torch.no_grad()
def run_eval_epoch(
    model: nn.Module, dataset: DeviceDataset, batch_size: int, mesh=None
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
    """(avg_loss, y_true, y_pred, y_prob [N, C]) over the dataset in order.

    Eval-mode forward (running statistics) batch by batch; the loss is the
    mean of the per-batch mean losses, as the reference averages it
    (``ssip_tpu/train/engine.py:379-419``). The last batch is run short
    rather than padded: in eval mode no row affects another. With a
    ``mesh`` of more than one process each batch is split over the data
    axis (``sharded_eval_batches``); the metrics are the one-process ones.
    """
    model.eval()
    if data_size(mesh) > 1:
        preds, probs, ce_sums, counts = sharded_eval_batches(
            model, dataset.images_u8, batch_size, mesh, dataset.labels_dev)
        avg_loss = float((ce_sums / torch.from_numpy(counts.astype(np.float32)).to(ce_sums.device)).mean())
        return avg_loss, dataset.labels.copy(), preds.cpu().numpy(), probs.cpu().numpy()
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
    trainable_mask: Optional[Dict[str, bool]] = None,
    resume_path: Optional[Path] = None,
) -> Tuple[TrainState, Dict[str, List[float]]]:
    """Epoch driver with reference-parity control flow (common.py:345-432).

    Trains ``state`` in place and returns it restored to its best
    validation loss (parameters, BN statistics where the model has them, optimizer moments and
    learning rate, step count), with the per-epoch history.
    ``checkpoint_fn(state)`` runs at each new best, as in the JAX package.
    ``trainable_mask`` freezes the parameters it marks false (``only_trainable``).
    ``resume_path``: a snapshot is written there every epoch (and its
    ``.best`` sidecar at each new best), and an existing one restores the
    run at the epoch after it; a snapshot that records an early stop
    (``finished``) ends the run at once.
    """
    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_acc": [],
        "val_acc": [], "train_f1": [], "val_f1": [],
    }
    best = Snapshot.take(state)
    best_val_loss = math.inf
    early_patience = 0
    plateau_best = math.inf
    plateau_bad = 0
    epoch_start = 0

    if resume_path is not None:
        if snapshot_exists(resume_path):
            driver, best_r = restore_resume_state(resume_path, state)
            if driver is not None:
                best = best_r
                history = driver["history"]
                best_val_loss = driver["best_val_loss"]
                early_patience = driver["early_patience"]
                plateau_best = driver["plateau_best"]
                plateau_bad = driver["plateau_bad"]
                epoch_start = driver["epoch"] + 1
                LOGGER.info("Resumed '%s' from %s at epoch %d", stream_name, resume_path, epoch_start)
                if driver.get("finished"):
                    best.restore(state)
                    return state, history

    row_width = pad_to_multiple(batch_size, data_size(state.mesh))
    for epoch in range(epoch_start, num_epochs):
        pidx, valid, coeffs = epoch_plan(
            train_dataset, seed=seed, epoch=epoch, stream_name=stream_name,
            balanced=balanced, batch_size=batch_size, row_width=row_width,
        )
        losses, preds = run_train_epoch(
            state, train_dataset, pidx, valid, coeffs if augment else None, trainable_mask
        )
        train_loss = float(np.mean(losses))
        valid_flat = valid.reshape(-1)
        train_acc, train_f1 = accuracy_f1(
            train_dataset.labels[pidx.reshape(-1)[valid_flat]], preds.reshape(-1)[valid_flat]
        )

        val_loss, vy, vp, _ = run_eval_epoch(state.model, val_dataset, batch_size, state.mesh)
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

        stopped = False
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            best = Snapshot.take(state)
            early_patience = 0
            if checkpoint_fn is not None:
                checkpoint_fn(state)
            if resume_path is not None:
                save_train_snapshot(Path(str(resume_path) + ".best"), best, {"epoch": epoch})
        else:
            early_patience += 1
            if early_patience >= early_stopping_patience:
                LOGGER.info("Early stopping triggered at epoch %d", epoch + 1)
                stopped = True

        if resume_path is not None:
            save_train_snapshot(resume_path, Snapshot.take(state), {
                "epoch": epoch, "history": history, "best_val_loss": best_val_loss,
                "early_patience": early_patience, "plateau_best": plateau_best, "plateau_bad": plateau_bad,
                # an early stop is terminal; a run that ran out of epochs stays extendable
                "finished": stopped,
            })
        if stopped:
            break

    best.restore(state)
    return state, history
