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
``augment_images``. The whole-epoch ``lax.scan`` is a Python loop of steps.

Under data parallelism (``TrainState.mesh``) the unlabeled batch and its
view draws are padded and split over the data axis like the labeled batch
(``train/engine.py``): the padding rows are out of the strong view's
BatchNorm statistics and out of ``keep``, the consistency term is divided
by the global ``Σkeep``, and the EMA teacher is a copy of the parameters in
their placement (FSDP shards included), updated alike on every rank. ``resume_path`` snapshots the student every epoch, as
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
from ssip_tpu_torch.parallel.distributed import synced_batch
from ssip_tpu_torch.parallel.fsdp import placed_like
from ssip_tpu_torch.parallel.mesh import data_size, local_rows, pad_to_multiple
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.runtime.prng import RandAugmentDraws, fixmatch_draws, host_rng
from ssip_tpu_torch.train.checkpoints import Snapshot, restore_resume_state, save_train_snapshot, snapshot_exists
from ssip_tpu_torch.train.engine import (
    ROTATE_DEGREES, DeviceDataset, TrainState, aux_loss_terms, gather_steps, get_lr, masked_cross_entropy,
    run_eval_epoch, set_lr, stacked_epoch, sync_gradients,
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

    def columns(self, rows: slice, u_rows: slice) -> "ViewDraws":
        """The draws of the labeled ``rows`` and unlabeled ``u_rows`` (the
        batch axis is the last of every field)."""
        view = self._map(lambda t: t[..., u_rows])
        view.sup_coeffs = self.sup_coeffs[..., rows]
        return view


def _pad_last(a: np.ndarray, width: Optional[int]) -> np.ndarray:
    """``a`` padded along its last (batch) axis to ``width`` with copies of
    its last row: valid draws for rows that are masked out."""
    if width is None or a.shape[-1] == width:
        return a
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])], mode="edge")


def epoch_view_draws(
    seed: int, stream: str, epoch: int, steps: int, batch: int, unlabeled_batch: int, device: torch.device,
    strong_aug: str = "jitter", image_size: Optional[Tuple[int, int]] = None,
    row_width: Optional[int] = None, u_row_width: Optional[int] = None,
) -> ViewDraws:
    """Every step's draws of one epoch (``runtime/prng.py:fixmatch_draws``),
    stacked and sent to ``device`` in one copy each. RandAugment's warp
    matrices are made here on the host, from the draws, for images of
    ``image_size`` (H, W). ``row_width``/``u_row_width``: the batches
    padded to a multiple of the data axis (the draws of the real rows
    unchanged)."""
    draws = [fixmatch_draws(seed, stream, epoch, s, batch, unlabeled_batch, ROTATE_DEGREES, strong_aug, image_size)
             for s in range(steps)]
    sup = _pad_last(np.stack([augment_coeffs(d.sup_flip, d.sup_angles) for d in draws]), row_width)
    weak = _pad_last(np.stack([d.weak_flip for d in draws]), u_row_width)
    if strong_aug == "randaugment":
        ra = RandAugmentDraws(*(np.stack(column) for column in zip(*(
            [getattr(d.randaugment, f.name) for f in fields(RandAugmentDraws)] for d in draws))))
        geo = _pad_last(draws_geometry(ra, *image_size), u_row_width)
        ra = ra.map(lambda a: torch.from_numpy(_pad_last(a, u_row_width)))
        view = ViewDraws(torch.from_numpy(sup), torch.from_numpy(weak), None, None, None, ra, torch.from_numpy(geo))
        return view.to(device)
    stacked = (
        sup, weak,
        _pad_last(np.stack([augment_coeffs(d.strong_flip, d.strong_angles) for d in draws]), u_row_width),
        _pad_last(np.stack([d.brightness for d in draws]), u_row_width),
        _pad_last(np.stack([d.contrast for d in draws]), u_row_width),
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
    EMA teacher's forward, validation and snapshot without a second model.
    FSDP gathers a sharded parameter from its own storage, so there the
    values are copied in and back rather than swapped."""
    if params is None:
        yield
        return
    named = dict(model.named_parameters())
    from ssip_tpu_torch.parallel.fsdp import is_sharded

    if is_sharded(model):
        with torch.no_grad():
            saved = {name: p.detach().clone() for name, p in named.items()}
            for name, p in named.items():
                p.copy_(params[name])
        try:
            yield
        finally:
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(saved[name])
        return
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
    """``ema = d·ema + (1 − d)·params``, in place (FSDP's sharded and whole
    parameters in separate groups: a foreach op takes one kind)."""
    live = dict(model.named_parameters())
    groups: Dict[type, List[str]] = {}
    for name in ema_params:
        groups.setdefault(type(live[name].data), []).append(name)
    for names in groups.values():
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
    n_valid: Optional[float] = None,
    u_valid: Optional[torch.Tensor] = None,
    n_unlabeled: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FixMatch optimizer step; returns (loss, supervised loss,
    consistency loss, keep rate, argmax predictions of the labeled batch), on
    the device. ``ema_params`` (None: the teacher is the live student) is
    updated in place after the optimizer step; gradients stay in ``.grad``.

    Under data parallelism the batches are this rank's rows, ``n_valid``
    the labeled batch's global valid count, ``u_valid`` marks this rank's
    real unlabeled rows and ``n_unlabeled`` is the global unlabeled batch;
    the four numbers returned are this rank's shares of the global ones."""
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
    group = state.group
    keep_total = None
    if group is not None:
        keep = keep & u_valid
        keep_total = keep.to(torch.float32).sum()
        torch.distributed.all_reduce(keep_total, group=group)

    model.train()
    with synced_batch(group):
        logits_sup = model(x_sup, mask=valid)
        aux_terms = aux_loss_terms(model)  # the labeled view's; the strong view's are dropped
        sup_loss = masked_cross_entropy(logits_sup, labels, valid, n_valid)
        cons_loss = masked_cross_entropy(model(x_strong, mask=u_valid), pseudo, keep, keep_total)
    loss = sup_loss + consistency_weight * cons_loss
    for term in aux_terms:
        loss = loss + term
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    sync_gradients(state)
    state.optimizer.step()
    state.step += 1
    if ema_params is not None:
        update_ema(ema_params, model, ema_decay)
    kept = keep.to(torch.float32).mean() if group is None else keep.to(torch.float32).sum() / n_unlabeled
    return loss.detach(), sup_loss.detach(), cons_loss.detach(), kept, logits_sup.detach().argmax(dim=1)


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
    group = state.group
    row_width = pad_to_multiple(batch_size, data_size(state.mesh))
    u_row_width = pad_to_multiple(unlabeled_batch_size, data_size(state.mesh))

    if resume_path is not None:
        if snapshot_exists(resume_path):
            driver, best_r = restore_resume_state(resume_path, state)
            if driver is not None:
                best = best_r
                if ema_params is not None:  # the .best parameters are EMA parameters
                    ema_params = {name: placed_like(best.model[name].detach(), live).clone()
                                  for name, live in ema_params.items()}
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
        pidx, valid = stacked_epoch(order, batch_size, row_width)
        steps = pidx.shape[0]
        u_rng = host_rng(seed, f"{stream_name}/unlabeled/{epoch}")
        u_idx = u_rng.integers(0, n_unlabeled, size=(steps, unlabeled_batch_size))
        draws = epoch_view_draws(seed, stream_name, epoch, steps, batch_size, unlabeled_batch_size, dev,
                                 strong_aug, tuple(unlabeled_images.shape[1:3]), row_width, u_row_width)
        totals = [None] * steps
        local_pidx, local_valid, u_valid_dev = pidx, valid, [None] * steps
        if group is not None:
            rows, u_rows = local_rows(state.mesh, row_width), local_rows(state.mesh, u_row_width)
            totals = [float(v) for v in valid.sum(axis=1)]
            local_pidx, local_valid = pidx[:, rows], valid[:, rows]
            u_valid = np.arange(u_row_width)[None, :].repeat(steps, 0) < unlabeled_batch_size
            u_idx = np.pad(u_idx, [(0, 0), (0, u_row_width - unlabeled_batch_size)])[:, u_rows]
            u_valid_dev = torch.from_numpy(u_valid[:, u_rows]).to(dev)
            draws = draws.columns(rows, u_rows)
        pidx_dev = torch.from_numpy(local_pidx.astype(np.int64)).to(dev)
        valid_dev = torch.from_numpy(local_valid).to(dev)
        u_idx_dev = torch.from_numpy(u_idx.astype(np.int64)).to(dev)
        metrics = []
        for s in range(steps):
            idx = pidx_dev[s]
            metrics.append(fixmatch_step(
                state, ema_params, train_dataset.images_u8[idx], train_dataset.labels_dev[idx], valid_dev[s],
                unlabeled_images[u_idx_dev[s]], draws[s], consistency_weight=consistency_weight,
                confidence_threshold=confidence_threshold, ema_decay=ema_decay,
                n_valid=totals[s], u_valid=u_valid_dev[s], n_unlabeled=unlabeled_batch_size,
            ))
        # one copy to the host per epoch, so the step loop never waits on it
        columns = [torch.stack(column) for column in zip(*metrics)]
        if group is not None:
            shares = torch.stack(columns[:4])
            torch.distributed.all_reduce(shares, group=group)
            columns = [*shares, gather_steps(columns[4], group)]
        losses, _sup, cons, keep, preds = (column.cpu().numpy() for column in columns)
        train_loss = float(np.mean(losses))
        valid_flat = valid.reshape(-1)
        train_acc, train_f1 = accuracy_f1(
            train_dataset.labels[pidx.reshape(-1)[valid_flat]], preds.reshape(-1)[valid_flat]
        )
        with swapped_parameters(model, ema_params):
            val_loss, vy, vp, _ = run_eval_epoch(model, val_dataset, batch_size, state.mesh)
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
