"""Supervised baseline pipeline (reference semantics: supervised.py:38-144).

Counterpart of ``ssip_tpu/pipelines/supervised.py:39-105`` and ``:236-361``.
Flow: seeded stratified split (index for index the JAX package's) →
``--arch`` classifier (ResNet or ViT) trained by ``train/engine.py`` (balanced sampler, device
augmentation, plateau LR, early stop, best-state checkpoint) → argmax test
eval → optional recall-first threshold calibration on val → thresholded
test eval → ``models/baseline_resnet18.pt``,
``tables/results_comparison.csv`` and ``notes/training_history.json``, at
the paths ``ArtifactRegistry`` names and with the JAX run's schemas.

Not ported yet, refused with an error naming the ROADMAP entry: ``--resume``
snapshots, the seed and cross-validation fan-outs, tensor parallelism and
FSDP, and the MoE archs. The four training figures
(``report/plots.py``) are not drawn yet either.
"""

from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ssip_tpu_torch.data.splits import split_dict
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_state_dict_arrays, read_torch_checkpoint, state_dict_from_flax
from ssip_tpu_torch.models.registry import build_model, refuse_unported_arch
from ssip_tpu_torch.ops.thresholds import select_operating_threshold
from ssip_tpu_torch.pipelines.extraction import DEFAULT_WEIGHTS_ENV
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.runtime.device import compute_dtype, configure_precision, device_label, resolve_device
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.train.checkpoints import save_checkpoint
from ssip_tpu_torch.train.data import load_labeled_dataset, subset
from ssip_tpu_torch.train.engine import DeviceDataset, TrainState, train_model
from ssip_tpu_torch.train.evaluate import evaluate_model

LOGGER = get_logger(__name__)

_NOT_PORTED = "is not ported to ssip_tpu_torch yet (ROADMAP.md, {item})"


def refuse_unported(config: TrainingConfig) -> None:
    """Raise for a setting whose code path the port does not have yet."""
    for setting, on, item in (
        ("--resume", config.resume, "Queue 1 item 15c: --resume snapshots and the .msgpack checkpoint"),
        ("--num-seeds > 1", config.num_seeds > 1, "Queue 1 item 18: seed and CV fan-out"),
        ("--cv-folds", config.cv_folds != 0, "Queue 1 item 18: seed and CV fan-out"),
        ("--mesh-model > 1", config.mesh_model > 1, "Queue 1 item 22: parallelism"),
        ("--fsdp", config.mesh_fsdp, "Queue 1 item 22: parallelism"),
    ):
        if on:
            raise ValueError(f"{setting} " + _NOT_PORTED.format(item=item))
    refuse_unported_arch(config.arch)


def build_classifier_state(
    config: TrainingConfig, num_classes: int, learning_rate: float, device: torch.device
) -> TrainState:
    """Fresh classifier on ``device``: the seeded init with its ``fc`` head
    (bit for bit the JAX package's), or a ported torchvision backbone from
    ``--pretrained-weights`` / ``$SSIP_RESNET18_WEIGHTS`` with the fresh
    head (``fc``, or a ViT's ``heads.head``) kept. ``--remat`` checkpoints a
    ViT's encoder blocks (``ssip_tpu/pipelines/supervised.py:53-56``)."""
    model = build_model(
        config.arch, num_classes=num_classes, compute_dtype=compute_dtype(config.compute_dtype),
        remat=config.remat, image_size=config.image_size,
    )
    arrays = state_dict_from_flax(
        seeded_init_host(config.arch, config.seed, num_classes, image_size=config.image_size)
    )
    weights = config.pretrained_weights or os.environ.get(DEFAULT_WEIGHTS_ENV)
    if weights and Path(weights).exists():
        LOGGER.info("Porting pretrained backbone from %s", weights)
        head = {k: v for k, v in arrays.items() if k.startswith(("fc.", "heads."))}
        arrays = {**read_torch_checkpoint(Path(weights)), **head}
    load_state_dict_arrays(model, arrays, weights or "<seeded init>")
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState.create(model, learning_rate, config.weight_decay)


def prepare_datasets(
    config: TrainingConfig, device: torch.device
) -> Tuple[Dict[str, DeviceDataset], List[str], Dict[str, np.ndarray]]:
    """(split datasets, classes, split indices)."""
    images, targets, classes, _paths = load_labeled_dataset(
        config.strong_data_dir, config.image_size, device, num_threads=config.num_workers
    )
    splits = split_dict(targets.tolist(), config.val_split, config.test_split, config.seed)
    datasets = {name: subset(images, targets, idx) for name, idx in splits.items()}
    return datasets, classes, splits


def _write_results_csv(path: Path, name: str, row: Dict) -> None:
    """``pandas.DataFrame.from_dict({name: row}, orient="index").to_csv(path)``'s
    text for a row of floats, strings and None, without pandas."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["", *row])
        writer.writerow([name, *row.values()])


def run_supervised(config: TrainingConfig) -> Dict[str, Dict[str, float]]:
    refuse_unported(config)
    device = resolve_device(config.device)
    configure_precision(config.compute_dtype)
    LOGGER.info("Training on %s (%s)", device_label(device), config.compute_dtype)
    reg = config.artifacts

    datasets, classes, splits = prepare_datasets(config, device)
    if config.positive_class not in classes:
        raise ValueError(
            f"Positive class '{config.positive_class}' not found in dataset classes: {classes}"
        )
    pos_index = classes.index(config.positive_class)

    state = build_classifier_state(config, len(classes), config.learning_rate, device)
    t0 = time.time()
    state, history = train_model(
        state,
        datasets["train"],
        datasets["val"],
        num_epochs=config.baseline_epochs,
        batch_size=config.batch_size,
        seed=config.seed,
        stream_name="baseline",
        balanced=True,
        augment=True,
        early_stopping_patience=config.early_stopping_patience,
        checkpoint_fn=lambda s: save_checkpoint(reg.baseline_checkpoint, s.model),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.time() - t0
    model = state.model

    arg_metrics, *_ = evaluate_model(model, datasets["test"], config.batch_size)
    arg_metrics["training_time_sec"] = train_time

    if config.target_recall is not None:
        _m, y_true_val, _p, y_prob_val = evaluate_model(
            model, datasets["val"], config.batch_size, pos_index=pos_index
        )
        thr, thr_meta = select_operating_threshold(
            (y_true_val == pos_index).astype(int),
            y_prob_val,
            target_recall=float(config.target_recall),
            min_precision=config.min_precision,
            max_fpr=config.max_fpr,
            f_beta=config.f_beta,
        )
        thr_metrics, _, _, _ = evaluate_model(
            model, datasets["test"], config.batch_size, pos_index=pos_index, threshold=thr
        )
        thr_metrics.update(
            threshold=float(thr),
            target_recall=float(config.target_recall),
            min_precision=None if config.min_precision is None else float(config.min_precision),
            max_fpr=None if config.max_fpr is None else float(config.max_fpr),
            threshold_policy=thr_meta.get("policy", "unknown"),
        )
    else:
        thr_metrics = dict(arg_metrics)
        thr_metrics.update(
            threshold=None, target_recall=None, min_precision=None,
            max_fpr=None, threshold_policy="disabled",
        )
    thr_metrics["training_time_sec"] = train_time

    _write_results_csv(reg.results_comparison_csv, "baseline_thresholded", thr_metrics)

    # split indices for post-hoc tooling (the threshold sweep)
    reg.notes_dir.mkdir(parents=True, exist_ok=True)
    history_payload = {
        "arch": config.arch,
        "image_size": int(config.image_size),
        "baseline": history,
        "splits": {k: np.asarray(v).tolist() for k, v in splits.items()},
    }
    reg.training_history_json.write_text(json.dumps(history_payload, indent=2))

    return {"baseline_thresholded": thr_metrics, "baseline_argmax": arg_metrics}
