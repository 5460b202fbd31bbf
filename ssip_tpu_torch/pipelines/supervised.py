"""Supervised baseline pipeline (reference semantics: supervised.py:38-144).

Counterpart of ``ssip_tpu/pipelines/supervised.py:39-105`` and ``:108-361``.
Flow: seeded stratified split (index for index the JAX package's) →
``--arch`` classifier (ResNet or ViT) trained by ``train/engine.py`` (balanced sampler, device
augmentation, plateau LR, early stop, best-state checkpoint) → argmax test
eval → optional recall-first threshold calibration on val → thresholded
test eval → ``models/baseline_resnet18.pt``,
``tables/results_comparison.csv`` and ``notes/training_history.json``, at
the paths ``ArtifactRegistry`` names and with the JAX run's schemas.

``pipelines/semi_supervised.py`` runs this baseline as its phase A and shares
``build_classifier_state``, ``prepare_datasets``, ``threshold_and_eval`` and
``write_results_csv`` with it.

``--resume`` snapshots the run every epoch under ``models/checkpoints/``
and restores an interrupted one (``train/checkpoints.py``); every ``--arch``
of the JAX package trains, the MoE ViTs with their auxiliary losses.

The fan-outs of ``train/multi_seed.py``: ``--num-seeds N`` trains seeds
``seed … seed + N − 1`` and keeps the lane of least validation loss
(``tables/seed_sweep.csv``, its checkpoint, its history); ``--cv-folds k``
first trains k stratified folds of the train + val pool, each from the
same init, and writes ``tables/cv_results.csv`` (one row a fold, then the
mean and the ddof-0 std). Both tables are written with the ``csv`` module
in the bytes pandas' ``to_csv(index=False)`` writes for the JAX run's rows.

Data parallelism (one process a card, launched by torchrun or the
``SSIP_*`` variables, ``parallel/distributed.py``): the mesh spans the
process group (``TrainingConfig.build_mesh``), each step and each
evaluation is split over its data axis with the one-process results
(``train/engine.py``), ``--fsdp`` shards the model (``parallel/fsdp.py``),
the seed lanes and folds are split over the ranks when their count divides
it (``train/multi_seed.py``), and rank 0 alone writes the checkpoint, the
tables and the notes. ``--mesh-model M`` makes the mesh data × M: each
model is sliced over M ranks (tensor parallelism for the ResNets and ViTs,
expert parallelism for the MoE ViTs, ``parallel/tensor.py``), composes
with ``--fsdp`` over the data axis, and is gathered whole for the
checkpoint. As in the JAX package, ``--cv-folds`` then runs its folds
unsharded (with a warning) and ``--num-seeds > 1`` raises; a process
started alone cannot make a model axis and raises before any data is
read.
The JAX run's four figures (``report/plots.py``: ``train_curves_baseline``,
``confusion_matrix_baseline``, ``roc_curves`` and ``pr_curves_baseline``)
are drawn by rank 0 after the evaluation, with the best lane's history
under ``--num-seeds``. The JAX package imports matplotlib with the pipeline
and cannot train without it; the port asks ``plots.available()`` once,
before any data is read, and where matplotlib is not installed warns once,
naming the figures it will not write, and trains on and writes every table.
An error while drawing stops the run, as in the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssip_tpu_torch.data.splits import split_dict, stratified_kfold_indices
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_state_dict_arrays, read_torch_checkpoint, state_dict_from_flax
from ssip_tpu_torch.models.registry import build_model, refuse_unported_arch
from ssip_tpu_torch.ops.thresholds import select_operating_threshold
from ssip_tpu_torch.parallel import tensor
from ssip_tpu_torch.parallel.distributed import is_primary
from ssip_tpu_torch.parallel.fsdp import shard_model
from ssip_tpu_torch.parallel.mesh import model_size
from ssip_tpu_torch.pipelines.extraction import DEFAULT_WEIGHTS_ENV
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.report import plots
from ssip_tpu_torch.runtime.device import compute_dtype, configure_precision, device_label, resolve_device
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.train.checkpoints import save_checkpoint
from ssip_tpu_torch.train.data import load_labeled_dataset, subset
from ssip_tpu_torch.train.engine import DeviceDataset, TrainState, train_model
from ssip_tpu_torch.train.evaluate import evaluate_model
from ssip_tpu_torch.train.multi_seed import train_multi_seed

LOGGER = get_logger(__name__)

PR_CURVES_BASELINE = "pr_curves_baseline.png"  # a name the JAX run writes outside its registry


def refuse_unported(config: TrainingConfig) -> None:
    """Raise for an ``--arch`` whose code path the port does not have."""
    refuse_unported_arch(config.arch)


def check_cv_folds(config: TrainingConfig) -> None:
    if config.cv_folds and config.cv_folds < 2:
        raise ValueError(f"--cv-folds must be >= 2 (or 0 to disable), got {config.cv_folds}")


def check_figures(names: List[str]) -> bool:
    """Whether the run draws its figures: ``plots.available()``, asked once
    before any data is read. Without matplotlib rank 0 warns, naming the
    figures the run will not write; the run trains on."""
    if plots.available():
        return True
    if is_primary():
        LOGGER.warning(
            "matplotlib is not installed: this run writes no figures (%s); it trains and writes every table",
            ", ".join(names),
        )
    return False


def build_classifier_state(
    config: TrainingConfig, num_classes: int, learning_rate: float, device: torch.device,
    seed: Optional[int] = None, mesh=None,
) -> TrainState:
    """Fresh classifier on ``device``: the seeded init with its ``fc`` head
    (bit for bit the JAX package's), or a ported torchvision backbone from
    ``--pretrained-weights`` / ``$SSIP_RESNET18_WEIGHTS`` with the fresh
    head (``fc``, or a ViT's ``heads.head``) kept. ``--remat`` checkpoints a
    ViT's encoder blocks (``ssip_tpu/pipelines/supervised.py:53-56``).
    ``seed`` overrides ``config.seed`` for the init: each lane of the seed
    fan-out has its own. ``mesh``: the data-parallel mesh the state trains
    on; on its model axis the model is sliced (``parallel/tensor.py``) and
    then, with ``--fsdp``, sharded over its data axis, before AdamW is
    made."""
    model = build_model(
        config.arch, num_classes=num_classes, compute_dtype=compute_dtype(config.compute_dtype),
        remat=config.remat, image_size=config.image_size,
    )
    arrays = state_dict_from_flax(
        seeded_init_host(config.arch, config.seed if seed is None else seed, num_classes,
                         image_size=config.image_size)
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
    model = tensor.shard_model(model, mesh)
    if mesh is not None and config.mesh_fsdp:
        model = shard_model(model, mesh)
    return TrainState.create(model, learning_rate, config.weight_decay, mesh=mesh)


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


def write_results_csv(path: Path, rows: Dict[str, Dict[str, Any]]) -> None:
    """``pandas.DataFrame.from_dict(rows, orient="index").to_csv(path)``'s
    text for rows of numbers, strings and None, without pandas: the union of
    the rows' keys in first-seen order, an empty cell for a missing key and
    for None. Rank 0 writes."""
    if not is_primary():
        return
    columns: List[str] = []
    for row in rows.values():
        columns.extend(key for key in row if key not in columns)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["", *columns])
        for name, row in rows.items():
            writer.writerow([name, *(row.get(key) for key in columns)])


def _column_cells(values: List[Any]) -> List[str]:
    """One column's cells as pandas writes them: a column of integers with
    a missing cell is float64 (``3.0``), floats in their shortest repr,
    everything else by ``str``; a missing cell, None or NaN is empty."""
    def missing(v):
        return v is None or (isinstance(v, float) and math.isnan(v))

    present = [v for v in values if not missing(v)]
    numbers = all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_))
                  for v in present)
    as_float = bool(present) and numbers and (
        len(present) < len(values) or any(isinstance(v, (float, np.floating)) for v in present))
    return ["" if missing(v) else repr(float(v)) if as_float else str(v) for v in values]


def write_table_csv(path: Path, rows: List[Dict[str, Any]]) -> None:
    """``pandas.DataFrame(rows).to_csv(path, index=False)``'s text for rows
    of numbers, booleans and strings, without pandas: the union of the
    rows' keys in first-seen order. Rank 0 writes."""
    if not is_primary():
        return
    columns: List[str] = []
    for row in rows:
        columns.extend(key for key in row if key not in columns)
    cells = [_column_cells([row.get(key) for row in rows]) for key in columns]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*cells))


def train_baseline_multi_seed(
    config: TrainingConfig, datasets: Dict[str, DeviceDataset], num_classes: int, device: torch.device, mesh=None
) -> Tuple[TrainState, Dict[str, List[float]], float]:
    """``--num-seeds``: seeds ``seed + i`` trained side by side, the lane of
    least validation loss (the reference's checkpoint criterion) kept and
    saved as the baseline checkpoint; ``tables/seed_sweep.csv`` gets one
    row a seed with its ``selected`` flag (``ssip_tpu/pipelines/
    supervised.py:108-156``). Returns (best state, its history, seconds)."""
    reg = config.artifacts
    seeds = [config.seed + i for i in range(config.num_seeds)]
    if config.resume:
        LOGGER.warning("--resume is not supported with --num-seeds > 1; training without mid-run snapshots")
    states = [build_classifier_state(config, num_classes, config.learning_rate, device, seed=s) for s in seeds]
    t0 = time.time()
    states, histories, summary = train_multi_seed(
        states, datasets["train"], datasets["val"], seeds=seeds, num_epochs=config.baseline_epochs,
        batch_size=config.batch_size, stream_name="baseline", balanced=True, augment=True,
        early_stopping_patience=config.early_stopping_patience, mesh=mesh,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_time = time.time() - t0
    for state in states:  # every rank holds every lane's model: evaluations split over the mesh
        state.mesh = mesh
    best_lane = int(np.argmin([row["best_val_loss"] for row in summary]))
    for row in summary:
        row["selected"] = row["seed"] == seeds[best_lane]
    write_table_csv(reg.seed_sweep_csv, summary)
    LOGGER.info(
        "Seed sweep: best seed %d (val loss %.4f of %s)", seeds[best_lane], summary[best_lane]["best_val_loss"],
        [round(r["best_val_loss"], 4) for r in summary],
    )
    save_checkpoint(reg.baseline_checkpoint, states[best_lane].model)
    return states[best_lane], histories[best_lane], train_time


def run_cross_validation(
    config: TrainingConfig, datasets: Dict[str, DeviceDataset], num_classes: int, device: torch.device, mesh=None
) -> List[Dict[str, Any]]:
    """``--cv-folds``: stratified k-fold over the train + val pool (the test
    split held out), every fold from the same init, trained side by side;
    writes and returns ``tables/cv_results.csv``'s rows (``ssip_tpu/
    pipelines/supervised.py:159-236``)."""
    reg = config.artifacts
    if model_size(mesh) > 1:
        LOGGER.warning(
            "--cv-folds repurposes the mesh data axis for the fold fan-out "
            "and cannot combine with --mesh-model; running CV lanes "
            "unsharded (the main run keeps its tensor-parallel mesh)"
        )
        mesh = None
    pool = DeviceDataset.create(
        torch.cat([datasets["train"].images_u8, datasets["val"].images_u8]),
        np.concatenate([datasets["train"].labels, datasets["val"].labels]),
    )
    folds = stratified_kfold_indices(pool.labels, config.cv_folds, config.seed)
    states = [build_classifier_state(config, num_classes, config.learning_rate, device) for _ in folds]
    _, histories, summary = train_multi_seed(
        states, pool, pool, seeds=[config.seed] * len(folds), num_epochs=config.baseline_epochs,
        batch_size=config.batch_size, stream_name="cv", balanced=True, augment=True,
        early_stopping_patience=config.early_stopping_patience,
        lane_train_pools=[f[0] for f in folds], lane_val_pools=[f[1] for f in folds], mesh=mesh,
    )
    rows: List[Dict[str, Any]] = []
    for f, (h, row, (tr, va)) in enumerate(zip(histories, summary, folds)):
        best_ep = int(np.argmin(h["val_loss"]))
        rows.append({
            "fold": f, "n_train": len(tr), "n_val": len(va), "best_val_loss": row["best_val_loss"],
            "val_acc": h["val_acc"][best_ep], "val_f1": h["val_f1"][best_ep],
            "epochs_run": row["epochs_run"], "stopped_early": row["stopped_early"],
        })
    stats = ("best_val_loss", "val_acc", "val_f1")
    columns = {k: np.array([row[k] for row in rows], np.float64) for k in stats}
    rows.append({"fold": "mean", **{k: float(v.mean()) for k, v in columns.items()}})
    rows.append({"fold": "std", **{k: float(v.std(ddof=0)) for k, v in columns.items()}})
    write_table_csv(reg.cv_results_csv, rows)
    LOGGER.info(
        "%d-fold CV: val_acc %.3f ± %.3f, val_f1 %.3f ± %.3f → %s", len(folds), rows[-2]["val_acc"],
        rows[-1]["val_acc"], rows[-2]["val_f1"], rows[-1]["val_f1"], reg.cv_results_csv,
    )
    return rows


@dataclass
class EvalPair:
    """The argmax and the thresholded test evaluation of one model."""

    arg_metrics: Dict[str, Any]
    arg_y_true: np.ndarray
    arg_y_pred: np.ndarray
    threshold: Optional[float]  # None without ``target_recall``
    thr_metrics: Dict[str, Any]
    thr_y_true: np.ndarray
    thr_y_pred: np.ndarray
    thr_y_prob: np.ndarray  # the positive column the JAX run plots: pos_index's, class 1's without target_recall


def threshold_and_eval(
    model: nn.Module, datasets: Dict[str, DeviceDataset], config: TrainingConfig, pos_index: int, label: str,
    arg_extras: Optional[Dict[str, float]] = None, mesh=None,
) -> EvalPair:
    """Evaluate ``model`` on the test split by argmax and at its operating
    threshold. With ``target_recall`` the threshold is calibrated on the
    validation split (``select_operating_threshold``); without it the
    thresholded metrics are the argmax ones. ``arg_extras`` joins the argmax
    metrics before the thresholded ones derive from them. ``mesh``: the
    evaluations split over its data axis."""
    arg_metrics, arg_y_true, arg_y_pred, y_prob = evaluate_model(model, datasets["test"], config.batch_size, mesh=mesh)
    arg_metrics.update(arg_extras or {})
    if config.target_recall is not None:
        _m, y_true_val, _p, y_prob_val = evaluate_model(
            model, datasets["val"], config.batch_size, pos_index=pos_index, mesh=mesh
        )
        thr, thr_meta = select_operating_threshold(
            (y_true_val == pos_index).astype(int),
            y_prob_val,
            target_recall=float(config.target_recall),
            min_precision=config.min_precision,
            max_fpr=config.max_fpr,
            f_beta=config.f_beta,
        )
        thr_metrics, thr_y_true, thr_y_pred, thr_y_prob = evaluate_model(
            model, datasets["test"], config.batch_size, pos_index=pos_index, threshold=thr, mesh=mesh
        )
        thr_metrics.update(
            threshold=float(thr),
            target_recall=float(config.target_recall),
            min_precision=None if config.min_precision is None else float(config.min_precision),
            max_fpr=None if config.max_fpr is None else float(config.max_fpr),
            threshold_policy=thr_meta.get("policy", "unknown"),
        )
        LOGGER.info("%s operating point: thr=%.4f policy=%s", label, thr, thr_meta.get("policy"))
    else:
        thr = None
        thr_metrics = dict(arg_metrics)
        thr_metrics.update(
            threshold=None, target_recall=None, min_precision=None,
            max_fpr=None, threshold_policy="disabled",
        )
        thr_y_true, thr_y_pred, thr_y_prob = arg_y_true, arg_y_pred, y_prob
    return EvalPair(arg_metrics, arg_y_true, arg_y_pred, thr, thr_metrics, thr_y_true, thr_y_pred, thr_y_prob)


def run_supervised(config: TrainingConfig) -> Dict[str, Dict[str, float]]:
    refuse_unported(config)
    check_cv_folds(config)
    device = resolve_device(config.device)
    configure_precision(config.compute_dtype)
    mesh = config.build_mesh(device)
    reg = config.artifacts
    figures = check_figures(
        [reg.baseline_curves_png.name, reg.baseline_confusion_png.name, reg.roc_curves_png.name, PR_CURVES_BASELINE]
    ) and is_primary()
    LOGGER.info("Training on %s (%s)", device_label(device), config.compute_dtype)

    datasets, classes, splits = prepare_datasets(config, device)
    if config.positive_class not in classes:
        raise ValueError(
            f"Positive class '{config.positive_class}' not found in dataset classes: {classes}"
        )
    pos_index = classes.index(config.positive_class)

    if config.cv_folds:
        run_cross_validation(config, datasets, len(classes), device, mesh)
    state, history, train_time = train_baseline(config, datasets, len(classes), device, mesh)
    evals = threshold_and_eval(
        state.model, datasets, config, pos_index, "baseline", arg_extras={"training_time_sec": train_time},
        mesh=mesh,
    )
    arg_metrics, thr_metrics = evals.arg_metrics, evals.thr_metrics
    thr_metrics["training_time_sec"] = train_time

    if figures:
        plots.plot_training_curves(history, reg.baseline_curves_png, "Baseline")
        plots.plot_confusion_matrix(evals.arg_y_true, evals.arg_y_pred, classes, reg.baseline_confusion_png)
        curves = {"Baseline": ((evals.thr_y_true == pos_index).astype(int), evals.thr_y_prob)}
        plots.plot_roc_curves(curves, reg.roc_curves_png)
        plots.plot_pr_curves(curves, reg.figures_dir / PR_CURVES_BASELINE)

    write_results_csv(reg.results_comparison_csv, {"baseline_thresholded": thr_metrics})

    # split indices for post-hoc tooling (the threshold sweep)
    history_payload = {
        "arch": config.arch,
        "image_size": int(config.image_size),
        "baseline": history,
        "splits": {k: np.asarray(v).tolist() for k, v in splits.items()},
    }
    if config.num_seeds > 1:
        history_payload["num_seeds"] = config.num_seeds
    if is_primary():
        reg.notes_dir.mkdir(parents=True, exist_ok=True)
        reg.training_history_json.write_text(json.dumps(history_payload, indent=2))

    return {"baseline_thresholded": thr_metrics, "baseline_argmax": arg_metrics}


def train_baseline(
    config: TrainingConfig, datasets: Dict[str, DeviceDataset], num_classes: int, device: torch.device, mesh=None
) -> Tuple[TrainState, Dict[str, List[float]], float]:
    """The baseline classifier, the seed fan-out's best lane with
    ``--num-seeds > 1``: (state at its best validation loss, history,
    training seconds). Both pipelines' phase A."""
    if config.num_seeds > 1:
        return train_baseline_multi_seed(config, datasets, num_classes, device, mesh)
    reg = config.artifacts
    state = build_classifier_state(config, num_classes, config.learning_rate, device, mesh=mesh)
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
        resume_path=config.resume_path("baseline"),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state, history, time.time() - t0
