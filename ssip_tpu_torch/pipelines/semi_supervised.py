"""Semi-supervised pipeline: baseline → pseudo-label → weak pretrain → finetune.

Counterpart of ``ssip_tpu/pipelines/semi_supervised.py`` (reference
src/training/semi_supervised.py:75-516):

(``--cv-folds``: the k-fold CV of ``pipelines/supervised.py`` first)
Phase A  baseline classifier on the strong labeled split (with
         ``--num-seeds > 1`` the seed fan-out's best lane, which then
         pseudo-labels, as ``:165-182`` there)
Phase B  pseudo-label the (optionally cohort-filtered) unlabeled pool at
         confidence ≥ 0.7 with a batched eval forward
Phase C  fresh model, backbone frozen by a gradient mask (the model stays in
         train mode, so BatchNorm statistics still move): head-only pretrain
         on the pseudo-labels with a balanced sampler
Phase D  everything unfrozen, a fresh optimizer at lr/2, fine-tune on the
         strong labels; with ``consistency_weight > 0`` the FixMatch
         fine-tune of ``train/consistency.py``, its strong view the jitter
         or ``--strong-augment randaugment``
Then: argmax and recall-first thresholded evaluation of both models,
training histories (with split indices and the pseudo-label count), the two
comparison tables, ``operating_point.json`` and the triage CSV over the full
unlabeled pool, at the paths ``ArtifactRegistry`` names and with the JAX
run's schemas (written without pandas).

All four phases run on device-resident data; the phase transitions
(pseudo-label selection, cohort filtering) are the only host round-trips.

With ``--resume`` each of the streams ``baseline``, ``semi_pretrain`` and
``semi_finetune`` (the FixMatch fine-tune or the plain one) snapshots every
epoch and restores an interrupted run, as the JAX pipeline's do.

Data parallelism and ``--fsdp`` as in ``pipelines/supervised.py``: the
pool's probabilities are split over the data axis and gathered in pool
order, the FixMatch fine-tune's unlabeled batches are split like the
labeled ones, and rank 0 alone writes the artifacts. Not ported yet: what
``pipelines/supervised.py`` refuses.

Rank 0 draws the JAX run's nine figures in its places (``report/plots.py``):
the baseline's curves after phase A; then the semi-supervised curves over
the pretrain and the fine-tune, the four confusion matrices, ROC and PR
with both models, and the metric bars over the detailed rows. Without
matplotlib, which the JAX package cannot train without, the run warns once
before reading any data, naming the figures, and trains on and writes every
table (``pipelines/supervised.py:check_figures``).
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ssip_tpu_torch.data.discovery import unlabeled_files
from ssip_tpu_torch.ops.metrics import binary_confusion_metrics
from ssip_tpu_torch.parallel.distributed import is_primary
from ssip_tpu_torch.pipelines.supervised import (
    build_classifier_state, check_cv_folds, check_figures, prepare_datasets, refuse_unported, run_cross_validation,
    threshold_and_eval, train_baseline, write_results_csv,
)
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.report import plots
from ssip_tpu_torch.runtime.device import configure_precision, device_label, resolve_device
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.train.checkpoints import save_checkpoint
from ssip_tpu_torch.train.consistency import check_strong_aug, train_fixmatch
from ssip_tpu_torch.train.data import load_unlabeled_dataset
from ssip_tpu_torch.train.engine import DeviceDataset, TrainState, head_only_mask, train_model
from ssip_tpu_torch.train.pseudo_label import generate_pseudo_labels, pool_probabilities

LOGGER = get_logger(__name__)


def resolve_cohort_paths(cohort_csv: Path, weak_data_dir: Path) -> set[str]:
    """Resolve cohort CSV 'path' entries against the weak pool directory.

    Path-matching semantics: reference semi_supervised.py:191-228 — accepts
    absolute paths, weak-dir-relative paths, paths prefixed with the weak
    dir's name, and bare filenames.
    """
    cohort_csv = Path(cohort_csv)
    if not cohort_csv.exists():
        raise FileNotFoundError(f"Cohort CSV not found: {cohort_csv}")
    with open(cohort_csv, newline="") as fh:
        reader = csv.DictReader(fh)
        if "path" not in (reader.fieldnames or []):
            raise ValueError("Cohort CSV must contain a 'path' column")
        entries = [row["path"] for row in reader]
    weak_data_dir = Path(weak_data_dir)
    weak_name = weak_data_dir.name
    allowed: set[str] = set()
    for p in entries:
        pp = Path(p)
        candidates = set()
        if pp.is_absolute():
            candidates.add(pp.resolve())
        else:
            candidates.add((weak_data_dir / pp).resolve())
            parts = pp.parts
            if len(parts) > 1 and parts[0] == weak_name:
                candidates.add((weak_data_dir / Path(*parts[1:])).resolve())
            if len(parts) == 1:
                candidates.add((weak_data_dir / pp.name).resolve())
        allowed.update(str(c) for c in candidates)
    return allowed


def _cohort_keep_paths(config: TrainingConfig) -> Optional[List[Path]]:
    if config.unlabeled_cohort_csv is None:
        return None
    allowed = resolve_cohort_paths(Path(config.unlabeled_cohort_csv), Path(config.weak_data_dir))
    pool_all = unlabeled_files(Path(config.weak_data_dir))
    keep_paths = [p for p in pool_all if str(p.resolve()) in allowed]
    LOGGER.info(
        "Filtered unlabeled pool via cohort CSV: %d -> %d images (%d excluded)",
        len(pool_all), len(keep_paths), len(pool_all) - len(keep_paths),
    )
    if not keep_paths:
        raise RuntimeError(
            "Cohort filtering removed all unlabeled images; check the CSV paths match --weak-data-dir."
        )
    return keep_paths


def run_pipeline(config: TrainingConfig) -> Dict[str, Dict[str, float]]:
    refuse_unported(config)
    check_cv_folds(config)
    if config.consistency_weight > 0:
        check_strong_aug(config.strong_augment)
    if config.weak_data_dir is None:
        raise ValueError("semi-supervised pipeline requires weak_data_dir")
    device = resolve_device(config.device)
    configure_precision(config.compute_dtype)
    mesh = config.build_mesh(device)
    reg = config.artifacts
    figures = check_figures([path.name for path in (
        reg.baseline_curves_png, reg.semi_curves_png, reg.baseline_confusion_png,
        reg.baseline_confusion_thresholded_png, reg.semi_confusion_png, reg.semi_confusion_thresholded_png,
        reg.roc_curves_png, reg.pr_curves_png, reg.metrics_comparison_png,
    )]) and is_primary()
    LOGGER.info("Training on %s (%s)", device_label(device), config.compute_dtype)

    datasets, classes, splits = prepare_datasets(config, device)
    if config.positive_class not in classes:
        raise ValueError(
            f"Positive class '{config.positive_class}' not found in dataset classes: {classes}"
        )
    pos_index = classes.index(config.positive_class)

    def timed(t0: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.time() - t0

    if config.cv_folds:
        run_cross_validation(config, datasets, len(classes), device, mesh)

    # ---- Phase A: baseline ------------------------------------------------
    baseline_state, baseline_history, baseline_time = train_baseline(config, datasets, len(classes), device, mesh)
    if figures:
        plots.plot_training_curves(baseline_history, reg.baseline_curves_png, "Baseline")
    base = threshold_and_eval(baseline_state.model, datasets, config, pos_index, "baseline", mesh=mesh)
    base.arg_metrics["training_time_sec"] = baseline_time
    base.thr_metrics["training_time_sec"] = baseline_time

    # ---- Phase B: pseudo-labeling ----------------------------------------
    keep_paths = _cohort_keep_paths(config)
    pool_images, pool_paths = load_unlabeled_dataset(
        Path(config.weak_data_dir), config.image_size, device,
        keep_paths=keep_paths, num_threads=config.num_workers,
    )
    keep_idx, pseudo_labels, _conf = generate_pseudo_labels(
        baseline_state.model, pool_images, config.batch_size, config.pseudo_label_threshold, mesh
    )
    if len(keep_idx) == 0:
        raise RuntimeError("No pseudo-labelled samples were generated. Try lowering the threshold.")
    LOGGER.info(
        "Pseudo-labeling kept %d/%d pool images (threshold %.2f)",
        len(keep_idx), len(pool_paths), config.pseudo_label_threshold,
    )
    pseudo_dataset = DeviceDataset.create(
        pool_images[torch.from_numpy(keep_idx).to(device)], pseudo_labels
    )

    # ---- Phase C: weak pretrain (backbone frozen) ------------------------
    semi_state = build_classifier_state(config, len(classes), config.learning_rate, device, mesh=mesh)
    t0 = time.time()
    semi_state, pretrain_history = train_model(
        semi_state,
        pseudo_dataset,
        datasets["val"],
        num_epochs=config.weak_pretrain_epochs,
        batch_size=config.batch_size,
        seed=config.seed,
        stream_name="semi_pretrain",
        balanced=True,
        augment=True,
        early_stopping_patience=config.early_stopping_patience,
        trainable_mask=head_only_mask(semi_state.model),
        resume_path=config.resume_path("semi_pretrain"),
    )

    # ---- Phase D: fine-tune (unfrozen, a fresh optimizer at lr/2) ---------
    semi_state = TrainState.create(semi_state.model, config.learning_rate / 2, config.weight_decay, mesh=mesh)
    if config.consistency_weight > 0:
        LOGGER.info(
            "Fine-tuning with augmentation-consistency (λ=%.2f, τ=%.2f)",
            config.consistency_weight, config.consistency_threshold,
        )
        semi_state, finetune_history = train_fixmatch(
            semi_state,
            datasets["train"],
            datasets["val"],
            pool_images,
            num_epochs=config.finetune_epochs,
            batch_size=config.batch_size,
            unlabeled_batch_size=config.batch_size,
            seed=config.seed,
            stream_name="semi_finetune",
            consistency_weight=config.consistency_weight,
            confidence_threshold=config.consistency_threshold,
            ema_decay=config.ema_decay,
            strong_aug=config.strong_augment,
            early_stopping_patience=config.early_stopping_patience,
            resume_path=config.resume_path("semi_finetune"),
        )
        save_checkpoint(reg.semi_checkpoint, semi_state.model)
        # keep the history schema uniform with the pretrain phase's
        finetune_history = {k: v for k, v in finetune_history.items() if k in pretrain_history}
    else:
        semi_state, finetune_history = train_model(
            semi_state,
            datasets["train"],
            datasets["val"],
            num_epochs=config.finetune_epochs,
            batch_size=config.batch_size,
            seed=config.seed,
            stream_name="semi_finetune",
            balanced=True,
            augment=True,
            early_stopping_patience=config.early_stopping_patience,
            checkpoint_fn=lambda s: save_checkpoint(reg.semi_checkpoint, s.model),
            resume_path=config.resume_path("semi_finetune"),
        )
    semi_time = timed(t0)
    semi_model = semi_state.model
    semi = threshold_and_eval(semi_model, datasets, config, pos_index, "semi", mesh=mesh)
    semi.arg_metrics["training_time_sec"] = semi_time
    semi.thr_metrics["training_time_sec"] = semi_time

    # ---- artifacts -------------------------------------------------------
    history_payload = {
        "arch": config.arch,
        "image_size": int(config.image_size),
        "baseline": baseline_history,
        "semi_pretrain": pretrain_history,
        "semi_finetune": finetune_history,
        "splits": {k: np.asarray(v).tolist() for k, v in splits.items()},
        "pseudo_label_count": int(len(keep_idx)),
    }
    if is_primary():
        reg.notes_dir.mkdir(parents=True, exist_ok=True)
        reg.training_history_json.write_text(json.dumps(history_payload, indent=2))

    if figures:
        plots.plot_training_curves(
            {key: pretrain_history[key] + finetune_history[key] for key in pretrain_history},
            reg.semi_curves_png,
            "Semi-supervised",
        )
        for evals, argmax_png, thresholded_png in (
            (base, reg.baseline_confusion_png, reg.baseline_confusion_thresholded_png),
            (semi, reg.semi_confusion_png, reg.semi_confusion_thresholded_png),
        ):
            plots.plot_confusion_matrix(evals.arg_y_true, evals.arg_y_pred, classes, argmax_png)
            plots.plot_confusion_matrix(evals.thr_y_true, evals.thr_y_pred, classes, thresholded_png)
        curves = {
            name: ((evals.thr_y_true == pos_index).astype(int), evals.thr_y_prob)
            for name, evals in (("Baseline", base), ("Semi-supervised", semi))
        }
        plots.plot_roc_curves(curves, reg.roc_curves_png)
        plots.plot_pr_curves(curves, reg.pr_curves_png)

    target_recall = None if config.target_recall is None else float(config.target_recall)
    detailed_rows: Dict[str, Dict[str, Any]] = {}
    for name, evals, seconds in (("baseline", base, baseline_time), ("semi", semi, semi_time)):
        detailed_rows[f"{name}_argmax"] = binary_confusion_metrics(
            evals.arg_y_true, evals.arg_y_pred, pos_index
        ) | {"threshold": None, "target_recall": None, "training_time_sec": seconds}
        detailed_rows[f"{name}_thresholded"] = binary_confusion_metrics(
            evals.thr_y_true, evals.thr_y_pred, pos_index
        ) | {
            "threshold": None if evals.threshold is None else float(evals.threshold),
            "target_recall": target_recall,
            "training_time_sec": seconds,
            "min_precision": evals.thr_metrics.get("min_precision"),
            "max_fpr": evals.thr_metrics.get("max_fpr"),
        }
    write_results_csv(reg.results_comparison_detailed_csv, detailed_rows)
    if figures:
        plots.plot_metrics_bars(
            detailed_rows, reg.metrics_comparison_png, keys=["TPR", "FPR", "TNR", "precision", "accuracy"]
        )
    write_results_csv(
        reg.results_comparison_csv,
        {"baseline_thresholded": base.thr_metrics, "semi_thresholded": semi.thr_metrics},
    )

    # The forwards below raise like any other; only a failure to write the
    # two files warns, as in the JAX run.
    op_payload = {
        "model": f"semi_supervised_{config.arch}",
        "arch": config.arch,
        "image_size": int(config.image_size),
        "checkpoint": str(reg.semi_checkpoint),
        "positive_class": config.positive_class,
        "classes": list(classes),  # serving derives pos_index from this
        "threshold": semi.thr_metrics.get("threshold"),
        "policy": semi.thr_metrics.get("threshold_policy"),
        "target_recall": config.target_recall,
        "min_precision": config.min_precision,
        "max_fpr": config.max_fpr,
        "seed": config.seed,
    }
    try:
        if is_primary():
            reg.operating_point_json.write_text(json.dumps(op_payload, indent=2))
    except OSError as exc:
        LOGGER.warning("Failed to write operating_point.json: %s", exc)

    # triage CSV over the FULL unlabeled pool (unfiltered)
    triage_thr = semi.thr_metrics.get("threshold")
    if triage_thr is None:
        LOGGER.info("Skipping triage CSV: no threshold selected")
    else:
        if keep_paths is not None:
            triage_images, triage_paths = load_unlabeled_dataset(
                Path(config.weak_data_dir), config.image_size, device, num_threads=config.num_workers
            )
        else:
            triage_images, triage_paths = pool_images, pool_paths
        probs = pool_probabilities(semi_model, triage_images, config.batch_size, mesh)[:, pos_index]
        flagged = probs >= float(triage_thr)
        try:
            if is_primary():
                with open(reg.triage_csv, "w", newline="") as fh:
                    writer = csv.writer(fh, lineterminator="\n")
                    writer.writerow(["path", "prob_positive", "flagged"])
                    writer.writerows(zip(map(str, triage_paths), probs, flagged))
                LOGGER.info(
                    "Wrote triage CSV with %d rows (%d flagged) to %s", len(probs), int(flagged.sum()),
                    reg.triage_csv,
                )
        except OSError as exc:
            LOGGER.warning("Failed to write triage CSV: %s", exc)

    return {"baseline_thresholded": base.thr_metrics, "semi_thresholded": semi.thr_metrics}
