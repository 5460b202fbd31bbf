"""Post-hoc threshold sweep over a trained checkpoint.

Counterpart of ``ssip_tpu/pipelines/sweep.py`` (reference
src/threshold_sweep.py:78-169): rebuild the test split from the persisted
``training_history.json`` indices, reload the requested checkpoint into the
recorded ``--arch`` at the recorded image size, compute positive-class
probabilities with ``train/engine.py:run_eval_epoch`` on the device, sweep
every unique probability (descending, plus {0, 1}) in one vectorized pass,
write ``threshold_sweep_{model}.csv`` (without pandas, in the text pandas
writes) and print the largest threshold with TPR≈1.0 as a JSON line.

The model is evaluated in float32 with TF32 off, as the JAX sweep evaluates
its float32 model.
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.ops.thresholds import sweep_thresholds
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.runtime.device import configure_precision, resolve_device
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.train.checkpoints import load_checkpoint
from ssip_tpu_torch.train.data import load_labeled_dataset, subset
from ssip_tpu_torch.train.engine import run_eval_epoch

LOGGER = get_logger(__name__)


@dataclass
class SweepConfig:
    strong_data_dir: Path
    output_dir: Path = Path("outputs")
    model: str = "semi"  # "baseline" | "semi"
    positive_class: str = "cancer"
    device: str = "auto"
    num_workers: int = 4
    batch_size: int = 16
    seed: int = 42
    image_size: int = 224


def load_history(history_path: Path) -> Dict:
    """Parsed training_history.json (read once; splits + recorded arch)."""
    payload = json.loads(Path(history_path).read_text())
    if "splits" not in payload:
        raise KeyError(f"'splits' missing from {history_path}")
    return payload


def splits_of(payload: Dict) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, dtype=np.int64) for k, v in payload["splits"].items()}


def arch_of(payload: Dict) -> str:
    """Backbone recorded by the training run (pre-arch histories: resnet18)."""
    return str(payload.get("arch", "resnet18"))


def image_size_of(payload: Dict, default: int) -> int:
    """Training image size recorded in the history: a ViT's position
    embedding is shaped by it, and any other grid would shift every sweep
    metric. Pre-image_size histories fall back to the CLI/default value."""
    return int(payload.get("image_size", default))


def write_sweep_csv(path: Path, rows: List[Dict[str, float]]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)``'s text for rows of
    floats: the first row's keys as the header, each value by ``repr``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def run_sweep(cfg: SweepConfig) -> Dict[str, float]:
    device = resolve_device(cfg.device)
    configure_precision("float32")
    reg = TrainingConfig(strong_data_dir=cfg.strong_data_dir, output_dir=cfg.output_dir).artifacts

    history_payload = load_history(reg.training_history_json)
    splits = splits_of(history_payload)
    image_size = image_size_of(history_payload, cfg.image_size)
    if image_size != cfg.image_size:
        LOGGER.info("Evaluating at the training run's recorded image size %d", image_size)
    images, targets, classes, _paths = load_labeled_dataset(
        cfg.strong_data_dir, image_size, device, num_threads=cfg.num_workers
    )
    if cfg.positive_class not in classes:
        raise ValueError(f"Positive class '{cfg.positive_class}' not in classes {classes}")
    pos_index = classes.index(cfg.positive_class)
    test_ds = subset(images, targets, splits["test"])

    ckpt_path = reg.baseline_checkpoint if cfg.model == "baseline" else reg.semi_checkpoint
    arch = arch_of(history_payload)
    model = build_model(arch, num_classes=len(classes), image_size=image_size)
    load_checkpoint(ckpt_path, model)
    model = model.to(device)
    LOGGER.info("Loaded %s checkpoint (%s) from %s", cfg.model, arch, ckpt_path)

    _loss, y_true, _pred, probs_full = run_eval_epoch(model, test_ds, cfg.batch_size)
    y_prob = probs_full[:, pos_index]

    rows = sweep_thresholds(y_true, y_prob, pos_index)
    out_csv = reg.threshold_sweep_csv(cfg.model)
    write_sweep_csv(out_csv, rows)

    # screening policy: TPR≈1.0, then the largest threshold (fewest FPs)
    tpr1 = [r for r in rows if r["TPR"] >= 0.999999]
    if tpr1:
        best = max(tpr1, key=lambda r: r["threshold"])
        result = {
            "best_threshold": best["threshold"],
            "TP": best["TP"], "FP": best["FP"], "TN": best["TN"], "FN": best["FN"],
            "TPR": best["TPR"], "FPR": best["FPR"],
            "precision": best["precision"], "accuracy": best["accuracy"],
            "csv": str(out_csv),
        }
    else:
        result = {"message": "No threshold achieves TPR=1.0 on test", "csv": str(out_csv)}
    print(json.dumps(result))
    return result
