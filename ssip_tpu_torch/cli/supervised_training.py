"""CLI: supervised baseline on PyTorch (CUDA or CPU), ResNet or ViT backbone.

Counterpart of ``src/supervised_training.py``, with the same flags, defaults
and flag-to-config mapping (copied here: that module imports the JAX
pipeline). Flags whose code paths are not ported yet are accepted by the
parser and refused with an error naming the ROADMAP entry: ``--resume``,
``--num-seeds > 1``, ``--cv-folds``, ``--mesh-model > 1``, ``--fsdp`` and the
MoE archs. ``--remat`` checkpoints the ViT encoder blocks and is ignored for
the ResNet archs, as in JAX.

    python -m ssip_tpu_torch.cli.supervised_training --strong-data-dir DATA/avec_labels --device cuda
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ssip_tpu_torch.pipelines.supervised import run_supervised
from ssip_tpu_torch.pipelines.train_config import TrainingConfig


def add_common_training_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--val-split", type=float, default=0.2)
    parser.add_argument("--test-split", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--baseline-epochs", type=int, default=10)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float, default=1e-4)
    parser.add_argument("--early-stopping", type=int, default=3)
    parser.add_argument("--positive-class", type=str, default="cancer")
    parser.add_argument("--target-recall", type=float, default=None)
    parser.add_argument("--min-precision", type=float, default=None)
    parser.add_argument("--max-fpr", type=float, default=None)
    parser.add_argument("--f-beta", type=float, default=2.0)
    parser.add_argument("--device", type=str, default="auto")
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    parser.add_argument(
        "--pretrained-weights", type=Path, default=None,
        help="torch resnet18 state_dict to port as the backbone init",
    )
    parser.add_argument("--resume", action="store_true", help="not ported yet")
    parser.add_argument(
        "--arch",
        choices=[
            "resnet18", "resnet34", "resnet50",
            "vit_t16", "vit_s16", "vit_b16",
            "vit_moe_t16", "vit_moe_s16",
        ],
        default="resnet18",
        help="backbone architecture (the vit_moe archs are not ported yet)",
    )
    parser.add_argument("--mesh-model", type=int, default=1, help="values above 1 are not ported yet")
    parser.add_argument("--remat", action="store_true", help="ViT only; ignored for resnet archs")
    parser.add_argument("--fsdp", action="store_true", help="not ported yet")
    parser.add_argument(
        "--compute-dtype", choices=["float32", "bfloat16"], default="float32",
        help="activation dtype for the train/eval forwards (params, BN stats, "
        "loss and optimizer stay float32)",
    )
    parser.add_argument("--cv-folds", type=int, default=0, help="not ported yet; 0 = off")
    parser.add_argument("--num-seeds", type=int, default=1, help="values above 1 are not ported yet")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--strong-data-dir", type=Path, required=True)
    add_common_training_flags(parser)
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> TrainingConfig:
    return TrainingConfig(
        strong_data_dir=args.strong_data_dir,
        weak_data_dir=getattr(args, "weak_data_dir", None),
        arch=args.arch,
        mesh_model=args.mesh_model,
        mesh_fsdp=getattr(args, "fsdp", False),
        remat=getattr(args, "remat", False),
        batch_size=args.batch_size,
        val_split=args.val_split,
        test_split=args.test_split,
        seed=args.seed,
        image_size=args.image_size,
        num_workers=args.num_workers,
        device=args.device,
        positive_class=args.positive_class,
        target_recall=args.target_recall,
        min_precision=args.min_precision,
        max_fpr=args.max_fpr,
        f_beta=args.f_beta,
        baseline_epochs=args.baseline_epochs,
        weak_pretrain_epochs=getattr(args, "weak_pretrain_epochs", 5),
        finetune_epochs=getattr(args, "finetune_epochs", 8),
        pseudo_label_threshold=getattr(args, "pseudo_threshold", 0.7),
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        early_stopping_patience=args.early_stopping,
        output_dir=args.output_dir,
        unlabeled_cohort_csv=getattr(args, "unlabeled_cohort_csv", None),
        pretrained_weights=args.pretrained_weights,
        consistency_weight=getattr(args, "consistency_weight", 0.0),
        consistency_threshold=getattr(args, "consistency_threshold", 0.95),
        strong_augment=getattr(args, "strong_augment", "jitter"),
        ema_decay=getattr(args, "ema_decay", 0.0),
        resume=getattr(args, "resume", False),
        compute_dtype=getattr(args, "compute_dtype", "float32"),
        num_seeds=getattr(args, "num_seeds", 1),
        cv_folds=getattr(args, "cv_folds", 0),
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    print(run_supervised(config_from_args(parse_args(argv))))


if __name__ == "__main__":
    main()
