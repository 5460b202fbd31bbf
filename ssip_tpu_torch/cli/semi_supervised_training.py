"""CLI: semi-supervised training pipeline on PyTorch (CUDA or CPU).

Counterpart of ``src/semi_supervised_training.py``, with the same flags and
defaults (copied here: that module imports the JAX pipeline) and the shared
flags of ``cli/supervised_training.py`` (``--resume`` and the MoE archs
included), ``--num-seeds`` and ``--cv-folds``, and ``--strong-augment
randaugment``, ``--fsdp`` and ``--mesh-model`` (the model axis, as in
the supervised CLI).

Launch on N cards (a launch difference, not a flag): one process a card,
started by ``torchrun --nproc-per-node N -m ssip_tpu_torch.cli.semi_supervised_training ...``
or by N processes with ``SSIP_COORDINATOR=host:port``,
``SSIP_NUM_PROCESSES=N`` and ``SSIP_PROCESS_ID=i``
(``parallel/distributed.py``); each runs on ``cuda:LOCAL_RANK`` and rank 0
writes the outputs (every rank prints the result, as ``src/``'s CLI does).
Started alone, the CLI is one process on one card, as the JAX CLI is on a
one-chip host. ``--device cpu`` joins the ranks over gloo.

    python -m ssip_tpu_torch.cli.semi_supervised_training \\
        --strong-data-dir DATA/avec_labels --weak-data-dir DATA/sans_label --device cuda
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ssip_tpu_torch.cli.supervised_training import add_common_training_flags, config_from_args, run_distributed
from ssip_tpu_torch.pipelines.semi_supervised import run_pipeline


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--strong-data-dir", type=Path, required=True)
    parser.add_argument("--weak-data-dir", type=Path, required=True)
    add_common_training_flags(parser)
    parser.add_argument("--weak-pretrain-epochs", type=int, default=5)
    parser.add_argument("--finetune-epochs", type=int, default=8)
    parser.add_argument("--pseudo-threshold", type=float, default=0.7)
    parser.add_argument("--unlabeled-cohort-csv", type=Path, default=None)
    parser.add_argument(
        "--consistency-weight", type=float, default=0.0,
        help="FixMatch-style augmentation-consistency loss weight during "
        "fine-tuning (0 = off, reference-equivalent)",
    )
    parser.add_argument("--consistency-threshold", type=float, default=0.95)
    parser.add_argument(
        "--strong-augment", choices=("jitter", "randaugment"), default="jitter",
        help="strong view for the consistency loss: 'jitter' (flip/rotate/"
        "brightness/contrast) or 'randaugment' (the FixMatch paper's "
        "RandAugment+Cutout policy)",
    )
    parser.add_argument(
        "--ema-decay", type=float, default=0.0,
        help="Mean-Teacher EMA decay for the consistency pseudo-target "
        "teacher (0 = off, teacher is the live student; 0.999 typical). "
        "Validation and the returned best model follow the EMA average.",
    )
    return parser.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    print(run_distributed(config_from_args(parse_args(argv)), run_pipeline))


if __name__ == "__main__":
    main()
