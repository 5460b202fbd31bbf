"""CLI: post-hoc threshold sweep on PyTorch (CUDA or CPU).

Counterpart of ``src/threshold_sweep.py``, with the same flags and defaults
(copied here: that module imports the JAX pipeline). Reads the outputs of
``supervised_training`` or ``semi_supervised_training`` and writes
``tables/threshold_sweep_{model}.csv``.

    python -m ssip_tpu_torch.cli.threshold_sweep --strong-data-dir DATA/avec_labels --model semi
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ssip_tpu_torch.pipelines.sweep import SweepConfig, run_sweep


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--strong-data-dir", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    parser.add_argument("--model", choices=["baseline", "semi"], default="semi")
    parser.add_argument("--positive-class", type=str, default="cancer")
    parser.add_argument("--device", type=str, default="auto")
    parser.add_argument("--num-workers", type=int, default=4)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    run_sweep(
        SweepConfig(
            strong_data_dir=args.strong_data_dir,
            output_dir=args.output_dir,
            model=args.model,
            positive_class=args.positive_class,
            device=args.device,
            num_workers=args.num_workers,
        )
    )


if __name__ == "__main__":
    main()
