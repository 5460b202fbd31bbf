"""CLI: standardize embeddings into the clustering feature bundle, on PyTorch.

Counterpart of ``src/standardize_features.py``, with the same flags,
defaults and artifact but one: ``--device`` takes ``auto|cpu|cuda`` and
defaults to ``auto``, the card (the JAX CLI defaults to ``cpu`` to skip a
TPU runtime's start-up; the port's entry points run on the card unless
asked for the CPU).

    python -m ssip_tpu_torch.cli.standardize_features
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssip_tpu_torch.analysis.standardize import standardize_embeddings
from ssip_tpu_torch.runtime.device import resolve_device
from ssip_tpu_torch.runtime.logging import configure_logging


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--embeddings-npy", type=Path, default=Path("outputs/features/embeddings.npy"))
    parser.add_argument("--embeddings-csv", type=Path, default=Path("outputs/features/embeddings.csv"))
    parser.add_argument("--output-npz", type=Path, default=Path("outputs/features/standardized_features.npz"))
    parser.add_argument("--log-level", choices=["DEBUG", "INFO", "WARNING", "ERROR"], default="INFO")
    parser.add_argument(
        "--device", choices=["auto", "cpu", "cuda"], default="auto",
        help="auto (default) and cuda: the card, and an error when none is visible; cpu: the host. "
        "(src.standardize_features defaults to cpu, a TPU work-around.)",
    )
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    configure_logging(args.log_level)
    standardize_embeddings(
        args.embeddings_npy, args.embeddings_csv, args.output_npz, device=resolve_device(args.device)
    )


if __name__ == "__main__":
    main()
