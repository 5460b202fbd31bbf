"""CLI: dataset audit (host only: an inventory scan, a PIL header probe, figures).

Counterpart of ``src/data_audit.py``, with the same flags and defaults.
Needs pandas and matplotlib.

    python -m ssip_tpu_torch.cli.data_audit --data-dir DATA
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from ssip_tpu_torch.analysis.audit import audit_dataset
from ssip_tpu_torch.runtime.logging import configure_logging


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="MRI dataset audit script")
    parser.add_argument("--data-dir", type=Path, default=Path("mri_dataset_brain_cancer_oc"))
    parser.add_argument("--sample-size", type=int, default=64)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    configure_logging("INFO")
    random.seed(args.seed)
    audit_dataset(args.data_dir, args.sample_size, args.seed, args.output_dir)


if __name__ == "__main__":
    main()
