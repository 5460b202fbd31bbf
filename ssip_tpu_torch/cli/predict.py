"""CLI: batch screening inference with a trained model, on PyTorch (CUDA or CPU).

Counterpart of ``src/predict.py``, with the same flags, defaults and CSV
(``path,prob_positive,flagged``, the values as the JAX CLI's ``to_csv``
writes them) but one: ``--device`` takes ``auto|cpu|cuda`` and ``auto``
(the default) is the card, an error when none is visible (the JAX CLI treats
``cuda`` as ``auto``). The CSV goes through ``csv``, not pandas. Loads a
pipeline run's checkpoint and calibrated operating point and predicts a
directory of images (or one file).

    python -m ssip_tpu_torch.cli.predict --images DATA/sans_label --model semi --output preds.csv
"""

from __future__ import annotations

import argparse
import csv
import io
import logging
from pathlib import Path

import numpy as np

from ssip_tpu_torch.data.discovery import IMAGE_SUFFIXES


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--images", type=Path, required=True, help="directory of images (or a single file)")
    parser.add_argument("--model", choices=["baseline", "semi"], default="semi")
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"),
                        help="pipeline run holding checkpoint + operating point")
    parser.add_argument("--output", type=Path, default=None, help="CSV destination (default: stdout)")
    parser.add_argument("--threshold", type=float, default=None, help="override the calibrated operating threshold")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument(
        "--compute-dtype", choices=["float32", "bfloat16"], default="float32",
        help="float32 (default) matches the calibration-time probabilities; bfloat16 trades O(1e-2) "
        "probability shift for throughput",
    )
    parser.add_argument(
        "--device", choices=["auto", "cpu", "cuda"], default="auto",
        help="auto (default) and cuda: the card, and an error when none is visible; cpu: the host",
    )
    return parser.parse_args(argv)


def triage_csv(result) -> str:
    """``path,prob_positive,flagged`` rows, as pandas' ``to_csv(index=False)``
    writes a float32 and a bool column."""
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(["path", "prob_positive", "flagged"])
    for path, prob, flag in zip(result.paths, np.asarray(result.prob_positive), np.asarray(result.flagged)):
        writer.writerow([path, str(prob), str(bool(flag))])
    return buf.getvalue()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from ssip_tpu_torch.serving import ScreeningPredictor

    predictor = ScreeningPredictor.from_artifacts(
        args.output_dir, model=args.model, batch_size=args.batch_size, compute_dtype=args.compute_dtype,
        device=args.device,
    )
    if args.threshold is not None:
        predictor.threshold = float(args.threshold)

    if args.images.is_file():
        paths = [args.images]
    else:
        paths = sorted(p for p in args.images.rglob("*") if p.is_file() and p.suffix.lower() in IMAGE_SUFFIXES)
    if not paths:
        raise SystemExit(f"No images under {args.images}")

    result = predictor.predict_paths(paths)
    text = triage_csv(result)
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(text)
        print(
            f"Predicted {len(result.paths)} images ({int(np.sum(result.flagged))} flagged at "
            f"thr={result.threshold:.4f} for '{result.positive_class}') -> {args.output}"
        )
    else:
        print(text)


if __name__ == "__main__":
    main()
