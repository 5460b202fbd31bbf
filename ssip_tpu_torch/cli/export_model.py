"""CLI: export a trained run as a self-contained serving artifact, on PyTorch.

Counterpart of ``src/export_model.py``, with the same flags and artifact
(``<output-dir>/models/<model>_serving.ssip.npz``: the serving forward as a
``torch.export`` program with a symbolic batch, its weights and the
calibrated operating point) but two, by rule:

- ``--device`` takes ``auto|cpu|cuda`` and defaults to ``auto``, the card (an
  error when none is visible); the JAX CLI defaults to ``cpu``. It is where
  the program is traced (and the int8 calibration runs); the artifact runs on
  every platform it lists.
- ``--platforms`` takes ``cpu`` and ``cuda``, default ``cpu,cuda``; ``tpu``
  (the JAX CLI's default ``cpu,tpu``) is refused with an error naming the
  port.

``python -m ssip_tpu_torch.cli.serve --model-file`` serves the artifact.

    python -m ssip_tpu_torch.cli.export_model --output-dir outputs --model semi
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ssip_tpu_torch.deploy.export import ARTIFACT_SUFFIX, DEFAULT_PLATFORMS


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"),
                        help="pipeline run holding checkpoint + operating point")
    parser.add_argument("--model", choices=["baseline", "semi"], default="semi")
    parser.add_argument("--out", type=Path, default=None,
                        help="artifact path (default: <output-dir>/models/<model>_serving.ssip.npz)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument(
        "--compute-dtype", choices=["float32", "bfloat16", "int8"], default="float32",
        help="float32 (default) matches calibration-time probabilities; bfloat16 trades O(1e-2) probability "
        "shift for throughput; int8 exports the PTQ mode of the ResNets (approximate) and requires "
        "--calibration-images",
    )
    parser.add_argument("--calibration-images", type=Path, default=None,
                        help="directory of images for int8 activation-scale calibration "
                        "(first --calibration-count, sorted)")
    parser.add_argument("--calibration-count", type=int, default=32)
    parser.add_argument("--platforms", default=",".join(DEFAULT_PLATFORMS),
                        help="comma-separated platforms the artifact is for: cpu and cuda")
    parser.add_argument("--threshold", type=float, default=None, help="override the calibrated operating threshold")
    parser.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto",
                        help="where the program is traced: auto (default) and cuda the card, cpu the host")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from ssip_tpu_torch.deploy.export import check_platforms, export_serving_artifact
    from ssip_tpu_torch.runtime.device import configure_precision, resolve_device
    from ssip_tpu_torch.serving import load_serving_bundle

    platforms = check_platforms(args.platforms.split(","))
    device = resolve_device(args.device)
    configure_precision("float32")  # the calibration forward and the fc head in true float32
    bundle = load_serving_bundle(args.output_dir, model=args.model, image_size=args.image_size)
    threshold = bundle.threshold if args.threshold is None else float(args.threshold)
    out = args.out or (args.output_dir / "models" / f"{args.model}_serving{ARTIFACT_SUFFIX}")

    calibration_u8 = None
    if args.compute_dtype == "int8":
        if args.calibration_images is None:
            raise SystemExit("--compute-dtype int8 requires --calibration-images")
        from ssip_tpu_torch.data.discovery import IMAGE_SUFFIXES
        from ssip_tpu_torch.serving import decode_and_resize

        paths = sorted(
            p for p in args.calibration_images.rglob("*") if p.is_file() and p.suffix.lower() in IMAGE_SUFFIXES
        )[: args.calibration_count]
        if not paths:
            raise SystemExit(f"No images under {args.calibration_images}")
        _, calibration_u8, _ = decode_and_resize(paths, args.image_size, device)
    path = export_serving_artifact(
        bundle.state,
        out,
        arch=bundle.arch,
        num_classes=bundle.num_classes,
        image_size=args.image_size,
        compute_dtype=args.compute_dtype,
        platforms=platforms,
        threshold=threshold,
        positive_class=bundle.positive_class,
        pos_index=bundle.pos_index,
        classes=bundle.classes,
        calibration_u8=calibration_u8,
        device=device,
    )
    size_mb = path.stat().st_size / 1e6
    print(
        f"Exported {args.model} ({bundle.arch}, thr={threshold:.4f}, "
        f"platforms={','.join(platforms)}) -> {path} ({size_mb:.1f} MB)"
    )


if __name__ == "__main__":
    main()
