"""CLI: frozen-backbone feature extraction on PyTorch (CUDA or CPU).

Counterpart of ``src/feature_extraction.py``, with the same flags and
defaults. Flags whose code paths are not ported yet are accepted by the
parser and refused with an error naming the ROADMAP entry:
``--compute-dtype int8``, ``--streaming always``, ``--fast-decode``,
``--host-preproc``, ``--shard-size > 0`` and the MoE archs. With
``--streaming auto`` a corpus above the host budget, which the JAX CLI
would stream, is refused the same way.

    python -m ssip_tpu_torch.cli.feature_extraction --data-dir DATA --device cuda --batch-size 128
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssip_tpu_torch.pipelines.extraction import _STREAMED_NOT_PORTED, ExtractionConfig, run_extraction


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", type=Path, default=Path("mri_dataset_brain_cancer_oc"))
    parser.add_argument("--device", type=str, default="auto")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"))
    parser.add_argument(
        "--weights", type=Path, default=None,
        help="torch ResNet-18 state_dict (.pt/.pth); default: "
        "$SSIP_RESNET18_WEIGHTS or seeded random init",
    )
    parser.add_argument(
        "--compute-dtype", choices=["float32", "bfloat16", "int8"], default="float32"
    )
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
    parser.add_argument("--no-cache", action="store_true", help="skip decode cache")
    parser.add_argument(
        "--streaming", choices=["auto", "always", "never"], default="auto",
        help="'always' (the streamed shape) is not ported yet; 'auto' takes the "
        "decode-once store path and refuses a corpus above the host budget",
    )
    speed = parser.add_mutually_exclusive_group()
    speed.add_argument("--fast-decode", action="store_true", help="not ported yet")
    speed.add_argument("--host-preproc", action="store_true", help="not ported yet")
    parser.add_argument(
        "--shard-size", type=int, default=0,
        help="sharded resumable extraction (not ported yet; 0 = single-shot)",
    )
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    for flag, on in (
        ("--fast-decode", args.fast_decode),
        ("--host-preproc", args.host_preproc),
        ("--shard-size > 0", args.shard_size > 0),
    ):
        if on:
            raise ValueError(f"{flag} {_STREAMED_NOT_PORTED}")
    cfg = ExtractionConfig(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        batch_size=args.batch_size,
        device=args.device,
        verbose=args.verbose,
        weights=args.weights,
        compute_dtype=args.compute_dtype,
        arch=args.arch,
        cache_decoded=not args.no_cache,
        streaming=args.streaming,
    )
    summary = run_extraction(cfg)
    print(
        f"Extracted {summary.embeddings.shape[0]} embeddings "
        f"({summary.embeddings.shape[1]}-D) in {summary.total_seconds:.2f}s"
    )


if __name__ == "__main__":
    main()
