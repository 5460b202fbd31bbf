"""CLI: frozen-backbone feature extraction on PyTorch (CUDA or CPU).

Counterpart of ``src/feature_extraction.py``, with the same flags and
defaults. ``--streaming always`` (and ``auto`` above the host budget) takes
the streamed shape; ``--host-preproc`` (exact) and ``--fast-decode``
(approximate) resize and crop on the host and imply it, and need the native
decoder, built at first use with g++ and libjpeg. ``--shard-size N``
(N > 0) is the resumable form (``pipelines/sharded_extraction.py``): shards
of N images under ``features/shards/`` with a manifest each, reused on a
re-run when they verify, merged into the same artifact set.

Launch on N cards (a launch difference, not a flag): one process a card,
started by ``torchrun --nproc-per-node N -m
ssip_tpu_torch.cli.feature_extraction ...`` or by N processes with
``SSIP_COORDINATOR=host:port``, ``SSIP_NUM_PROCESSES=N`` and
``SSIP_PROCESS_ID=i`` (``parallel/distributed.py``); each runs on
``cuda:LOCAL_RANK`` and embeds its share of every global batch, and rank 0
writes the outputs (every rank prints the summary line, as ``src/``'s CLI
does). Started alone, the CLI is one process on one card, as the JAX CLI is
on a one-chip host. ``--device cpu`` joins the ranks over gloo.

``--compute-dtype int8`` (with a ResNet or with ``vit_t16``, ``vit_s16`` or
``vit_b16``; refused with the MoE archs, as in JAX) is post-training int8
extraction: calibrated on the corpus's
first 32 images, ``metadata.json``'s ``weights`` ends in ``+int8_ptq``.

    python -m ssip_tpu_torch.cli.feature_extraction --data-dir DATA --device cuda --batch-size 128
    python -m ssip_tpu_torch.cli.feature_extraction --data-dir DATA --arch vit_b16 --compute-dtype int8
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ssip_tpu_torch.parallel import distributed
from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction
from ssip_tpu_torch.pipelines.sharded_extraction import run_sharded_extraction


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
        "--compute-dtype", choices=["float32", "bfloat16", "int8"], default="float32",
        help="int8: post-training quantized extraction (the ResNets and the dense ViTs)",
    )
    parser.add_argument(
        "--arch",
        choices=[
            "resnet18", "resnet34", "resnet50",
            "vit_t16", "vit_s16", "vit_b16",
            "vit_moe_t16", "vit_moe_s16",
        ],
        default="resnet18",
        help="backbone architecture; vit_moe_* are Switch-style mixture-of-experts towers",
    )
    parser.add_argument("--no-cache", action="store_true", help="skip decode cache")
    parser.add_argument(
        "--streaming", choices=["auto", "always", "never"], default="auto",
        help="'always': decode→copy→embed overlapped in O(batch) host memory; "
        "'auto': stream only when no decode cache exists and the corpus "
        "exceeds the host-RAM budget",
    )
    speed = parser.add_mutually_exclusive_group()
    speed.add_argument(
        "--fast-decode", action="store_true",
        help="streaming turbo mode: DCT-scaled JPEG decode + host crop "
        "(approximate resample numerics; implies --streaming always)",
    )
    speed.add_argument(
        "--host-preproc", action="store_true",
        help="streaming with EXACT host-side resize+crop so only the crop "
        "crosses the host→device link (numerics unchanged; implies --streaming always)",
    )
    parser.add_argument(
        "--shard-size", type=int, default=0,
        help="sharded resumable extraction: shards of this many images with a manifest each, "
        "reused on a re-run (0 = single-shot)",
    )
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
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
        streaming="always" if (args.fast_decode or args.host_preproc) else args.streaming,
        fast_decode=args.fast_decode,
        host_preproc=args.host_preproc,
    )
    distributed.initialize(device=cfg.device)
    try:
        if args.shard_size > 0:
            summary = run_sharded_extraction(cfg, shard_size=args.shard_size)
        else:
            summary = run_extraction(cfg)
    except BaseException:
        distributed.shutdown(clean=False)
        raise
    distributed.shutdown(clean=True)
    print(
        f"Extracted {summary.embeddings.shape[0]} embeddings "
        f"({summary.embeddings.shape[1]}-D) in {summary.total_seconds:.2f}s"
    )


if __name__ == "__main__":
    main()
