"""CLI: HTTP scoring endpoint for a trained screening model, on PyTorch.

Counterpart of ``src/serve.py``, with the same flags and endpoints
(``deploy/server.py``) but one: ``--device`` takes ``auto|cpu|cuda`` and
``auto`` (the default) is the card, an error when none is visible. Serves
either an artifact from ``cli.export_model`` (``--model-file``) or a
pipeline run's checkpoint directly (``--output-dir``/``--model``).

    python -m ssip_tpu_torch.cli.serve --model-file outputs/models/semi_serving.ssip.npz
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-file", type=Path, default=None, help="exported .ssip.npz artifact (cli.export_model)")
    parser.add_argument("--output-dir", type=Path, default=Path("outputs"),
                        help="pipeline run (used when --model-file is absent)")
    parser.add_argument("--model", choices=["baseline", "semi"], default="semi")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--max-batch", type=int, default=256)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--device", choices=["auto", "cpu", "cuda"], default="auto",
                        help="auto (default) and cuda: the card, and an error when none is visible; cpu: the host")
    return parser.parse_args(argv)


def build_model(args):
    if args.model_file is not None:
        from ssip_tpu_torch.deploy.export import ExportedModel

        return ExportedModel.load(args.model_file, max_batch=args.max_batch, device=args.device)
    from ssip_tpu_torch.serving import ScreeningPredictor

    return ScreeningPredictor.from_artifacts(
        args.output_dir, model=args.model, batch_size=args.max_batch, image_size=args.image_size,
        compute_dtype=args.compute_dtype, device=args.device,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from ssip_tpu_torch.deploy.server import make_server

    model = build_model(args)
    httpd = make_server(model, host=args.host, port=args.port)
    host, port = httpd.server_address[:2]
    print(f"Serving on http://{host}:{port} (POST /predict, /predict_paths)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
