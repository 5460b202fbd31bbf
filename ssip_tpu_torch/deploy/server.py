"""Minimal stdlib HTTP serving endpoint for exported screening models.

The port's copy of ``ssip_tpu/deploy/server.py``: the same endpoints and
responses (``tests/test_torch_shared.py`` holds the copy to its original),
with images resized on the predictor's device through
``train/data.py:resize_on_device``. Two differences, both for latency on the
card:

- device work (the resize and the model) runs on one long-lived worker
  thread, which also serializes it as the original's lock does: the server
  starts a thread a request, and the first CUDA work of a fresh thread took
  about 32 ms more than the same work on a warm one (46.6 against 14.6 ms
  for a 512² JPEG, ``chip_smoke.py`` ``[serve]`` on an H100); decoding stays
  on the request's thread;
- Nagle's algorithm is off on the connection, which otherwise holds each
  response's body until the client's delayed ACK.

Endpoints:

    GET  /healthz        → {"status": "ok", "model": <arch>}
    GET  /manifest       → the artifact manifest JSON
    POST /predict        → body: raw image bytes (JPEG/PNG/BMP);
                           response: {prob_positive, flagged, threshold,
                           positive_class}
    POST /predict_paths  → body: {"paths": [server-local image paths]};
                           response: triage-schema rows (the CSV columns of
                           reference semi_supervised.py:472-511 as JSON)

One program serves every request (the exported artifact's symbolic batch,
or the in-process predictor); concurrent requests queue for the worker. This
is a single-model scoring sidecar, not a gateway: TLS, auth and multi-model
routing belong in front of it.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)


def _decode_image_bytes(body: bytes) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(body)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def make_server(model, host: str = "127.0.0.1", port: int = 0):
    """Build a ThreadingHTTPServer around any predictor with the
    ``predict_images(images_u8, paths=...)`` / ``image_size`` /
    ``manifest``-ish surface (``ExportedModel`` or ``ScreeningPredictor``);
    its ``device`` (the CPU when it has none) runs the resize.
    ``server_close()`` also stops the worker thread.
    """
    from ssip_tpu_torch.data.decode import decode_batch
    from ssip_tpu_torch.train.data import resize_on_device

    worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ssip-serve")
    device = getattr(model, "device", torch.device("cpu"))
    manifest = getattr(model, "manifest", None) or {
        "arch": getattr(model, "arch", "unknown"),
        "image_size": model.image_size,
        "threshold": model.threshold,
        "positive_class": model.positive_class,
    }

    def on_worker(arrays, paths=None):
        """Resize (images already at the serving size as they are) and
        predict: the device work, run on the worker thread."""
        s = model.image_size
        if all(a.shape == (s, s, 3) for a in arrays):
            return model.predict_images(np.stack(arrays), paths=paths)
        return model.predict_images(resize_on_device(arrays, s, device), paths=paths)

    def predict_array(arr: np.ndarray):
        return worker.submit(on_worker, [arr]).result()

    def predict_paths(paths):
        arrays, failures = decode_batch([Path(p) for p in paths], convert_rgb=True, num_threads=4)
        kept = [(p, a) for p, a in zip(paths, arrays) if a is not None]
        failures = [str(p) for p in failures]
        if not kept:
            return None, failures
        return worker.submit(on_worker, [a for _, a in kept], [p for p, _ in kept]).result(), failures

    class Handler(BaseHTTPRequestHandler):
        # the headers and the body go out in two writes; with Nagle's
        # algorithm on, the second waits for the client's delayed ACK
        disable_nagle_algorithm = True

        def _send_json(self, obj, status: int = 200) -> None:
            payload = json.dumps(obj).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, fmt, *args):  # route through our logger
            LOGGER.debug("http: " + fmt, *args)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send_json({"status": "ok", "model": manifest.get("arch", "unknown")})
            elif self.path == "/manifest":
                self._send_json(manifest)
            else:
                self._send_json({"error": f"unknown path {self.path}"}, 404)

        def do_POST(self):  # noqa: N802 (stdlib API)
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path == "/predict":
                    result = predict_array(_decode_image_bytes(body))
                    self._send_json(
                        {
                            "prob_positive": float(result.prob_positive[0]),
                            "flagged": bool(result.flagged[0]),
                            "threshold": result.threshold,
                            "positive_class": result.positive_class,
                        }
                    )
                elif self.path == "/predict_paths":
                    req = json.loads(body.decode("utf-8"))
                    paths = req.get("paths") or []
                    if not paths:
                        self._send_json({"error": "no paths given"}, 400)
                        return
                    result, failures = predict_paths(paths)
                    if result is None:
                        self._send_json({"error": "no decodable images", "failures": failures}, 400)
                        return
                    self._send_json(
                        {
                            "rows": [
                                {"path": p, "prob_positive": float(prob), "flagged": bool(flag)}
                                for p, prob, flag in zip(result.paths, result.prob_positive, result.flagged)
                            ],
                            "threshold": result.threshold,
                            "positive_class": result.positive_class,
                            "failures": failures,
                        }
                    )
                else:
                    self._send_json({"error": f"unknown path {self.path}"}, 404)
            except Exception as exc:  # a bad request must not kill the server
                LOGGER.warning("request failed: %s", exc)
                self._send_json({"error": str(exc)}, 400)

    class Server(ThreadingHTTPServer):
        def server_close(self) -> None:
            super().server_close()
            worker.shutdown(wait=True)

    return Server((host, port), Handler)
