"""Serving export: a ``torch.export`` program with a manifest, one file.

Counterpart of ``ssip_tpu/deploy/export.py``: ``build_serving_fn``,
``build_serving_fn_int8``, ``quantized_serving_bundle``,
``export_serving_artifact`` and ``ExportedModel``. The exported program is
the serving forward the in-process predictor runs (``serving.py``): eval
normalization → the classifier in eval mode → float32 softmax, on
``uint8 [b, S, S, 3]`` eval-resized input with a symbolic batch
(``torch.export.Dim("b", min=1)``), traced under ``torch.no_grad()``.

Artifact format (one ``.ssip.npz``, a plain zip that ``np.load`` opens),
the JAX package's contract with the program in place of StableHLO:

    __manifest__      uint8 bytes of a JSON manifest
    __torch_export__  uint8 bytes of ``torch.export.save`` of the program,
                      the weights inside it (once)

Manifest: ``{version, arch, num_classes, image_size, compute_dtype,
platforms, threshold, positive_class, pos_index, classes, torch_version,
input, output, calibration_images}``, ``torch_version`` in place of
``jax_version``. ``version`` is ``MANIFEST_VERSION``, not the JAX package's
``1``: its loader refuses a port artifact by its own version check, and this
loader refuses a JAX artifact (it holds ``__stablehlo__``) by name.

``platforms`` are ``cpu`` and ``cuda`` (both by default). The program's
operations are device-generic (ATen and the port's custom operators
``ssip_tpu_torch::layer_norm`` and ``ssip_tpu_torch::attention_qkv``, whose
CUDA implementations launch the kernels), so one trace serves both:
``ExportedModel.load`` moves it to the device it is asked for
(``torch.export.passes.move_to_device_pass``). Loading needs torch, numpy
and the port's operator modules, not its model code. Write and read an
artifact with the same torch version.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)

MANIFEST_VERSION = "ssip_tpu_torch/torch.export/1"
DEFAULT_PLATFORMS = ("cpu", "cuda")  # every platform the port exports for
ARTIFACT_SUFFIX = ".ssip.npz"
PROGRAM_KEY = "__torch_export__"
JAX_PROGRAM_KEY = "__stablehlo__"
_TRACE_BATCH = 2  # the example batch; 1 would be specialized


def check_platforms(platforms: Sequence[str]) -> tuple:
    """The platforms an artifact is for; ``tpu`` (the JAX package's) and
    any other name raise."""
    out = tuple(p.strip() for p in platforms if p.strip())
    bad = [p for p in out if p not in DEFAULT_PLATFORMS]
    if bad or not out:
        raise ValueError(
            f"--platforms {','.join(out)}: the PyTorch port (ssip_tpu_torch) exports for "
            f"{' and '.join(DEFAULT_PLATFORMS)}; a TPU artifact comes from the JAX package's src.export_model"
        )
    return out


class ServingForward(nn.Module):
    """uint8 [b, S, S, 3] → eval preprocess in ``dtype`` → ``model`` →
    float32 softmax [b, classes]."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        from ssip_tpu_torch.ops.augment import eval_preprocess

        logits = self.model(eval_preprocess(images_u8, dtype=self.dtype))
        return torch.softmax(logits.to(torch.float32), dim=1)


def build_serving_fn(arch: str, num_classes: int, compute_dtype: str, state: Mapping[str, Any],
                     image_size: int = 224, device: torch.device | str = "cpu") -> nn.Module:
    """The serving forward of a classifier checkpoint (``state``): the math
    of ``ScreeningPredictor``'s per-batch step, in eval mode on ``device``."""
    from ssip_tpu_torch.runtime.device import compute_dtype as dtype_of
    from ssip_tpu_torch.serving import build_classifier

    model = build_classifier(state, arch, num_classes, image_size, compute_dtype, torch.device(device))
    return ServingForward(model, dtype_of(compute_dtype)).eval()


class _Int8Classifier(nn.Module):
    """The int8 backbone (``models/quantized.py``, quantizing its own input)
    and the float32 ``fc`` head."""

    def __init__(self, arch: str, bundle: Mapping[str, Any]):
        super().__init__()
        from ssip_tpu_torch.models.port import quantized_resnet_from_tree

        tree = {"stem": bundle["stem"], "blocks": [bundle["blocks"][k] for k in sorted(bundle["blocks"])]}
        self.backbone = quantized_resnet_from_tree(tree, arch)
        self.register_buffer("fc_kernel", torch.from_numpy(np.array(bundle["fc"]["kernel"], np.float32)))
        self.register_buffer("fc_bias", torch.from_numpy(np.array(bundle["fc"]["bias"], np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x) @ self.fc_kernel + self.fc_bias


def _refuse_non_resnet(arch: str) -> None:
    from ssip_tpu_torch.models.resnet import MODEL_STAGES

    if arch not in MODEL_STAGES:
        raise ValueError(
            f"int8 export covers the ResNet family only, got --arch {arch}; "
            "export the ViT archs with --compute-dtype bfloat16"
        )


def build_serving_fn_int8(arch: str, bundle: Mapping[str, Any], device: torch.device | str = "cpu") -> nn.Module:
    """int8-PTQ serving forward: the quantized backbone (``stem_prequantized``
    off: the preprocess-quantize fusion is an extraction detail, not part of
    the portable artifact) + the float32 ``fc`` head + softmax. ``bundle``
    is ``quantized_serving_bundle``'s tree."""
    _refuse_non_resnet(arch)
    return ServingForward(_Int8Classifier(arch, bundle), torch.float32).to(device).eval()


def quantized_serving_bundle(state: Mapping[str, Any], calibration_u8, arch: str,
                             device: torch.device | str = "cpu") -> Dict[str, Any]:
    """A classifier checkpoint and uint8 eval-resized calibration images →
    the int8 bundle (numpy, the JAX layout: ``stem``, ``blocks`` as a sorted
    dict ``block00``…, ``fc`` with ``kernel`` [in, out] and ``bias``); the
    calibration forward runs on ``device``."""
    from ssip_tpu_torch.models.quantized import quantize_extractor
    from ssip_tpu_torch.models.resnet import MODEL_STAGES
    from ssip_tpu_torch.ops.augment import eval_preprocess

    _refuse_non_resnet(arch)
    if "fc.weight" not in state:
        raise ValueError("int8 export needs a classifier checkpoint (no 'fc' head found)")
    from ssip_tpu_torch.serving import as_uint8_tensor

    calib = eval_preprocess(as_uint8_tensor(calibration_u8).to(device), dtype=torch.float32)
    qtree = quantize_extractor(state, calib, MODEL_STAGES[arch], bottleneck=arch == "resnet50")
    return {
        "stem": qtree["stem"],
        "blocks": {f"block{i:02d}": blk for i, blk in enumerate(qtree["blocks"])},
        "fc": {
            "kernel": np.ascontiguousarray(np.asarray(state["fc.weight"].cpu(), np.float32).T),
            "bias": np.asarray(state["fc.bias"].cpu(), np.float32),
        },
    }


def export_serving_artifact(
    state: Mapping[str, Any],
    out_path: Path | str,
    *,
    arch: str = "resnet18",
    num_classes: int = 2,
    image_size: int = 224,
    compute_dtype: str = "float32",
    platforms: Sequence[str] = DEFAULT_PLATFORMS,
    threshold: float = 0.5,
    positive_class: str = "cancer",
    pos_index: int = 0,
    classes: Optional[List[str]] = None,
    calibration_u8=None,
    device: torch.device | str = "cpu",
) -> Path:
    """Export the classifier ``state`` as a self-contained serving artifact,
    traced on ``device``; returns the written path. ``compute_dtype="int8"``
    exports the PTQ throughput mode and needs ``calibration_u8``."""
    platforms = check_platforms(platforms)
    device = torch.device(device)
    calibration_images = 0
    if compute_dtype == "int8":
        if calibration_u8 is None:
            raise ValueError("int8 export requires calibration images")
        bundle = quantized_serving_bundle(state, calibration_u8, arch, device)
        program = build_serving_fn_int8(arch, bundle, device)
        calibration_images = int(np.shape(calibration_u8)[0])
    else:
        program = build_serving_fn(arch, num_classes, compute_dtype, state, image_size, device)

    example = torch.zeros((_TRACE_BATCH, image_size, image_size, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        exported = torch.export.export(
            program, (example,), dynamic_shapes={"images_u8": {0: torch.export.Dim("b", min=1)}}
        )
    blob = io.BytesIO()
    torch.export.save(exported, blob)

    manifest = {
        "version": MANIFEST_VERSION,
        "arch": arch,
        "num_classes": int(num_classes),
        "image_size": int(image_size),
        "compute_dtype": compute_dtype,
        "platforms": list(platforms),
        "threshold": float(threshold),
        "positive_class": positive_class,
        "pos_index": int(pos_index),
        "classes": classes,
        "torch_version": torch.__version__,
        "traced_on": device.type,
        "input": f"uint8 [b, {image_size}, {image_size}, 3], eval-resized",
        "output": f"float32 softmax probabilities [b, {num_classes}]",
        "calibration_images": calibration_images,
    }
    payload = {
        "__manifest__": np.frombuffer(json.dumps(manifest).encode("utf-8"), dtype=np.uint8),
        PROGRAM_KEY: np.frombuffer(blob.getvalue(), dtype=np.uint8),
    }
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    # np.savez appends '.npz' when absent; a buffer keeps the path exact
    buf = io.BytesIO()
    np.savez(buf, **payload)
    out_path.write_bytes(buf.getvalue())
    return out_path


class ExportedModel:
    """A loaded serving artifact: the program on its device and the manifest.

    Batch sizes are bucketed to powers of two up to ``max_batch`` (padding
    repeats the last row), so a server sees a bounded set of shapes although
    the program takes any batch.
    """

    def __init__(self, program, manifest: dict, device: torch.device, max_batch: int = 256) -> None:
        self._call = program
        self.manifest = dict(manifest)
        self.device = device
        self.max_batch = int(max_batch)
        self.image_size = int(manifest["image_size"])
        self.threshold = float(manifest["threshold"])
        self.positive_class = str(manifest["positive_class"])
        self.pos_index = int(manifest["pos_index"])

    @classmethod
    def load(cls, path: Path | str, max_batch: int = 256, device: str = "auto") -> "ExportedModel":
        # the program's custom operators must be registered before it loads
        import ssip_tpu_torch.ops.attention  # noqa: F401
        import ssip_tpu_torch.ops.layernorm  # noqa: F401
        from ssip_tpu_torch.runtime.device import resolve_device

        with np.load(Path(path)) as z:
            manifest = json.loads(bytes(z["__manifest__"]).decode("utf-8"))
            if JAX_PROGRAM_KEY in z.files or PROGRAM_KEY not in z.files:
                raise ValueError(
                    f"{path} is not an ssip_tpu_torch artifact: it holds a JAX package program "
                    f"({JAX_PROGRAM_KEY}, manifest version {manifest.get('version')!r}); load it with "
                    "ssip_tpu.deploy.export.ExportedModel, or export the run with "
                    "python -m ssip_tpu_torch.cli.export_model"
                )
            if manifest.get("version") != MANIFEST_VERSION:
                raise ValueError(
                    f"Unsupported serving-artifact version {manifest.get('version')!r} "
                    f"(supported: {MANIFEST_VERSION})"
                )
            blob = bytes(z[PROGRAM_KEY])
        dev = resolve_device(device)
        if dev.type not in manifest["platforms"]:
            raise ValueError(f"{path} was exported for {manifest['platforms']}, not for {dev.type}")
        if manifest.get("torch_version") != torch.__version__:
            LOGGER.warning("%s was written by torch %s, read by %s", path, manifest.get("torch_version"),
                           torch.__version__)
        exported = torch.export.load(io.BytesIO(blob))
        if dev.type != manifest.get("traced_on"):
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, dev)
        return cls(exported.module(), manifest, dev, max_batch=max_batch)

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        return b

    def predict_probs(self, images_u8) -> np.ndarray:
        """uint8 [N, S, S, 3] → float32 probabilities [N, num_classes]."""
        from ssip_tpu_torch.serving import as_uint8_tensor

        images = as_uint8_tensor(images_u8)
        n = int(images.shape[0])
        if n == 0:
            return np.empty((0, int(self.manifest["num_classes"])), np.float32)
        s = self.image_size
        if tuple(images.shape[1:]) != (s, s, 3):
            raise ValueError(
                f"Expected eval-resized input [N, {s}, {s}, 3], got "
                f"{tuple(images.shape)} — resize upstream (see predict_paths)"
            )
        images = images.to(self.device)
        out = []
        with torch.inference_mode():
            for start in range(0, n, self.max_batch):
                chunk = images[start : start + self.max_batch]
                idx = torch.clamp(torch.arange(self._bucket(len(chunk)), device=self.device), max=len(chunk) - 1)
                out.append(self._call(chunk[idx])[: len(chunk)])
        return torch.cat(out).cpu().numpy()

    def predict_images(self, images_u8, paths=None):
        from ssip_tpu_torch.serving import PredictionResult

        probs = self.predict_probs(images_u8)
        pos = probs[:, self.pos_index]
        return PredictionResult(
            paths=[str(p) for p in (paths if paths is not None else range(len(pos)))],
            prob_positive=pos,
            flagged=pos >= self.threshold,
            threshold=self.threshold,
            positive_class=self.positive_class,
        )

    def predict_paths(self, paths: Sequence[Path], num_threads: int = 4):
        """Decode → eval-resize → predict, the predictor's chain; returns
        (result, failed paths)."""
        from ssip_tpu_torch.serving import decode_and_resize

        kept, resized, failures = decode_and_resize(paths, self.image_size, self.device, num_threads)
        if not kept:
            raise RuntimeError("No decodable images to predict")
        return self.predict_images(resized, paths=kept), failures
