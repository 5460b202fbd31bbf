"""Production inference: the screening predictor of a trained run.

Counterpart of ``ssip_tpu/serving.py``: ``PredictionResult``,
``ServingBundle``, ``load_serving_bundle`` and ``ScreeningPredictor``. A
pipeline run's checkpoint and calibrated operating point are loaded once;
then batches of eval-resized uint8 images go through eval preprocess →
``model`` in eval mode → float32 softmax, thresholded at the operating point.

- The checkpoint is the run's ``.pt`` (``train/checkpoints.py``), the file
  both packages read.
- ``ScreeningPredictor`` pads the images to whole batches by repeating the
  last row (``:239-241`` there) and runs one batch at a time on its device
  (the card unless the caller asks for the CPU).
- ``predict_paths`` decodes (RGB), resizes through ``train/data.py:
  resize_on_device`` (the training chain's ``Resize((S, S))``) and predicts.

Usage (library):

    predictor = ScreeningPredictor.from_artifacts("outputs", model="semi")
    result = predictor.predict_paths(list_of_jpegs)
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.ops.augment import eval_preprocess
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from ssip_tpu_torch.runtime.device import compute_dtype as dtype_of
from ssip_tpu_torch.runtime.device import configure_precision, resolve_device
from ssip_tpu_torch.runtime.logging import get_logger
from ssip_tpu_torch.train.checkpoints import load_checkpoint

LOGGER = get_logger(__name__)


@dataclass
class PredictionResult:
    paths: List[str]
    prob_positive: np.ndarray
    flagged: np.ndarray
    threshold: float
    positive_class: str


@dataclass
class ServingBundle:
    """A pipeline run's checkpoint and calibrated operating point, resolved:
    what the in-process predictor and the export serve. ``state`` is the
    classifier's state_dict (float32 CPU tensors, torchvision names)."""

    state: Dict[str, torch.Tensor]
    threshold: float
    positive_class: str
    pos_index: int
    classes: Optional[List[str]]
    arch: str
    num_classes: int
    checkpoint_path: Path
    image_size: int = 224


def load_serving_bundle(
    output_dir: Path | str = "outputs",
    model: str = "semi",
    image_size: int = 224,
) -> ServingBundle:
    """Load the checkpoint and ``operating_point.json`` of a pipeline run.

    The head size comes from the operating point's class list; without an
    operating point, ``training_history.json`` gives the arch and the
    training resolution.
    """
    reg = ArtifactRegistry(Path(output_dir))
    ckpt = reg.semi_checkpoint if model == "semi" else reg.baseline_checkpoint

    threshold, positive_class = 0.5, "cancer"
    classes = None
    arch = "resnet18"
    op_path = reg.operating_point_json
    if op_path.exists():
        op = json.loads(op_path.read_text())
        if op.get("threshold") is not None:
            threshold = float(op["threshold"])
        positive_class = op.get("positive_class", positive_class)
        classes = op.get("classes")
        arch = str(op.get("arch", arch))
        # serving resizes to the training resolution: a ViT's position
        # embedding is shaped by it, and any other grid moves the
        # probabilities off the calibrated threshold
        image_size = int(op.get("image_size", image_size))
    else:
        LOGGER.warning("No operating_point.json under %s — defaulting threshold 0.5", output_dir)
        hist_path = reg.training_history_json
        if hist_path.exists():
            hist = json.loads(hist_path.read_text())
            arch = str(hist.get("arch", arch))
            image_size = int(hist.get("image_size", image_size))

    num_classes = len(classes) if classes else 2
    template = build_model(arch, num_classes=num_classes, image_size=image_size)
    try:
        load_checkpoint(ckpt, template)
    except Exception as exc:
        raise RuntimeError(
            f"Failed to restore checkpoint {ckpt} against a "
            f"{num_classes}-class {arch} head (classes from "
            f"{op_path.name}: {classes}). If the checkpoint was trained "
            "with a different class count, regenerate "
            "operating_point.json or pass matching artifacts."
        ) from exc

    if classes and positive_class in classes:
        pos_index = classes.index(positive_class)
    else:
        # legacy operating points lack the class list: the default dataset's
        # sorted class directories (cancer=0, normal=1)
        LOGGER.warning(
            "operating_point.json has no class list — assuming sorted "
            "class dirs for pos_index of '%s'", positive_class,
        )
        pos_index = 0 if positive_class == "cancer" else 1
    return ServingBundle(
        state=template.state_dict(),
        threshold=float(threshold),
        positive_class=positive_class,
        pos_index=pos_index,
        classes=classes,
        arch=arch,
        num_classes=num_classes,
        checkpoint_path=ckpt,
        image_size=image_size,
    )


def build_classifier(state: Dict[str, Any], arch: str, num_classes: int, image_size: int,
                     compute_dtype: str, device: torch.device) -> torch.nn.Module:
    """The classifier of ``arch`` in ``compute_dtype`` with ``state``
    loaded, in eval mode on ``device`` (channels_last for a ResNet on the
    card, as extraction runs it)."""
    model = build_model(arch, num_classes=num_classes, compute_dtype=dtype_of(compute_dtype), image_size=image_size)
    model.load_state_dict(state, strict=False)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def as_uint8_tensor(images_u8) -> torch.Tensor:
    """A tensor as it is; a numpy array (a decoder's may be read-only) as a
    writable contiguous tensor."""
    if torch.is_tensor(images_u8):
        return images_u8
    return torch.from_numpy(np.require(images_u8, requirements=["C", "W"]))


class ScreeningPredictor:
    """A checkpoint and an operating point as a batch predictor."""

    def __init__(
        self,
        state: Dict[str, Any],
        threshold: float,
        positive_class: str,
        pos_index: int,
        image_size: int = 224,
        batch_size: int = 64,
        compute_dtype: str = "float32",
        num_classes: int = 2,
        arch: str = "resnet18",
        device: str = "auto",
    ) -> None:
        self.threshold = float(threshold)
        self.positive_class = positive_class
        self.pos_index = int(pos_index)
        self.image_size = image_size
        self.batch_size = batch_size
        self.arch = arch
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self._dtype = dtype_of(compute_dtype)
        configure_precision(compute_dtype)
        self._model = build_classifier(state, arch, num_classes, image_size, compute_dtype, self.device)

    @classmethod
    def from_artifacts(
        cls,
        output_dir: Path | str = "outputs",
        model: str = "semi",
        batch_size: int = 64,
        image_size: int = 224,
        compute_dtype: str = "float32",
        device: str = "auto",
    ) -> "ScreeningPredictor":
        """Load the checkpoint and operating point of a pipeline run."""
        bundle = load_serving_bundle(output_dir, model=model, image_size=image_size)
        LOGGER.info(
            "Predictor ready: %s checkpoint, threshold %.4f on '%s'",
            model, bundle.threshold, bundle.positive_class,
        )
        return cls(
            bundle.state, bundle.threshold, bundle.positive_class, bundle.pos_index,
            image_size=bundle.image_size, batch_size=batch_size, compute_dtype=compute_dtype,
            num_classes=bundle.num_classes, arch=bundle.arch, device=device,
        )

    def predict_probs(self, images_u8: np.ndarray | torch.Tensor) -> np.ndarray:
        """uint8 [N, S, S, 3] eval-resized (any N) → float32 softmax
        probabilities [N, classes]."""
        images = as_uint8_tensor(images_u8)
        n = int(images.shape[0])
        if n == 0:
            return np.empty((0, self.num_classes), np.float32)
        steps = max(1, -(-n // self.batch_size))
        idx = torch.clamp(torch.arange(steps * self.batch_size), max=n - 1).to(images.device)
        staged = images[idx].to(self.device)
        out = []
        with torch.inference_mode():
            for lo in range(0, steps * self.batch_size, self.batch_size):
                logits = self._model(eval_preprocess(staged[lo : lo + self.batch_size], dtype=self._dtype))
                out.append(torch.softmax(logits.to(torch.float32), dim=1))
        return torch.cat(out).cpu().numpy()[:n]

    def predict_images(self, images_u8: np.ndarray | torch.Tensor, paths: Optional[Sequence] = None) -> PredictionResult:
        """images_u8: [N, S, S, 3] eval-resized uint8 (any N; padded inside)."""
        pos_probs = self.predict_probs(images_u8)[:, self.pos_index]
        return PredictionResult(
            paths=[str(p) for p in (paths or range(len(pos_probs)))],
            prob_positive=pos_probs,
            flagged=pos_probs >= self.threshold,
            threshold=self.threshold,
            positive_class=self.positive_class,
        )

    def predict_paths(self, paths: Sequence[Path], num_threads: int = 4) -> PredictionResult:
        """Decode → eval-resize → predict, end to end."""
        kept, resized, failures = decode_and_resize(paths, self.image_size, self.device, num_threads)
        if failures:
            LOGGER.warning("Skipping %d undecodable images", len(failures))
        if not kept:
            raise RuntimeError("No decodable images to predict")
        return self.predict_images(resized, paths=kept)


def decode_and_resize(paths: Sequence[Path], image_size: int, device: torch.device, num_threads: int = 4):
    """(kept paths, uint8 [N, S, S, 3] on ``device``, failed paths): RGB
    decode on the host, then the training resize on ``device``."""
    from ssip_tpu_torch.data.decode import decode_batch
    from ssip_tpu_torch.train.data import resize_on_device

    arrays, failures = decode_batch([Path(p) for p in paths], convert_rgb=True, num_threads=num_threads)
    kept = [(p, a) for p, a in zip(paths, arrays) if a is not None]
    if not kept:
        return [], None, [str(p) for p in failures]
    resized = resize_on_device([a for _, a in kept], image_size, device)
    return [p for p, _ in kept], resized, [str(p) for p in failures]
