"""Training-side dataset assembly: device-resident resized images.

Counterpart of ``ssip_tpu/train/data.py:30-84`` and ``:114-116``. The
deterministic prefix of the reference's train transform (decode → RGB →
``Resize((S, S))``) runs once: decode on the host, the resize on the device
in batches, leaving a uint8 [N, S, S, 3] tensor resident on the device. Per
step, the engine gathers a batch from it and augments it on the device.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ssip_tpu_torch.data.decode import decode_batch
from ssip_tpu_torch.data.discovery import labeled_folder
from ssip_tpu_torch.ops.resize import training_resize
from ssip_tpu_torch.train.engine import DeviceDataset

_RESIZE_BATCH = 256


def resize_on_device(arrays: List[np.ndarray], image_size: int, device: torch.device) -> torch.Tensor:
    """Decoded uint8 images of any sizes → uint8 [N, S, S, 3] on ``device``,
    in input order; images of one shape are resized together."""
    by_shape: dict[tuple, list[int]] = defaultdict(list)
    for i, arr in enumerate(arrays):
        by_shape[arr.shape].append(i)
    out = torch.empty((len(arrays), image_size, image_size, 3), dtype=torch.uint8, device=device)
    for idxs in by_shape.values():
        for start in range(0, len(idxs), _RESIZE_BATCH):
            chunk = idxs[start : start + _RESIZE_BATCH]
            stacked = torch.from_numpy(np.stack([arrays[i] for i in chunk])).to(device)
            out[torch.as_tensor(chunk, device=device)] = training_resize(stacked, image_size)
    return out


def load_labeled_dataset(
    strong_data_dir: Path, image_size: int, device: torch.device, num_threads: int = 4
) -> Tuple[torch.Tensor, np.ndarray, List[str], List[Path]]:
    """(resized uint8 images on ``device``, targets, classes, paths), in
    ImageFolder order. Images are converted to RGB, as the reference's
    training loader does; a decode failure is fatal (labeled data must be
    intact), as in ImageFolder."""
    paths, targets, classes = labeled_folder(strong_data_dir)
    arrays, failures = decode_batch(paths, num_threads=num_threads, convert_rgb=True)
    if failures:
        raise RuntimeError(f"Failed to decode labeled images: {failures}")
    return resize_on_device(arrays, image_size, device), np.asarray(targets), classes, paths


def subset(images: torch.Tensor, labels: np.ndarray, indices: np.ndarray) -> DeviceDataset:
    idx = np.asarray(indices)
    return DeviceDataset.create(images[torch.from_numpy(idx).to(images.device)], np.asarray(labels)[idx])
