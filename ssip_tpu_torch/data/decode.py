"""Host image decode with PIL, one thread pool per batch.

Counterpart of ``ssip_tpu/data/decode.py:30-57`` (``decode_image``,
``try_decode_image``) and ``:109-168`` (``decode_batch``, PIL branch). The
channel policy is the same: no RGB conversion unless asked, grayscale
stacked to 3 channels. PIL is imported inside the functions, so the rest
of the port runs on a machine without it; the native libjpeg decoder of
the JAX package is not used yet.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

LOGGER = logging.getLogger(__name__)


def decode_image(path: Path, convert_rgb: bool = False) -> np.ndarray:
    """Decode one image to uint8 [H, W, C]."""
    from PIL import Image

    with Image.open(path) as img:
        if convert_rgb and img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img)
    if arr.ndim == 2:  # grayscale without conversion: replicate for the model
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def try_decode_image(path: Path, convert_rgb: bool = False) -> Optional[np.ndarray]:
    """``decode_image`` that logs and returns None on any decode failure."""
    try:
        return decode_image(path, convert_rgb=convert_rgb)
    except Exception as exc:  # noqa: BLE001 — any decode failure is tolerated
        LOGGER.warning("Failed to decode %s: %s", path, exc)
        return None


def decode_batch(
    paths: Sequence[Path], num_threads: int, convert_rgb: bool = False
) -> Tuple[List[Optional[np.ndarray]], List[Path]]:
    """(arrays with None for failures, failed paths), threads capped at the
    core count."""
    num_threads = max(1, min(num_threads, os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        arrays = list(pool.map(lambda p: try_decode_image(p, convert_rgb), paths))
    failures = [p for p, a in zip(paths, arrays) if a is None]
    return arrays, failures
