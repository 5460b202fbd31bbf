"""Host image decode: PIL, or the native libjpeg decoder, on a thread pool.

Counterpart of ``ssip_tpu/data/decode.py:30-57`` (``decode_image``,
``try_decode_image``), ``:69-108`` (``preprocess_host_exact``) and
``:109-168`` (``decode_batch``). The channel policy is the same: no RGB
conversion unless asked, grayscale stacked to 3 channels.

``decode_batch`` decodes with PIL, bit for bit what the native decoder
gives for a JPEG, unless it is given ``fast_scale`` (DCT-domain scaled
decode, approximate) or ``host_resize`` and ``host_crop`` (the exact
short-side resize and center crop inside the decode worker): those run the
native library of ``ssip_tpu_torch/native/``, built at first use, and raise
where it cannot be built. As in the JAX package with its library built, a
file the library declines (not a JPEG) is decoded by PIL (with ``draft``
for ``fast_scale``), and a shape the library's resize does not take by PIL's
resize. PIL is imported inside the functions, so the rest of the port runs
on a machine without it.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

LOGGER = logging.getLogger(__name__)


def decode_image(path: Path, convert_rgb: bool = False, fast_scale: Optional[int] = None) -> np.ndarray:
    """Decode one image to uint8 [H, W, C]; ``fast_scale``: the short side
    to decode towards in draft mode (DCT-domain scaling), None for a full
    decode."""
    from PIL import Image

    with Image.open(path) as img:
        if fast_scale is not None:
            img.draft("RGB", (fast_scale, fast_scale))
        if convert_rgb and img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img)
    if arr.ndim == 2:  # grayscale without conversion: replicate for the model
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def try_decode_image(path: Path, convert_rgb: bool = False, fast_scale: Optional[int] = None) -> Optional[np.ndarray]:
    """``decode_image`` that logs and returns None on any decode failure."""
    try:
        return decode_image(path, convert_rgb=convert_rgb, fast_scale=fast_scale)
    except Exception as exc:  # noqa: BLE001 — any decode failure is tolerated
        LOGGER.warning("Failed to decode %s: %s", path, exc)
        return None


def preprocess_host_exact(arr: np.ndarray, resize: int, crop: int) -> np.ndarray:
    """The extraction chain's resize and crop on the host, uint8 in and out:
    short side to ``resize`` with PIL's bilinear filter (long side
    int-truncated, torchvision's rule), then the center crop. The same chain
    the device computes (``ops/resize.py``)."""
    if crop > resize:
        raise ValueError(
            f"crop ({crop}) must be <= resize ({resize}) for the exact "
            "host preprocessing chain"
        )
    from PIL import Image

    from ssip_tpu_torch.ops.resize import resize_target

    h0, w0 = arr.shape[:2]
    th, tw = resize_target(h0, w0, resize)
    if (h0, w0) != (th, tw):
        arr = np.asarray(Image.fromarray(arr).resize((tw, th), Image.BILINEAR))
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
    # torchvision CenterCrop offset: round((size - crop) / 2)
    top = int(round((arr.shape[0] - crop) / 2.0))
    left = int(round((arr.shape[1] - crop) / 2.0))
    return arr[top : top + crop, left : left + crop]


def decode_batch(
    paths: Sequence[Path],
    num_threads: int,
    convert_rgb: bool = False,
    fast_scale: Optional[int] = None,
    host_resize: Optional[int] = None,
    host_crop: Optional[int] = None,
) -> Tuple[List[Optional[np.ndarray]], List[Path]]:
    """(arrays with None for failures, failed paths), threads capped at the
    core count. ``host_resize`` and ``host_crop`` together: each array is
    the exact resize and crop of its image, [host_crop, host_crop, 3]."""
    num_threads = max(1, min(num_threads, os.cpu_count() or 1))
    preprocess = host_resize is not None and host_crop is not None
    if preprocess or fast_scale is not None:
        from ssip_tpu_torch.native import decoder as native

        native.load()  # raises, naming what is missing, where it cannot be built

        def work(p: Path) -> Optional[np.ndarray]:
            arr = native.decode_one(p, fast_scale)
            if arr is None:
                arr = try_decode_image(p, convert_rgb, fast_scale)
            if arr is None or not preprocess:
                return arr
            try:
                if host_crop > host_resize:
                    raise ValueError(f"crop ({host_crop}) must be <= resize ({host_resize})")
                out = native.resize_crop(arr, host_resize, host_crop)
                return out if out is not None else preprocess_host_exact(arr, host_resize, host_crop)
            except Exception as exc:  # noqa: BLE001 — tolerated like a decode failure
                LOGGER.warning("Failed to preprocess %s: %s", p, exc)
                return None
    else:

        def work(p: Path) -> Optional[np.ndarray]:
            return try_decode_image(p, convert_rgb)

    if num_threads <= 1 or len(paths) <= 1:
        arrays = [work(p) for p in paths]
    else:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            arrays = list(pool.map(work, paths))
    failures = [p for p, a in zip(paths, arrays) if a is None]
    return arrays, failures
