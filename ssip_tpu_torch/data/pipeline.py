"""Decode-once image store and the double-buffered host→device feed.

Counterpart of ``ssip_tpu/data/pipeline.py:29-183`` (``ImageStore``: the
majority shape packed into one uint8 array, odd shapes kept aside, decode
failures listed, the same ``raw_<key>.u8.npy`` + ``.meta.json`` cache) and
``:340-401`` (``iter_device_batches``) and ``:192-339``
(``iter_streamed_decode_batches``).

The feed on a CUDA device: a background thread makes each batch on the host
(``iter_device_batches`` gathers it from the store and zero-pads it;
``iter_streamed_decode_batches`` decodes it on a thread pool, so host memory
stays O(prefetch × batch) whatever the corpus size); the consumer copies it
into one of ``_DEPTH`` pinned buffers and from there to the card with
``non_blocking=True`` on a side stream, so the decode of batch i+2, the copy
of batch i+1 and the compute of batch i overlap. A pinned buffer is reused
only after the event of its previous copy has completed, and each device
batch is handed to the caller's stream through an event wait plus
``record_stream``.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import Counter, deque
from pathlib import Path
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ssip_tpu_torch.data.decode import decode_batch
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)

# Double buffer: the pinned slots, the host queue and the copies in flight.
_DEPTH = 2


class ImageStore:
    """Packed uint8 [N, H, W, 3] store with an odd-size fallback list."""

    def __init__(
        self,
        packed: np.ndarray,
        packed_index: np.ndarray,
        extras: dict[int, np.ndarray],
        failures: List[Path],
        paths: List[Path],
    ) -> None:
        self.packed = packed
        self._packed_index = packed_index  # row in `packed` per dataset index, -1 if extra/failed
        self._extras = extras
        self.failures = failures
        self.paths = paths

    @classmethod
    def from_array(cls, images: np.ndarray, paths: Sequence[Path]) -> "ImageStore":
        """An in-memory store over already-decoded uint8 [N, H, W, 3] images."""
        return cls(images, np.arange(len(images)), {}, [], [Path(p) for p in paths])

    @classmethod
    def from_paths(
        cls,
        paths: Sequence[Path],
        num_threads: int,
        convert_rgb: bool = False,
        cache_dir: Optional[Path] = None,
        cache_key: Optional[str] = None,
    ) -> "ImageStore":
        paths = [Path(p) for p in paths]
        if cache_dir is not None and cache_key is not None:
            cached = cls._load_cache(cache_dir, cache_key, paths)
            if cached is not None:
                return cached

        arrays, failures = decode_batch(paths, convert_rgb=convert_rgb, num_threads=num_threads)
        shapes = [a.shape for a in arrays if a is not None]
        if not shapes:
            raise RuntimeError("All images failed to decode")
        major_shape = Counter(shapes).most_common(1)[0][0]
        n_major = sum(1 for s in shapes if s == major_shape)
        packed = np.empty((n_major, *major_shape), dtype=np.uint8)
        packed_index = np.full(len(paths), -1, dtype=np.int64)
        extras: dict[int, np.ndarray] = {}
        row = 0
        for i, arr in enumerate(arrays):
            if arr is None:
                continue
            if arr.shape == major_shape:
                packed[row] = arr
                packed_index[i] = row
                row += 1
            else:
                extras[i] = arr
        store = cls(packed, packed_index, extras, failures, paths)
        if cache_dir is not None and cache_key is not None and not extras and not failures:
            store._save_cache(cache_dir, cache_key)
        return store

    # -- cache (same files and format as the JAX package) -----------------
    @staticmethod
    def _cache_paths(cache_dir: Path, key: str) -> tuple[Path, Path]:
        return cache_dir / f"raw_{key}.u8.npy", cache_dir / f"raw_{key}.meta.json"

    def _save_cache(self, cache_dir: Path, key: str) -> None:
        cache_dir.mkdir(parents=True, exist_ok=True)
        data_path, meta_path = self._cache_paths(cache_dir, key)
        np.save(data_path, self.packed)
        meta = {
            "paths": [str(p) for p in self.paths],
            "packed_index": self._packed_index.tolist(),
            "shape": list(self.packed.shape),
        }
        meta_path.write_text(json.dumps(meta))
        LOGGER.info("Cached decoded images to %s (%.1f MB)", data_path, self.packed.nbytes / 1e6)

    @classmethod
    def _load_cache(
        cls, cache_dir: Path, key: str, paths: List[Path]
    ) -> Optional["ImageStore"]:
        data_path, meta_path = cls._cache_paths(cache_dir, key)
        if not (data_path.exists() and meta_path.exists()):
            return None
        try:
            meta = json.loads(meta_path.read_text())
            if meta["paths"] != [str(p) for p in paths]:
                return None
            packed = np.load(data_path, mmap_mode="r")
        except (OSError, ValueError, KeyError) as exc:  # corrupt cache tolerated
            LOGGER.warning("Ignoring unreadable cache %s: %s", data_path, exc)
            return None
        LOGGER.info("Loaded decoded-image cache %s", data_path)
        return cls(packed, np.asarray(meta["packed_index"]), {}, [], paths)

    # -- access -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.paths)

    @property
    def image_shape(self) -> tuple[int, ...]:
        return tuple(self.packed.shape[1:])

    def valid_indices(self) -> np.ndarray:
        """Dataset indices that decoded successfully."""
        ok = self._packed_index >= 0
        for i in self._extras:
            ok[i] = True
        return np.nonzero(ok)[0]

    def get(self, index: int) -> np.ndarray:
        row = self._packed_index[index]
        if row >= 0:
            return self.packed[row]
        if index in self._extras:
            return self._extras[index]
        raise KeyError(f"Image {index} ({self.paths[index]}) failed to decode")

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        """[len(indices), H, W, 3]; odd-size extras are PIL-resized to the
        majority shape. A full in-order gather of a fully packed store
        returns the packed array itself (possibly a disk memmap)."""
        indices_arr = np.asarray(indices)
        if (
            not self._extras
            and len(indices_arr) == len(self.paths)
            and np.array_equal(self._packed_index[indices_arr], np.arange(len(self.paths)))
        ):
            return self.packed

        h, w, c = self.image_shape
        out = np.empty((len(indices_arr), h, w, c), dtype=np.uint8)
        rows = self._packed_index[indices_arr]
        packed_mask = rows >= 0
        out[packed_mask] = self.packed[rows[packed_mask]]
        for pos in np.nonzero(~packed_mask)[0]:
            arr = self.get(int(indices_arr[pos]))
            if arr.shape != (h, w, c):
                from PIL import Image

                arr = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
                if arr.ndim == 2:
                    arr = np.stack([arr] * 3, axis=-1)
            out[pos] = arr
        return out


class Batch(NamedTuple):
    data: torch.Tensor  # [batch, H, W, 3] uint8 on the target device, zero-padded
    indices: np.ndarray  # dataset indices of the valid rows
    valid: int  # number of valid rows (the rest is padding)


def _background(
    make: Callable[[Callable[[], bool]], Iterator[tuple[np.ndarray, np.ndarray, int]]], depth: int, name: str
) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """The host batches of ``make(stopped)``, made on a background thread at
    most ``depth`` ahead of the consumer; ``stopped()`` turns true once the
    consumer has gone."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def stage() -> None:
        try:
            for item in make(stop.is_set):
                if stop.is_set():
                    return
                q.put(item)
            q.put(None)
        except BaseException as exc:  # handed to the consumer, which raises it
            q.put(exc)

    thread = threading.Thread(target=stage, daemon=True, name=name)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # drain so the stager can exit
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(timeout=0.05)
        thread.join(timeout=5)


def _host_batches(
    store: ImageStore, indices: np.ndarray, batch_size: int
) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Gather + pad on a background thread, ``_DEPTH`` batches ahead."""
    num_batches = (len(indices) + batch_size - 1) // batch_size

    def make(stopped: Callable[[], bool]) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        for bi in range(num_batches):
            if stopped():
                return
            batch_idx = indices[bi * batch_size : (bi + 1) * batch_size]
            arr = store.gather(batch_idx)
            valid = len(batch_idx)
            if valid < batch_size:
                pad = np.zeros((batch_size - valid, *arr.shape[1:]), arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
            yield np.ascontiguousarray(arr), batch_idx, valid

    return _background(make, _DEPTH, "ssip-feeder")


def iter_device_batches(
    store: ImageStore,
    indices: Sequence[int],
    batch_size: int,
    device: torch.device,
) -> Iterator[Batch]:
    """Fixed-shape uint8 batches on ``device``; the last one zero-padded."""
    indices = np.asarray(indices)
    if len(indices) == 0:
        return
    yield from _to_device(_host_batches(store, indices, batch_size), device)


def iter_streamed_decode_batches(
    paths: Sequence[Path],
    batch_size: int,
    image_shape: tuple[int, int, int],
    device: torch.device,
    num_threads: int,
    convert_rgb: bool = False,
    fast_scale: Optional[int] = None,
    host_resize: Optional[int] = None,
    host_crop: Optional[int] = None,
    prefetch: int = 2,
    failures: Optional[List[Path]] = None,
) -> Iterator[Batch]:
    """The constant-host-memory stream: decode ∥ copy ∥ compute.

    Each batch of ``paths`` is decoded on a pool of ``num_threads`` in a
    background thread (``decode_batch``, with ``fast_scale``,
    ``host_resize`` and ``host_crop``), at most ``prefetch`` batches ahead,
    then copied to ``device``. Rows that fail to decode are dropped (and
    appended to ``failures``); rows of another shape than ``image_shape``
    are PIL-resized to it, as ``ImageStore.gather`` does. The valid rows
    are compacted to the front of each fixed-shape, zero-padded batch and
    ``Batch.indices`` names them; a batch with no valid row is skipped.
    """
    paths = [Path(p) for p in paths]
    if not paths:
        return
    h, w, c = image_shape
    num_batches = (len(paths) + batch_size - 1) // batch_size

    def make(stopped: Callable[[], bool]) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        from PIL import Image

        for bi in range(num_batches):
            if stopped():
                return
            lo = bi * batch_size
            arrays, failed = decode_batch(
                paths[lo : lo + batch_size], num_threads=num_threads, convert_rgb=convert_rgb,
                fast_scale=fast_scale, host_resize=host_resize, host_crop=host_crop,
            )
            if failed and failures is not None:
                failures.extend(failed)
            out = np.zeros((batch_size, h, w, c), dtype=np.uint8)
            kept: list[int] = []
            for j, arr in enumerate(arrays):
                if arr is None:
                    continue
                if arr.shape != (h, w, c):
                    arr = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
                out[len(kept)] = arr
                kept.append(lo + j)
            if kept:
                yield out, np.asarray(kept, dtype=np.int64), len(kept)

    yield from _to_device(_background(make, prefetch, "ssip-decode"), device)


def _to_device(host: Iterator[tuple[np.ndarray, np.ndarray, int]], device: torch.device) -> Iterator[Batch]:
    """Host batches → batches on ``device``; on a card through ``_DEPTH``
    pinned buffers and a side stream, one copy in flight ahead of the one
    the caller computes on."""
    if device.type != "cuda":
        for arr, idx, valid in host:
            yield Batch(torch.from_numpy(arr).to(device), idx, valid)
        return

    copy_stream = torch.cuda.Stream(device)
    pinned: list[Optional[torch.Tensor]] = [None] * _DEPTH
    copied: list[Optional[torch.cuda.Event]] = [None] * _DEPTH
    inflight: deque = deque()

    def hand_over(item: tuple) -> Batch:
        dev, idx, valid, event = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        dev.record_stream(consumer)
        return Batch(dev, idx, valid)

    for i, (arr, idx, valid) in enumerate(host):
        slot = i % _DEPTH
        if pinned[slot] is None:
            pinned[slot] = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
        else:
            copied[slot].synchronize()  # the slot's previous copy has landed
        pinned[slot].copy_(torch.from_numpy(arr))
        with torch.cuda.stream(copy_stream):
            dev = torch.empty(arr.shape, dtype=torch.uint8, device=device)
            dev.copy_(pinned[slot], non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        copied[slot] = event
        inflight.append((dev, idx, valid, event))
        if len(inflight) == _DEPTH:  # batch i+1 is in flight while i runs
            yield hand_over(inflight.popleft())
    while inflight:
        yield hand_over(inflight.popleft())
