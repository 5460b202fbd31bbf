"""Checkpoints: the torchvision-layout ``.pt`` state_dict, and resume snapshots.

Counterpart of ``ssip_tpu/train/checkpoints.py:30-49`` (``save_checkpoint``)
and ``:52-199`` (``save_train_snapshot``, ``load_train_snapshot``,
``restore_resume_state``).

The reference persists best-val-loss state_dicts at
``outputs/models/baseline_resnet18.pt`` (reference common.py:418-424); the
port's modules already carry torchvision's names (a ViT's
``encoder.layers.encoder_layer_0.…`` and ``heads.head`` included; an MoE
ViT's expert leaves are the port's own, ``models/port.py``), so
``save_checkpoint`` writes ``model.state_dict()`` as it is. The JAX package
also writes a Flax ``.msgpack`` beside it; that needs flax, so the port does
not write it, and the JAX package's ``load_checkpoint`` (``:141-152``) ports
the ``.pt`` when no ``.msgpack`` is there.

A resume snapshot (``--resume``) is one file, committed by an atomic rename
(a temporary name, then ``os.replace``): a kill at any instant leaves the
previous complete snapshot or the new one. It holds the whole train state
(the model's ``state_dict`` with any BatchNorm statistics, AdamW's
``state_dict`` with its moments, step counts and the learning rate the
plateau rule lowered, and the step) and the epoch driver's dict, with the
JAX package's keys and meanings: ``epoch``, ``history``, ``best_val_loss``,
``early_patience``, ``plateau_best``, ``plateau_bad``, ``finished``. No
random state is saved: the port's epoch plans and augmentation draws are
pure functions of (seed, stream, epoch, step) (``runtime/prng.py``).

The format is the port's own, because flax's msgpack needs flax: the magic
``SSIPTORCHSNAP1``, the driver JSON's length (8 bytes, big endian), the
driver JSON, then ``torch.save`` of the state. Neither package misreads the
other's snapshot: the JAX loader finds no magic of its own and no legacy
``.driver.json`` beside it and calls it unreadable, and so does this one of a
JAX snapshot.

``SSIP_SNAPSHOT_FORMAT=orbax`` writes the sharded form instead, a directory
of ``torch.distributed.checkpoint`` shards (``train/orbax_ckpt.py``); a
snapshot path that is a directory restores that way whatever the variable
says.

Under a process group every rank runs the same epoch loop: each call here
is made on every rank. The files (the ``.pt``, a one-file snapshot) are
written by rank 0 alone; under ``--fsdp`` and ``--mesh-model`` the state
is gathered whole first (collectives over the data and the model axis), so
``export_model``, ``predict`` and the sweep read them unchanged, and a
restore puts each tensor back in its live placement: this rank's slice on
the model axis (``parallel/tensor.py:local_part``), then its FSDP shard.
On a model axis a ``Snapshot`` holds the whole tensors, AdamW's moments
included.
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ssip_tpu_torch.models.port import load_state_dict_arrays
from ssip_tpu_torch.parallel import tensor
from ssip_tpu_torch.parallel.distributed import barrier, is_primary
from ssip_tpu_torch.parallel.fsdp import full_tensor, placed_like
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)

_SNAPSHOT_MAGIC = b"SSIPTORCHSNAP1\n"


def save_checkpoint(path: Path, model: nn.Module) -> None:
    """Write ``model``'s state_dict to ``path`` as float32/int64 CPU tensors
    (gathered whole under FSDP; rank 0 writes)."""
    path = Path(path)
    state = {k: v.detach().to("cpu", copy=True) for k, v in tensor.whole_state_dict(model).items()}
    if not is_primary():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)
    LOGGER.info("Saved checkpoint %s", path)


def load_checkpoint(path: Path, model: nn.Module) -> None:
    """Load a ``.pt`` state_dict written by either package into ``model``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dict_arrays(model, state, path)


@dataclass
class Snapshot:
    """A copy of a train state: the step, the model's and the optimizer's
    state_dicts. ``take`` clones on the state's device; ``restore`` loads it
    back into a state of the same model."""

    step: int
    model: Dict[str, torch.Tensor]
    optimizer: dict

    @classmethod
    def take(cls, state) -> "Snapshot":
        model = state.model
        if not tensor.is_tensor_parallel(model):
            return cls(state.step, {k: v.detach().clone() for k, v in model.state_dict().items()},
                       copy.deepcopy(state.optimizer.state_dict()))
        # a model axis: the whole tensors (collectives), moments like their parameters
        names = tensor.parameter_names(model, state.optimizer)
        optimizer = state.optimizer.state_dict()
        optimizer = {**optimizer, "state": {
            i: {k: tensor.whole_tensor(model, names[int(i)], full_tensor(v)).clone()
                if torch.is_tensor(v) and v.dim() > 0 else copy.deepcopy(v) for k, v in entry.items()}
            for i, entry in optimizer["state"].items()}, "param_groups": copy.deepcopy(optimizer["param_groups"])}
        return cls(state.step, {k: v.clone() for k, v in tensor.whole_state_dict(model).items()}, optimizer)

    def restore(self, state) -> None:
        """Load into ``state``; a whole tensor read from a file goes back
        into its live parameter's placement (this rank's slice on a model
        axis, then its FSDP shard)."""
        model = state.model
        live = model.state_dict()
        model.load_state_dict({k: _placed(tensor.local_part(model, k, v), live[k]) for k, v in self.model.items()})
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        names = tensor.parameter_names(model, state.optimizer)

        def placed(i, v):
            v = tensor.local_part(model, names[int(i)], v)
            return _placed(v, params[int(i)]) if v.shape == params[int(i)].shape else v

        optimizer = dict(self.optimizer)
        optimizer["state"] = {
            i: {k: placed(i, v) if torch.is_tensor(v) else v for k, v in entry.items()}
            for i, entry in self.optimizer["state"].items()
        }
        state.optimizer.load_state_dict(optimizer)
        state.step = self.step


def _placed(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return placed_like(value, like) if isinstance(like, DTensor) else value


def snapshot_exists(path: Path) -> bool:
    """A snapshot (a file, a directory, or a directory whose replacement
    was cut between its two renames) is at ``path``."""
    from ssip_tpu_torch.train.orbax_ckpt import committed_path

    return committed_path(Path(path)) is not None


def _to_cpu(obj: Any) -> Any:
    if torch.is_tensor(obj):
        return full_tensor(obj).detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _sharded_form(path: Path) -> bool:
    """Write the sharded form: asked for by the variable, or kept where the
    snapshot (for a ``.best`` sidecar, its stream's) is a directory."""
    stream = path.with_name(path.name[: -len(".best")]) if path.name.endswith(".best") else path
    return os.environ.get("SSIP_SNAPSHOT_FORMAT") == "orbax" or path.is_dir() or stream.is_dir()


def save_train_snapshot(path: Path, snapshot: Snapshot, driver: Dict[str, Any]) -> None:
    """Write ``snapshot`` and the driver dict to ``path`` in one file,
    committed by an atomic rename (rank 0 writes; every rank returns after
    the rename); with
    ``SSIP_SNAPSHOT_FORMAT=orbax``, or where the snapshot is a directory
    already, a directory of shards, every rank writing its own."""
    if _sharded_form(Path(path)):
        from ssip_tpu_torch.train.orbax_ckpt import save_train_snapshot_orbax

        save_train_snapshot_orbax(path, snapshot, driver)
        return
    path = Path(path)
    whole = {"step": int(snapshot.step), "model": _to_cpu(snapshot.model), "optimizer": _to_cpu(snapshot.optimizer)}
    if is_primary():
        path.parent.mkdir(parents=True, exist_ok=True)
        driver_bytes = json.dumps(driver).encode()
        state = io.BytesIO()
        torch.save(whole, state)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(_SNAPSHOT_MAGIC + len(driver_bytes).to_bytes(8, "big") + driver_bytes + state.getvalue())
        os.replace(tmp, path)
    barrier()  # every rank leaves with the snapshot committed: a restore in the same processes reads it


def load_train_snapshot(path: Path, template=None) -> Tuple[Snapshot, Dict[str, Any]]:
    """(snapshot, driver dict); raises on a missing, corrupt or foreign
    snapshot. A file gives CPU tensors; a directory (the sharded form)
    restores into the placements of ``template``'s tensors (a
    ``TrainState``; CPU tensors without one)."""
    from ssip_tpu_torch.train.orbax_ckpt import committed_path, load_train_snapshot_orbax

    found = committed_path(Path(path))
    if found is not None and found.is_dir():
        return load_train_snapshot_orbax(found, template)
    raw = Path(path).read_bytes()
    if not raw.startswith(_SNAPSHOT_MAGIC):
        raise ValueError(f"{path} is not a resume snapshot of ssip_tpu_torch")
    off = len(_SNAPSHOT_MAGIC)
    dlen = int.from_bytes(raw[off : off + 8], "big")
    driver = json.loads(raw[off + 8 : off + 8 + dlen].decode())
    state = torch.load(io.BytesIO(raw[off + 8 + dlen :]), map_location="cpu", weights_only=True)
    return Snapshot(int(state["step"]), state["model"], state["optimizer"]), driver


def restore_resume_state(resume_path: Path, state) -> Tuple[Optional[Dict[str, Any]], Snapshot]:
    """Restore ``state`` in place from the snapshot at ``resume_path``; then
    read the ``.best`` sidecar with its two failure modes (unreadable: warn;
    missing while the driver records a finite best: warn that the current
    state stands in).

    Returns ``(driver, best)``. ``driver`` is None when the snapshot is
    unreadable: ``state`` is left as it was and the caller starts fresh (a
    resume point must never brick the run it protects).
    """
    path = Path(resume_path)
    fresh = Snapshot.take(state)
    try:
        snapshot, driver = load_train_snapshot(path, state)
        snapshot.restore(state)
    except Exception as exc:  # noqa: BLE001 — any unreadable snapshot starts the run fresh
        fresh.restore(state)
        LOGGER.warning("Unreadable resume snapshot %s (%s) — starting fresh", path, exc)
        return None, fresh

    best_path = Path(str(path) + ".best")
    best = Snapshot.take(state)
    best_val = driver.get("best_val_loss", math.inf)
    if snapshot_exists(best_path):
        try:
            best, _ = load_train_snapshot(best_path, state)
        except Exception as exc:  # noqa: BLE001
            LOGGER.warning("Unreadable best-state snapshot %s (%s) — using current", best_path, exc)
    elif math.isfinite(best_val):
        # the improvement was recorded but its state is gone: the current
        # state stands in as best while the historic loss still gates
        # improvements
        LOGGER.warning(
            "Best-state snapshot %s missing (historic best %.4f) — current "
            "state stands in as best until the next improvement",
            best_path, best_val,
        )
    return driver, best
