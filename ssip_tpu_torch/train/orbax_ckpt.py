"""Sharded train snapshots on ``torch.distributed.checkpoint`` (DCP).

Counterpart of ``ssip_tpu/train/orbax_ckpt.py:1-112``, which writes them
with orbax. The default snapshot (``train/checkpoints.py``) is one file
that rank 0 writes after gathering the state whole; this form keeps the
same snapshot API (a ``Snapshot`` and the driver dict, atomic commit, one
snapshot a training stream) but:

- save: every rank writes its own shards (an FSDP-sharded parameter and
  its moments in pieces, a replicated tensor once) into a ``.tmp``
  directory; rank 0 adds ``driver.json`` (the driver dict and the
  optimizer's param groups) and commits it by renames: the previous
  snapshot to ``.old``, the new one into place, ``.old`` removed. A kill
  before the second rename leaves the previous snapshot, which
  ``committed_path`` finds under ``.old``.
- restore: the tensors are read straight into the template's placements
  (its ``DeviceMesh`` and ``Shard`` dims under FSDP, its device otherwise),
  no gather on one rank. On a model axis the snapshot holds whole tensors
  (``checkpoints.py:Snapshot``), read whole and sliced on restore.

Opt in with ``SSIP_SNAPSHOT_FORMAT=orbax`` (``checkpoints.py`` dispatches);
the snapshot path then names a directory. Loads detect the form: a
directory restores this way whatever the variable says, so switching
formats between runs cannot orphan a resume point.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ssip_tpu_torch.parallel.distributed import barrier, is_primary
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)

_DRIVER = "driver.json"


def _aside(path: Path, suffix: str) -> Path:
    return path.with_name(path.name + suffix)


def committed_path(path: Path) -> Optional[Path]:
    """The snapshot at ``path``: itself, or the ``.old`` directory a save
    cut between its two renames left; None when there is neither."""
    if path.exists():
        return path
    old = _aside(path, ".old")
    return old if (old / _DRIVER).exists() else None


def _tree(step: int, model: Dict[str, torch.Tensor], optimizer_state: Dict) -> Dict[str, Any]:
    return {
        "step": torch.tensor(int(step)),
        "model": dict(model),
        "optim": {str(i): dict(entry) for i, entry in optimizer_state.items()},
    }


def save_train_snapshot_orbax(path: Path, snapshot, driver: Dict[str, Any]) -> None:
    """Write ``path`` as a DCP directory (every rank its shards; atomic commit)."""
    import torch.distributed.checkpoint as dcp

    path = Path(path).resolve()
    tmp = _aside(path, ".tmp")
    if is_primary():
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.parent.mkdir(parents=True, exist_ok=True)
    barrier()
    dcp.save(_tree(snapshot.step, snapshot.model, snapshot.optimizer["state"]), checkpoint_id=str(tmp))
    if is_primary():
        (tmp / _DRIVER).write_text(json.dumps({"driver": driver, "param_groups": snapshot.optimizer["param_groups"]}))
        old = _aside(path, ".old")
        shutil.rmtree(old, ignore_errors=True)
        if path.exists():
            path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old, ignore_errors=True)
    barrier()


def _template(path: Path, state) -> Dict[str, Any]:
    """Empty tensors in the snapshot's structure, each in ``state``'s
    placement (a moment like its parameter); CPU tensors of the saved
    shapes where ``state`` is None."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    if state is not None:
        live = state.model.state_dict()
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
    tree: Dict[str, Any] = {"model": {}, "optim": {}}
    for key, item in meta.items():
        shape, dtype = tuple(item.size), item.properties.dtype
        if key == "step":
            tree["step"] = torch.empty(shape, dtype=dtype)
            continue
        top, rest = key.split(".", 1)
        if top == "model":
            like = live.get(rest) if state is not None else None
            fits = like is not None and tuple(like.shape) == shape  # a model axis saves whole tensors
            tree["model"][rest] = torch.empty_like(like) if fits else torch.empty(shape, dtype=dtype)
        else:
            index, name = rest.split(".", 1)
            like = params[int(index)] if state is not None else None
            fits = like is not None and tuple(like.shape) == shape
            tree["optim"].setdefault(index, {})[name] = (
                torch.empty_like(like, dtype=dtype) if fits else torch.empty(shape, dtype=dtype))
    return tree


def load_train_snapshot_orbax(path: Path, state_template=None) -> Tuple[Any, Dict[str, Any]]:
    """(``Snapshot``, driver) from a DCP snapshot directory, its tensors in
    ``state_template``'s placements. Raises on a missing or unreadable
    snapshot (callers treat that as 'no snapshot', as for the file form)."""
    import torch.distributed.checkpoint as dcp

    from ssip_tpu_torch.train.checkpoints import Snapshot

    path = Path(path).resolve()
    extra = json.loads((path / _DRIVER).read_text())
    tree = _template(path, state_template)
    dcp.load(tree, checkpoint_id=str(path))
    groups = [dict(g, betas=tuple(g["betas"])) if "betas" in g else g for g in extra["param_groups"]]
    optimizer = {"state": {int(i): entry for i, entry in tree["optim"].items()}, "param_groups": groups}
    return Snapshot(int(tree["step"]), tree["model"], optimizer), dict(extra["driver"])
