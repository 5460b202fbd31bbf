"""Checkpoints: the torchvision-layout ``.pt`` state_dict.

Counterpart of ``ssip_tpu/train/checkpoints.py:30-49`` (``save_checkpoint``).
The reference persists best-val-loss state_dicts at
``outputs/models/baseline_resnet18.pt`` (reference common.py:418-424); the
port's modules already carry torchvision's names (a ViT's
``encoder.layers.encoder_layer_0.…`` and ``heads.head`` included), so
``save_checkpoint`` writes ``model.state_dict()`` as it is. The JAX package also writes a Flax
``.msgpack`` beside it; that needs flax, so the port does not write it, and
the JAX package's ``load_checkpoint`` (``:141-152``) ports the ``.pt`` when
no ``.msgpack`` is there.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from ssip_tpu_torch.models.port import load_state_dict_arrays
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)


def save_checkpoint(path: Path, model: nn.Module) -> None:
    """Write ``model``'s state_dict to ``path`` as float32/int64 CPU tensors."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)
    LOGGER.info("Saved checkpoint %s", path)


def load_checkpoint(path: Path, model: nn.Module) -> None:
    """Load a ``.pt`` state_dict written by either package into ``model``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dict_arrays(model, state, path)
