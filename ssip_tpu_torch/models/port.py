"""Carry weights between the Flax ResNet tree and the torch module.

Counterpart of ``ssip_tpu/models/port_torch.py:38-91`` (torch key → Flax
path) and ``:200-282`` (``export_state_dict``, Flax tree → torchvision
names), written here because importing ``port_torch`` loads jax through
``ssip_tpu/models/__init__.py``. Layouts:

- conv kernels HWIO → OIHW;
- Dense ``fc`` kernel [in, out] → [out, in];
- BN ``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_LEAVES = {"kernel": "weight", "bias": "bias"}


def _torch_key(path: Sequence[str]) -> str:
    *mods, leaf = path
    parts = []
    is_bn = False
    for mod in mods:
        m = re.match(r"^layer(\d+)_(\d+)$", mod)
        if m:
            parts.append(f"layer{m.group(1)}.{m.group(2)}")
        elif mod == "downsample_conv":
            parts.append("downsample.0")
        elif mod == "downsample_bn":
            parts.append("downsample.1")
            is_bn = True
        else:
            parts.append(mod)
            is_bn = is_bn or mod.startswith("bn")
    torch_leaf = _BN_LEAVES[leaf] if (is_bn or leaf in ("scale", "mean", "var")) else _LEAVES[leaf]
    return ".".join(parts + [torch_leaf])


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ResNet tree (nested dicts of arrays) → torchvision-named arrays."""
    if "cls_token" in variables.get("params", {}):
        raise ValueError("ViT trees are not ported to ssip_tpu_torch yet (ROADMAP.md, slice 6)")
    out: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: tuple) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (name,))
                continue
            key = _torch_key(prefix + (name,))
            arr = np.asarray(value, dtype=np.float32)
            if arr.ndim == 4:
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
            elif key == "fc.weight":
                arr = np.transpose(arr, (1, 0))
            out[key] = np.ascontiguousarray(arr)

    walk(variables.get("params", {}), ())
    walk(variables.get("batch_stats", {}), ())
    return out


def load_state_dict_arrays(module: nn.Module, arrays: Mapping[str, Any], source: Any) -> None:
    """Load torchvision-named arrays into ``module``; ``num_batches_tracked``
    may be absent (Flax has no counterpart). Any other missing or extra key
    means the checkpoint is another architecture, and raises."""
    state = {k: torch.as_tensor(v) for k, v in arrays.items()}
    expected = set(module.state_dict())
    missing = sorted(k for k in expected - set(state) if not k.endswith("num_batches_tracked"))
    unexpected = sorted(set(state) - expected)
    if missing or unexpected:
        raise ValueError(
            f"Checkpoint {source} does not match the model: missing "
            f"{missing[:4]}{'…' if len(missing) > 4 else ''}, unexpected "
            f"{unexpected[:4]}{'…' if len(unexpected) > 4 else ''}"
        )
    module.load_state_dict(state, strict=False)


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Load a Flax ResNet variable tree into the torch module."""
    load_state_dict_arrays(module, state_dict_from_flax(variables), "<flax variables>")


def read_torch_checkpoint(path: Path) -> Dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` torchvision state_dict (``{"state_dict": …}``
    wrapper accepted) without its ``fc`` head: the frozen extractor has none
    (reference feature_extraction.py:210-227 strips it too)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if not k.startswith("fc.")}
