"""Carry weights between the Flax ResNet and ViT trees and the torch modules.

Counterpart of ``ssip_tpu/models/port_torch.py:38-141`` (torch key → Flax
path) and ``:200-282`` (``export_state_dict``, Flax tree → torchvision
names). Layouts:

- conv kernels (the ViT's patch kernel too) HWIO → OIHW;
- Dense kernels [in, out] → [out, in]: the ResNet's ``fc`` and every 2-D
  ViT weight (``qkv`` → ``self_attention.in_proj_weight``, ``out`` →
  ``self_attention.out_proj``, ``mlp_1``/``mlp_2`` → ``mlp.0``/``mlp.3``,
  ``fc`` → ``heads.head``);
- BN ``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``;
  LayerNorm ``scale/bias`` → ``weight/bias``;
- the ViT's ``cls_token`` → ``class_token``, ``pos_embedding`` →
  ``encoder.pos_embedding``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Sequence, Tuple

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


_VIT_TOP = {"cls_token": "class_token", "pos_embedding": "encoder.pos_embedding"}
_VIT_MODS = {
    "conv_proj": "conv_proj", "fc": "heads.head", "ln": "encoder.ln",
    "ln_1": "ln_1", "ln_2": "ln_2", "out": "self_attention.out_proj",
    "mlp_1": "mlp.0", "mlp_2": "mlp.3",
}
_VIT_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
# torchvision < 0.13 names of the MLP's Linears, accepted on load
_VIT_OLD_MLP = {".mlp.linear_1.": ".mlp.0.", ".mlp.linear_2.": ".mlp.3."}


def _torch_key_vit(path: Sequence[str]) -> str:
    *mods, leaf = path
    if not mods:
        return _VIT_TOP[leaf]
    prefix = ""
    m = re.match(r"^block(\d+)$", mods[0])
    if m:
        prefix, mods = f"encoder.layers.encoder_layer_{m.group(1)}.", mods[1:]
    if mods == ["qkv"]:
        return f"{prefix}self_attention.in_proj_{_VIT_LEAVES[leaf]}"
    return f"{prefix}{_VIT_MODS[mods[0]]}.{_VIT_LEAVES[leaf]}"


def is_vit_state_dict(state: Mapping[str, Any]) -> bool:
    return any(k == "class_token" or k.startswith("conv_proj.") for k in state)


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ResNet or ViT tree (nested dicts of arrays) → torchvision-named
    arrays; the family is read from the tree (``cls_token`` means ViT)."""
    vit = "cls_token" in variables.get("params", {})
    to_key = _torch_key_vit if vit else _torch_key
    out: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: tuple) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (name,))
                continue
            key = to_key(prefix + (name,))
            arr = np.asarray(value, dtype=np.float32)
            if arr.ndim == 4:
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
            elif key == "fc.weight" or (vit and arr.ndim == 2):
                arr = np.transpose(arr, (1, 0))
            out[key] = np.ascontiguousarray(arr)

    walk(variables.get("params", {}), ())
    walk(variables.get("batch_stats", {}), ())
    return out


def flax_from_state_dict(
    state: Mapping[str, Any], leaves: Iterable[Tuple[Tuple[str, ...], Tuple[int, ...]]]
) -> Dict[str, Dict]:
    """The way back: torchvision-named arrays → the Flax tree whose leaves
    (key path, shape) are ``leaves`` (``models/host_init.py:arch_leaves``)."""
    leaves = list(leaves)
    vit = any(path == ("params", "cls_token") for path, _ in leaves)
    tree: Dict[str, Dict] = {}
    for path, shape in leaves:
        key = (_torch_key_vit if vit else _torch_key)(path[1:])
        arr = np.asarray(state[key].detach().cpu() if hasattr(state[key], "detach") else state[key], np.float32)
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW → HWIO
        elif key == "fc.weight" or (vit and arr.ndim == 2):
            arr = np.transpose(arr, (1, 0))
        if arr.shape != tuple(shape):
            raise ValueError(f"{key} has shape {arr.shape}, the tree wants {tuple(shape)}")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def load_state_dict_arrays(module: nn.Module, arrays: Mapping[str, Any], source: Any) -> None:
    """Load torchvision-named arrays into ``module``; ``num_batches_tracked``
    may be absent (Flax has no counterpart). Any other missing or extra
    key, or a tensor of another shape (a ViT of another width, depth or image
    size), means the checkpoint is another architecture, and raises."""
    state = {k: torch.as_tensor(v) for k, v in arrays.items()}
    expected = module.state_dict()
    missing = sorted(k for k in set(expected) - set(state) if not k.endswith("num_batches_tracked"))
    unexpected = sorted(set(state) - set(expected))
    resized = sorted(
        f"{k} {tuple(v.shape)} for {tuple(expected[k].shape)}"
        for k, v in state.items() if k in expected and v.shape != expected[k].shape
    )
    if missing or unexpected or resized:
        raise ValueError(
            f"Checkpoint {source} does not match the model: missing "
            f"{missing[:4]}{'…' if len(missing) > 4 else ''}, unexpected "
            f"{unexpected[:4]}{'…' if len(unexpected) > 4 else ''}, other shapes "
            f"{resized[:4]}{'…' if len(resized) > 4 else ''}"
        )
    module.load_state_dict(state, strict=False)


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> None:
    """Load a Flax ResNet or ViT variable tree into the torch module."""
    load_state_dict_arrays(module, state_dict_from_flax(variables), "<flax variables>")


def read_torch_checkpoint(path: Path) -> Dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` torchvision state_dict (``{"state_dict": …}``
    wrapper accepted) without its classifier head (``fc.`` of a ResNet,
    ``heads.`` of a ViT): the frozen extractor has none (reference
    feature_extraction.py:210-227 strips it too). A ViT's older
    ``mlp.linear_1/2`` names become ``mlp.0/3``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    head = "heads." if is_vit_state_dict(state) else "fc."
    out = {}
    for key, value in state.items():
        if key.startswith(head):
            continue
        for old, new in _VIT_OLD_MLP.items():
            key = key.replace(old, new)
        out[key] = value
    return out
