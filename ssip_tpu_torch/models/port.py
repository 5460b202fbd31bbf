"""Carry weights between the Flax ResNet, ViT and MoE trees and the torch modules.

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
  ``encoder.pos_embedding``;
- an MoE ViT's dense blocks as a ViT's; its expert blocks'
  ``block{i}/moe/router/{kernel, bias}`` → ``…encoder_layer_{i}.moe.router.
  {weight, bias}`` (the kernel transposed) and ``block{i}/moe/{w_in, b_in,
  w_out, b_out}`` → ``…moe.{w_in, …}`` as they are, the expert axis leading.
  No torchvision topology exists for an MoE, so these names, and the
  ``.pt`` the port's training writes for an MoE arch, are the port's own;
  the port's readers of a run (the sweep, ``ScreeningPredictor``,
  ``export_model``, ``predict``) take it.

The int8 ViT tree (``quantize_vit_extractor``'s output in either package, as
numpy arrays) carries over unchanged in layout: ``quantized_vit_from_tree``
builds the port's ``QuantizedVisionTransformer`` from it after checking every
leaf's size and type against the arch, ``tree_from_quantized_vit`` is the way
back. The int8 ResNet tree (``quantize_extractor``'s output: ``stem`` and
``blocks[i].{conv1, conv2[, conv3][, downsample]}``, each ``kernel`` int8
HWIO, ``mult``, ``bias``, ``inv_in_scale``) likewise:
``quantized_resnet_from_tree`` and ``tree_from_quantized_resnet``.
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
    if mods == ["moe", "router"]:
        return f"{prefix}moe.router.{_VIT_LEAVES[leaf]}"
    if mods == ["moe"]:  # the expert leaves, their [E] axis leading in both layouts
        return f"{prefix}moe.{leaf}"
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
            elif key == "fc.weight" or (vit and name == "kernel" and arr.ndim == 2):
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
        elif key == "fc.weight" or (vit and path[-1] == "kernel" and arr.ndim == 2):
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
    """Load a Flax ResNet, ViT or MoE ViT variable tree into the torch module."""
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


_QSITES = ("qkv", "out", "mlp_1", "mlp_2")


def _check_quantized_tree(tree: Mapping[str, Any], arch: str) -> None:
    """Raise unless ``tree`` is an int8 tree of ``arch``: the layer count,
    every kernel's shape and int8 type, ``mult`` and ``bias`` as wide as the
    kernel's output."""
    from ssip_tpu_torch.models.vit import VIT_CONFIGS

    cfg = VIT_CONFIGS[arch]
    d, mlp, p = cfg["hidden_dim"], cfg["mlp_dim"], cfg["patch_size"]
    if len(tree["blocks"]) != cfg["num_layers"]:
        raise ValueError(f"the int8 tree has {len(tree['blocks'])} blocks, {arch} has {cfg['num_layers']}")
    want = {"qkv": (d, 3 * d), "out": (d, d), "mlp_1": (d, mlp), "mlp_2": (mlp, d)}
    sites = [("stem", tree["stem"], (p, p, 3, d))]
    for i, blk in enumerate(tree["blocks"]):
        sites += [(f"block{i}.{name}", blk[name], want[name]) for name in _QSITES]
    for name, site, shape in sites:
        kernel = np.asarray(site["kernel"])
        if kernel.dtype != np.int8 or kernel.shape != shape:
            raise ValueError(f"{name}.kernel is {kernel.dtype} {kernel.shape}, {arch} wants int8 {shape}")
        for leaf in ("mult", "bias"):
            if np.shape(site[leaf]) != (shape[-1],):
                raise ValueError(f"{name}.{leaf} has shape {np.shape(site[leaf])}, {arch} wants ({shape[-1]},)")
    if np.shape(tree["cls_token"]) != (1, 1, d) or np.shape(tree["pos_embedding"])[::2] != (1, d):
        raise ValueError(
            f"cls_token {np.shape(tree['cls_token'])} or pos_embedding {np.shape(tree['pos_embedding'])} "
            f"is not {arch}'s (width {d})"
        )


def quantized_vit_from_tree(
    tree: Mapping[str, Any], arch: str, inter_dtype: torch.dtype = torch.bfloat16, stem_prequantized: bool = False
) -> nn.Module:
    """The int8 tree of either package (numpy or anything ``np.asarray``
    takes) → the port's quantized module."""
    from ssip_tpu_torch.models.quantized_vit import QuantizedVisionTransformer

    _check_quantized_tree(tree, arch)
    return QuantizedVisionTransformer(arch, tree, inter_dtype=inter_dtype, stem_prequantized=stem_prequantized)


def tree_from_quantized_vit(module: nn.Module) -> Dict[str, Any]:
    """The way back: the module's buffers as the int8 tree (numpy)."""

    def ln(mod: nn.Module) -> Dict[str, np.ndarray]:
        return {"scale": mod.scale.cpu().numpy(), "bias": mod.bias.cpu().numpy()}

    return {
        "stem": module.stem.leaves(),
        "cls_token": module.cls_token.cpu().numpy(),
        "pos_embedding": module.pos_embedding.cpu().numpy(),
        "blocks": [
            {"ln_1": ln(blk.ln_1), "ln_2": ln(blk.ln_2), **{name: getattr(blk, name).leaves() for name in _QSITES}}
            for blk in module.blocks
        ],
        "ln": ln(module.ln),
    }


def _check_quantized_resnet_tree(tree: Mapping[str, Any], arch: str) -> None:
    """Raise unless ``tree`` is an int8 tree of the ResNet ``arch``: the
    block count, each block's sites, every kernel's shape and int8 type,
    ``mult`` and ``bias`` as wide as the kernel's output."""
    from ssip_tpu_torch.models.resnet import MODEL_STAGES, STAGE_WIDTHS

    if arch not in MODEL_STAGES:
        raise ValueError(f"int8 ResNet trees are for {', '.join(MODEL_STAGES)}, got {arch}")
    stages, bottleneck = MODEL_STAGES[arch], arch == "resnet50"
    if len(tree["blocks"]) != sum(stages):
        raise ValueError(f"the int8 tree has {len(tree['blocks'])} blocks, {arch} has {sum(stages)}")
    sites = [("stem", tree["stem"], (7, 7, 3, 64))]
    cin, i = 64, 0
    for stage, n in enumerate(stages):
        w = STAGE_WIDTHS[stage]
        out = 4 * w if bottleneck else w
        for block in range(n):
            blk = tree["blocks"][i]
            want = ({"conv1": (1, 1, cin, w), "conv2": (3, 3, w, w), "conv3": (1, 1, w, out)} if bottleneck
                    else {"conv1": (3, 3, cin, w), "conv2": (3, 3, w, w)})
            if cin != out or (stage > 0 and block == 0):
                want["downsample"] = (1, 1, cin, out)
            if set(blk) != set(want):
                raise ValueError(f"block {i} has sites {sorted(blk)}, {arch} wants {sorted(want)}")
            sites += [(f"block{i}.{name}", blk[name], shape) for name, shape in want.items()]
            cin, i = out, i + 1
    for name, site, shape in sites:
        kernel = np.asarray(site["kernel"])
        if kernel.dtype != np.int8 or kernel.shape != shape:
            raise ValueError(f"{name}.kernel is {kernel.dtype} {kernel.shape}, {arch} wants int8 {shape}")
        for leaf in ("mult", "bias"):
            if np.shape(site[leaf]) != (shape[-1],):
                raise ValueError(f"{name}.{leaf} has shape {np.shape(site[leaf])}, {arch} wants ({shape[-1]},)")


def quantized_resnet_from_tree(
    tree: Mapping[str, Any], arch: str, inter_dtype: torch.dtype = torch.bfloat16, stem_prequantized: bool = False
) -> nn.Module:
    """The int8 ResNet tree of either package → the port's quantized module."""
    from ssip_tpu_torch.models.quantized import QuantizedResNet
    from ssip_tpu_torch.models.resnet import MODEL_STAGES

    _check_quantized_resnet_tree(tree, arch)
    return QuantizedResNet(tree, MODEL_STAGES[arch], bottleneck=arch == "resnet50", inter_dtype=inter_dtype,
                           stem_prequantized=stem_prequantized)


def tree_from_quantized_resnet(module: nn.Module) -> Dict[str, Any]:
    """The way back: the module's buffers as the int8 tree (numpy)."""
    from ssip_tpu_torch.models.quantized import site_names

    return {
        "stem": module.stem.leaves(),
        "blocks": [
            {name: getattr(blk, name).leaves() for name in site_names(dict(blk.named_children()))}
            for blk in module.blocks
        ],
    }
