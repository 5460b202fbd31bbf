"""Seeded random init of the ResNet, ViT and MoE ViT families, with numpy and no jax.

Counterpart of ``ssip_tpu/models/host_init.py:20-57`` (``seeded_init_host``),
leaf for leaf and bit for bit. The JAX version walks the Flax variable tree
from ``jax.eval_shape(model.init)``; here the same tree is written out as a
table of Flax names and shapes (HWIO conv kernels), because that is what
the seeds are drawn from:

- each leaf's generator is ``default_rng`` seeded with the first 8 bytes
  (little endian) of ``sha256(f"{seed}:{name}")``, where ``name`` is the Flax
  key path as jax prints it, e.g. ``['params']/['layer1_0']/['conv1']/['kernel']``;
- kernels draw ``normal(0, sqrt(1/fan_in))`` in their Flax shape
  (fan_in = product of all but the last axis), the classifier's Dense
  ``fc`` kernel [features, classes] and the ViT's patch kernel
  [16, 16, 3, D] and Dense kernels [in, out] included;
- the ViT's ``pos_embedding`` draws ``normal(0, 0.02)``;
- an MoE block's expert kernels ``w_in`` [E, D, F] and ``w_out`` [E, F, D]
  draw ``normal(0, sqrt(1/fan))`` with the fan from axis −2 (the expert
  axis is a batch axis), its router [D, E] is a ``kernel``; the ``aux``
  collection holds no state and is not in the tree;
- BN and LayerNorm ``scale`` and BN ``var`` are ones; every other leaf
  (biases, BN ``mean``, the ViT's ``cls_token``) is zeros.

The result is the Flax-layout tree (nested dicts of numpy arrays);
``models/port.py:state_dict_from_flax`` turns it into torch layout.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ssip_tpu_torch.models.moe import MOE_CONFIGS
from ssip_tpu_torch.models.resnet import MODEL_STAGES, STAGE_WIDTHS
from ssip_tpu_torch.models.vit import VIT_CONFIGS

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...]]  # (Flax key path, shape)


def _bn(collection_path: Tuple[str, ...], features: int) -> Iterator[Leaf]:
    yield ("params", *collection_path, "scale"), (features,)
    yield ("params", *collection_path, "bias"), (features,)
    yield ("batch_stats", *collection_path, "mean"), (features,)
    yield ("batch_stats", *collection_path, "var"), (features,)


def resnet_leaves(arch: str, num_classes: Optional[int] = None) -> Iterator[Leaf]:
    """Every leaf of the Flax ResNet's variable tree, with its shape; the
    Dense ``fc`` head only for a classifier (``num_classes`` set)."""
    stages = MODEL_STAGES[arch]
    bottleneck = arch == "resnet50"
    expansion = 4 if bottleneck else 1
    yield ("params", "conv1", "kernel"), (7, 7, 3, 64)
    yield from _bn(("bn1",), 64)
    cin = 64
    for stage, num_blocks in enumerate(stages):
        width = STAGE_WIDTHS[stage]
        out = width * expansion
        for block in range(num_blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            mod = f"layer{stage + 1}_{block}"
            if bottleneck:
                convs = [(1, cin, width), (3, width, width), (1, width, out)]
            else:
                convs = [(3, cin, width), (3, width, width)]
            for k, (ks, ci, co) in enumerate(convs, start=1):
                yield ("params", mod, f"conv{k}", "kernel"), (ks, ks, ci, co)
                yield from _bn((mod, f"bn{k}"), co)
            if cin != out or stride != 1:
                yield ("params", mod, "downsample_conv", "kernel"), (1, 1, cin, out)
                yield from _bn((mod, "downsample_bn"), out)
            cin = out
    if num_classes is not None:
        yield ("params", "fc", "kernel"), (cin, num_classes)
        yield ("params", "fc", "bias"), (num_classes,)


def vit_leaves(arch: str, num_classes: Optional[int] = None, image_size: int = 224) -> Iterator[Leaf]:
    """Every leaf of the Flax ViT's ``params`` tree, with its shape, for
    ``image_size``² inputs (the position embedding covers the unpadded
    tokens); the Dense ``fc`` head only for a classifier. An MoE arch's
    expert blocks (every other block) hold ``moe/{router, w_in, b_in, w_out,
    b_out}`` in place of ``mlp_1`` and ``mlp_2``."""
    moe = arch in MOE_CONFIGS
    cfg = MOE_CONFIGS[arch] if moe else VIT_CONFIGS[arch]
    patch, d, mlp = cfg["patch_size"], cfg["hidden_dim"], cfg["mlp_dim"]
    yield ("params", "conv_proj", "kernel"), (patch, patch, 3, d)
    yield ("params", "conv_proj", "bias"), (d,)
    yield ("params", "cls_token"), (1, 1, d)
    yield ("params", "pos_embedding"), (1, (image_size // patch) ** 2 + 1, d)

    def dense(path: Tuple[str, ...], cin: int, cout: int) -> Iterator[Leaf]:
        yield ("params", *path, "kernel"), (cin, cout)
        yield ("params", *path, "bias"), (cout,)

    def ln(path: Tuple[str, ...]) -> Iterator[Leaf]:
        yield ("params", *path, "scale"), (d,)
        yield ("params", *path, "bias"), (d,)

    for i in range(cfg["num_layers"]):
        block = f"block{i}"
        yield from ln((block, "ln_1"))
        yield from dense((block, "qkv"), d, 3 * d)
        yield from dense((block, "out"), d, d)
        yield from ln((block, "ln_2"))
        if moe and i % 2 == 1:
            e = cfg["num_experts"]
            yield from dense((block, "moe", "router"), d, e)
            yield ("params", block, "moe", "w_in"), (e, d, mlp)
            yield ("params", block, "moe", "b_in"), (e, mlp)
            yield ("params", block, "moe", "w_out"), (e, mlp, d)
            yield ("params", block, "moe", "b_out"), (e, d)
        else:
            yield from dense((block, "mlp_1"), d, mlp)
            yield from dense((block, "mlp_2"), mlp, d)
    yield from ln(("ln",))
    if num_classes is not None:
        yield from dense(("fc",), d, num_classes)


def arch_leaves(arch: str, num_classes: Optional[int] = None, image_size: int = 224) -> Iterator[Leaf]:
    """The Flax variable tree's leaves for any ported arch."""
    if arch in VIT_CONFIGS or arch in MOE_CONFIGS:
        return vit_leaves(arch, num_classes, image_size)
    return resnet_leaves(arch, num_classes)


def _path_rng(seed: int, path: Tuple[str, ...]) -> np.random.Generator:
    name = "/".join(f"[{p!r}]" for p in path)  # jax's DictKey str form
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def seeded_init_host(
    arch: str, seed: int, num_classes: Optional[int] = None, image_size: int = 224
) -> Dict[str, Dict]:
    """Flax-layout ``{"params": …, "batch_stats": …}`` tree for ``arch``
    (``params`` alone for a ViT or an MoE ViT): the extractor, or with ``num_classes`` the
    classifier of the JAX package's module. ``image_size`` sizes the ViT's
    position embedding and is ignored for a ResNet."""
    tree: Dict[str, Dict] = {}
    for path, shape in arch_leaves(arch, num_classes, image_size):
        leaf = path[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            value = _path_rng(seed, path).normal(
                0.0, float(np.sqrt(1.0 / max(fan_in, 1))), size=shape
            ).astype(np.float32)
        elif leaf in ("w_in", "w_out"):  # fan from the per-expert (in, out) axes
            value = _path_rng(seed, path).normal(
                0.0, float(np.sqrt(1.0 / max(shape[-2], 1))), size=shape
            ).astype(np.float32)
        elif leaf == "pos_embedding":  # torch inits it normal(std=0.02)
            value = _path_rng(seed, path).normal(0.0, 0.02, size=shape).astype(np.float32)
        elif leaf in ("scale", "var"):
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
