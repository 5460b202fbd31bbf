"""``--fsdp``: FSDP2 ``fully_shard`` over the mesh's data axis.

Counterpart of the JAX package's ``fsdp=True`` placements
(``ssip_tpu/parallel/mesh.py:fsdp_param_spec``, ``tree_shardings``): every
parameter of at least ``FSDP_MIN_ELEMENTS`` elements is sharded on the
dimension ``fsdp_shard_dim`` names (the largest divisible one in its Flax
layout), through ``shard_placement_fn``; smaller leaves (biases, norms,
the class token, the router) stay whole on every rank as
``ignored_params``, and the engine sums their gradients by hand
(``replicated_params``). AdamW's moments are made from the sharded
parameters, so they follow them.

Each residual block (ResNet) or encoder block (ViT, MoE ViT) is one FSDP
unit, the root another: a block's parameters are gathered just before its
forward and backward and freed after. Gradients are reduced by SUM
(``set_gradient_divide_factor(1.0)``, SUM collectives): the engine's loss
is each rank's share of the global loss, so the summed gradient is the
single-process one.

With a model axis (``--mesh-model``) the model is sliced over it first
(``parallel/tensor.py``) and FSDP shards the slices over the data sub-mesh,
each on the dimension ``fsdp_param_spec`` gives its whole leaf next to the
model axis' dimension, as the JAX package composes the two rules.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ssip_tpu_torch.parallel.mesh import DATA_AXIS, data_size, fsdp_shard_dim, model_size


def _blocks(model: nn.Module) -> List[nn.Module]:
    from ssip_tpu_torch.models.moe import MoEEncoderBlock
    from ssip_tpu_torch.models.resnet import BasicBlock, Bottleneck
    from ssip_tpu_torch.models.vit import EncoderBlock

    return [m for m in model.modules() if isinstance(m, (BasicBlock, Bottleneck, EncoderBlock, MoEEncoderBlock))]


def contiguous_parameters(model: nn.Module) -> nn.Module:
    """Every parameter in the default (contiguous) layout, in place: FSDP
    shards only those, so a card's channels_last conv weights go back to
    NCHW (cuDNN takes the mix with channels_last activations)."""
    with torch.no_grad():
        for p in model.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    return model


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Apply ``fully_shard`` to ``model`` (already on its device, and
    sliced over the mesh's model axis if it has one) in place over the
    mesh's data axis and return it."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    contiguous_parameters(model)
    n, m = data_size(mesh), model_size(mesh)
    sliced = getattr(model, "_ssip_tp", {})  # a leaf the model axis sliced: its whole shape
    dims = {p: fsdp_shard_dim(name, sliced[name][0] if name in sliced else tuple(p.shape), n, m)
            for name, p in model.named_parameters()}
    whole = {p for p, d in dims.items() if d is None}
    data_mesh = mesh[DATA_AXIS]

    def placement(p: nn.Parameter):
        return Shard(dims[p])

    for unit in [*_blocks(model), model]:
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=placement, ignored_params=whole)
        unit.set_gradient_divide_factor(1.0)
        if hasattr(unit, "set_force_sum_reduction_for_comms"):
            unit.set_force_sum_reduction_for_comms(True)  # gloo has no PREMUL_SUM
    model._ssip_replicated = [p for p in model.parameters() if p in whole]
    return model


def is_sharded(model: nn.Module) -> bool:
    return hasattr(model, "_ssip_replicated")


def replicated_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters whose gradients the engine sums over the data axis:
    all of them under plain data parallelism, the whole (ignored) ones
    under FSDP, in the model's parameter order (the same on every rank)."""
    return list(model._ssip_replicated) if is_sharded(model) else list(model.parameters())


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it), any
    other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def placed_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a whole tensor, the same on every rank) in ``like``'s
    placement: a DTensor of ``like``'s mesh and placements when ``like`` is
    one, else on ``like``'s device."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        if isinstance(value, DTensor):
            return value
        return distribute_tensor(value.to(like.device, like.dtype), like.device_mesh, like.placements)
    return value.to(like.device)
