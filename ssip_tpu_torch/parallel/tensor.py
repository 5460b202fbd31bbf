"""The model axis: tensor and expert parallelism by hand.

Counterpart of what ``jit`` does to the JAX package's program when a leaf
is placed by ``tp_param_spec`` (``ssip_tpu/parallel/mesh.py:82-139``,
``tree_shardings`` ``:176-201``): XLA slices the leaves over the mesh's
``model`` axis and inserts the collectives their products need. Here the
slicing is ``shard_model`` and the collectives are four autograd
Functions over the model axis' group (``ModelAxis``):

- ``copy``: identity forward, the gradients summed over the axis backward
  (a replicated tensor entering a rank's share of a product);
- ``reduce``: the sum over the axis forward, identity backward (partial
  products summed; what follows is the same on every rank);
- ``gather``: every rank's block concatenated along a dimension forward,
  this rank's slice of the gradient backward;
- ``ring_shift``: each rank's tensor to the next rank forward
  (``lax.ppermute`` around the ring), the reverse rotation backward.

Every collective is an ``all_reduce`` (of the partial sums, or of a
buffer with one zero-padded block a rank, which is exact: each place holds
one rank's value), on both backends: gloo has ``all_reduce`` but not
``all_gather`` on CUDA tensors, and two gloo ranks sharing one card are the
model axis a one-card machine can run. The padded form moves model-size
times the bytes of a gather; NCCL's ``all_gather`` and all-to-all are later
speed work. A collective that fails raises.

``all_reduce_sum`` of ``parallel/distributed.py`` is not one of these: its
backward sums the gradients over the ranks, right for the data axis (each
rank's loss is its share) and wrong after a model-axis sum that every rank
follows with the same computation (it would multiply the gradients by the
model size).

What the modules do with a sharded leaf (``models/resnet.py``,
``models/vit.py``, ``models/moe.py``, each reading ``tp`` on the module):

- a wide conv (output 128 or more) is column-parallel: ``copy`` of the
  input, the local output channels, ``gather`` before the BatchNorm, which
  stays replicated; a bias (the ViT's patch conv) is added after the
  gather;
- the classifier (``fc``, ``heads.head``) is row-parallel: this rank's
  columns of the ``copy`` of its input, ``reduce``, then the bias once;
- a ViT block's ``qkv`` and ``mlp.0`` are column-parallel, ``out_proj`` and
  ``mlp.3`` row-parallel. Where the heads divide the axis the qkv rows are
  regrouped by head before slicing (``qkv_view``), so each rank runs the
  attention kernel on its heads; otherwise the qkv columns are gathered
  and the attention runs whole on every rank;
- an MoE layer's expert leaves are sliced on their ``[E]`` axis; the
  router stays replicated, each rank runs its experts on its slice of the
  dispatch, and the partial combine is reduced.

``shard_model`` records each sliced leaf's whole shape and slicing
(``model._ssip_tp``); ``whole_tensor`` and ``local_part`` go between a
rank's slice and the whole tensor (checkpoints, snapshots, the export).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.parallel.mesh import model_group, model_rank, model_size, tp_shard_dim


@dataclass(frozen=True)
class ModelAxis:
    """The model axis of this rank: its group, size and this rank's place."""

    group: Any
    size: int
    rank: int


def model_axis(mesh) -> Optional[ModelAxis]:
    """The mesh's model axis, or None when it is 1 (no mesh: one process)."""
    if model_size(mesh) <= 1:
        return None
    return ModelAxis(model_group(mesh), model_size(mesh), model_rank(mesh))


def _all_reduce(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Sum of ``t`` over the axis, in place; half types go through float32
    (gloo sums no bfloat16), so a sum of zero-padded blocks stays exact."""
    if t.dtype in (torch.bfloat16, torch.float16):
        wide = t.float()
        dist.all_reduce(wide, group=axis.group)
        t.copy_(wide)
    else:
        dist.all_reduce(t, group=axis.group)
    return t


def _stacked(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) on a new leading axis, in rank order."""
    out = x.new_zeros((axis.size, *x.shape))
    out[axis.rank] = x
    return _all_reduce(out, axis)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return torch.cat(_stacked(x.contiguous(), axis).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return ring_shift_(x, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift_(grad, ctx.axis, -1), None


def copy(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _Copy.apply(x, axis)


def reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _Reduce.apply(x, axis)


def gather(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _Gather.apply(x, axis, dim % x.dim())


def ring_shift(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _RingShift.apply(x, axis)


def ring_shift_(x: torch.Tensor, axis: ModelAxis, shift: int = 1) -> torch.Tensor:
    """No autograd: rank r's ``x`` arrives on rank r + ``shift`` (mod the
    axis); returns what this rank received."""
    return _stacked(x.contiguous(), axis)[(axis.rank - shift) % axis.size].clone()


def split(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of the replicated ``x`` (``copy``
    first: each rank's gradient covers its block only, and the sum is the
    whole one)."""
    n = x.shape[dim] // axis.size
    return copy(x, axis).narrow(dim, axis.rank * n, n)


def row_linear(x_local: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], axis: ModelAxis):
    """Row-parallel product: this rank's input columns times its weight
    columns, reduced, the bias added once."""
    y = reduce(F.linear(x_local, weight), axis)
    return y if bias is None else y + bias


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` for a replicated ``x``: row-parallel where
    ``shard_model`` sliced the layer's input columns."""
    axis = getattr(layer, "tp", None)
    if axis is None:
        return layer(x)
    return row_linear(split(x, axis), layer.weight, layer.bias, axis)


# -- slicing the leaves ------------------------------------------------------

def qkv_view(shape: Tuple[int, ...], num_heads: int) -> Tuple[int, ...]:
    """The packed qkv weight ``[3·D, D]`` (bias ``[3·D]``) seen as
    ``[3, H, Dh, …]``, whose head axis (1) a head-divisible axis slices."""
    return (3, num_heads, shape[0] // (3 * num_heads), *shape[1:])


def _leaf_view(model: nn.Module, name: str, shape, dim: int, size: int) -> Tuple[Tuple[int, ...], int]:
    """(view of the whole leaf, the view's sliced dimension)."""
    from ssip_tpu_torch.models.vit import SelfAttention

    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if isinstance(owner, SelfAttention) and leaf.startswith("in_proj") and owner.num_heads % size == 0:
        return qkv_view(tuple(shape), owner.num_heads), 1
    return tuple(shape), dim


def _narrow(whole: torch.Tensor, view, dim: int, axis_size: int, rank: int) -> torch.Tensor:
    n = view[dim] // axis_size
    local = whole.reshape(view).narrow(dim, rank * n, n)
    return local.reshape(-1, *whole.shape[1:]) if len(view) != whole.dim() else local


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Slice ``model``'s leaves over the mesh's model axis in place (a
    no-op at model 1 or on a model sliced already) and mark the modules
    that own them (``module.tp``); returns the model. A pipelined or
    sequence-parallel ViT (``parallel/pipeline.py``, ``sequence.py``) uses
    the model axis its own way and is returned as it is."""
    axis = model_axis(mesh)
    if axis is None or hasattr(model, "_ssip_model_axis"):
        return model
    layout: Dict[str, Tuple] = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = tp_shard_dim(name, tuple(p.shape), axis.size)
            if dim is None:
                continue
            view, vdim = _leaf_view(model, name, p.shape, dim, axis.size)
            layout[name] = (tuple(p.shape), view, vdim)
            p.data = _narrow(p.data, view, vdim, axis.size, axis.rank).contiguous()
            owner = model.get_submodule(name.rpartition(".")[0])
            owner.tp, owner.tp_dim = axis, dim
    model._ssip_tp = layout
    model._ssip_model_axis = axis
    return model


def is_tensor_parallel(model: nn.Module) -> bool:
    return hasattr(model, "_ssip_tp")


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every tensor whole: gathered over the
    data axis under FSDP, then over the model axis (collectives: every rank
    calls it); a pipelined ViT's stages gathered
    (``parallel/pipeline.py:PipelinedViT.whole_state_dict``)."""
    from ssip_tpu_torch.parallel.fsdp import full_tensor

    if hasattr(model, "whole_state_dict"):
        return model.whole_state_dict()
    return {k: whole_tensor(model, k, full_tensor(v)) for k, v in model.state_dict().items()}


def whole_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole leaf ``name`` from this rank's slice ``t`` (a collective
    over the model axis: every rank calls it); any other tensor as it is."""
    entry = getattr(model, "_ssip_tp", {}).get(name)
    if entry is None:
        return t
    shape, view, dim = entry
    axis = model._ssip_model_axis
    local_view = list(view)
    local_view[dim] //= axis.size
    blocks = _stacked(t.detach().reshape(local_view), axis)
    return torch.cat(blocks.unbind(0), dim=dim).reshape(shape)


def local_part(model: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole leaf ``name`` (as it is for a leaf
    the model axis does not slice, or a tensor of another shape)."""
    entry = getattr(model, "_ssip_tp", {}).get(name)
    if entry is None or tuple(whole.shape) != entry[0]:
        return whole
    _, view, dim = entry
    axis = model._ssip_model_axis
    return _narrow(whole, view, dim, axis.size, axis.rank).contiguous()


def parameter_names(model: nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """The name of each parameter of ``optimizer``, in its state's index order."""
    if hasattr(model, "reshard"):  # FSDP2 leaves its root unit gathered after a forward without backward
        model.reshard()
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]
