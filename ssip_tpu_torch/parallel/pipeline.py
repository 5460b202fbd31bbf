"""GPipe pipeline parallelism for the ViT encoder over the mesh's model axis.

Counterpart of ``ssip_tpu/parallel/pipeline.py``: the ``num_layers``
encoder blocks split into S stages of L/S consecutive blocks, one stage a
rank of the model axis (each rank holds and steps 1/S of the encoder's
parameters and AdamW moments); M microbatches drain through the ring in
M + S − 1 ticks, bubble fraction (S − 1)/(M + S − 1).

- ``split_stage_params``, ``merge_stage_params``, ``pp_param_shardings``:
  the JAX functions on a Flax-layout tree (nested dicts of numpy or torch
  arrays; a spec tuple stands for a ``NamedSharding``), so JAX's
  ``{"outer", "stacked"}`` tree carries over: ``merge_stage_params``, then
  ``models/port.py:state_dict_from_flax`` (``pp_state_dict_from_flax``).
- ``make_pipelined_vit_forward`` / ``make_pp_apply_fn``: a
  ``PipelinedViT`` built from a port ``VisionTransformer``: its stage's
  ``EncoderBlock``s (under their global names, so LayerNorm and the packed
  attention run as the kernels they are on the card) and the outer
  modules, replicated. In PyTorch the engine's model contract is the
  module itself, so the two JAX names give the same module.

The schedule is written out, forward and backward, rather than left to
autograd through a ring of collectives as ``jax.grad`` differentiates the
JAX ``lax.scan``: each rank's autograd engine orders its own backward, and
a collective whose backward one rank runs and another does not (a stage
that reads no incoming activation) would stall the ring. So one autograd
Function (``_GPipe``) runs the ticks: each active stage applies its blocks
to the microbatch it holds, keeping the graph, and every rank passes its
output on (``parallel/tensor.py:ring_shift_``); its backward runs the ticks
in reverse, each stage's input gradient passed back one rank. A stage
computes nothing in its bubble ticks (the JAX ring runs every stage every
tick on padding).

The outer parameters are replicated. The patch embedding runs on every
rank but only stage 0 reads it, so its gradient is summed over the axis
(``tensor.copy``); the last stage's class tokens are summed over the axis
(the other stages add zeros, ``lax.psum`` at JAX ``:211-213``) with an
identity backward (``tensor.reduce``): the final LayerNorm and the head
then compute the same thing on every rank and their gradients are not
summed again.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ssip_tpu_torch.models.vit import VisionTransformer
from ssip_tpu_torch.parallel import tensor
from ssip_tpu_torch.parallel.mesh import MODEL_AXIS


def _map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(xs):
    return torch.stack(list(xs)) if torch.is_tensor(xs[0]) else np.stack(xs)


def split_stage_params(params: Mapping, num_layers: int, num_stages: int) -> Tuple[dict, Any]:
    """A plain ViT tree → ``(outer, stacked)``: the non-block leaves, and
    every block's leaves stacked to ``[num_stages, num_layers/num_stages, …]``."""
    if num_layers % num_stages:
        raise ValueError(f"{num_layers} encoder blocks not divisible into {num_stages} stages")
    block_names = {f"block{i}" for i in range(num_layers)}
    missing = block_names - set(params)
    if missing:
        raise ValueError(f"param tree is missing encoder blocks: {sorted(missing)}")
    per = num_layers // num_stages
    blocks = [params[f"block{i}"] for i in range(num_layers)]
    stacked = _map(lambda *xs: _stack(xs).reshape(num_stages, per, *xs[0].shape), *blocks)
    return {k: v for k, v in params.items() if k not in block_names}, stacked


def merge_stage_params(outer: Mapping, stacked: Any) -> dict:
    """Inverse of ``split_stage_params``: back to the plain ViT tree."""
    first = stacked
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    num_stages, per = first.shape[0], first.shape[1]
    flat = _map(lambda a: a.reshape(num_stages * per, *a.shape[2:]), stacked)
    params = dict(outer)
    for i in range(num_stages * per):
        params[f"block{i}"] = _map(lambda a: a[i], flat)
    return params


def pp_param_shardings(pp_params: Mapping) -> dict:
    """The placement of each leaf of a ``{"outer", "stacked"}`` tree as a
    spec tuple: the stacked stage leaves shard their leading axis over the
    model axis, the outer ones replicate."""
    return {"outer": _map(lambda _: (), pp_params["outer"]),
            "stacked": _map(lambda _: (MODEL_AXIS,), pp_params["stacked"])}


def pp_state_dict_from_flax(pp_params: Mapping) -> dict:
    """A JAX ``{"outer", "stacked"}`` tree as the plain ViT's torch state dict."""
    from ssip_tpu_torch.models.port import state_dict_from_flax

    return state_dict_from_flax({"params": merge_stage_params(pp_params["outer"], pp_params["stacked"])})


# -- the schedule ------------------------------------------------------------

def _run_ticks(stage_fn, mbs: torch.Tensor, axis, keep: bool):
    """The forward ticks on this rank: (the class tokens of the last stage's
    outputs [M, mb, D], zeros on the others; the (input, output) of each
    microbatch this stage ran, with their graphs when ``keep``)."""
    m, s, stage = mbs.shape[0], axis.size, axis.rank
    cls = mbs.new_zeros((m, mbs.shape[1], mbs.shape[3]))
    ran: List[Tuple[torch.Tensor, torch.Tensor]] = []
    buf = None
    for t in range(m + s - 1):
        j = t - stage
        send = None
        if 0 <= j < m:
            inp = (mbs[j] if stage == 0 else buf).detach()
            with torch.set_grad_enabled(keep):
                if keep:
                    inp.requires_grad_(True)
                y = stage_fn(inp)
            ran.append((inp, y))
            send = y.detach()
            if stage == s - 1:
                cls[j] = send[:, 0]
        if t < m + s - 2:  # the last tick's output goes nowhere
            buf = tensor.ring_shift_(send if send is not None else mbs.new_zeros(mbs.shape[1:]), axis, 1)
    return cls, ran


class _GPipe(torch.autograd.Function):
    """``(mbs, module, *stage params) → class tokens [M, mb, D]`` (the last
    stage's, on every rank); the backward runs the ticks in reverse."""

    @staticmethod
    def forward(ctx, mbs, module, *params):
        cls, ran = _run_ticks(module.run_stage, mbs, module.axis, keep=True)
        ctx.ran, ctx.module, ctx.params, ctx.mbs_shape, ctx.like = ran, module, params, mbs.shape, mbs[0]
        return tensor._all_reduce(cls, module.axis)

    @staticmethod
    def backward(ctx, grad_cls):
        axis = ctx.module.axis
        m, s, stage = ctx.mbs_shape[0], axis.size, axis.rank
        trainable = [p for p in ctx.params if p.requires_grad]
        grads = [torch.zeros_like(p) for p in trainable]
        grad_mbs = ctx.like.new_zeros(ctx.mbs_shape)
        buf = None
        for u in range(m + s - 1):
            j = (m - 1) - (u - (s - 1 - stage))  # the microbatch this stage runs at reverse tick u
            send = None
            if 0 <= j < m:
                inp, y = ctx.ran[j]
                if stage == s - 1:
                    g = torch.zeros_like(y)
                    g[:, 0] = grad_cls[j].to(y.dtype)
                else:
                    g = buf
                got = torch.autograd.grad(y, [inp, *trainable], g, allow_unused=True)
                for acc, gp in zip(grads, got[1:]):
                    if gp is not None:
                        acc.add_(gp)
                send = got[0]
                if stage == 0:
                    grad_mbs[j] = send
            if u < m + s - 2:
                buf = tensor.ring_shift_(send if send is not None else torch.zeros_like(ctx.like), axis, -1)
        by_param = {id(p): g for p, g in zip(trainable, grads)}
        ctx.ran = ctx.like = None
        return (grad_mbs, None, *(by_param.get(id(p)) for p in ctx.params))


class PipelinedViT(nn.Module):
    """The ViT of ``model`` pipelined over the mesh's model axis: this
    rank's stage of ``num_layers / S`` blocks and the outer modules; the
    engine's model contract (``forward(x_nhwc, mask=None)``)."""

    embed = VisionTransformer.embed
    head = VisionTransformer.head

    def __init__(self, model: VisionTransformer, mesh, num_microbatches: int):
        super().__init__()
        axis = tensor.model_axis(mesh)
        if axis is None:
            raise ValueError("a pipelined ViT needs a mesh with a model axis of 2 or more ranks")
        layers = list(model.encoder.layers.items())
        if len(layers) % axis.size:
            raise ValueError(f"{len(layers)} layers not divisible by {axis.size} stages")
        per = len(layers) // axis.size
        self.axis, self.num_microbatches, self.per_stage = axis, num_microbatches, per
        for name in ("patch_size", "image_size", "compute_dtype", "num_features"):
            setattr(self, name, getattr(model, name))
        self.conv_proj, self.class_token, self.heads = model.conv_proj, model.class_token, model.heads
        self.encoder = nn.Module()
        self.encoder.pos_embedding, self.encoder.ln = model.encoder.pos_embedding, model.encoder.ln
        self.encoder.layers = nn.ModuleDict(layers[axis.rank * per : (axis.rank + 1) * per])
        self._ssip_model_axis = axis

    def run_stage(self, h: torch.Tensor) -> torch.Tensor:
        for block in self.encoder.layers.values():
            h = block(h)
        return h

    def forward(self, x_nhwc: torch.Tensor, mask=None, return_features: bool = False):
        del mask  # no batch statistics, as the ViT
        tok = self.embed(x_nhwc)
        b, t, d = tok.shape
        m = self.num_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible into {m} microbatches")
        mbs = tok.reshape(m, b // m, t, d)
        stage_params = list(self.encoder.layers.parameters())
        if torch.is_grad_enabled() and (tok.requires_grad or any(p.requires_grad for p in stage_params)):
            cls = _GPipe.apply(tensor.copy(mbs, self.axis), self, *stage_params)
        else:
            cls = tensor._all_reduce(_run_ticks(self.run_stage, mbs, self.axis, keep=False)[0], self.axis)
        return self.head(cls.reshape(b, d), return_features)

    def whole_state_dict(self) -> dict:
        """The plain ViT's state dict (a collective)."""
        return self.gather_stages(self.state_dict())

    def gather_stages(self, tensors: dict) -> dict:
        """``tensors`` (this rank's, by state-dict name: its values, or its
        gradients) with every stage's blocks gathered over the axis under
        their global names (a collective)."""
        out = {}
        for k, v in tensors.items():
            parts = k.split(".")
            if parts[:2] != ["encoder", "layers"]:
                out[k] = v
                continue
            index = int(parts[2].rsplit("_", 1)[1]) - self.axis.rank * self.per_stage
            for stage, value in enumerate(tensor._stacked(v.detach(), self.axis).unbind(0)):
                out[".".join(["encoder", "layers", f"encoder_layer_{stage * self.per_stage + index}", *parts[3:]])] = value
        return out


def make_pipelined_vit_forward(model: VisionTransformer, mesh, num_microbatches: int) -> PipelinedViT:
    """``PipelinedViT(model, mesh, num_microbatches)``: call it as
    ``forward(x, return_features=False)``. The local batch must divide
    into ``num_microbatches``."""
    return PipelinedViT(model, mesh, num_microbatches)


make_pp_apply_fn = make_pipelined_vit_forward  # the engine's model contract is the module
