"""Sequence parallelism (ring attention) for the ViT encoder.

Counterpart of ``ssip_tpu/parallel/sequence.py``: the token axis of the
encoder is split over the mesh's model axis, so each rank holds
ceil(S / m) tokens of every image and activation memory scales as S / m.
LayerNorm, the qkv, out and MLP products are per token and run on the
rank's tokens with the parameters replicated (the LayerNorm kernel on the
card); attention is a ring: each rank's K and V block goes round the axis
(``parallel/tensor.py:ring_shift``, K and V packed in one tensor, so one
chain of collectives a block) while an online softmax merges one block of
scores a tick, in float32 (plain PyTorch, as the JAX ring is plain
``jnp``):

    m' = max(m, max_k s),  c = exp(m − m'),
    l' = l·c + Σ_k exp(s − m'),  a' = a·c + exp(s − m')·V

The sequence pads to a multiple of m; padded keys are masked out of every
softmax and padded query rows come out finite (``l`` clamped) and are cut
off. The class token is token 0, on shard 0: the final LayerNorm and the
head read it there, summed over the axis from shard 0 and zeros
(``tensor.reduce``), so they compute the same thing on every rank.

Gradients: every rank's tokens give part of each block parameter's
gradient, so the module lists the block parameters as partial over the
model axis (``_ssip_model_partial``) and ``train/engine.py:sync_gradients``
sums them over it. The patch embedding's tokens are split with
``tensor.split`` (its backward sums the gradient over the axis) and the
head's input is the reduced class token, so those gradients are whole on
every rank and are not summed again.

``make_ring_attention``, ``make_sp_vit_forward``, ``make_sp_apply_fn``:
the JAX names. In PyTorch the engine's model contract is the module
(``SequenceParallelViT``), so the last two give the same module; its
parameters are the plain ViT's, under the plain names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.models.vit import EncoderBlock, VisionTransformer
from ssip_tpu_torch.parallel import tensor

_NEG_INF = -1e30  # finite, as the attention kernels' masking


def make_ring_attention(num_shards: int, seq_len: int, axis):
    """``ring_attn(q, k, v) -> o`` on this rank's token block ``[B, H, T,
    Dh]``, ``T = ceil(seq_len / num_shards)``, shard ``axis.rank`` holding
    tokens ``[rank·T, (rank + 1)·T)``; tokens past ``seq_len`` are padding."""

    def ring_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, h, t, dh = q.shape
        scale = 1.0 / math.sqrt(dh)
        q32 = q.float()
        kv = torch.stack([k, v])
        m = q32.new_full((b, h, t), _NEG_INF)
        l = q32.new_zeros((b, h, t))
        acc = torch.zeros_like(q32)
        for step in range(num_shards):
            # after ``step`` shifts this rank holds the block of rank − step
            src = (axis.rank - step) % num_shards
            valid = (src * t + torch.arange(t, device=q.device)) < seq_len
            s = torch.einsum("bhqd,bhkd->bhqk", q32, kv[0].float()) * scale
            s = torch.where(valid, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            e = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + e.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", e.to(q.dtype), kv[1]).float()
            m = m_new
            if step < num_shards - 1:  # the last block goes nowhere
                kv = tensor.ring_shift(kv, axis)
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    return ring_attn


def _block(block: EncoderBlock, x: torch.Tensor, ring_attn) -> torch.Tensor:
    """``EncoderBlock.forward`` on this rank's tokens with the attention
    core swapped for the ring (the same casts)."""
    b, t, d = x.shape
    att = block.self_attention
    heads, ct = att.num_heads, att.compute_dtype
    y = block.ln_1(x).to(ct)
    qkv = F.linear(y, att.in_proj_weight.to(ct), att.in_proj_bias.to(ct)).reshape(b, t, 3, heads, d // heads)
    o = ring_attn(*(qkv[:, :, i].transpose(1, 2) for i in range(3)))
    x = x + att.out_proj(o.transpose(1, 2).reshape(b, t, d)).to(x.dtype)
    y = F.gelu(block.mlp["0"](block.ln_2(x)))
    return x + block.mlp["3"](y).to(x.dtype)


class SequenceParallelViT(nn.Module):
    """The ViT of ``model`` with its token axis split over the mesh's model
    axis (the parameters replicated, under the plain names); the engine's
    model contract (``forward(x_nhwc, mask=None)``)."""

    embed = VisionTransformer.embed
    head = VisionTransformer.head

    def __init__(self, model: VisionTransformer, mesh):
        super().__init__()
        axis = tensor.model_axis(mesh)
        if axis is None:
            raise ValueError("a sequence-parallel ViT needs a mesh with a model axis of 2 or more ranks")
        self.axis = axis
        for name in ("patch_size", "image_size", "compute_dtype", "num_features"):
            setattr(self, name, getattr(model, name))
        self.conv_proj, self.class_token, self.encoder, self.heads = (
            model.conv_proj, model.class_token, model.encoder, model.heads)
        self._ssip_model_axis = axis
        self._ssip_model_partial = list(self.encoder.layers.parameters())

    def forward(self, x_nhwc: torch.Tensor, mask=None, return_features: bool = False):
        del mask  # no batch statistics, as the ViT
        tok = self.embed(x_nhwc)
        seq = tok.shape[1]
        m = self.axis.size
        tok = F.pad(tok, (0, 0, 0, -(-seq // m) * m - seq))
        x = tensor.split(tok, self.axis, dim=1).contiguous()
        ring_attn = make_ring_attention(m, seq, self.axis)
        for block in self.encoder.layers.values():
            x = _block(block, x, ring_attn)
        first = 1.0 if self.axis.rank == 0 else 0.0  # the class token is on shard 0
        return self.head(tensor.reduce(x[:, 0] * first, self.axis), return_features)


def make_sp_vit_forward(model: VisionTransformer, mesh) -> SequenceParallelViT:
    """``SequenceParallelViT(model, mesh)``: call it as ``forward(x,
    return_features=False)``; the batch splits over the data axis as usual."""
    return SequenceParallelViT(model, mesh)


make_sp_apply_fn = make_sp_vit_forward  # the engine's model contract is the module
