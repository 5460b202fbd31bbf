"""Mixture-of-Experts ViT in PyTorch: top-k and expert-choice routing.

Counterpart of ``ssip_tpu/models/moe.py``: ``MoEMlp``, ``MoEEncoderBlock``,
``MoEVisionTransformer``, ``MOE_CONFIGS`` and the factories with their
``num_experts`` override. The tower is the port's ViT (``models/vit.py``)
with every ``moe_every``-th encoder block's MLP swapped for the expert
layer; the attention half of an expert block is the dense block's
(``ln_1`` → ``SelfAttention`` → ``ln_2``), so on the card it runs the
LayerNorm and attention kernels as the dense ViT does.

- Routing is the JAX module's, step for step: a float32 router (a plain
  ``nn.Linear`` whose weights are never cast to the compute type), the
  softmax over its logits, then either token choice (top-1 Switch gates or
  top-2 GShard gates renormalized over the pair; capacity
  ``C = ceil(S·K·cf/E)``, slots by a cumulative sum over pseudo-tokens
  ``s·K + r`` so a token's rank 1 comes before its rank 2, assignments past
  an expert's capacity dropped) or expert choice (each expert takes its
  top ``ceil(S·cf/E)`` tokens by router probability).
- Top-k takes the lower index first on ties, as ``jax.lax.top_k`` does:
  ``torch.topk`` promises no order among equal values, so the selection is
  a stable descending sort.
- The dispatch, expert MLP and return are ``torch.einsum`` on dense
  one-hot tensors (the JAX module leaves them to XLA too), with the
  dispatch and combine tensors cast to the compute type before the
  products, so in bfloat16 the gate is rounded as it is there. GELU is the
  exact erf form.
- Auxiliary losses: a train-mode forward leaves each expert layer's
  coefficient-scaled terms (``load_balance`` for token choice, ``router_z``
  when its coefficient is set) in that layer's ``aux``, and
  ``MoEVisionTransformer.aux_losses()`` lists them; an eval-mode forward
  leaves none. The training steps add them to the loss
  (``train/engine.py``, ``train/consistency.py``). ``mask`` is accepted and
  ignored, as in the JAX module, so padded rows count in the balance loss.
  Inside ``parallel.distributed.synced_batch(group)`` (a data-parallel
  step) ``f_e`` is the global batch's and each rank's terms are its share
  of the global ones: summed over the ranks they are the JAX step's terms
  over the sharded batch, and so are their gradients.

Expert parallelism (``--mesh-model``, ``parallel/tensor.py:shard_model``):
each rank of the model axis holds ``E / model`` experts (the expert
leaves sliced on ``[E]``) and the router whole. The routing, the capacity
(of the global E) and the auxiliary terms are computed whole on every
rank; each rank runs its experts on its slice of the dispatch and the
partial combines are reduced. The model ranks hold the same rows, so this
is an all-reduce, not an all-to-all.

Parameter names are the port's own (no torchvision topology exists for an
MoE): the dense blocks carry the ViT's torchvision names, an expert block
``encoder.layers.encoder_layer_{i}.moe.{router.weight, router.bias, w_in,
b_in, w_out, b_out}`` with the expert axis leading, as the Flax tree's
``block{i}/moe/...`` (``models/port.py`` carries one to the other).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.models.vit import LayerNorm, SelfAttention, VisionTransformer
from ssip_tpu_torch.parallel import tensor
from ssip_tpu_torch.parallel.distributed import sync_group

ROUTINGS = ("token_choice", "expert_choice")


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` over a new last axis of ``n``."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(torch.float32)


def top_k_lower_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, in
    descending order, equal values by ascending index (``jax.lax.top_k``)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class MoEMlp(nn.Module):
    """Routed expert MLP over tokens ``[B, S, D] -> [B, S, D]``."""

    tp = None  # the model axis, set by parallel/tensor.py:shard_model

    def __init__(
        self,
        hidden_dim: int,
        mlp_dim: int,
        num_experts: int,
        capacity_factor: float = 1.25,
        aux_loss_coef: float = 0.01,
        router_top_k: int = 1,
        routing: str = "token_choice",
        router_z_loss_coef: float = 0.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_coef = aux_loss_coef
        self.router_top_k = router_top_k
        self.routing = routing
        self.router_z_loss_coef = router_z_loss_coef
        self.compute_dtype = compute_dtype
        e = num_experts
        self.router = nn.Linear(hidden_dim, e)
        self.w_in = nn.Parameter(torch.randn(e, hidden_dim, mlp_dim) * hidden_dim**-0.5)
        self.b_in = nn.Parameter(torch.zeros(e, mlp_dim))
        self.w_out = nn.Parameter(torch.randn(e, mlp_dim, hidden_dim) * mlp_dim**-0.5)
        self.b_out = nn.Parameter(torch.zeros(e, hidden_dim))
        self.aux: Dict[str, torch.Tensor] = {}

    def _expert_ffn(self, xe: torch.Tensor) -> torch.Tensor:
        """Batched per-expert MLP on dispatched slots ``[E, B, C, D]``."""
        ct = self.compute_dtype
        h = torch.einsum("ebcd,edf->ebcf", xe, self.w_in.to(ct))
        h = F.gelu(h + self.b_in[:, None, None, :].to(ct))
        out_e = torch.einsum("ebcf,efd->ebcd", h, self.w_out.to(ct))
        return out_e + self.b_out[:, None, None, :].to(ct)

    def _local(self, y: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor, dim: int):
        """(tokens, dispatch, combine) of this rank's experts (axis ``dim``
        of the dispatch); all three whole without a model axis."""
        if self.tp is None:
            return y, dispatch, combine
        n = self.w_in.shape[0]
        lo = self.tp.rank * n
        return (tensor.copy(y, self.tp), dispatch.narrow(dim, lo, n),
                tensor.copy(combine, self.tp).narrow(dim, lo, n))

    def _reduced(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.tp is None else tensor.reduce(out, self.tp)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        b, s, d = y.shape
        e, k = self.num_experts, self.router_top_k
        if not 1 <= k <= e:
            raise ValueError(f"router_top_k={k} must be in [1, {e}]")
        if self.routing not in ROUTINGS:
            raise ValueError(f"unknown MoE routing {self.routing!r}")
        cap = max(1, math.ceil(s * k * self.capacity_factor / e))
        ct = self.compute_dtype
        aux: Dict[str, torch.Tensor] = {}

        # the router in float32: the softmax must not see bf16 rounding
        logits = F.linear(y.to(torch.float32), self.router.weight, self.router.bias)  # [B, S, E]
        probs = torch.softmax(logits, dim=-1)
        group = sync_group()
        if group is not None:
            # data parallel: a rank's term is its share of the global batch's,
            # the shares summing to the term over all ranks' tokens
            tokens = float(b * s * dist.get_world_size(group))
        if self.router_z_loss_coef > 0.0:
            z = torch.logsumexp(logits, dim=-1)
            z2 = torch.square(z)
            aux["router_z"] = self.router_z_loss_coef * (
                torch.mean(z2) if group is None else z2.sum() / tokens)

        if self.routing == "expert_choice":
            cap_ec = min(s, max(1, math.ceil(s * self.capacity_factor / e)))
            gates_ec, tok_idx = top_k_lower_index_first(probs.transpose(1, 2), cap_ec)  # [B, E, C]
            dispatch = _one_hot(tok_idx, s)  # [B, E, C, S]
            combine = dispatch * gates_ec[..., None]
            y_e, dispatch, combine = self._local(y, dispatch, combine, 1)
            xe = torch.einsum("becs,bsd->ebcd", dispatch.to(ct), y_e.to(ct))
            out = self._reduced(torch.einsum("ebcd,becs->bsd", self._expert_ffn(xe), combine.to(ct)))
        else:
            top_probs, top_idx = top_k_lower_index_first(probs, k)  # [B, S, K]
            # Switch: the argmax expert's raw probability; GShard: the pair renormalized
            gate = top_probs if k == 1 else top_probs / top_probs.sum(dim=-1, keepdim=True)
            onehot = _one_hot(top_idx, e)  # [B, S, K, E]
            # load balance before the capacity drops: f_e over all K ranks, P_e
            if group is None:
                frac = onehot.sum(dim=2).mean(dim=(0, 1))
                mean_prob = probs.mean(dim=(0, 1))
            else:  # f_e of the global batch (no gradient), P_e this rank's share
                frac = onehot.sum(dim=(0, 1, 2))
                dist.all_reduce(frac, group=group)
                frac = frac / tokens
                mean_prob = probs.sum(dim=(0, 1)) / tokens
            aux["load_balance"] = self.aux_loss_coef * (e / k) * torch.sum(frac * mean_prob)

            sk = s * k
            onehot = onehot.reshape(b, sk, e)
            gate = gate.reshape(b, sk)
            pos = torch.cumsum(onehot, dim=1) * onehot  # [B, S·K, E], 1-indexed queue positions
            kept = onehot * (pos <= cap)
            slot_oh = _one_hot((pos - 1.0).clamp(min=0).to(torch.int64), cap)  # [B, S·K, E, C]
            dispatch = kept[..., None] * slot_oh
            combine = dispatch * gate[..., None, None]
            y_rep = torch.repeat_interleave(y, k, dim=1) if k > 1 else y
            y_rep, dispatch, combine = self._local(y_rep, dispatch, combine, 2)
            xe = torch.einsum("btec,btd->ebcd", dispatch.to(ct), y_rep.to(ct))
            out = self._reduced(torch.einsum("ebcd,btec->btd", self._expert_ffn(xe), combine.to(ct)))
            if k > 1:
                out = out.reshape(b, s, k, d).sum(dim=2)
        self.aux = aux if self.training else {}
        return out


class MoEEncoderBlock(nn.Module):
    """The dense block's attention half, then ``MoEMlp`` in place of the MLP."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, compute_dtype: torch.dtype, **moe_kwargs):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim)
        self.self_attention = SelfAttention(hidden_dim, num_heads, compute_dtype)
        self.ln_2 = LayerNorm(hidden_dim)
        self.moe = MoEMlp(hidden_dim, mlp_dim, compute_dtype=compute_dtype, **moe_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.ln_1(x)).to(x.dtype)
        return x + self.moe(self.ln_2(x).to(self.moe.compute_dtype)).to(x.dtype)


class MoEVisionTransformer(VisionTransformer):
    """The ViT tower with block ``i`` an expert block where
    ``i % moe_every == moe_every - 1``; same call contract as the ViT."""

    def __init__(
        self,
        patch_size: int = 16,
        hidden_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        num_experts: int = 8,
        capacity_factor: float = 1.25,
        aux_loss_coef: float = 0.01,
        router_top_k: int = 1,
        routing: str = "token_choice",
        router_z_loss_coef: float = 0.0,
        moe_every: int = 2,
        num_classes: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
        image_size: int = 224,
    ):
        super().__init__(patch_size, hidden_dim, num_layers, num_heads, mlp_dim, num_classes, compute_dtype, remat,
                         image_size)
        self.moe_every = moe_every
        moe_kwargs = dict(num_experts=num_experts, capacity_factor=capacity_factor, aux_loss_coef=aux_loss_coef,
                          router_top_k=router_top_k, routing=routing, router_z_loss_coef=router_z_loss_coef)
        for i in range(num_layers):
            if i % moe_every == moe_every - 1:
                self.encoder.layers[f"encoder_layer_{i}"] = MoEEncoderBlock(
                    hidden_dim, num_heads, mlp_dim, compute_dtype, **moe_kwargs
                )

    def moe_layers(self) -> List[MoEMlp]:
        return [m for m in self.modules() if isinstance(m, MoEMlp)]

    def aux_losses(self) -> List[torch.Tensor]:
        """The last train-mode forward's auxiliary terms, block by block
        (none after an eval-mode forward)."""
        return [term for layer in self.moe_layers() for _, term in sorted(layer.aux.items())]


# V-MoE's small-scale recipe (8 experts, every other block) on the dense
# s16/t16 towers
MOE_CONFIGS = {
    "vit_moe_s16": dict(patch_size=16, hidden_dim=384, num_layers=12, num_heads=6, mlp_dim=1536, num_experts=8),
    "vit_moe_t16": dict(patch_size=16, hidden_dim=192, num_layers=12, num_heads=3, mlp_dim=768, num_experts=8),
}


def build_moe(
    arch: str,
    num_classes: Optional[int] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    image_size: int = 224,
    num_experts: Optional[int] = None,
) -> MoEVisionTransformer:
    """``--arch vit_moe_t16|vit_moe_s16`` → module; ``num_experts``
    overrides the config's 8 (the expert-count axis, as the JAX factory)."""
    if arch not in MOE_CONFIGS:
        raise ValueError(f"--arch {arch} is not an MoE arch; those are: " + ", ".join(MOE_CONFIGS))
    kw = dict(MOE_CONFIGS[arch])
    if num_experts is not None:
        kw["num_experts"] = num_experts
    return MoEVisionTransformer(num_classes=num_classes, compute_dtype=compute_dtype, remat=remat,
                                image_size=image_size, **kw)
