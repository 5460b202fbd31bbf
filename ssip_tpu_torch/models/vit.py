"""torchvision-topology Vision Transformer in PyTorch, eval and train forward.

Counterpart of ``ssip_tpu/models/vit.py``: ``VIT_CONFIGS``, ``EncoderBlock``,
``VisionTransformer`` and ``build_vit``, with torchvision's parameter names
(``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_3.self_attention.in_proj_weight``,
``heads.head.weight``, …) so a torchvision ``vit_b_16`` state_dict loads with
``load_state_dict``:

    conv_proj (patch conv, bias) → prepend class token → + pos_embedding
    → N × [ln_1 → attention → +res → ln_2 → Linear/GELU(exact)/Linear → +res]
    → final ln of the class token → features → head

- ``forward`` takes NHWC like the Flax module and the port's ResNet;
  ``mask`` is accepted and ignored (LayerNorm is per sample, so padded batch
  rows cannot touch real ones).
- Types as in the JAX package (``vit.py:26-27``): parameters float32; the
  token stream, the Dense layers and the residual adds in the compute type
  (explicit casts, not autocast, so CPU tests compare bfloat16 runs too);
  LayerNorm moments in float32 (``ops/layernorm.py``); the final LayerNorm
  and the head on a float32 class token, and only that token is normalized.
- LayerNorm and the attention core are the hand-written kernels of
  ``ops/layernorm.py`` and ``ops/attention.py`` on the card; the Dense
  layers, the patch convolution and GELU are plain PyTorch (cuBLAS and
  cuDNN on the card), as the JAX package left them to XLA.
- The token axis is NOT padded to a multiple of 16 here. The JAX package
  pads it (``vit.py:70-75``, ``:197-201``) for the TPU's sublane tile; rows
  are hidden_dim wide, so 16-byte loads need no such pad on the card, and
  the real rows of the padded form equal the unpadded math to rounding.
  The kernels' ``kv_len`` mask is still part of their function.
- ``remat`` wraps each block in ``torch.utils.checkpoint`` while gradients
  are recorded (``nn.remat`` in Flax, ``vit.py:203``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssip_tpu_torch.ops.attention import fused_attention_qkv
from ssip_tpu_torch.ops.layernorm import LN_EPS, layer_norm

# (hidden, layers, heads, mlp). b16 is torchvision vit_b_16; s16/t16 follow
# the ViT-S/Ti recipe with the same 64-wide heads.
VIT_CONFIGS = {
    "vit_b16": dict(patch_size=16, hidden_dim=768, num_layers=12, num_heads=12, mlp_dim=3072),
    "vit_s16": dict(patch_size=16, hidden_dim=384, num_layers=12, num_heads=6, mlp_dim=1536),
    "vit_t16": dict(patch_size=16, hidden_dim=192, num_layers=12, num_heads=3, mlp_dim=768),
}


class LayerNorm(nn.Module):
    """``weight``/``bias`` float32 [D]; the output keeps the input's type."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, LN_EPS)


class Dense(nn.Linear):
    """Linear whose input, kernel and bias are cast to the compute type
    (``nn.Dense(dtype=…)`` in Flax); the parameters stay float32."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class SelfAttention(nn.Module):
    """The fused qkv projection (``in_proj_weight`` [3·D, D], rows ordered
    [3, H, Dh]), the attention core and ``out_proj``."""

    def __init__(self, hidden_dim: int, num_heads: int, compute_dtype: torch.dtype):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden dim {hidden_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_dim, hidden_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_dim))
        self.out_proj = Dense(hidden_dim, hidden_dim, compute_dtype)
        nn.init.normal_(self.in_proj_weight, std=hidden_dim**-0.5)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        qkv = F.linear(y.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        # the packed qkv goes straight into the attention kernel: the
        # per-head column slicing happens inside it
        return self.out_proj(fused_attention_qkv(qkv, self.num_heads))


class EncoderBlock(nn.Module):
    """Pre-norm transformer encoder block on a [B, S, D] stream."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim)
        self.self_attention = SelfAttention(hidden_dim, num_heads, compute_dtype)
        self.ln_2 = LayerNorm(hidden_dim)
        # torchvision's MLPBlock is Sequential(Linear, GELU, Dropout, Linear,
        # Dropout): its Linears are entries 0 and 3
        self.mlp = nn.ModuleDict({
            "0": Dense(hidden_dim, mlp_dim, compute_dtype),
            "3": Dense(mlp_dim, hidden_dim, compute_dtype),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attention(self.ln_1(x)).to(x.dtype)
        y = F.gelu(self.mlp["0"](self.ln_2(x)))  # the exact erf form, torch's nn.GELU default
        return x + self.mlp["3"](y).to(x.dtype)


class Encoder(nn.Module):
    def __init__(self, seq_length: int, hidden_dim: int, num_layers: int, num_heads: int,
                 mlp_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim).normal_(std=0.02))
        self.layers = nn.ModuleDict({
            f"encoder_layer_{i}": EncoderBlock(hidden_dim, num_heads, mlp_dim, compute_dtype)
            for i in range(num_layers)
        })
        self.ln = LayerNorm(hidden_dim)


class VisionTransformer(nn.Module):
    """``num_classes=None`` is the feature extractor (the final-LayerNorm
    class token, ``hidden_dim``-D, float32); otherwise ``heads.head`` maps
    it to logits. The position embedding fixes ``image_size``."""

    def __init__(
        self,
        patch_size: int = 16,
        hidden_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        num_classes: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
        image_size: int = 224,
    ):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} not divisible by patch size {patch_size}")
        self.patch_size = patch_size
        self.image_size = image_size
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.num_features = hidden_dim
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + 1
        self.encoder = Encoder(seq_length, hidden_dim, num_layers, num_heads, mlp_dim, compute_dtype)
        self.heads = None if num_classes is None else nn.ModuleDict({"head": nn.Linear(hidden_dim, num_classes)})

    def forward(
        self, x_nhwc: torch.Tensor, mask: Optional[torch.Tensor] = None, return_features: bool = False
    ):
        del mask  # no batch statistics: padded rows cannot touch real ones
        b, h, w, _ = x_nhwc.shape
        if h != self.image_size or w != self.image_size:
            raise ValueError(
                f"this model's position embedding is for {self.image_size}x{self.image_size} "
                f"images, got {h}x{w}"
            )
        dt = self.compute_dtype
        x = F.conv2d(
            x_nhwc.permute(0, 3, 1, 2).to(dt),  # channels_last NCHW view
            self.conv_proj.weight.to(dt), self.conv_proj.bias.to(dt), stride=self.patch_size,
        )
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.num_features)  # [B, tokens, D], row-major patches
        x = torch.cat([self.class_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = x + self.encoder.pos_embedding.to(dt)

        remat = self.remat and torch.is_grad_enabled()
        for block in self.encoder.layers.values():
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)

        # LayerNorm is per row, so normalizing only the class token equals
        # torchvision's normalize-then-slice at 1/tokens of the work
        features = self.encoder.ln(x[:, 0].to(torch.float32).contiguous())
        if self.heads is None:
            return features
        logits = self.heads["head"](features)
        return (logits, features) if return_features else logits


def build_vit(
    arch: str,
    num_classes: Optional[int] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    image_size: int = 224,
) -> VisionTransformer:
    """``--arch vit_t16|vit_s16|vit_b16`` → module."""
    if arch not in VIT_CONFIGS:
        raise ValueError(f"--arch {arch} is not a dense ViT arch; those are: " + ", ".join(VIT_CONFIGS))
    return VisionTransformer(
        num_classes=num_classes, compute_dtype=compute_dtype, remat=remat,
        image_size=image_size, **VIT_CONFIGS[arch],
    )
