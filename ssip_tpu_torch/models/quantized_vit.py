"""Post-training int8 quantization of the frozen ViT extractor.

Counterpart of ``ssip_tpu/models/quantized_vit.py``: ``_vit_flow`` (the one
control flow of the calibration pass and the quantized pass, ``:65-123``),
``quantize_vit_extractor`` (``:155-232``) and ``make_quantized_vit_apply``
(``:235-274``, here the ``QuantizedVisionTransformer`` module).

1. Weights quantize per output channel, symmetric int8, at four sites per
   encoder block (the fused ``qkv``, the attention ``out``, ``mlp_1``,
   ``mlp_2``) and at the patch-embedding conv; the arithmetic is float64
   numpy, as in the JAX package.
2. Activations quantize per tensor, symmetric int8, at each site's input,
   with scales calibrated from one float32 forward over real data.
3. Each site computes ``int32(x_q · W_q) · (s_x·s_w) + b``; LayerNorms,
   residual adds, GELU and attention run in float32 or ``inter_dtype``.

The quantized tree is a dict of numpy arrays in the JAX package's layout
(each site ``kernel`` int8, ``mult``, ``bias``, ``inv_in_scale``), so the two
packages' trees compare leaf for leaf and carry over either way
(``models/port.py``).

- The patch conv is 16×16 with stride 16, so on int8 it is a GEMM: NHWC
  [B, H, W, 3] → [B·(H/16)·(W/16), 16·16·3] patches in (row, column,
  channel) order against the HWIO kernel reshaped to [768, D].
- The MLP sublayer is ``ops/qmlp.py:quantized_mlp`` (the fused kernel on the
  card); LayerNorm and attention are the port's ``layer_norm`` and
  ``fused_attention_qkv``; the other three sites are ``ops/quant.py:qdense``.
- Two GELUs, as in the JAX package: calibration runs the true-erf GELU
  (``F.gelu``), the quantized pass the polynomial one inside the MLP.
- The token axis is NOT padded. The JAX int8 forward pads the stream to a
  multiple of 16 and masks the pad keys with ``kv_len`` (``:92-96, 105``);
  its calibration runs unpadded, so every per-tensor scale comes from real
  rows only. Rows are independent at every site and the pad keys are masked
  in attention, so the real rows of the padded form and this unpadded form
  agree (``tests/test_torch_quantized_vit.py``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.models.vit import VIT_CONFIGS, VisionTransformer
from ssip_tpu_torch.ops.attention import fused_attention_qkv
from ssip_tpu_torch.ops.layernorm import LN_EPS, layer_norm
from ssip_tpu_torch.ops.qmlp import quantized_mlp
from ssip_tpu_torch.ops.quant import QMAX, QuantSite, int8_matmul, qdense, quantize

SITES = ("qkv", "out", "mlp_1", "mlp_2")


def _ln(x: torch.Tensor, p: Any) -> torch.Tensor:
    """LayerNorm (eps 1e-6): float32 moments, result in ``x``'s type."""
    return layer_norm(x, p.scale, p.bias, LN_EPS)


def patches(x_nhwc: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC [B, H, W, C] → [B·(H/p)·(W/p), p·p·C], each row one patch in
    (row, column, channel) order: the rows of the HWIO kernel reshaped to
    [p·p·C, D]."""
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.reshape(b, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // patch) * (w // patch), patch * patch * c)


def _vit_flow(tree: Any, x: torch.Tensor, cfg: Mapping[str, int], *, site_fn: Callable, stem_fn: Callable,
              inter_dtype: torch.dtype, mlp_fn: Optional[Callable] = None) -> torch.Tensor:
    """The control flow both passes share, so that every calibrated scale
    belongs to exactly the tensor the int8 pass quantizes.

    ``stem_fn(x, stem)`` → float32 [B·patches, D] and ``site_fn(t, blk,
    name)`` → float32 run one dense site; ``mlp_fn(y, blk)`` takes the place
    of the ``mlp_1`` → GELU → ``mlp_2`` composition. The stream is flat
    [B·S, D], float32 up to the first residual add and ``inter_dtype`` after.
    """
    d, heads = cfg["hidden_dim"], cfg["num_heads"]
    b = x.shape[0]
    x = stem_fn(x, tree.stem).reshape(b, -1, d)
    x = torch.cat([tree.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
    x = x + tree.pos_embedding.to(x.dtype)
    s = x.shape[1]
    x = x.reshape(b * s, d)

    for blk in tree.blocks:
        y = _ln(x, blk.ln_1)
        qkv = site_fn(y, blk, "qkv")  # [M, 3D] float32
        o = fused_attention_qkv(qkv.to(inter_dtype).reshape(b, s, 3 * d), heads)
        o = site_fn(o.reshape(b * s, d), blk, "out")
        x = (x.to(torch.float32) + o).to(inter_dtype)

        y = _ln(x, blk.ln_2)
        if mlp_fn is None:
            y = site_fn(y, blk, "mlp_1")
            y = F.gelu(y)  # the true erf
            y = site_fn(y, blk, "mlp_2")
        else:
            y = mlp_fn(y, blk)
        x = (x.to(torch.float32) + y).to(inter_dtype)

    # only the class token is normalized, in float32, so the published
    # features are not rounded to inter_dtype
    return _ln(x.reshape(b, s, d)[:, 0].to(torch.float32).contiguous(), tree.ln)


def _float_tree(model: VisionTransformer) -> Dict[str, Any]:
    """The dense ViT's parameters in the JAX site layout: kernels [in, out]
    (the patch kernel HWIO) in float64, everything else float32, numpy."""

    def f32(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().to(torch.float32).numpy()

    def dense(weight: torch.Tensor, bias: torch.Tensor) -> Dict[str, np.ndarray]:
        return {"kernel": f32(weight).T.astype(np.float64), "bias": f32(bias)}

    def ln(mod: nn.Module) -> Dict[str, np.ndarray]:
        return {"scale": f32(mod.weight), "bias": f32(mod.bias)}

    blocks = []
    for blk in model.encoder.layers.values():
        att = blk.self_attention
        blocks.append({
            "ln_1": ln(blk.ln_1), "ln_2": ln(blk.ln_2),
            "qkv": dense(att.in_proj_weight, att.in_proj_bias),
            "out": dense(att.out_proj.weight, att.out_proj.bias),
            "mlp_1": dense(blk.mlp["0"].weight, blk.mlp["0"].bias),
            "mlp_2": dense(blk.mlp["3"].weight, blk.mlp["3"].bias),
        })
    return {
        "stem": {
            "kernel": f32(model.conv_proj.weight).transpose(2, 3, 1, 0).astype(np.float64),  # OIHW → HWIO
            "bias": f32(model.conv_proj.bias),
        },
        "cls_token": f32(model.class_token),
        "pos_embedding": f32(model.encoder.pos_embedding),
        "blocks": blocks,
        "ln": ln(model.encoder.ln),
    }


def quantize_vit_extractor(model: VisionTransformer, calibration_batch: torch.Tensor, arch: str = "vit_b16") -> Dict[str, Any]:
    """A dense ViT extractor and one normalized float32 [n, H, W, 3] batch →
    the int8 inference tree (numpy, the JAX package's layout).

    The calibration pass runs in float32 on the batch's device, through the
    port's LayerNorm and attention, and records the largest magnitude of
    every site's input.
    """
    cfg = VIT_CONFIGS[arch]
    f32 = _float_tree(model)
    dev = calibration_batch.device

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def ns(node: Mapping[str, np.ndarray]) -> SimpleNamespace:
        return SimpleNamespace(**{k: on_dev(v) for k, v in node.items()})

    tree = SimpleNamespace(
        stem=ns(f32["stem"]), cls_token=on_dev(f32["cls_token"]), pos_embedding=on_dev(f32["pos_embedding"]),
        blocks=[SimpleNamespace(index=i, **{k: ns(v) for k, v in blk.items()}) for i, blk in enumerate(f32["blocks"])],
        ln=ns(f32["ln"]),
    )
    maxima: Dict[int, Dict[str, float]] = {}
    stem_max = [0.0]

    def stem_cal(x, stem):
        stem_max[0] = float(x.abs().max())
        return patches(x, cfg["patch_size"]) @ stem.kernel.reshape(-1, stem.kernel.shape[-1]) + stem.bias

    def site_cal(t, blk, name):
        maxima.setdefault(blk.index, {})[name] = float(t.abs().max())
        site = getattr(blk, name)
        return t @ site.kernel + site.bias

    with torch.inference_mode():
        _vit_flow(tree, calibration_batch.to(torch.float32), cfg, site_fn=site_cal, stem_fn=stem_cal,
                  inter_dtype=torch.float32)

    def qsite(site: Mapping[str, np.ndarray], max_abs: float) -> Dict[str, np.ndarray]:
        s_x = (max_abs / QMAX) or 1.0
        k = site["kernel"]
        s_w = np.max(np.abs(k), axis=tuple(range(k.ndim - 1))) / QMAX
        s_w = np.where(s_w == 0.0, 1.0, s_w)
        return {
            "kernel": np.clip(np.rint(k / s_w), -QMAX, QMAX).astype(np.int8),
            "mult": (s_x * s_w).astype(np.float32),
            "bias": site["bias"],
            "inv_in_scale": np.float32(1.0 / s_x),
        }

    return {
        "stem": qsite(f32["stem"], stem_max[0]),
        "cls_token": f32["cls_token"],
        "pos_embedding": f32["pos_embedding"],
        "blocks": [
            {"ln_1": blk["ln_1"], "ln_2": blk["ln_2"], **{m: qsite(blk[m], maxima[i][m]) for m in SITES}}
            for i, blk in enumerate(f32["blocks"])
        ],
        "ln": f32["ln"],
    }


class _LayerNormParams(nn.Module):
    def __init__(self, node: Mapping[str, Any]):
        super().__init__()
        self.register_buffer("scale", torch.from_numpy(np.array(node["scale"], np.float32)))
        self.register_buffer("bias", torch.from_numpy(np.array(node["bias"], np.float32)))


class QuantizedBlock(nn.Module):
    """One encoder block's LayerNorm parameters and four int8 sites; the
    two MLP sites also keep the transposed kernels the fused kernel reads."""

    def __init__(self, node: Mapping[str, Any]):
        super().__init__()
        self.ln_1 = _LayerNormParams(node["ln_1"])
        self.ln_2 = _LayerNormParams(node["ln_2"])
        for name in SITES:
            setattr(self, name, QuantSite(**node[name], transposed=name.startswith("mlp")))


class QuantizedVisionTransformer(nn.Module):
    """The quantized forward: normalized NHWC float [B, H, W, 3] (or, with
    ``stem_prequantized``, the int8 operand that the preprocess kernel's
    int8 epilogue wrote with ``stem.inv_scale``) → class-token features
    [B, D] float32. Every leaf of the int8 tree is a buffer."""

    def __init__(self, arch: str, tree: Mapping[str, Any], inter_dtype: torch.dtype = torch.bfloat16,
                 stem_prequantized: bool = False):
        super().__init__()
        if arch not in VIT_CONFIGS:
            raise ValueError(f"int8 quantization covers the dense ViT archs ({', '.join(VIT_CONFIGS)}), got {arch}")
        self.cfg = VIT_CONFIGS[arch]
        self.inter_dtype = inter_dtype
        self.stem_prequantized = stem_prequantized
        self.num_features = self.cfg["hidden_dim"]
        self.stem = QuantSite(**tree["stem"])
        self.register_buffer("cls_token", torch.from_numpy(np.array(tree["cls_token"], np.float32)))
        self.register_buffer("pos_embedding", torch.from_numpy(np.array(tree["pos_embedding"], np.float32)))
        self.blocks = nn.ModuleList(QuantizedBlock(node) for node in tree["blocks"])
        self.ln = _LayerNormParams(tree["ln"])

    def _stem(self, x: torch.Tensor, stem: nn.Module) -> torch.Tensor:
        x_q = x if self.stem_prequantized else quantize(x, stem.inv_scale)
        if x_q.dtype != torch.int8:
            raise ValueError(f"a prequantized stem takes the int8 operand, got {x_q.dtype}")
        y32 = int8_matmul(patches(x_q, self.cfg["patch_size"]), stem.kernel.reshape(-1, stem.kernel.shape[-1]))
        return y32.to(torch.float32) * stem.mult + stem.bias

    @staticmethod
    def _site(t: torch.Tensor, blk: nn.Module, name: str) -> torch.Tensor:
        site = getattr(blk, name)
        return qdense(quantize(t, site.inv_scale), site)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        tokens = (x_nhwc.shape[1] // self.cfg["patch_size"]) * (x_nhwc.shape[2] // self.cfg["patch_size"]) + 1
        if x_nhwc.shape[1] % self.cfg["patch_size"] or x_nhwc.shape[2] % self.cfg["patch_size"] \
                or tokens != self.pos_embedding.shape[1]:
            raise ValueError(
                f"this model's position embedding is for {self.pos_embedding.shape[1]} tokens, "
                f"got images {tuple(x_nhwc.shape[1:3])}"
            )
        return _vit_flow(self, x_nhwc, self.cfg, site_fn=self._site, stem_fn=self._stem,
                         inter_dtype=self.inter_dtype, mlp_fn=quantized_mlp)
