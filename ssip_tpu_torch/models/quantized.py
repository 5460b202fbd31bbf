"""Post-training int8 quantization of the frozen ResNet extractor.

Counterpart of ``ssip_tpu/models/quantized.py``: ``fold_f32_extractor``,
``calibrate_act_scales``, ``quantize_extractor``, ``_quant``, ``_qconv_raw``,
``_qconv``, ``_requant`` and ``make_quantized_apply`` (here also the
``QuantizedResNet`` module).

1. BN folds into each conv (``models/inference.py``, float64 on the host);
2. folded weights quantize per output channel, symmetric int8
   (``s_w[o] = max|W[..., o]| / 127``);
3. activations quantize per tensor, symmetric int8, at each conv input, with
   scales calibrated from one float32 forward over real data;
4. each conv site computes ``int32(conv(x_q, W_q))·(s_x·s_w) + b``; residual
   adds and ReLU run in float32, block outputs are stored as ``inter_dtype``
   (bf16 by default), and the tensor between two convs of a block never
   leaves int8 (``_requant``: dequantize → ReLU → quantize for the next
   site, from the float32 affine).

The quantized tree is a dict of numpy arrays in the JAX package's layout
(each site ``kernel`` int8 HWIO, ``mult`` float32 [O], ``bias`` float32 [O],
``inv_in_scale`` float32 scalar), so the two packages' trees compare leaf for
leaf and carry over either way (``models/port.py``).

The int8 convolution (an XLA conv with int32 results in the JAX package, not
a Pallas kernel) is im2col and a library product here:
``ops/quant.py:int8_matmul`` (``torch._int_mm`` on both devices), exact in
int32. The patches are taken in (row, column, channel) order, the order of
the HWIO kernel reshaped to [kh·kw·C, O]; the inner size is zero-padded to a
multiple of 8, as cuBLASLt wants (the stem's 7·7·3 = 147 becomes 152), which
adds zero products only.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.models.inference import (
    block_strides, conv_nhwc, fold_resnet_extractor, max_pool,
)
from ssip_tpu_torch.models.resnet import RESNET18_STAGES
from ssip_tpu_torch.ops.quant import QMAX, int8_matmul, quantize

_K_MULTIPLE = 8  # cuBLASLt's int8 product wants inner sizes that are multiples of 8


def fold_f32_extractor(
    model: nn.Module | Mapping[str, Any],
    stage_sizes: Sequence[int] = RESNET18_STAGES,
    bottleneck: bool = False,
) -> Dict[str, Any]:
    """The BN-folded float32 tree (numpy, HWIO), without the s2d stem."""
    return fold_resnet_extractor(model, stage_sizes, bottleneck, stem_s2d=False)


def site_names(block: Mapping[str, Any]) -> List[str]:
    names = [c for c in ("conv1", "conv2", "conv3") if c in block]
    if "downsample" in block:
        names.append("downsample")
    return names


@contextmanager
def _true_float32():
    """cuDNN convolutions and cuBLAS products in true float32 inside the
    block (TF32 would move the calibrated maxima); the caller's settings
    put back after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def calibrate_act_scales(
    folded: Dict[str, Any],
    x: torch.Tensor,
    stage_sizes: Sequence[int] = RESNET18_STAGES,
    bottleneck: bool = False,
) -> Dict[str, Any]:
    """Per-conv-site input scales (max|x|/127, 1 where the input is all
    zero) from one float32 forward on ``x``'s device, in the control flow of
    the quantized forward. Returns ``{"stem": s, "blocks": [{site: s}]}`` of
    Python floats."""
    f32 = torch.float32
    x = x.to(f32)

    def scale(t: torch.Tensor) -> float:
        return float(t.abs().max()) / QMAX or 1.0

    def conv(t, site, stride):
        return conv_nhwc(t, site["kernel"], site["bias"], stride, f32)

    with torch.inference_mode(), _true_float32():
        scales: Dict[str, Any] = {"stem": scale(x), "blocks": []}
        x = max_pool(F.relu(conv(x, folded["stem"], 2)))
        for block, stride in zip(folded["blocks"], block_strides(stage_sizes)):
            s: Dict[str, float] = {"conv1": scale(x)}
            identity = x
            if bottleneck:
                y = F.relu(conv(x, block["conv1"], 1))
                s["conv2"] = scale(y)
                y = F.relu(conv(y, block["conv2"], stride))
                s["conv3"] = scale(y)
                y = conv(y, block["conv3"], 1)
            else:
                y = F.relu(conv(x, block["conv1"], stride))
                s["conv2"] = scale(y)
                y = conv(y, block["conv2"], 1)
            if "downsample" in block:
                s["downsample"] = s["conv1"]  # the same input tensor as conv1
                identity = conv(x, block["downsample"], stride)
            x = F.relu(y + identity)
            scales["blocks"].append(s)
    return scales


def quantize_extractor(
    model: nn.Module | Mapping[str, Any],
    calibration_batch: torch.Tensor,
    stage_sizes: Sequence[int] = RESNET18_STAGES,
    bottleneck: bool = False,
) -> Dict[str, Any]:
    """A ResNet (module or state_dict) and one normalized float32
    [n, H, W, 3] batch → the int8 inference tree (numpy, the JAX layout)."""
    folded = fold_f32_extractor(model, stage_sizes, bottleneck)
    scales = calibrate_act_scales(folded, calibration_batch, stage_sizes, bottleneck)

    def qsite(site: Mapping[str, np.ndarray], s_x: float) -> Dict[str, Any]:
        k = np.asarray(site["kernel"], np.float64)
        s_w = np.max(np.abs(k), axis=(0, 1, 2)) / QMAX
        s_w = np.where(s_w == 0.0, 1.0, s_w)
        return {
            "kernel": np.clip(np.rint(k / s_w), -QMAX, QMAX).astype(np.int8),
            "mult": (s_x * s_w).astype(np.float32),
            "bias": np.asarray(site["bias"], np.float32),
            "inv_in_scale": np.float32(1.0 / s_x),
        }

    return {
        "stem": qsite(folded["stem"], scales["stem"]),
        "blocks": [
            {name: qsite(block[name], s[name]) for name in site_names(block)}
            for block, s in zip(folded["blocks"], scales["blocks"])
        ],
    }


class QuantConv(nn.Module):
    """One int8 conv site. Buffers: ``gemm`` (the HWIO kernel reshaped to
    [kh·kw·C, O], zero rows appended up to a multiple of 8), ``mult``,
    ``bias`` and ``inv_in_scale``; ``inv_scale`` is the same scale as a
    Python float, a launch-free operand. The HWIO kernel is kept once, in
    ``gemm``; ``leaves()`` gives it back."""

    def __init__(self, kernel: Any, mult: Any, bias: Any, inv_in_scale: Any):
        super().__init__()
        kernel = np.asarray(kernel)
        if kernel.dtype != np.int8 or kernel.ndim != 4:
            raise ValueError(f"a quantized conv kernel must be int8 HWIO, got {kernel.dtype} {kernel.shape}")
        kh, kw, cin, out = kernel.shape
        mult, bias = np.asarray(mult, np.float32), np.asarray(bias, np.float32)
        if mult.shape != (out,) or bias.shape != (out,):
            raise ValueError(f"mult and bias must be [{out}], got {mult.shape} and {bias.shape}")
        self.kh, self.kw, self.cin = kh, kw, cin
        k = kh * kw * cin
        gemm = np.zeros((-(-k // _K_MULTIPLE) * _K_MULTIPLE, out), np.int8)
        gemm[:k] = kernel.reshape(k, out)
        inv = np.float32(inv_in_scale)
        self.inv_scale = float(inv)
        self.register_buffer("gemm", torch.from_numpy(gemm))
        self.register_buffer("mult", torch.from_numpy(mult.copy()))
        self.register_buffer("bias", torch.from_numpy(bias.copy()))
        self.register_buffer("inv_in_scale", torch.tensor(inv, dtype=torch.float32))

    def leaves(self) -> Dict[str, np.ndarray]:
        """The site as the JAX tree holds it (numpy arrays)."""
        k = self.kh * self.kw * self.cin
        kernel = self.gemm[:k].cpu().numpy().reshape(self.kh, self.kw, self.cin, -1)
        return {
            "kernel": kernel, "mult": self.mult.cpu().numpy(), "bias": self.bias.cpu().numpy(),
            "inv_in_scale": np.float32(self.inv_scale),
        }


def im2col(x_q: torch.Tensor, kh: int, kw: int, stride: int, pad: int, cols: int):
    """int8 NHWC [B, H, W, C] → ([B·OH·OW, cols], (OH, OW)): each row one
    output position's window in (row, column, channel) order, zero-padded by
    ``pad`` each side and by zero columns up to ``cols``."""
    if pad:
        x_q = F.pad(x_q, (0, 0, pad, pad, pad, pad))
    b, _, _, c = x_q.shape
    win = x_q.unfold(1, kh, stride).unfold(2, kw, stride)  # [B, OH, OW, C, kh, kw], a view
    oh, ow = win.shape[1], win.shape[2]
    win = win.permute(0, 1, 2, 4, 5, 3)  # [B, OH, OW, kh, kw, C]
    k = kh * kw * c
    if cols == k:
        return win.reshape(b * oh * ow, k), (oh, ow)
    out = x_q.new_empty((b * oh * ow, cols))
    out[:, k:] = 0
    out[:, :k].view(b, oh, ow, kh, kw, c).copy_(win)
    return out, (oh, ow)


_quant = quantize  # the JAX name: int8 at 1/inv_scale, rounded in float32 whatever x's type


def _qconv_raw(x_q: torch.Tensor, site: QuantConv, stride: int, padding: int) -> torch.Tensor:
    """int8 NHWC through one site's int8 kernel → int32 NHWC, exact; the
    epilogue is the caller's."""
    if x_q.dtype != torch.int8:
        raise ValueError(f"a quantized conv takes int8 input, got {x_q.dtype}")
    cols, (oh, ow) = im2col(x_q, site.kh, site.kw, stride, padding, site.gemm.shape[0])
    return int8_matmul(cols, site.gemm).view(x_q.shape[0], oh, ow, -1)


def _qconv(x_q: torch.Tensor, site: QuantConv, stride: int, padding: int) -> torch.Tensor:
    """int8 conv + float32 per-channel dequantize affine."""
    return _qconv_raw(x_q, site, stride, padding).to(torch.float32) * site.mult + site.bias


def _requant(y32: torch.Tensor, site: QuantConv, next_inv_scale: float) -> torch.Tensor:
    """int32 → dequantize affine → ReLU → int8 at the next site's scale."""
    return quantize(F.relu(y32.to(torch.float32) * site.mult + site.bias), next_inv_scale)


class QuantizedBlock(nn.Module):
    def __init__(self, node: Mapping[str, Any]):
        super().__init__()
        for name in site_names(node):
            setattr(self, name, QuantConv(**node[name]))
        if "downsample" not in node:
            self.downsample = None


def _quantized_flow(q: "QuantizedResNet", x: torch.Tensor) -> torch.Tensor:
    """The forward of ``make_quantized_apply`` there, over the module's sites."""
    f32, inter = torch.float32, q.inter_dtype
    x_q = x if q.stem_prequantized else _quant(x, q.stem.inv_scale)
    if x_q.dtype != torch.int8:
        raise ValueError(f"a prequantized stem takes the int8 operand, got {x_q.dtype}")
    x = max_pool(F.relu(_qconv(x_q, q.stem, 2, 3)).to(inter))
    for block, stride in zip(q.blocks, q.strides):
        # conv1 and downsample share the block input: quantized once
        x_q = _quant(x, block.conv1.inv_scale)
        identity = x
        if q.bottleneck:
            h_q = _requant(_qconv_raw(x_q, block.conv1, 1, 0), block.conv1, block.conv2.inv_scale)
            h_q = _requant(_qconv_raw(h_q, block.conv2, stride, 1), block.conv2, block.conv3.inv_scale)
            y = _qconv(h_q, block.conv3, 1, 0)
        else:
            h_q = _requant(_qconv_raw(x_q, block.conv1, stride, 1), block.conv1, block.conv2.inv_scale)
            y = _qconv(h_q, block.conv2, 1, 1)
        if block.downsample is not None:
            identity = _qconv(x_q, block.downsample, stride, 0)
        x = F.relu(y + identity.to(f32)).to(inter)
    return x.to(f32).mean(dim=(1, 2))


class QuantizedResNet(nn.Module):
    """The quantized extractor: normalized NHWC float [B, H, W, 3] (or, with
    ``stem_prequantized``, the int8 operand that the preprocess kernel's
    int8 epilogue wrote with ``stem.inv_scale``) → pooled features [B, D]
    float32. Every leaf of the int8 tree is a buffer."""

    def __init__(self, tree: Mapping[str, Any], stage_sizes: Sequence[int] = RESNET18_STAGES,
                 bottleneck: bool = False, inter_dtype: torch.dtype = torch.bfloat16,
                 stem_prequantized: bool = False):
        super().__init__()
        self.strides = block_strides(stage_sizes)
        if len(tree["blocks"]) != len(self.strides):
            raise ValueError(f"the int8 tree has {len(tree['blocks'])} blocks, the stages {tuple(stage_sizes)} "
                             f"have {len(self.strides)}")
        self.bottleneck = bottleneck
        self.inter_dtype = inter_dtype
        self.stem_prequantized = stem_prequantized
        self.stem = QuantConv(**tree["stem"])
        self.blocks = nn.ModuleList(QuantizedBlock(node) for node in tree["blocks"])
        last = self.blocks[-1]
        self.num_features = (last.conv3 if bottleneck else last.conv2).gemm.shape[1]

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return _quantized_flow(self, x_nhwc)


def make_quantized_apply(
    stage_sizes: Sequence[int] = RESNET18_STAGES,
    bottleneck: bool = False,
    inter_dtype: torch.dtype = torch.bfloat16,
    stem_prequantized: bool = False,
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """apply(qtree, x) → pooled features [B, D] float32, the functional form:
    ``qtree`` is ``quantize_extractor``'s tree (built into a
    ``QuantizedResNet`` on ``x``'s device at each call) or a
    ``QuantizedResNet`` already built with these arguments."""

    def apply(qtree: Any, x: torch.Tensor) -> torch.Tensor:
        if isinstance(qtree, QuantizedResNet):
            return _quantized_flow(qtree, x)
        q = QuantizedResNet(qtree, stage_sizes, bottleneck, inter_dtype, stem_prequantized).to(x.device)
        return _quantized_flow(q, x)

    return apply
