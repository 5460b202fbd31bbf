"""The frozen ResNet extractor with its BatchNorms folded into the convs.

Counterpart of ``ssip_tpu/models/inference.py:50-182``: ``_fold``,
``fold_resnet_extractor`` and ``make_folded_apply``. The frozen extractor
never updates BatchNorm, so at inference each BN is an affine map that folds
into the conv before it:

    W' = W·γ/σ,   b' = β − μ·γ/σ,   σ = sqrt(var + eps),

in float64 on the host, rounded to float32 once. The folded tree has the
JAX package's layout (numpy, HWIO kernels): ``{"stem": {kernel, bias},
"blocks": [{conv1, conv2[, conv3][, downsample]}, ...]}``, so the two
packages' trees compare leaf for leaf. ``models/quantized.py`` quantizes
from it.

The space-to-depth stem (``stem_s2d=True`` there) is a TPU-only rewrite
(ROADMAP.md, "Do not port"); ``stem_s2d=True`` raises here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.models.resnet import BN_EPS, RESNET18_STAGES

_S2D_REFUSED = (
    "the space-to-depth stem (stem_s2d=True) is TPU-only and not ported "
    "(ROADMAP.md, Queue 1, 'Do not port': the space-to-depth stem of models/inference.py)"
)


def _refuse_s2d(stem_s2d: bool) -> None:
    if stem_s2d:
        raise ValueError(_S2D_REFUSED)


def state_arrays(model: nn.Module | Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A ResNet module or a torchvision-named state_dict → float32 numpy
    arrays by name (whatever the tensors' device and memory format)."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    out = {}
    for key, value in state.items():
        if torch.is_tensor(value):
            value = value.detach().to("cpu", torch.float32).contiguous().numpy()
        out[key] = np.asarray(value, np.float32)
    return out


def _fold(kernel_oihw: np.ndarray, state: Mapping[str, np.ndarray], bn: str) -> Tuple[np.ndarray, np.ndarray]:
    """Fold the BN named ``bn`` into the OIHW kernel before it (float64 on
    the host); the kernel comes back HWIO, as the JAX tree holds it."""
    k = np.transpose(np.asarray(kernel_oihw, np.float64), (2, 3, 1, 0))
    gamma = np.asarray(state[f"{bn}.weight"], np.float64)
    beta = np.asarray(state[f"{bn}.bias"], np.float64)
    mean = np.asarray(state[f"{bn}.running_mean"], np.float64)
    var = np.asarray(state[f"{bn}.running_var"], np.float64)
    g = gamma / np.sqrt(var + BN_EPS)
    return (k * g).astype(np.float32), (beta - mean * g).astype(np.float32)


def _site(state: Mapping[str, np.ndarray], conv: str, bn: str) -> Dict[str, np.ndarray]:
    k, b = _fold(state[f"{conv}.weight"], state, bn)
    return {"kernel": k, "bias": b}


def fold_resnet_extractor(
    model: nn.Module | Mapping[str, Any],
    stage_sizes: Sequence[int] = RESNET18_STAGES,
    bottleneck: bool = False,
    stem_s2d: bool = False,
) -> Dict[str, Any]:
    """A ResNet (module or torchvision-named state_dict) → the folded tree,
    float32 numpy leaves, HWIO kernels."""
    _refuse_s2d(stem_s2d)
    state = state_arrays(model)
    tree: Dict[str, Any] = {"stem": _site(state, "conv1", "bn1"), "blocks": []}
    convs = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")
    for stage, blocks in enumerate(stage_sizes):
        for block in range(blocks):
            name = f"layer{stage + 1}.{block}"
            folded = {conv: _site(state, f"{name}.{conv}", f"{name}.bn{conv[-1]}") for conv in convs}
            if f"{name}.downsample.0.weight" in state:
                folded["downsample"] = _site(state, f"{name}.downsample.0", f"{name}.downsample.1")
            tree["blocks"].append(folded)
    return tree


def folded_to_device(folded: Dict[str, Any], device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """``fold_resnet_extractor``'s tree as tensors on ``device`` in ``dtype``,
    for ``make_folded_apply`` to run without a copy a call: each HWIO
    kernel is a view of an OIHW tensor in the channels-last layout the
    convolutions take on the card."""
    def site(leaf: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        oihw = torch.as_tensor(leaf["kernel"]).permute(3, 2, 0, 1).to(device, dtype)
        if device.type == "cuda":
            oihw = oihw.contiguous(memory_format=torch.channels_last)
        return {"kernel": oihw.permute(2, 3, 1, 0), "bias": torch.as_tensor(leaf["bias"]).to(device, dtype)}

    return {"stem": site(folded["stem"]),
            "blocks": [{name: site(leaf) for name, leaf in block.items()} for block in folded["blocks"]]}


def block_strides(stage_sizes: Sequence[int]) -> List[int]:
    """Each block's stride: 2 at the first block of every stage but the first."""
    return [2 if (stage > 0 and block == 0) else 1 for stage, n in enumerate(stage_sizes) for block in range(n)]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def max_pool(x_nhwc: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 max-pool padded with −inf (``nn.max_pool`` there)."""
    return to_nhwc(F.max_pool2d(to_nchw(x_nhwc), 3, stride=2, padding=1))


def conv_nhwc(x: torch.Tensor, kernel_hwio: Any, bias: Any, stride: int, dtype: torch.dtype) -> torch.Tensor:
    """``x`` NHWC through an HWIO kernel (numpy or tensor), padded by half
    the kernel each side (the JAX tree's ``((p, p), (p, p))`` or ``VALID``
    for 1×1), input, kernel and bias in ``dtype``."""
    k = torch.as_tensor(kernel_hwio, device=x.device)
    y = F.conv2d(to_nchw(x.to(dtype)), k.permute(3, 2, 0, 1).to(dtype), None, stride, k.shape[0] // 2)
    return to_nhwc(y) + torch.as_tensor(bias, device=x.device).to(dtype)


def make_folded_apply(
    stage_sizes: Sequence[int] = RESNET18_STAGES,
    bottleneck: bool = False,
    stem_s2d: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable[[Dict[str, Any], torch.Tensor], torch.Tensor]:
    """apply(folded, x_normalized_nhwc) → pooled features [B, D] float32,
    the function of the ResNet's eval forward with ``num_classes=None``.
    ``folded`` is ``fold_resnet_extractor``'s tree (numpy or tensor leaves,
    moved to ``x``'s device on each call)."""
    _refuse_s2d(stem_s2d)
    strides = block_strides(stage_sizes)
    dt = compute_dtype

    def apply(folded: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        stem = folded["stem"]
        x = max_pool(F.relu(conv_nhwc(x, stem["kernel"], stem["bias"], 2, dt)))
        for blk, stride in zip(folded["blocks"], strides):
            identity = x
            if bottleneck:
                y = F.relu(conv_nhwc(x, *_kb(blk["conv1"]), 1, dt))
                y = F.relu(conv_nhwc(y, *_kb(blk["conv2"]), stride, dt))
                y = conv_nhwc(y, *_kb(blk["conv3"]), 1, dt)
            else:
                y = F.relu(conv_nhwc(x, *_kb(blk["conv1"]), stride, dt))
                y = conv_nhwc(y, *_kb(blk["conv2"]), 1, dt)
            if "downsample" in blk:
                identity = conv_nhwc(x, *_kb(blk["downsample"]), stride, dt)
            x = F.relu(y + identity)
        return x.to(torch.float32).mean(dim=(1, 2)).to(dt).to(torch.float32)

    return apply


def _kb(site: Mapping[str, Any]) -> Tuple[Any, Any]:
    return site["kernel"], site["bias"]
