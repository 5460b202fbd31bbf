"""torchvision-topology ResNet in PyTorch, eval forward.

Counterpart of ``ssip_tpu/models/resnet.py:66-390``: the same blocks and
stage layout, with torchvision's parameter and buffer names (``conv1.weight``,
``layer2.0.downsample.1.running_var``, …) so a torchvision state_dict loads
with ``load_state_dict``.

- ``forward`` takes NHWC like the Flax module. ``x.permute(0, 3, 1, 2)`` of a
  contiguous NHWC tensor is an NCHW view in channels_last memory, which is
  what cuDNN's fast convolutions want; no copy is made.
- BatchNorm is eval-only with the math of ``MaskedBatchNorm``
  (``resnet.py:136-137``): ``((x − mean)·rsqrt(var + eps))·scale + bias``
  in float32, then cast to the compute dtype.
- The bfloat16 rounding points are explicit casts, not autocast, so CPU
  tests compare bfloat16 runs too: each conv casts its input and kernel to
  the compute dtype; BN computes in float32 and casts back; the global
  average pool is a float32 mean rounded to the compute dtype, then float32
  (``resnet.py:349``).
- Convolutions, pooling and the mean are plain PyTorch (cuDNN on the card),
  as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

RESNET18_STAGES: tuple[int, ...] = (2, 2, 2, 2)
RESNET34_STAGES: tuple[int, ...] = (3, 4, 6, 3)
RESNET50_STAGES: tuple[int, ...] = (3, 4, 6, 3)
STAGE_WIDTHS: tuple[int, ...] = (64, 128, 256, 512)
BN_EPS = 1e-5

MODEL_STAGES = {
    "resnet18": RESNET18_STAGES,
    "resnet34": RESNET34_STAGES,
    "resnet50": RESNET50_STAGES,
}


class Conv(nn.Conv2d):
    """Bias-free conv whose input and kernel are cast to the compute dtype
    (``nn.Conv(dtype=…)`` in Flax); the parameter stays float32."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, compute_dtype: torch.dtype):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(
            x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
            None, self.stride, self.padding,
        )


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d with ``MaskedBatchNorm``'s arithmetic.

    Holds torchvision's ``weight``/``bias`` parameters and
    ``running_mean``/``running_var``/``num_batches_tracked`` buffers, so
    checkpoints load unchanged.
    """

    def __init__(self, features: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        y = (x.to(torch.float32) - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + BN_EPS
        )
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(self.compute_dtype)


class BasicBlock(nn.Module):
    """Two 3×3 convs with identity (or 1×1-projected) residual."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, compute_dtype)
        self.bn1 = BatchNorm(features, compute_dtype)
        self.conv2 = Conv(features, features, 3, 1, compute_dtype)
        self.bn2 = BatchNorm(features, compute_dtype)
        self.downsample = _projection(cin, features, stride, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 block, output 4× the width (ResNet v1.5)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, compute_dtype: torch.dtype):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv(cin, features, 1, 1, compute_dtype)
        self.bn1 = BatchNorm(features, compute_dtype)
        self.conv2 = Conv(features, features, 3, stride, compute_dtype)
        self.bn2 = BatchNorm(features, compute_dtype)
        self.conv3 = Conv(features, out, 1, 1, compute_dtype)
        self.bn3 = BatchNorm(out, compute_dtype)
        self.downsample = _projection(cin, out, stride, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def _projection(cin: int, cout: int, stride: int, compute_dtype) -> Optional[nn.Sequential]:
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(
        Conv(cin, cout, 1, stride, compute_dtype), BatchNorm(cout, compute_dtype)
    )


class ResNet(nn.Module):
    """``num_classes=None`` is the frozen extractor (global-average-pooled
    features, 512-D for resnet18/34, 2048-D for resnet50); otherwise an
    ``fc`` head maps them to logits."""

    def __init__(
        self,
        stage_sizes: Sequence[int] = RESNET18_STAGES,
        num_classes: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
        bottleneck: bool = False,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        block_cls = Bottleneck if bottleneck else BasicBlock
        self.conv1 = Conv(3, 64, 7, 2, compute_dtype)
        self.bn1 = BatchNorm(64, compute_dtype)
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(block_cls(cin, STAGE_WIDTHS[stage], stride, compute_dtype))
                cin = STAGE_WIDTHS[stage] * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.num_features = cin
        self.fc = None if num_classes is None else nn.Linear(cin, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)  # channels_last NCHW view
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        feats = x.to(torch.float32).mean(dim=(2, 3)).to(self.compute_dtype).to(torch.float32)
        return feats if self.fc is None else self.fc(feats)


def build_resnet(
    arch: str, num_classes: Optional[int] = None, compute_dtype: torch.dtype = torch.float32
) -> ResNet:
    """``--arch`` → module. The ViT and MoE archs are not ported yet."""
    if arch not in MODEL_STAGES:
        raise ValueError(
            f"--arch {arch} is not ported to ssip_tpu_torch yet (ROADMAP.md, "
            "Queue 1 slice 6: ViT family); ported: " + ", ".join(MODEL_STAGES)
        )
    return ResNet(
        MODEL_STAGES[arch], num_classes=num_classes, compute_dtype=compute_dtype,
        bottleneck=arch == "resnet50",
    )
