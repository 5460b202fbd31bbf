"""torchvision-topology ResNet in PyTorch, eval and train forward.

Counterpart of ``ssip_tpu/models/resnet.py:66-390``: the same blocks and
stage layout, with torchvision's parameter and buffer names (``conv1.weight``,
``layer2.0.downsample.1.running_var``, …) so a torchvision state_dict loads
with ``load_state_dict``.

- ``forward`` takes NHWC like the Flax module. ``x.permute(0, 3, 1, 2)`` of a
  contiguous NHWC tensor is an NCHW view in channels_last memory, which is
  what cuDNN's fast convolutions want; no copy is made.
- BatchNorm has the math of ``MaskedBatchNorm`` (``resnet.py:77-137``):
  ``((x − mean)·rsqrt(var + eps))·scale + bias`` in float32, then cast to
  the compute dtype. ``module.eval()`` normalizes with the running
  statistics; ``module.train()`` with the batch statistics of the rows
  where ``mask`` is true, and updates the running buffers.
- ``forward(x_nhwc, mask=None)`` threads ``mask`` ([B] bool, the rows that
  are real and not batch padding) through every BatchNorm.
- The bfloat16 rounding points are explicit casts, not autocast, so CPU
  tests compare bfloat16 runs too: each conv casts its input and kernel to
  the compute dtype; BN computes in float32 and casts back; the global
  average pool is a float32 mean rounded to the compute dtype, then float32
  (``resnet.py:349``).
- Convolutions, pooling and the mean are plain PyTorch (cuDNN on the card),
  as the JAX package left them to XLA.
- On a model axis (``--mesh-model``, ``parallel/tensor.py:shard_model``)
  each conv of 128 output channels or more holds its slice of them and
  gathers them before its BatchNorm, which stays replicated; ``fc`` holds
  its slice of the input features and reduces its partial product.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssip_tpu_torch.parallel import tensor
from ssip_tpu_torch.parallel.distributed import all_reduce_sum, sync_group

RESNET18_STAGES: tuple[int, ...] = (2, 2, 2, 2)
RESNET34_STAGES: tuple[int, ...] = (3, 4, 6, 3)
RESNET50_STAGES: tuple[int, ...] = (3, 4, 6, 3)
STAGE_WIDTHS: tuple[int, ...] = (64, 128, 256, 512)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # running = 0.9·running + 0.1·batch (torch's momentum 0.1)

MODEL_STAGES = {
    "resnet18": RESNET18_STAGES,
    "resnet34": RESNET34_STAGES,
    "resnet50": RESNET50_STAGES,
}


class Conv(nn.Conv2d):
    """Bias-free conv whose input and kernel are cast to the compute dtype
    (``nn.Conv(dtype=…)`` in Flax); the parameter stays float32. With
    ``tp`` set the weight is this rank's output channels, gathered after
    the product."""

    tp = None  # the model axis, set by parallel/tensor.py:shard_model

    def __init__(self, cin: int, cout: int, k: int, stride: int, compute_dtype: torch.dtype):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.compute_dtype), self.weight.to(self.compute_dtype)
        if self.tp is None:
            return F.conv2d(x, w, None, self.stride, self.padding)
        return tensor.gather(F.conv2d(tensor.copy(x, self.tp), w, None, self.stride, self.padding), self.tp, dim=1)


class BatchNorm(nn.Module):
    """BatchNorm2d with ``MaskedBatchNorm``'s arithmetic.

    Holds torchvision's ``weight``/``bias`` parameters and
    ``running_mean``/``running_var``/``num_batches_tracked`` buffers, so
    checkpoints load unchanged.

    Train mode (``resnet.py:107-135``): the statistics cover the rows where
    ``mask`` is true, as float32 ``E[x²] − E[x]²`` clamped at 0 over
    ``count = max(Σmask·H·W, 1)`` values (not ``F.batch_norm``, which cannot
    leave rows out); normalization uses this biased variance, and the
    running buffers move as ``0.9·old + 0.1·new`` with the unbiased
    variance ``var·count/max(count − 1, 1)``. Inside
    ``parallel.distributed.synced_batch(group)`` the sums and the count are
    the global batch's, so every rank normalizes alike and moves its
    buffers alike, as the JAX step's statistics over a sharded batch do.
    """

    def __init__(self, features: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.to(torch.float32)
        if self.training:
            mean, var = self._batch_stats(xf, mask)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(self.compute_dtype)

    def _batch_stats(self, xf: torch.Tensor, mask: Optional[torch.Tensor]):
        axes = (0, 2, 3)
        group = sync_group()
        if group is not None:
            # data parallel: the global batch's Σw·x, Σw·x² and count, summed
            # over the ranks with autograd (``parallel/distributed.py``)
            w = (torch.ones(xf.shape[0], device=xf.device) if mask is None else mask.to(torch.float32)).view(-1, 1, 1, 1)
            local = torch.cat([(xf * w).sum(axes), (xf * xf * w).sum(axes),
                               (w.sum() * float(xf.shape[2] * xf.shape[3])).view(1)])
            sums = all_reduce_sum(local, group)
            c = xf.shape[1]
            count = torch.clamp(sums[2 * c], min=1.0)
            mean = sums[:c] / count
            var = sums[c : 2 * c] / count - mean * mean
        elif mask is None:
            count = torch.tensor(float(xf.numel() // xf.shape[1]), device=xf.device)
            mean = xf.mean(axes)
            var = (xf * xf).mean(axes) - mean * mean
        else:
            w = mask.to(torch.float32).view(-1, 1, 1, 1)
            count = torch.clamp(w.sum() * float(xf.shape[2] * xf.shape[3]), min=1.0)
            mean = (xf * w).sum(axes) / count
            var = (xf * xf * w).sum(axes) / count - mean * mean
        var = torch.clamp(var, min=0.0)
        with torch.no_grad():
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * unbiased)
            self.num_batches_tracked += 1
        return mean, var


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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), mask))
        y = self.bn2(self.conv2(y), mask)
        return F.relu(y + _identity(self.downsample, x, mask))


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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), mask))
        y = F.relu(self.bn2(self.conv2(y), mask))
        y = self.bn3(self.conv3(y), mask)
        return F.relu(y + _identity(self.downsample, x, mask))


def _projection(cin: int, cout: int, stride: int, compute_dtype) -> Optional[nn.Sequential]:
    """torchvision's ``downsample``: ``Sequential(conv, bn)``, for its names."""
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(
        Conv(cin, cout, 1, stride, compute_dtype), BatchNorm(cout, compute_dtype)
    )


def _identity(downsample: Optional[nn.Sequential], x: torch.Tensor, mask) -> torch.Tensor:
    if downsample is None:
        return x
    conv, bn = downsample
    return bn(conv(x), mask)


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

    def forward(self, x_nhwc: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)  # channels_last NCHW view
        x = F.relu(self.bn1(self.conv1(x), mask))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, mask)
        feats = x.to(torch.float32).mean(dim=(2, 3)).to(self.compute_dtype).to(torch.float32)
        return feats if self.fc is None else tensor.linear(self.fc, feats)


def build_resnet(
    arch: str, num_classes: Optional[int] = None, compute_dtype: torch.dtype = torch.float32
) -> ResNet:
    """``--arch resnet18|resnet34|resnet50`` → module; the other archs are
    built by ``models/registry.py:build_model``."""
    if arch not in MODEL_STAGES:
        raise ValueError(f"--arch {arch} is not a ResNet arch; those are: " + ", ".join(MODEL_STAGES))
    return ResNet(
        MODEL_STAGES[arch], num_classes=num_classes, compute_dtype=compute_dtype,
        bottleneck=arch == "resnet50",
    )
