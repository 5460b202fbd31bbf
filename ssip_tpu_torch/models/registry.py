"""One registry of the ported archs: ``--arch`` → module.

Counterpart of ``ssip_tpu/models/__init__.py:20-23`` (``MODEL_FACTORIES``):
every ported ``--arch`` value builds a module with the shared call shape
``model(x_nhwc, mask=None)``, a ``compute_dtype`` and a ``num_features``
(the embedding width: 512 or 2048 for the ResNets, 192, 384 or 768 for the
ViTs). The MoE archs are refused with their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ssip_tpu_torch.models.resnet import MODEL_STAGES, build_resnet
from ssip_tpu_torch.models.vit import VIT_CONFIGS, build_vit

PORTED_ARCHS = (*MODEL_STAGES, *VIT_CONFIGS)
_MOE_ITEM = "Queue 1 slice 6 item 20: models/moe.py, the vit_moe_* archs"


def refuse_unported_arch(arch: str) -> None:
    if arch not in PORTED_ARCHS:
        raise ValueError(
            f"--arch {arch} is not ported to ssip_tpu_torch yet (ROADMAP.md, {_MOE_ITEM}); "
            "ported: " + ", ".join(PORTED_ARCHS)
        )


def build_model(
    arch: str,
    num_classes: Optional[int] = None,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    image_size: int = 224,
) -> nn.Module:
    """``remat`` and ``image_size`` (the position embedding's size) take
    effect for the ViT archs and are ignored for the ResNets, as in JAX."""
    refuse_unported_arch(arch)
    if arch in VIT_CONFIGS:
        return build_vit(arch, num_classes, compute_dtype, remat=remat, image_size=image_size)
    return build_resnet(arch, num_classes, compute_dtype)
