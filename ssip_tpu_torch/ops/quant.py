"""Symmetric int8 quantization and the int8 dense site.

Counterpart of ``ssip_tpu/models/quantized_vit.py:50-62`` (``_quant`` and
``_qdense``) and of the per-site leaves that ``quantize_vit_extractor``
(``:203-214``) makes: ``kernel`` int8 [in, out], ``mult`` float32 [out]
(input scale × weight scale), ``bias`` float32 [out] and ``inv_in_scale``
(float32 scalar).

    quantize(x, inv_scale) = int8(clip(round_half_even(float32(x)·inv_scale), ±127))
    qdense(x_q, site)      = float32(x_q · kernel as int32) · mult + bias

The s8×s8→s32 product is outside any hand-written kernel, as the JAX package
leaves it to XLA outside any Pallas kernel: ``torch._int_mm`` on both devices
(cuBLASLt on the card), so a traced program holds the same operation for
either. Integer sums are exact, so both give the same bits. ``torch.round``
rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

QMAX = 127.0
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA wants more than 16 rows


def quantize(x: torch.Tensor, inv_scale: float | torch.Tensor) -> torch.Tensor:
    """``x`` (any float type) → int8 with the per-tensor scale ``1/inv_scale``."""
    return torch.clamp(torch.round(x.to(torch.float32) * inv_scale), -QMAX, QMAX).to(torch.int8)


class QuantSite(nn.Module):
    """One int8 dense site: the four leaves of the tree (the constructor's
    arguments carry their names, so ``QuantSite(**leaves)`` builds one) as
    buffers, so ``.to(device)`` moves them and ``state_dict`` holds them.

    ``inv_scale`` is ``inv_in_scale`` once more as a Python float (exactly
    the float32 value): the kernels take it as a launch argument, and reading
    a CUDA scalar for every launch would stall the host on the device.
    ``transposed=True`` also keeps ``kernel_t`` [out, in] (the layout whose
    input axis is contiguous, which ``csrc/qmlp.cu`` reads).
    """

    def __init__(self, kernel: Any, mult: Any, bias: Any, inv_in_scale: Any, transposed: bool = False):
        super().__init__()
        kernel = np.asarray(kernel)
        if kernel.dtype != np.int8:
            raise ValueError(f"a quantized site's kernel must be int8, got {kernel.dtype}")
        out = kernel.shape[-1]
        mult, bias = np.asarray(mult, np.float32), np.asarray(bias, np.float32)
        if mult.shape != (out,) or bias.shape != (out,):
            raise ValueError(f"mult and bias must be [{out}], got {mult.shape} and {bias.shape}")
        inv = np.float32(inv_in_scale)
        self.inv_scale = float(inv)
        self.register_buffer("kernel", torch.from_numpy(np.array(kernel)))
        self.register_buffer("mult", torch.from_numpy(mult.copy()))
        self.register_buffer("bias", torch.from_numpy(bias.copy()))
        self.register_buffer("inv_in_scale", torch.tensor(inv, dtype=torch.float32))
        if transposed:
            if kernel.ndim != 2:
                raise ValueError(f"only a dense [in, out] kernel has a transposed copy, got {kernel.shape}")
            self.register_buffer("kernel_t", torch.from_numpy(np.ascontiguousarray(kernel.T)))

    def leaves(self) -> dict[str, np.ndarray]:
        """The site as the JAX tree holds it (numpy arrays)."""
        return {
            "kernel": self.kernel.cpu().numpy(), "mult": self.mult.cpu().numpy(),
            "bias": self.bias.cpu().numpy(), "inv_in_scale": np.float32(self.inv_scale),
        }


def int8_matmul(x_q: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] → int32 [M, N], exact.

    ``torch._int_mm`` on both devices. On the card it takes more than 16
    rows and K and N that are multiples of 8, and raises otherwise (every
    dense site of the three ViT configs at one image or more meets this, and
    every convolution of ``models/quantized.py`` at 224² and one image or
    more). A size that is symbolic (a traced batch) is left to the library's
    own check.
    """
    if x_q.dtype != torch.int8 or kernel.dtype != torch.int8 or x_q.dim() != 2 or kernel.dim() != 2:
        raise ValueError(
            f"int8_matmul takes int8 [M, K] and int8 [K, N], got {x_q.dtype} {tuple(x_q.shape)} "
            f"and {kernel.dtype} {tuple(kernel.shape)}"
        )
    if x_q.shape[1] != kernel.shape[0]:
        raise ValueError(f"inner sizes differ: {tuple(x_q.shape)} @ {tuple(kernel.shape)}")
    if x_q.device.type == "cpu":
        return torch._int_mm(x_q.contiguous(), kernel.contiguous())
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cpu or cuda tensors, got {x_q.device}")
    m, k = x_q.shape
    n = kernel.shape[1]
    if all(isinstance(v, int) for v in (m, k, n)) and (m < _INT_MM_MIN_ROWS or k % 8 or n % 8):
        raise ValueError(
            f"the int8 product on the card (torch._int_mm) takes more than 16 rows and inner and "
            f"output sizes that are multiples of 8, got [{m}, {k}] @ [{k}, {n}]"
        )
    return torch._int_mm(x_q.contiguous(), kernel)


def qdense(x_q: torch.Tensor, site: QuantSite) -> torch.Tensor:
    """int8 [..., in] through one site → float32 [..., out]: the exact int32
    product, then one multiply and one add per value (two roundings)."""
    lead = x_q.shape[:-1]
    y32 = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), site.kernel)
    return (y32.to(torch.float32) * site.mult + site.bias).reshape(*lead, -1)
