"""Int8 ViT MLP: plain versions and CUDA kernels. Inference only.

Counterpart of ``ssip_tpu/ops/qmlp.py``: ``_erf_poly`` and ``_gelu_erf``
(``:45-71``, the Abramowitz and Stegun 7.1.26 polynomial, same constants),
``quantized_mlp_plain`` after ``quantized_mlp_xla`` (``:141-149``) and
``quantized_mlp`` after the entry of the same name (``:152-191``), whose
kernel ``_qmlp_kernel`` the two kernels of ``csrc/qmlp.cu`` replace:

    quantize(y)·W1q → dequantize → polynomial-erf GELU → requantize   (qmlp_hidden_plain: int8 gq)
    gq·W2q → dequantize                                                (qmlp_output_plain: float32)

on a [..., D] stream (bfloat16 or float32), float32 out. ``blk`` is one
encoder block of the quantized ViT: anything with ``mlp_1`` and ``mlp_2``
``QuantSite``s (``ops/quant.py``) that keep their transposed kernels. The
card runs each half as one launch of a tiled int8 GEMM, joined by the int8
hidden [rows, hidden] in device memory; ``quantized_mlp_plain`` is the
composition of the two halves' plain versions.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain versions (the unfused site composition); a CUDA tensor launches the
kernels or raises. There is no gradient: the quantized model is a frozen
extractor.

The kernels repeat the plain versions' float operations one for one, and
integer sums are exact, so the two differ only where their ``exp`` differ by
an ulp and that moves a hidden value across a ``.5`` tie of the requantize:
one int8 step of one hidden value, up to ``127·m2`` in an output.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Any

import torch

from ssip_tpu_torch.ops.quant import qdense, quantize

_INV_SQRT2 = 0.7071067811865476
# Abramowitz & Stegun 7.1.26 rational-polynomial erf: |error| ≤ 1.5e-7
_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_WIDTHS = (192, 384, 768)  # the hidden_dim of vit_t16, vit_s16, vit_b16
KERNEL_HIDDEN_MULTIPLE = 256  # csrc/qmlp.cu's hidden widths; 768, 1536 and 3072 are multiples


def _erf_poly(z: torch.Tensor) -> torch.Tensor:
    """float32 erf by A&S 7.1.26, extended as an odd function."""
    s = torch.sign(z)
    z = torch.abs(z)
    t = 1.0 / (1.0 + _ERF_P * z)
    a0, a1, a2, a3, a4 = _ERF_A
    poly = ((((a4 * t + a3) * t + a2) * t + a1) * t + a0) * t
    return s * (1.0 - poly * torch.exp(-z * z))


def _gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Erf-form GELU on the polynomial erf, in float32. The quantized pass
    uses it in the kernel and in the plain version alike; calibration uses
    the true erf (``models/quantized_vit.py``)."""
    x = x.to(torch.float32)
    return 0.5 * x * (1.0 + _erf_poly(x * _INV_SQRT2))


def qmlp_hidden_plain(y: torch.Tensor, blk: Any) -> torch.Tensor:
    """The first site and the GELU: quantize → int8 product → dequantize →
    polynomial GELU → requantize for the second site: int8 [..., hidden]."""
    h = qdense(quantize(y, blk.mlp_1.inv_scale), blk.mlp_1)
    return quantize(_gelu_erf(h), blk.mlp_2.inv_scale)


def qmlp_output_plain(gq: torch.Tensor, blk: Any) -> torch.Tensor:
    """The second site on the requantized hidden: int8 product →
    dequantize, float32 [..., D]."""
    return qdense(gq, blk.mlp_2)


def quantized_mlp_plain(y: torch.Tensor, blk: Any) -> torch.Tensor:
    """The unfused site composition: quantize → int8 product → dequantize
    at each site, the polynomial GELU between."""
    return qmlp_output_plain(qmlp_hidden_plain(y, blk), blk)


@lru_cache(maxsize=1)
def _kernel_entries():
    from ssip_tpu_torch.kernels.build import load_library

    lib = load_library()
    hidden, output = lib.ssip_qmlp_hidden, lib.ssip_qmlp_output
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # y, is_bf16, w1t, m1, b1, gq, rows, d, hidden, inv1, inv2, stream
    hidden.argtypes = [p, i, p, p, p, p, i, i, i, f, f, p]
    # gq, w2t, m2, b2, out, rows, d, hidden, stream
    output.argtypes = [p, p, p, p, p, i, i, i, p]
    hidden.restype = output.restype = ctypes.c_int
    return hidden, output


def _check_cuda_operands(y2d: torch.Tensor, blk: Any) -> int:
    """Raise on what the kernel does not take; returns the hidden width."""
    d = y2d.shape[1]
    if y2d.dtype not in _DTYPES:
        raise ValueError(f"quantized_mlp kernel takes float32 or bfloat16, got {y2d.dtype}")
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"quantized_mlp kernel takes stream widths {KERNEL_WIDTHS}, got {d}")
    for name, site in (("mlp_1", blk.mlp_1), ("mlp_2", blk.mlp_2)):
        if not hasattr(site, "kernel_t"):
            raise ValueError(f"quantized_mlp kernel needs {name}'s transposed kernel (QuantSite(transposed=True))")
        for t in (site.kernel_t, site.mult, site.bias):
            if t.device != y2d.device or not t.is_contiguous():
                raise ValueError(f"{name}'s tensors must be contiguous on {y2d.device}, got {t.device}")
    hidden = blk.mlp_1.kernel_t.shape[0]
    if tuple(blk.mlp_1.kernel_t.shape) != (hidden, d) or tuple(blk.mlp_2.kernel_t.shape) != (d, hidden):
        raise ValueError(
            f"quantized_mlp expects kernels [{d}, hidden] and [hidden, {d}], got transposed shapes "
            f"{tuple(blk.mlp_1.kernel_t.shape)} and {tuple(blk.mlp_2.kernel_t.shape)}"
        )
    if hidden % KERNEL_HIDDEN_MULTIPLE:
        raise ValueError(f"quantized_mlp kernel takes hidden widths that are multiples of {KERNEL_HIDDEN_MULTIPLE}, got {hidden}")
    if any(t.data_ptr() % 16 for t in (y2d, *(x for s in (blk.mlp_1, blk.mlp_2) for x in (s.kernel_t, s.mult, s.bias)))):
        raise ValueError("quantized_mlp kernel needs its operands at 16-byte aligned addresses")
    return hidden


def _launch_hidden(y2d: torch.Tensor, blk: Any, hidden: int) -> torch.Tensor:
    """The first kernel: int8 gq [rows, hidden] of a checked CUDA stream."""
    rows, d = y2d.shape
    gq = torch.empty((rows, hidden), dtype=torch.int8, device=y2d.device)
    m1 = blk.mlp_1
    err = _kernel_entries()[0](
        y2d.data_ptr(), int(y2d.dtype == torch.bfloat16), m1.kernel_t.data_ptr(), m1.mult.data_ptr(),
        m1.bias.data_ptr(), gq.data_ptr(), rows, d, hidden, m1.inv_scale, blk.mlp_2.inv_scale,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quantized_mlp hidden kernel launch failed: cudaError {err}")
    return gq


def _launch_output(gq: torch.Tensor, blk: Any, d: int) -> torch.Tensor:
    """The second kernel: float32 [rows, d] from the int8 hidden."""
    rows, hidden = gq.shape
    out = torch.empty((rows, d), dtype=torch.float32, device=gq.device)
    m2 = blk.mlp_2
    err = _kernel_entries()[1](
        gq.data_ptr(), m2.kernel_t.data_ptr(), m2.mult.data_ptr(), m2.bias.data_ptr(), out.data_ptr(),
        rows, d, hidden, torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quantized_mlp output kernel launch failed: cudaError {err}")
    return out


def quantized_mlp(y: torch.Tensor, blk: Any) -> torch.Tensor:
    """Int8 MLP over a [..., D] stream → float32 [..., D].

    ``quantized_mlp.launches`` counts calls that launch the kernels (one a
    call: two kernels, the hidden then the output; CPU calls and empty
    inputs launch nothing and count nothing).
    """
    if y.device.type == "cpu":
        return quantized_mlp_plain(y, blk)
    if y.device.type != "cuda":
        raise ValueError(f"quantized_mlp runs on cpu or cuda tensors, got {y.device}")
    if not y.is_contiguous():
        raise ValueError("quantized_mlp kernel needs a contiguous stream")
    y2d = y.reshape(-1, y.shape[-1])
    hidden = _check_cuda_operands(y2d, blk)
    rows, d = y2d.shape
    if rows == 0:
        return torch.empty(y.shape, dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):  # the launches' device; restored after
        out = _launch_output(_launch_hidden(y2d, blk, hidden), blk, d)
    quantized_mlp.launches += 1
    return out.reshape(y.shape)


quantized_mlp.launches = 0
