"""Row LayerNorm for the ViT family: plain version and CUDA kernels.

Counterpart of ``ssip_tpu/ops/layernorm.py``: ``layer_norm_plain`` after
``layer_norm_xla`` (``:43-52``), ``layer_norm`` after ``layer_norm``
(``:171-203``) with its custom VJP (``:153-168``) as a
``torch.autograd.Function`` whose forward and backward launch the kernels of
``csrc/layernorm.cu`` (which replace ``_ln_fwd_kernel`` and
``_ln_bwd_kernel``).

    y = (x − mean)·rsqrt(var + eps)·scale + bias    over the last axis,

float32 moments (the variance of the deviations), output in ``x``'s type.
Saved for backward: ``x`` and ``scale`` only; the backward recomputes the
row statistics.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain version (autograd differentiates it); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache
from typing import Tuple

import torch

LN_EPS = 1e-6  # torchvision ViT's norm_layer eps, the models' default
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_WIDTH = 1024  # 32 values a lane (csrc/layernorm.cu)
_WARPS = 4  # a block's warps (kWarps in csrc/layernorm.cu), each one row or more at a time
_FWD, _BWD = 0, 1  # ssip_layer_norm_info's kernel numbers


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis in float32 math, ``x``'s type out."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def layer_norm_bwd_plain(
    x2d: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = LN_EPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) as the backward kernel computes them, written
    out (``ssip_tpu/ops/layernorm.py:65-96``) rather than taken from
    autograd: what the card's kernel is compared with."""
    xf, g0 = x2d.to(torch.float32), dy.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    r = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * r
    g = g0 * scale
    dx = r * (g - g.mean(dim=-1, keepdim=True) - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x2d.dtype), (g0 * xhat).sum(dim=0), g0.sum(dim=0)


@lru_cache(maxsize=1)
def _kernel_entries():
    from ssip_tpu_torch.kernels.build import load_library

    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd, info = lib.ssip_layer_norm_fwd, lib.ssip_layer_norm_bwd, lib.ssip_layer_norm_info
    fwd.argtypes = [p, p, p, p, i, i, i, i, f, p]  # x, scale, bias, y, is_bf16, n, d, blocks, eps, stream
    bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]  # x, scale, dy, dx, partials, sums, is_bf16, n, d, blocks, eps, stream
    info.argtypes = [i, i, i, p]  # kernel, is_bf16, d, out[4]
    fwd.restype = bwd.restype = info.restype = ctypes.c_int
    return fwd, bwd, info


def launch_grid(n: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of a persistent launch over ``n`` rows: one wave, as many
    blocks as fit on every SM, and no more than give each warp a row."""
    return max(1, min(sms * blocks_per_sm, -(-n // _WARPS)))


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@lru_cache(maxsize=None)
def _blocks_per_sm(kernel: int, bf16: bool, d: int, index: int) -> int:
    """Resident blocks an SM of one kernel at width ``d`` on card ``index``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); called with that
    card current."""
    out = (ctypes.c_int * 4)()
    err = _kernel_entries()[2](kernel, int(bf16), d, out)
    if err != 0 or out[3] < 1:
        raise RuntimeError(f"layer_norm kernel {kernel} at width {d}: cudaError {err}, {out[3]} blocks an SM")
    return out[3]


def _on_device(device: torch.device):
    """The launch's device made current, unless it is already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_cuda_operands(x2d: torch.Tensor, *params: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    n, d = x2d.shape
    vec = 16 // x2d.element_size()
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"layer_norm kernel takes float32 or bfloat16, got {x2d.dtype}")
    if d % vec or d > _MAX_WIDTH:
        raise ValueError(
            f"layer_norm kernel needs a width that is a multiple of {vec} and at most "
            f"{_MAX_WIDTH} for {x2d.dtype}, got {d}"
        )
    if not x2d.is_contiguous() or x2d.data_ptr() % 16:
        raise ValueError("layer_norm kernel needs contiguous, 16-byte aligned rows")
    for t in params:
        if t.dtype != torch.float32 or tuple(t.shape) != (d,) or t.device != x2d.device or not t.is_contiguous():
            raise ValueError(
                f"layer_norm scale and bias must be contiguous float32 [{d}] on {x2d.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _launch_fwd(x2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    _check_cuda_operands(x2d, scale, bias)
    n, d = x2d.shape
    y = torch.empty_like(x2d)
    if y.numel() == 0:
        return y
    bf16 = x2d.dtype == torch.bfloat16
    index = x2d.device.index
    with _on_device(x2d.device):
        blocks = launch_grid(n, _sm_count(index), _blocks_per_sm(_FWD, bf16, d, index))
        err = _kernel_entries()[0](
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), int(bf16), n, d, blocks, float(eps),
            torch.cuda.current_stream(index).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
    layer_norm.launches += 1
    return y


def layer_norm_bwd(
    x2d: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = LN_EPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx [N, D] in ``x2d``'s type, dscale [D], dbias [D] float32) from the
    saved ``x2d`` and ``scale`` and the incoming ``dy``.

    On the card a call is two launches: the backward kernel, in which each
    block writes its sums to its row of a ``[2, blocks, D]`` float32 scratch,
    then a column sum over the blocks, in block order (the JAX package too
    sums its partials outside its kernel). ``layer_norm_bwd.launches``
    counts calls that launched.
    """
    if x2d.dim() != 2 or dy.shape != x2d.shape or dy.dtype != x2d.dtype or dy.device != x2d.device:
        raise ValueError(
            f"layer_norm_bwd expects x [N, D] and dy of the same shape, type and device, got "
            f"{tuple(x2d.shape)} {x2d.dtype} and {tuple(dy.shape)} {dy.dtype}"
        )
    if x2d.device.type == "cpu":
        return layer_norm_bwd_plain(x2d, scale, dy, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda tensors, got {x2d.device}")
    _check_cuda_operands(x2d, scale)
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("layer_norm kernel needs contiguous, 16-byte aligned rows")
    n, d = x2d.shape
    dx = torch.empty_like(x2d)
    if dx.numel() == 0:
        zeros = torch.zeros((2, d), dtype=torch.float32, device=x2d.device)
        return dx, zeros[0], zeros[1]
    bf16 = x2d.dtype == torch.bfloat16
    index = x2d.device.index
    with _on_device(x2d.device):
        blocks = launch_grid(n, _sm_count(index), _blocks_per_sm(_BWD, bf16, d, index))
        partials = torch.empty((2, blocks, d), dtype=torch.float32, device=x2d.device)
        sums = torch.empty((2, d), dtype=torch.float32, device=x2d.device)
        err = _kernel_entries()[1](
            x2d.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            int(bf16), n, d, blocks, float(eps), torch.cuda.current_stream(index).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm backward kernel launch failed: cudaError {err}")
    layer_norm_bwd.launches += 1
    return dx, sums[0], sums[1]


layer_norm_bwd.launches = 0


class _LayerNormKernel(torch.autograd.Function):
    """The two kernels as one differentiable function of (x2d, scale, bias)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        ctx.save_for_backward(x2d, scale)
        ctx.eps = eps
        return _launch_fwd(x2d, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2d, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x2d, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` [..., D]; ``x``'s type out.

    ``scale`` and ``bias`` are float32 [D]. ``layer_norm.launches`` counts
    forward-kernel launches (CPU calls and empty inputs launch nothing and
    count nothing).
    """
    d = x.shape[-1]
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"layer_norm scale and bias must be [{d}], got {tuple(scale.shape)} and {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous input")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _LayerNormKernel.apply(x.view(-1, d), scale, bias, float(eps)).view(x.shape)
    return _launch_fwd(x.view(-1, d), scale, bias, float(eps)).view(x.shape)  # nothing to differentiate


layer_norm.launches = 0
