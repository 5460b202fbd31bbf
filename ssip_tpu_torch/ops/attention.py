"""Multi-head attention off the packed qkv tensor: plain version and CUDA kernels.

Counterpart of ``ssip_tpu/ops/attention.py``: ``attention_plain`` after
``attention_xla`` (``:43-56``), ``attention_qkv_plain`` after
``attention_qkv_xla`` (``:393-411``), ``fused_attention_qkv`` after the
entry of the same name (``:414-442``) with its custom VJP (``:369-390``) as
a ``torch.autograd.Function`` whose forward and backward launch the kernels
of ``csrc/attention.cu`` (which replace ``_attn_qkv_kernel`` and
``_attn_qkv_bwd_kernel``).

``qkv`` is [B, S, 3·D] with columns ordered [3, H, Dh] (the fused Dense of
``models/vit.py``); the result is [B, S, D]. Per image and head:
``s = q·kᵀ/√Dh`` as a float32 sum of products of the inputs, keys at index
≥ ``kv_len`` left out, float32 softmax, ``p`` rounded to the input type,
``o = p·v`` summed in float32 and rounded once. Saved for backward: ``qkv``
only; the backward recomputes the probabilities.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain version (autograd differentiates it); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_WIDTHS = (32, 64)
MAX_KERNEL_SEQ = 256  # 8 chunks of 32 keys or queries a lane (csrc/attention.cu)
_SEQ_LIMIT_ITEM = (
    "ROADMAP.md, Queue 2 #5a: sequences up to 1024 in the attention kernels, by tiling the "
    "keys in two passes"
)


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled-dot-product attention on q, k, v [B, H, S, Dh]: float32 sums
    of the inputs' products, float32 softmax, probabilities rounded to the
    input type before the second product."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * _scale(q.shape[-1])
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.to(torch.float32), v.to(torch.float32)).to(q.dtype)


def _unpack(qkv: torch.Tensor, num_heads: int):
    b, s, three_d = qkv.shape
    parts = qkv.reshape(b, s, 3, num_heads, three_d // 3 // num_heads)
    return (parts[:, :, i].permute(0, 2, 1, 3) for i in range(3))


def attention_qkv_plain(qkv: torch.Tensor, num_heads: int, kv_len: int = 0) -> torch.Tensor:
    """Packed-qkv attention by unpacking: keys and values at index ≥
    ``kv_len`` are sliced off (the kernels' key mask); every query row
    still gives an output row."""
    b, s, three_d = qkv.shape
    q, k, v = _unpack(qkv, num_heads)
    if kv_len and kv_len < s:
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    return attention_plain(q, k, v).permute(0, 2, 1, 3).reshape(b, s, three_d // 3)


def attention_qkv_bwd_plain(qkv: torch.Tensor, d_o: torch.Tensor, num_heads: int, kv_len: int = 0) -> torch.Tensor:
    """dqkv as the backward kernel computes it, written out
    (``ssip_tpu/ops/attention.py:256-299``) rather than taken from autograd:
    what the card's kernel is compared with. ``pc`` and ``dsc`` are ``p``
    and ``ds`` rounded to the input type before their products."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    kv = kv_len if kv_len and kv_len < s else s
    f32 = torch.float32
    q, k, v = (t.to(f32) for t in _unpack(qkv, num_heads))
    k, v = k[:, :, :kv], v[:, :, :kv]
    do = d_o.reshape(b, s, num_heads, d // num_heads).permute(0, 2, 1, 3).to(f32)
    scale = _scale(d // num_heads)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    pc = p.to(qkv.dtype).to(f32)
    dv = torch.matmul(pc.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(qkv.dtype).to(f32)
    dq = torch.matmul(dsc, k) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), q) * scale
    out = torch.zeros((b, s, 3, num_heads, d // num_heads), dtype=qkv.dtype, device=qkv.device)
    out[:, :, 0] = dq.permute(0, 2, 1, 3).to(qkv.dtype)
    out[:, :kv, 1] = dk.permute(0, 2, 1, 3).to(qkv.dtype)
    out[:, :kv, 2] = dv.permute(0, 2, 1, 3).to(qkv.dtype)
    return out.view(b, s, three_d)


@lru_cache(maxsize=1)
def _kernel_entries():
    from ssip_tpu_torch.kernels.build import load_library

    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ssip_attention_qkv_fwd, lib.ssip_attention_qkv_bwd
    fwd.argtypes = [p, p, i, i, i, i, i, i, f, p]  # qkv, o, is_bf16, batch, heads, s, dh, kv, scale, stream
    bwd.argtypes = [p, p, p, i, i, i, i, i, i, f, p]  # qkv, dO, dqkv, is_bf16, batch, heads, s, dh, kv, scale, stream
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _geometry(qkv: torch.Tensor, num_heads: int, kv_len: int):
    """(batch, seq, width, head width, real keys), or raise."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % num_heads:
        raise ValueError(f"packed qkv must be [B, S, 3·H·Dh] for {num_heads} heads, got {tuple(qkv.shape)}")
    b, s, three_d = qkv.shape
    if kv_len < 0:
        raise ValueError(f"kv_len must be 0 (all keys) or positive, got {kv_len}")
    d = three_d // 3
    return b, s, d, d // num_heads, (kv_len if 0 < kv_len < s else s)


def _check_cuda_operands(qkv: torch.Tensor, s: int, dh: int) -> None:
    """Raise on what the kernels do not take."""
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if dh not in _HEAD_WIDTHS:
        raise ValueError(f"attention kernel takes head widths {_HEAD_WIDTHS}, got {dh}")
    if s > MAX_KERNEL_SEQ:
        raise ValueError(
            f"attention kernel takes sequences up to {MAX_KERNEL_SEQ}, got {s}: longer ones "
            f"are not ported to ssip_tpu_torch yet ({_SEQ_LIMIT_ITEM})"
        )
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous packed qkv")


def _launch_fwd(qkv: torch.Tensor, num_heads: int, kv_len: int) -> torch.Tensor:
    b, s, d, dh, kv = _geometry(qkv, num_heads, kv_len)
    _check_cuda_operands(qkv, s, dh)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):  # the launch's device; restored after
        err = _kernel_entries()[0](
            qkv.data_ptr(), out.data_ptr(), int(qkv.dtype == torch.bfloat16),
            b, num_heads, s, dh, kv, _scale(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    fused_attention_qkv.launches += 1
    return out


def attention_qkv_bwd(qkv: torch.Tensor, d_o: torch.Tensor, num_heads: int, kv_len: int = 0) -> torch.Tensor:
    """dqkv [B, S, 3·D] from the saved ``qkv`` and the incoming ``d_o``
    [B, S, D], for any ``d_o`` (pad-query rows included); key rows at index
    ≥ ``kv_len`` get zeros. ``attention_qkv_bwd.launches`` counts kernel
    launches."""
    b, s, d, dh, kv = _geometry(qkv, num_heads, kv_len)
    if tuple(d_o.shape) != (b, s, d) or d_o.dtype != qkv.dtype or d_o.device != qkv.device:
        raise ValueError(
            f"attention_qkv_bwd expects dO [{b}, {s}, {d}] {qkv.dtype} on {qkv.device}, got "
            f"{tuple(d_o.shape)} {d_o.dtype} on {d_o.device}"
        )
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, d_o, num_heads, kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, got {qkv.device}")
    _check_cuda_operands(qkv, s, dh)
    if not d_o.is_contiguous():
        raise ValueError("attention kernel needs a contiguous dO")
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    with torch.cuda.device(qkv.device):
        err = _kernel_entries()[1](
            qkv.data_ptr(), d_o.data_ptr(), dqkv.data_ptr(), int(qkv.dtype == torch.bfloat16),
            b, num_heads, s, dh, kv, _scale(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    attention_qkv_bwd.launches += 1
    return dqkv


attention_qkv_bwd.launches = 0


class _AttentionKernel(torch.autograd.Function):
    """The two kernels as one differentiable function of the packed qkv."""

    @staticmethod
    def forward(ctx, qkv, num_heads, kv_len):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.kv_len = num_heads, kv_len
        return _launch_fwd(qkv, num_heads, kv_len)

    @staticmethod
    def backward(ctx, d_o):
        (qkv,) = ctx.saved_tensors
        return attention_qkv_bwd(qkv, d_o.contiguous(), ctx.num_heads, ctx.kv_len), None, None


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, kv_len: int = 0) -> torch.Tensor:
    """Multi-head attention straight off the packed qkv [B, S, 3·D] →
    [B, S, D]. ``kv_len`` (0 means S) is the number of real keys of a padded
    token axis; later keys are masked, all S query rows are computed.
    ``fused_attention_qkv.launches`` counts forward-kernel launches (CPU
    calls and empty inputs launch nothing and count nothing).
    """
    _geometry(qkv, num_heads, kv_len)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, got {qkv.device}")
    return _AttentionKernel.apply(qkv, num_heads, kv_len)


fused_attention_qkv.launches = 0
