"""Multi-head attention, off the packed qkv tensor and on q, k, v apart:
plain versions and CUDA kernels.

Counterpart of ``ssip_tpu/ops/attention.py``: ``attention_plain`` after
``attention_xla`` (``:43-56``), ``attention_qkv_plain`` after
``attention_qkv_xla`` (``:393-411``), ``fused_attention_qkv`` after the
entry of the same name (``:414-442``) with its custom VJP (``:369-390``) as
a ``torch.autograd.Function`` whose forward and backward launch the kernels
that replace ``_attn_qkv_kernel`` and ``_attn_qkv_bwd_kernel``: for bfloat16
those of ``csrc/attention_mma.cu`` (float32 FMA scores and ``mma.sync`` on
bf16 operands; up to 256 tokens a head a block, staged whole in shared
memory, the backward one launch; past it keys or queries streamed in tiles
of 64 by ``cp.async``, the backward two launches); for float32 those of
``csrc/attention_f32_mma.cu`` (3×TF32 products on ``mma.sync``, keys or
queries streamed in tiles of 64, an online softmax in the forward; the
backward two launches).

``qkv`` is [B, S, 3·D] with columns ordered [3, H, Dh] (the fused Dense of
``models/vit.py``); the result is [B, S, D]. Per image and head:
``s = q·kᵀ/√Dh`` as a float32 sum of products of the inputs, keys at index
≥ ``kv_len`` left out, float32 softmax, ``p`` rounded to the input type,
``o = p·v`` summed in float32 and rounded once. Saved for backward: in
bfloat16 ``qkv`` only (the backward recomputes the probabilities); in
float32 also the output and each query row's softmax statistics, which the
forward kernel writes beside it (``attention_qkv_residuals``): the float32
backward takes ``p`` from them and ``Σ_j dp·p`` as ``dO·o``, which holds
because a float32 ``o`` is never rounded.

``fused_attention(q, k, v)`` on [B, H, S, Dh] is the counterpart of the
entry of the same name (``:445-467``) with its custom VJP (``:187-205``):
its forward and backward kernels replace ``_attn_kernel`` (``:59-75``) and
``_attn_bwd_kernel`` (``:109-148``). Those two keep ``p`` and ``ds`` in
float32 for their products (``:73``, ``:135-145``) where the packed pair
rounds both to the input type, so this entry has plain versions of its own,
``attention_unrounded_plain`` and ``attention_bwd_plain``; in float32 the two
forms are the same function. No pad to 128 tokens exists here and every key
is real. For bfloat16 its kernels are those of
``csrc/attention_unpacked_mma.cu``: every product on ``mma.sync``, keys (or
queries) streamed in tiles of 64, ``p`` and ``ds`` entering their products
as bf16 hi/lo pairs; the backward is two launches joined by a float32
scratch this module allocates. For float32 its kernels are the packed
pair's, ``csrc/attention_f32_mma.cu``.

Sequences: any length in both types. Past 1024 tokens (``_MAX_FUSED_SEQ``,
the JAX entries' VMEM limit for their kernels) the JAX entry of
``fused_attention`` computes ``attention_xla``, which rounds ``p`` to the
input type: there this entry's plain versions are ``attention_plain`` and
``attention_rounded_bwd_plain``, and in bfloat16 its kernels are the packed
pair's, run on q, k, v (``csrc/attention_mma.cu``). The JAX packed entry
computes one function at every length (its kernel or ``attention_qkv_xla``),
and so does the port's.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain version (autograd differentiates it); a CUDA tensor launches the
kernels or raises.

While a program is traced (``torch.export``; ``torch.compiler.is_compiling``)
and nothing is differentiated, the packed forward is the custom operator
``torch.ops.ssip_tpu_torch.attention_qkv`` (``torch.library.custom_op``,
with a fake implementation for tracing): its CPU implementation is the plain
version and its CUDA one the kernel, so the exported program keeps one node
that runs the kernel on whichever device it is given (``deploy/export.py``).
An exported program needs this module imported. Eager calls launch
directly: the operator's dispatch would add host time to every call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_WIDTHS = (32, 64)
# the JAX entries' longest sequence for their kernels: past it the JAX
# ``fused_attention`` computes ``attention_xla``, which rounds p (csrc/attention.cu's kMaxFusedSeq)
_MAX_FUSED_SEQ = 1024
# the packed bf16 pair works a whole head in a block up to this many tokens,
# the backward in one launch with no scratch (csrc/attention_mma.cu's kWholeMaxSeq)
_WHOLE_MAX_SEQ = 256


@lru_cache(maxsize=None)
def _scale(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled-dot-product attention on q, k, v [B, H, S, Dh]: float32 sums
    of the inputs' products, float32 softmax, probabilities rounded to the
    input type before the second product."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * _scale(q.shape[-1])
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.to(torch.float32), v.to(torch.float32)).to(q.dtype)


def attention_unrounded_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attention_plain`` with the float32 probabilities left unrounded in
    the second product, as ``_attn_kernel`` computes it."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * _scale(q.shape[-1])
    return torch.matmul(torch.softmax(s, dim=-1), v.to(f32)).to(q.dtype)


def _bwd_written_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_o: torch.Tensor, rounded: bool):
    f32 = torch.float32
    qf, kf, vf, do = (t.to(f32) for t in (q, k, v, d_o))
    scale = _scale(q.shape[-1])
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    pc = p.to(q.dtype).to(f32) if rounded else p
    dv = torch.matmul(pc.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(q.dtype).to(f32) if rounded else ds
    dq = torch.matmul(dsc, kf) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_o: torch.Tensor):
    """(dq, dk, dv) as ``_attn_bwd_kernel`` computes them, written out
    (``ssip_tpu/ops/attention.py:122-148``): ``p`` recomputed, every product
    in float32, one rounding to the input type at the end."""
    return _bwd_written_out(q, k, v, d_o, rounded=False)


def attention_rounded_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_o: torch.Tensor):
    """(dq, dk, dv) as ``_attn_qkv_bwd_kernel`` computes them
    (``ssip_tpu/ops/attention.py:256-299``), on q, k, v [B, H, S, Dh] given
    apart: ``attention_bwd_plain`` with ``p`` and ``ds`` rounded to the
    input type before their products (``pc``, ``dsc``). The gradient of
    ``attention_plain``; what the card's rounded kernels are compared with."""
    return _bwd_written_out(q, k, v, d_o, rounded=True)


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
    q, k, v = _unpack(qkv, num_heads)
    do = d_o.reshape(b, s, num_heads, d // num_heads).permute(0, 2, 1, 3)
    dq, dk, dv = _bwd_written_out(q, k[:, :, :kv], v[:, :, :kv], do, rounded=True)
    out = torch.zeros((b, s, 3, num_heads, d // num_heads), dtype=qkv.dtype, device=qkv.device)
    out[:, :, 0] = dq.permute(0, 2, 1, 3)
    out[:, :kv, 1] = dk.permute(0, 2, 1, 3)
    out[:, :kv, 2] = dv.permute(0, 2, 1, 3)
    return out.view(b, s, three_d)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@lru_cache(maxsize=1)
def _kernel_entries():
    from ssip_tpu_torch.kernels.build import load_library

    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ssip_attention_qkv_fwd, lib.ssip_attention_qkv_bwd
    # qkv, o, row statistics (float32, or None), is_bf16, batch, heads, s, dh, kv, scale, stream
    fwd.argtypes = [p, p, p, i, i, i, i, i, i, f, p]
    # qkv, dO, dqkv, o and row statistics (float32), scratch, is_bf16, batch, heads, s, dh, kv, scale, stream
    bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@lru_cache(maxsize=1)
def _unpacked_kernel_entries():
    from ssip_tpu_torch.kernels.build import load_library

    lib = load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.ssip_attention_fwd, lib.ssip_attention_bwd
    # q, k, v, o, row statistics (float32, or None), is_bf16, batch·heads, s, dh, scale, stream
    fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    # q, k, v, dO, dq, dk, dv, o and row statistics (float32), scratch, is_bf16, batch·heads, s, dh, scale, stream
    bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, p]
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


def _check_cuda_operands(qkv: torch.Tensor, dh: int) -> None:
    """Raise on what the kernels do not take (any sequence length is taken)."""
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if dh not in _HEAD_WIDTHS:
        raise ValueError(f"attention kernel takes head widths {_HEAD_WIDTHS}, got {dh}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous packed qkv")


def _check_aligned(*operands: torch.Tensor) -> None:
    """The kernels stage rows by 16-byte copies."""
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError(f"{operands[0].dtype} attention kernel needs its operands at 16-byte aligned addresses")


def _check_residuals(residuals, out_shape, stats_rows: int, like: torch.Tensor):
    """The float32 backward's (o, stats) as ``*_residuals`` made them, or raise."""
    o, stats = residuals
    if (tuple(o.shape) != tuple(out_shape) or o.dtype != like.dtype or o.device != like.device
            or not o.is_contiguous() or stats is None or stats.dtype != torch.float32
            or stats.numel() != 2 * stats_rows or stats.device != like.device):
        raise ValueError("attention backward expects the (o, stats) its forward's residuals function returns")
    _check_aligned(o, stats)
    return o, stats


def _launch_fwd(qkv: torch.Tensor, num_heads: int, kv_len: int, with_stats: bool = False):
    """(o, stats): the forward kernel's output and, for float32 when
    ``with_stats``, each query row's softmax statistics, else None."""
    b, s, d, dh, kv = _geometry(qkv, num_heads, kv_len)
    _check_cuda_operands(qkv, dh)
    _check_aligned(qkv)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    want = with_stats and qkv.dtype == torch.float32
    stats = torch.empty(b * num_heads * 2 * _round16(s), device=qkv.device) if want else None
    if out.numel() == 0:
        return out, stats
    with torch.cuda.device(qkv.device):  # the launch's device; restored after
        err = _kernel_entries()[0](
            qkv.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
            int(qkv.dtype == torch.bfloat16), b, num_heads, s, dh, kv, _scale(dh),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    fused_attention_qkv.launches += 1
    return out, stats


def attention_qkv_residuals(qkv: torch.Tensor, num_heads: int, kv_len: int = 0):
    """(o, stats): what autograd keeps of the forward for
    ``attention_qkv_bwd``. ``o`` is the output; ``stats`` is, for float32 on
    the card, each query row's softmax statistics (float32
    [B·H, 2, round16(S)]: −max·scale·log2 e and 1/sum, written by the
    forward kernel in the same launch), else None (the bfloat16 kernels and
    the plain version recompute the probabilities). On the card it counts
    one forward launch."""
    _geometry(qkv, num_heads, kv_len)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, kv_len), None
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, got {qkv.device}")
    return _launch_fwd(qkv, num_heads, kv_len, with_stats=True)


def attention_qkv_bwd(qkv: torch.Tensor, d_o: torch.Tensor, num_heads: int, kv_len: int = 0,
                      residuals=None) -> torch.Tensor:
    """dqkv [B, S, 3·D] from the saved ``qkv`` and the incoming ``d_o``
    [B, S, D], for any ``d_o`` (pad-query rows included); key rows at index
    ≥ ``kv_len`` get zeros. The float32 kernels read the forward's output
    and row statistics, ``residuals`` as ``attention_qkv_residuals`` returns
    them; without them a float32 call on the card runs that forward first
    (one more forward launch). bfloat16 and the CPU ignore ``residuals``.
    ``attention_qkv_bwd.launches`` counts calls that launch the backward,
    one a call: in bfloat16 up to 256 tokens one kernel, a head a block (a
    pass over its query rows for dq, then one over its key rows for dk and
    dv), past it and in float32 two kernels (dq by query rows, then dk and
    dv by key rows)."""
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
    _check_cuda_operands(qkv, dh)
    if not d_o.is_contiguous():
        raise ValueError("attention kernel needs a contiguous dO")
    _check_aligned(qkv, d_o)
    dqkv = torch.empty_like(qkv)
    if dqkv.numel() == 0:
        return dqkv
    bf16 = qkv.dtype == torch.bfloat16
    o = stats = None
    if not bf16:
        if residuals is None:
            residuals = _launch_fwd(qkv, num_heads, kv_len, with_stats=True)
        o, stats = _check_residuals(residuals, (b, s, d), b * num_heads * _round16(s), qkv)
    # between the two launches: bf16 past 256 tokens each row's max, 1/sum and delta; float32 delta
    scratch = None if bf16 and s <= _WHOLE_MAX_SEQ else torch.empty(
        b * num_heads * (3 if bf16 else 1) * _round16(s), device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _kernel_entries()[1](
            qkv.data_ptr(), d_o.data_ptr(), dqkv.data_ptr(), None if o is None else o.data_ptr(),
            None if stats is None else stats.data_ptr(), None if scratch is None else scratch.data_ptr(), int(bf16),
            b, num_heads, s, dh, kv, _scale(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    attention_qkv_bwd.launches += 1
    return dqkv


attention_qkv_bwd.launches = 0


class _AttentionKernel(torch.autograd.Function):
    """The kernels as one differentiable function of the packed qkv; in
    float32 the forward's output and row statistics are saved too."""

    @staticmethod
    def forward(ctx, qkv, num_heads, kv_len):
        out, stats = _launch_fwd(qkv, num_heads, kv_len, with_stats=True)
        ctx.save_for_backward(qkv, *(() if stats is None else (out, stats)))
        ctx.num_heads, ctx.kv_len = num_heads, kv_len
        return out

    @staticmethod
    def backward(ctx, d_o):
        qkv, *residuals = ctx.saved_tensors
        dqkv = attention_qkv_bwd(qkv, d_o.contiguous(), ctx.num_heads, ctx.kv_len, residuals or None)
        return dqkv, None, None


@torch.library.custom_op("ssip_tpu_torch::attention_qkv", mutates_args=())
def attention_qkv_op(qkv: torch.Tensor, num_heads: int, kv_len: int) -> torch.Tensor:
    """The packed forward with nothing to differentiate, as a traced program
    holds it: the plain version on the CPU, the kernel on the card."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, kv_len)
    return _launch_fwd(qkv, num_heads, kv_len)[0]


@attention_qkv_op.register_fake
def _(qkv, num_heads, kv_len):
    b, s, three_d = qkv.shape
    return qkv.new_empty((b, s, three_d // 3))


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, kv_len: int = 0) -> torch.Tensor:
    """Multi-head attention straight off the packed qkv [B, S, 3·D] →
    [B, S, D]. ``kv_len`` (0 means S) is the number of real keys of a padded
    token axis; later keys are masked, all S query rows are computed.
    ``fused_attention_qkv.launches`` counts forward-kernel launches (CPU
    calls and empty inputs launch nothing and count nothing).
    """
    _geometry(qkv, num_heads, kv_len)
    differentiate = torch.is_grad_enabled() and qkv.requires_grad
    if not differentiate and torch.compiler.is_compiling():
        return attention_qkv_op(qkv, num_heads, kv_len)  # a traced program keeps the operator
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, kv_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, got {qkv.device}")
    if differentiate:
        return _AttentionKernel.apply(qkv, num_heads, kv_len)
    return _launch_fwd(qkv, num_heads, kv_len)[0]  # nothing to differentiate: no autograd node to set up


fused_attention_qkv.launches = 0


def _check_unpacked(q: torch.Tensor, *others: torch.Tensor) -> None:
    """q [B, H, S, Dh]; every other operand of q's shape, type and device."""
    if q.dim() != 4:
        raise ValueError(f"fused_attention expects q, k, v [B, H, S, Dh], got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"fused_attention expects operands of one shape, type and device, got {tuple(q.shape)} "
                f"{q.dtype} on {q.device} and {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _check_unpacked_cuda(*operands: torch.Tensor) -> None:
    q = operands[0]
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, got {q.device}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("attention kernel needs contiguous q, k, v and dO")
    _check_cuda_operands(q, q.shape[3])
    _check_aligned(*operands)


def _rounds_p(q: torch.Tensor) -> bool:
    """Whether ``fused_attention``'s function at q's length rounds ``p``
    (the JAX entry's ``attention_xla`` past ``_MAX_FUSED_SEQ``)."""
    return q.shape[2] > _MAX_FUSED_SEQ


def _unpacked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fused_attention``'s plain version at q's length."""
    return (attention_plain if _rounds_p(q) else attention_unrounded_plain)(q, k, v)


def _launch_unpacked_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_stats: bool = False):
    """(o, stats), as ``_launch_fwd``."""
    _check_unpacked_cuda(q, k, v)
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    want = with_stats and q.dtype == torch.float32
    stats = torch.empty(b * h * 2 * _round16(s), device=q.device) if want else None
    if out.numel() == 0:
        return out, stats
    with torch.cuda.device(q.device):  # the launch's device; restored after
        err = _unpacked_kernel_entries()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
            int(q.dtype == torch.bfloat16), b * h, s, dh, _scale(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out, stats


def attention_residuals(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o, stats) of q, k, v [B, H, S, Dh] for ``attention_bwd``, as
    ``attention_qkv_residuals`` gives them for the packed pair."""
    _check_unpacked(q, k, v)
    if q.device.type == "cpu":
        return _unpacked_plain(q, k, v), None
    return _launch_unpacked_fwd(q, k, v, with_stats=True)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_o: torch.Tensor, residuals=None):
    """(dq, dk, dv), each [B, H, S, Dh] in the inputs' type, from the saved
    q, k, v and the incoming ``d_o``. ``residuals`` as for
    ``attention_qkv_bwd`` (``attention_residuals`` makes them; without them
    a float32 call on the card runs the forward first).
    ``attention_bwd.launches`` counts calls that launch the backward (one a
    call: two kernels, dq by query rows, then dk and dv by key rows)."""
    _check_unpacked(q, k, v, d_o)
    if q.device.type == "cpu":
        return (attention_rounded_bwd_plain if _rounds_p(q) else attention_bwd_plain)(q, k, v, d_o)
    _check_unpacked_cuda(q, k, v, d_o)
    b, h, s, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if q.numel() == 0:
        return dq, dk, dv
    bf16 = q.dtype == torch.bfloat16
    o = stats = None
    if not bf16:
        if residuals is None:
            residuals = _launch_unpacked_fwd(q, k, v, with_stats=True)
        o, stats = _check_residuals(residuals, q.shape, b * h * _round16(s), q)
    # between the two launches: bf16 each row's max, 1/sum and delta; float32 delta
    scratch = torch.empty(b * h * (3 if bf16 else 1) * _round16(s), device=q.device)
    with torch.cuda.device(q.device):
        err = _unpacked_kernel_entries()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if o is None else o.data_ptr(), None if stats is None else stats.data_ptr(),
            scratch.data_ptr(), int(bf16), b * h, s, dh, _scale(dh), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


class _UnpackedAttentionKernel(torch.autograd.Function):
    """The kernels as one differentiable function of q, k, v; in float32 the
    forward's output and row statistics are saved too."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, stats = _launch_unpacked_fwd(q, k, v, with_stats=True)
        ctx.save_for_backward(q, k, v, *(() if stats is None else (out, stats)))
        return out

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, *residuals = ctx.saved_tensors
        return attention_bwd(q, k, v, d_o.contiguous(), residuals or None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention on q, k, v [B, H, S, Dh] → [B, H, S, Dh]:
    float32 scores and softmax, float32 probabilities times ``v`` (past
    1024 tokens rounded to the input type first, as the JAX entry computes
    there), one rounding to the input type. ``fused_attention.launches`` counts
    forward-kernel launches (CPU calls and empty inputs launch nothing and
    count nothing)."""
    _check_unpacked(q, k, v)
    if q.device.type == "cpu":
        return _unpacked_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _UnpackedAttentionKernel.apply(q, k, v)
    return _launch_unpacked_fwd(q, k, v)[0]  # nothing to differentiate: no autograd node to set up


fused_attention.launches = 0
