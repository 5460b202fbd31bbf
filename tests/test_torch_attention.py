"""The port's packed-qkv attention against the JAX package's, forward and
gradients, with and without the ``kv_len`` key mask; and the port's
``fused_attention`` on q, k, v apart against the JAX entry of that name.

The same numpy-seeded inputs go through
``ssip_tpu.ops.attention.fused_attention_qkv`` (the Pallas kernels in
interpret mode, and the XLA reference) and the port's plain version, which
is what the port's ``fused_attention_qkv`` runs for a CPU tensor. float32
agrees within 1e-5; bfloat16 within one bfloat16 step of the JAX value
(gradients within 1e-2 of each tensor's largest entry).

``fused_attention`` keeps the probabilities in float32 for ``p·v``, as the
Pallas kernels behind the JAX entry do, where ``attention_xla`` rounds them to
the input type first. In float32 that is the same function; in bfloat16 the
port is held to the Pallas kernels (interpret mode) at the tolerances above,
and to ``attention_xla`` within two bfloat16 steps of the value or 2⁻⁸ of the
tensor's largest entry, whichever is larger: rounding 197 probabilities to 8
bits moves a sum of them by up to that. Cases run past 256 tokens (257, 577)
and past the JAX entries' 1024 (1025), where the JAX packed entry computes
``attention_qkv_xla`` and its ``fused_attention`` computes ``attention_xla``,
which rounds ``p``: the port's ``fused_attention`` computes that function
there too. The last tests emulate the kernels'
arithmetic on the CPU: the bfloat16 kernels' (p and ds as bf16 hi/lo pairs)
and the float32 kernels' (3×TF32 products, forward and backward), showing
why each splits what it splits, and check the float32 kernels' fragment
maps lane by lane; the bfloat16 whole-head forward's index maps are
emulated in numpy too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.attention import attention_qkv_xla, attention_xla
from ssip_tpu.ops.attention import fused_attention as jax_fused_attention
from ssip_tpu.ops.attention import fused_attention_qkv as jax_fused_attention_qkv
from ssip_tpu_torch.ops.attention import (
    attention_bwd, attention_bwd_plain, attention_plain, attention_qkv_bwd, attention_qkv_bwd_plain,
    attention_qkv_plain, attention_residuals, attention_rounded_bwd_plain, attention_unrounded_plain,
    fused_attention, fused_attention_qkv,
)

torch.set_num_threads(2)

# (batch, tokens, heads, head width, kv_len, type)
CASES = [
    (2, 10, 2, 8, 0, "float32"), (2, 17, 3, 16, 13, "float32"), (1, 50, 2, 64, 37, "float32"),
    (2, 208, 1, 32, 197, "float32"), (3, 16, 4, 8, 16, "float32"),
    (2, 17, 3, 16, 0, "bfloat16"), (2, 48, 2, 64, 41, "bfloat16"),
    # past the packed bf16 kernels' former 256 (interpret mode), and past the
    # JAX entry's 1024, where it computes attention_qkv_xla
    (1, 257, 2, 32, 250, "float32"), (2, 257, 2, 32, 197, "bfloat16"),
    (1, 1025, 2, 32, 1000, "float32"), (1, 1025, 2, 32, 1001, "bfloat16"),
]


def _inputs(case, seed: int = 0):
    b, s, heads, dh, _, dtype = case
    rng = np.random.default_rng(seed + b * s * heads)
    qkv = rng.standard_normal((b, s, 3 * heads * dh)).astype(np.float32)
    d_o = rng.standard_normal((b, s, heads * dh)).astype(np.float32)  # non-zero on pad-query rows too
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (jnp.asarray(qkv).astype(jdt), jnp.asarray(d_o).astype(jdt)), (
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(d_o).to(tdt))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, dtype: str, what: str) -> None:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=what)
    else:
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= np.maximum(step, 1e-5)).all(), (what, np.abs(got - want).max())


def _assert_grad_close(got, want, dtype: str, what: str) -> None:
    got, want = _f32(got), _f32(want)
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert rel <= (1e-5 if dtype == "float32" else 1e-2), (what, rel)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_forward_matches_pallas_interpret_and_xla(case):
    _, s, heads, _, kv_len, dtype = case
    (jqkv, _), (tqkv, _) = _inputs(case)
    got = fused_attention_qkv(tqkv, heads, kv_len)
    assert got.dtype == tqkv.dtype and got.shape == (*tqkv.shape[:2], tqkv.shape[2] // 3)
    # Past 1024 tokens the JAX entry is attention_qkv_xla itself. Over a
    # thousand keys each output is a sum of a thousand bf16(p) products, and
    # the p that XLA's exp and torch's round apart move it by one step of the
    # larger value (7 of 65,600 outputs at 1025 tokens lie a step of the
    # smaller past it): held as the file holds the port to attention_xla.
    close = _assert_close_to_rounded_p if s > 1024 else _assert_close
    close(got, jax_fused_attention_qkv(jqkv, heads, kv_len=kv_len, interpret=True), dtype, "interpret")
    close(got, attention_qkv_xla(jqkv, heads, kv_len=kv_len), dtype, "xla")
    assert torch.equal(got, attention_qkv_plain(tqkv, heads, kv_len))  # a CPU tensor takes the plain version


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_gradients_match_jax_vjp(case, use_pallas):
    """Autograd through the plain version, and the backward written out as
    the kernel computes it, against ``jax.vjp`` of the Pallas custom VJP
    (interpret mode) and of the XLA reference; pad-query rows carry a
    non-zero ``dO``, and masked keys get zero gradients."""
    _, s, heads, dh, kv_len, dtype = case
    (jqkv, jdo), (tqkv, tdo) = _inputs(case, seed=1)
    kwargs = {"interpret": True} if use_pallas else {"use_pallas": False}
    _, vjp = jax.vjp(lambda x: jax_fused_attention_qkv(x, heads, kv_len=kv_len, **kwargs), jqkv)
    (want,) = vjp(jdo)

    leaf = tqkv.clone().requires_grad_()
    (got,) = torch.autograd.grad(fused_attention_qkv(leaf, heads, kv_len), leaf, tdo)
    written_out = attention_qkv_bwd(tqkv, tdo, heads, kv_len)
    assert got.dtype == written_out.dtype == tqkv.dtype
    d = heads * dh
    for i, part in enumerate("qkv"):  # each of dq, dk, dv against its own largest entry
        cols = slice(i * d, (i + 1) * d)
        _assert_grad_close(got[..., cols], want[..., cols], dtype, f"autograd d{part}")
        _assert_grad_close(written_out[..., cols], want[..., cols], dtype, f"written out d{part}")
    if 0 < kv_len < s:
        assert not got[:, kv_len:, d:].any() and not written_out[:, kv_len:, d:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpacked_attention_matches_attention_xla(dtype):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, 11, 16)).astype(np.float32) for _ in range(3))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = attention_xla(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    got = attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    _assert_close(got, want, dtype, "attention_plain")


def test_masked_keys_do_not_reach_real_rows():
    """With ``kv_len`` set, whatever sits in the pad keys and values leaves
    every output row unchanged."""
    (_, _), (qkv, _) = _inputs((2, 24, 2, 8, 19, "float32"), seed=2)
    other = qkv.clone()
    other[:, 19:, 16:] = 1e3  # the pad rows' k and v columns
    assert torch.equal(fused_attention_qkv(qkv, 2, 19), fused_attention_qkv(other, 2, 19))
    assert not torch.equal(fused_attention_qkv(qkv, 2), fused_attention_qkv(other, 2))
    assert torch.equal(fused_attention_qkv(qkv, 2, 24), fused_attention_qkv(qkv, 2, 0))  # kv_len = S masks nothing
    assert torch.equal(fused_attention_qkv(qkv, 2, 99), fused_attention_qkv(qkv, 2, 0))


def test_wrapper_raises_on_wrong_operands():
    with pytest.raises(ValueError, match="packed qkv must be"):
        fused_attention_qkv(torch.zeros((2, 4, 30)), 4)
    with pytest.raises(ValueError, match="kv_len must be"):
        fused_attention_qkv(torch.zeros((2, 4, 24)), 2, -1)
    with pytest.raises(ValueError, match="expects dO"):
        attention_qkv_bwd(torch.zeros((2, 4, 24)), torch.zeros((2, 4, 24)), 2)
    # no sequence limit, past the JAX entry's 1024 too
    long = torch.zeros((1, 1032, 3 * 8))
    assert fused_attention_qkv(long, 1).shape == (1, 1032, 8)


# (batch, heads, tokens, head width, type)
UNPACKED_CASES = [
    (2, 3, 11, 16, "float32"), (1, 2, 50, 64, "float32"), (2, 1, 197, 32, "float32"),
    (2, 3, 11, 16, "bfloat16"), (1, 2, 50, 64, "bfloat16"), (1, 1, 197, 64, "bfloat16"),
    (1, 2, 577, 64, "bfloat16"),  # past the packed bf16 kernels' 256: ViT-B/16's tokens at 384²
]


def _unpacked_inputs(case, seed: int = 0):
    b, h, s, dh, dtype = case
    rng = np.random.default_rng(seed + b * h * s)
    arrays = [rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(4)]  # q, k, v, dO
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return [jnp.asarray(a).astype(jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def _assert_close_to_rounded_p(got, want, dtype: str, what: str) -> None:
    """Against ``attention_xla``, which rounds ``p`` to the input type."""
    if dtype == "float32":
        return _assert_close(got, want, dtype, what)
    got, want = _f32(got), _f32(want)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    tol = np.maximum(2 * step, np.abs(want).max() * 2.0**-8)
    assert (np.abs(got - want) <= tol).all(), (what, np.abs(got - want).max())


@pytest.mark.parametrize("case", UNPACKED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_unpacked_forward_matches_pallas_interpret_and_xla(case):
    dtype = case[-1]
    (jq, jk, jv, _), (tq, tk, tv, _) = _unpacked_inputs(case)
    before = fused_attention.launches
    got = fused_attention(tq, tk, tv)
    assert fused_attention.launches == before  # a CPU call launches nothing
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _assert_close(got, jax_fused_attention(jq, jk, jv, interpret=True), dtype, "interpret")
    _assert_close_to_rounded_p(got, attention_xla(jq, jk, jv), dtype, "xla")
    assert torch.equal(got, attention_unrounded_plain(tq, tk, tv))  # a CPU tensor takes the plain version
    if dtype == "float32":  # no rounding of p to speak of: the packed pair's plain version is the same function
        _assert_close(got, attention_plain(tq, tk, tv), dtype, "attention_plain")


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", UNPACKED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_unpacked_gradients_match_jax_vjp(case, use_pallas):
    """Autograd through the plain version, and the backward written out as
    the kernel computes it, against ``jax.vjp`` of the Pallas custom VJP
    (interpret mode) and of ``attention_xla``."""
    dtype = case[-1]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _unpacked_inputs(case, seed=1)
    kwargs = {"interpret": True} if use_pallas else {"use_pallas": False}
    _, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, **kwargs), jq, jk, jv)
    want = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = torch.autograd.grad(fused_attention(*leaves), leaves, tdo)
    written_out = attention_bwd(tq, tk, tv, tdo)
    assert all(torch.equal(a, b) for a, b in zip(written_out, attention_bwd_plain(tq, tk, tv, tdo)))
    for name, g, w_out, w in zip("qkv", got, written_out, want):
        assert g.dtype == w_out.dtype == tq.dtype and g.shape == tq.shape
        _assert_grad_close(g, w, dtype, f"autograd d{name}")
        _assert_grad_close(w_out, w, dtype, f"written out d{name}")


def test_unpacked_wrapper_raises_on_wrong_operands():
    q = torch.zeros((2, 2, 4, 8))
    with pytest.raises(ValueError, match=r"q, k, v \[B, H, S, Dh\]"):
        fused_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="one shape, type and device"):
        fused_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="one shape, type and device"):
        fused_attention(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one shape, type and device"):
        attention_bwd(q, q, q, q[..., :4])
    # no sequence limit, past the JAX entry's 1024 too
    long = torch.zeros((1, 1, 1032, 8))
    assert fused_attention(long, long, long).shape == long.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpacked_past_1024_matches_attention_xla(dtype):
    """Past 1024 tokens the JAX ``fused_attention`` computes ``attention_xla``
    (``p`` rounded to the input type) even when asked for its kernel, and so
    does the port's: forward within one step of it, gradients (autograd and
    written out) within 1e-2 of each tensor's max of ``jax.vjp``'s."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _unpacked_inputs((1, 2, 1025, 32, dtype), seed=3)
    want = jax_fused_attention(jq, jk, jv, interpret=True)
    got = fused_attention(tq, tk, tv)
    _assert_close_to_rounded_p(got, want, dtype, "forward")  # as the packed entry past 1024
    assert torch.equal(got, attention_plain(tq, tk, tv))  # the rounded form: a CPU tensor takes its plain version
    assert torch.equal(attention_residuals(tq, tk, tv)[0], got)
    _, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, interpret=True), jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    autograd = torch.autograd.grad(fused_attention(*leaves), leaves, tdo)
    written_out = attention_bwd(tq, tk, tv, tdo)
    assert all(torch.equal(a, b) for a, b in zip(written_out, attention_rounded_bwd_plain(tq, tk, tv, tdo)))
    for name, g, w_out, w in zip("qkv", autograd, written_out, vjp(jdo)):
        _assert_grad_close(g, w, dtype, f"autograd d{name}")
        _assert_grad_close(w_out, w, dtype, f"written out d{name}")


def _outside_one_step(got: torch.Tensor, ref: torch.Tensor) -> int:
    """How many of ``got`` lie further than one bfloat16 step of the plain
    value ``ref`` (2e-5 where a step is smaller): the card's element gate."""
    err = (got.float() - ref.float()).abs()
    step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    return int((err > torch.maximum(step, torch.full_like(step, 2e-5))).sum())


def _emulated_bf16_kernels(q, k, v, d_o, split: bool):
    """(o, dq, dk, dv) as the bfloat16 kernels of
    ``csrc/attention_unpacked_mma.cu`` compute them, in float32 on the CPU:
    scores of the bf16 inputs summed in float32 and scaled after the sum by
    scale·log2(e), keys in tiles of 64 with a running max and sum, o times
    1/sum at the end; p and ds enter their products as a bf16 hi/lo pair
    (``split``) or rounded to bf16 once (the shortcut the kernels do not
    take), q, k, v, dO as they are."""
    f32, bf16 = torch.float32, torch.bfloat16

    def times(a, b):
        hi = a.to(bf16).to(f32)
        if not split:
            return hi @ b
        return hi @ b + (a - hi).to(bf16).to(f32) @ b

    qf, kf, vf, do = (t.to(f32) for t in (q, k, v, d_o))
    scale = float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    scale_log2 = float(np.float32(scale) * np.float32(np.log2(np.e)))
    mx = torch.full(q.shape[:-1] + (1,), -np.inf)
    total = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape)
    for k0 in range(0, q.shape[2], 64):
        x = (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * scale_log2
        m_new = torch.maximum(mx, x.amax(-1, keepdim=True))
        f = torch.exp2(mx - m_new)
        total, acc, mx = total * f, acc * f, m_new
        e = torch.exp2(x - mx)
        total = total + e.sum(-1, keepdim=True)
        acc = acc + times(e, vf[:, :, k0:k0 + 64])
    o = acc * (1.0 / total)
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * scale_log2 - mx) * (1.0 / total)
    dp = do @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = times(ds, kf) * scale
    dk = times(ds.transpose(-1, -2), qf) * scale
    dv = times(p.transpose(-1, -2), do)
    return tuple(t.to(bf16) for t in (o, dq, dk, dv))


def test_bf16_kernels_need_p_and_ds_split_to_hold_one_step():
    """Why the bfloat16 kernels take p and ds as hi/lo pairs: emulated in
    float32, the split form puts no output and no gradient further than one
    bfloat16 step (or 2e-5) from ``attention_unrounded_plain`` and
    ``attention_bwd_plain``, at ViT-B/16's 12 heads of 64 over 197 tokens;
    p and ds rounded to bf16 once put some of each beyond it."""
    rng = np.random.default_rng(7)
    q, k, v, d_o = (torch.from_numpy(rng.standard_normal((2, 12, 197, 64)).astype(np.float32)).to(torch.bfloat16)
                    for _ in range(4))
    refs = (attention_unrounded_plain(q, k, v), *attention_bwd_plain(q, k, v, d_o))
    split = [_outside_one_step(got, ref) for got, ref in zip(_emulated_bf16_kernels(q, k, v, d_o, True), refs)]
    once = [_outside_one_step(got, ref) for got, ref in zip(_emulated_bf16_kernels(q, k, v, d_o, False), refs)]
    assert split == [0, 0, 0, 0], split
    assert all(n > 0 for n in once), once


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` cut to TF32 as the kernel's split cuts it and as the tensor core
    reads a float32 operand: 10 mantissa bits, the low 13 bits cleared
    (toward zero), kept as float32."""
    return (x.to(torch.float32).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


# The kernels' orders inside a product (csrc/attention_f32_mma.cu): the scores
# take d as (16kk + 4t, +1) in the first k step of a float4 and (+2, +3) in the
# second; the next product takes an 8-column slice as k = t for column 2t,
# k = t + 4 for column 2t + 1.
_D_ORDER = [16 * kk + x for kk in range(4) for x in (0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)]
_KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _tf32_times(split: bool):
    """a @ b (k over the last axis of a) of TF32 operands: split into
    hi + lo with the three terms a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
    (``split``), or one TF32 product (the shortcut the kernels do not take).
    hi = tf32(x), lo = x - hi, and the tensor core reads tf32(lo)."""

    def times(a, b):
        a_hi, b_hi = _tf32(a), _tf32(b)
        if not split:
            return a_hi @ b_hi
        return (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi)) + a_hi @ b_hi

    return times


def _relabelled(start: int, stop: int) -> list:
    """Rows start .. stop-1 of a 64-row tile in the order the second product
    of the kernels takes them (k = t is row 2t of each 8-row slice)."""
    return [start + 8 * j + i for j in range(-(-(stop - start) // 8)) for i in _KEY_ORDER if start + 8 * j + i < stop]


def _f32_constants(dh: int):
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    return [d for d in _D_ORDER if d < dh], scale, float(np.float32(scale) * np.float32(np.log2(np.e)))


def _emulated_f32_forward(q, k, v, kv: int, split: bool, with_stats: bool = False):
    """o as the float32 forward of ``csrc/attention_f32_mma.cu`` computes
    it, in float32 on the CPU: keys past ``kv`` left out, key tiles of 64
    with a running max and sum, scores scaled by scale·log2(e) after the
    sum, o times 1/sum at the end; every product of TF32 operands
    (``_tf32_times``), in the kernel's d and key orders. ``with_stats``:
    (o, shift, inv), the row statistics the kernel writes for the backward
    (−max·scale·log2 e and 1/sum), each [..., S, 1]."""
    times = _tf32_times(split)
    d_order, _, scale_log2 = _f32_constants(q.shape[-1])
    mx = torch.full(q.shape[:-1] + (1,), -np.inf)
    total = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape)
    for k0 in range(0, kv, 64):
        k1 = min(k0 + 64, kv)
        s = times(q[..., d_order], k[:, :, k0:k1][..., d_order].transpose(-1, -2))
        m_new = torch.maximum(mx, s.amax(-1, keepdim=True))
        f = torch.exp2((mx - m_new) * scale_log2)
        total, acc, mx = total * f, acc * f, m_new
        e = torch.exp2(s * scale_log2 - mx * scale_log2)
        total = total + e.sum(-1, keepdim=True)
        keys = _relabelled(k0, k1)
        acc = acc + times(e[..., [key - k0 for key in keys]], v[:, :, keys])
    o = acc * (1.0 / total)
    return (o, -mx * scale_log2, 1.0 / total) if with_stats else o


def _emulated_f32_backward(q, k, v, d_o, kv: int, split: bool):
    """(dq, dk, dv) as the float32 backward kernels of
    ``csrc/attention_f32_mma.cu`` compute them, in float32 on the CPU, from
    the emulated forward's o and row statistics: delta = rowsum(dO ∘ o);
    the rows kernel over key tiles of 64 (s = q·kᵀ and dp = dO·vᵀ, p from
    the statistics, ds = p·(dp − delta), dq += ds·k), the keys kernel over
    query tiles of 64 (sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, dv += pᵀ·dO, dk += dsᵀ·q),
    every product ``_tf32_times`` in the kernels' d and row orders. dk and
    dv are [..., kv, Dh]: the kernel writes zeros past kv."""
    times = _tf32_times(split)
    d_order, scale, scale_log2 = _f32_constants(q.shape[-1])
    o, shift, inv = _emulated_f32_forward(q, k, v, kv, split, with_stats=True)
    delta = (d_o * o).sum(-1, keepdim=True)

    def probs(scores, shift, inv):  # 2^(s·scale·log2 e + shift) by one fma, times 1/sum
        return torch.exp2((scores.double() * scale_log2 + shift.double()).float()) * inv

    k, v = k[:, :, :kv], v[:, :, :kv]
    dq = torch.zeros(q.shape)
    for k0 in range(0, kv, 64):
        keys = _relabelled(k0, min(k0 + 64, kv))
        s = times(q[..., d_order], k[:, :, keys][..., d_order].transpose(-1, -2))
        dp = times(d_o[..., d_order], v[:, :, keys][..., d_order].transpose(-1, -2))
        dq = dq + times(probs(s, shift, inv) * (dp - delta), k[:, :, keys])
    dk, dv = torch.zeros(k.shape), torch.zeros(k.shape)
    for i0 in range(0, q.shape[2], 64):
        rows = _relabelled(i0, min(i0 + 64, q.shape[2]))
        s_t = times(k[..., d_order], q[:, :, rows][..., d_order].transpose(-1, -2))
        dp_t = times(v[..., d_order], d_o[:, :, rows][..., d_order].transpose(-1, -2))
        p_t = probs(s_t, shift[:, :, rows].transpose(-1, -2), inv[:, :, rows].transpose(-1, -2))
        dv = dv + times(p_t, d_o[:, :, rows])
        dk = dk + times(p_t * (dp_t - delta[:, :, rows].transpose(-1, -2)), q[:, :, rows])
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("b,heads,s,kv", [(2, 12, 197, 197), (2, 3, 208, 197), (1, 2, 130, 65)],
                         ids=["vit_b16-heads", "packed-kv_len", "ragged-tiles"])
def test_f32_kernel_needs_3xtf32_to_hold_2e_5(b, heads, s, kv):
    """Why the float32 forward splits every operand into TF32 hi + lo:
    emulated in float32, the three-term product puts no output further than
    2e-5 (the card's float32 gate) from ``attention_unrounded_plain``, at
    ViT-B/16's 12 heads of 64 over 197 tokens and at a packed ``kv_len``
    below S; one TF32 product puts some outputs beyond it."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, heads, s, 64)).astype(np.float32)) for _ in range(3))
    ref = attention_unrounded_plain(q, k[:, :, :kv], v[:, :, :kv])
    outside = {}
    for split in (True, False):
        err = (_emulated_f32_forward(q, k, v, kv, split) - ref).abs()
        outside[split] = int((err > 2e-5).sum())
        print(f"{'3xTF32' if split else '1xTF32'}: {outside[split]} of {err.numel()} outputs beyond 2e-5, "
              f"max |d| {err.max().item():.3g}")
    assert outside[True] == 0, outside
    assert outside[False] > 0, outside


@pytest.mark.parametrize("packed", [False, True], ids=["vit_b16-heads", "packed-kv_len"])
def test_f32_backward_needs_3xtf32_to_hold_1e_5_of_max(packed):
    """Why the float32 backward splits every operand, p and ds into TF32
    hi + lo: emulated in float32, with delta from the emulated forward's o
    and p from its max and sum, the three-term products put every element of
    dq, dk and dv within 1e-5 of each tensor's largest entry (the card's
    float32 gradient gate) of ``attention_bwd_plain`` at [2, 12, 197, 64],
    and of ``attention_qkv_bwd_plain`` on a packed [2, 208, 3·3·64] with
    ``kv_len`` 197; one TF32 product puts some beyond it."""
    rng = np.random.default_rng(13)
    if packed:
        b, s, heads, dh, kv = 2, 208, 3, 64, 197
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * heads * dh)).astype(np.float32))
        d_o = torch.from_numpy(rng.standard_normal((b, s, heads * dh)).astype(np.float32))
        q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
        d_o = d_o.view(b, s, heads, dh).permute(0, 2, 1, 3)
        ref = attention_qkv_bwd_plain(qkv, d_o.permute(0, 2, 1, 3).reshape(b, s, -1), heads, kv)
        refs = ref.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
        assert not refs[1:, :, :, kv:].any()  # the kernel writes zeros past kv
        refs = (refs[0], refs[1][:, :, :kv], refs[2][:, :, :kv])
    else:
        q, k, v, d_o = (torch.from_numpy(rng.standard_normal((2, 12, 197, 64)).astype(np.float32)) for _ in range(4))
        kv, refs = 197, attention_bwd_plain(q, k, v, d_o)
    rels = {}
    for split in (True, False):
        got = _emulated_f32_backward(q, k, v, d_o, kv, split)
        rels[split] = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, refs)]
        print(f"{'3xTF32' if split else '1xTF32'}: dq, dk, dv off by {rels[split]} of their max")
    assert max(rels[True]) <= 1e-5, rels
    assert max(rels[False]) > 1e-5, rels


def _swz32(row, chunk, dh: int):
    """``swz32<DH>`` of ``csrc/attention_f32_mma.cu``: the float offset of a
    16-byte chunk in a staged [rows, DH] float32 matrix."""
    f = (((row >> 1) & 3) << 1) ^ ((row & 1) << 2)
    return row * dh + ((chunk ^ f) << 2)


def _staged(x: np.ndarray) -> np.ndarray:
    """x [64, DH] as ``stage_rows`` leaves it in shared memory; each phase of
    8 cp.async writes falls on 8 distinct bank groups."""
    dh = x.shape[1]
    smem = np.zeros(x.size)
    rows, chunks = np.divmod(np.arange(x.size // 4), dh // 4)  # staging: idx -> (row, chunk)
    for idx0 in range(0, rows.size, 8):
        assert len({(_swz32(r, c, dh) // 4) % 8 for r, c in zip(rows[idx0:idx0 + 8], chunks[idx0:idx0 + 8])}) == 8
    for r, c in zip(rows, chunks):
        smem[_swz32(r, c, dh):_swz32(r, c, dh) + 4] = x[r, 4 * c:4 * c + 4]
    return smem


def _load4(smem: np.ndarray, row, chunk, dh: int) -> np.ndarray:
    """One 16-byte shared load a lane → [32 lanes, 4]; the lanes of each
    quarter warp fall on distinct bank groups."""
    offs = _swz32(row, chunk, dh)
    for quarter in range(4):
        assert len(set((offs[8 * quarter:8 * quarter + 8] // 4) % 8)) == 8
    return np.stack([smem[offs + j] for j in range(4)], 1)


def _mma_m16n8k8(a, b, c):
    """``mma.sync.aligned.m16n8k8.row.col`` (in float64) from its PTX fragment
    layouts: lane (g, t) = (lane >> 2, lane & 3) holds A[g][t], A[g+8][t],
    A[g][t+4], A[g+8][t+4]; B[t][g], B[t+4][g]; D[g][2t], D[g][2t+1],
    D[g+8][2t], D[g+8][2t+1]. a [32, 4], b [32, 2], c [32, 4] → d [32, 4]."""
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    big_a, big_b = np.zeros((16, 8)), np.zeros((8, 8))
    big_a[g, t], big_a[g + 8, t], big_a[g, t + 4], big_a[g + 8, t + 4] = a.T
    big_b[t, g], big_b[t + 4, g] = b.T
    big_d = big_a @ big_b
    return c + np.stack([big_d[g, 2 * t], big_d[g, 2 * t + 1], big_d[g + 8, 2 * t], big_d[g + 8, 2 * t + 1]], 1)


_LANES = np.arange(32)
_G, _T = _LANES >> 2, _LANES & 3


def _kernel_scores(kept: np.ndarray, b_s: np.ndarray, row0: int, nt: int) -> np.ndarray:
    """``scores<DH, nt>``: the 16 kept rows as float4 A fragments in the
    permuted d order times rows row0 + 8n + g of the staged b → [nt, 32, 4]."""
    dh = kept.shape[1]
    g, t = _G, _T
    acc = np.zeros((nt, 32, 4))
    for n in range(nt):
        for kk in range(dh // 16):
            x = np.stack([kept[g, 16 * kk + 4 * t + j] for j in range(4)], 1)      # row g
            y = np.stack([kept[g + 8, 16 * kk + 4 * t + j] for j in range(4)], 1)  # row g + 8
            bf = _load4(b_s, row0 + 8 * n + g, 4 * kk + t, dh)
            acc[n] = _mma_m16n8k8(np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1), bf[:, :2], acc[n])
            acc[n] = _mma_m16n8k8(np.stack([x[:, 2], y[:, 2], x[:, 3], y[:, 3]], 1), bf[:, 2:], acc[n])
    return acc


def _kernel_weighted(acc_p: np.ndarray, b_s: np.ndarray, row0: int, dh: int) -> np.ndarray:
    """``weighted`` then ``store_rows``: the accumulator-layout p [nt, 32, 4]
    as A fragments (k = t is column 2t) times the staged b's rows
    row0 + 8n + 2t, +1 (float4 columns 4g .. 4g+3 for 4 n tiles) → the
    [16, DH] result as the lanes store it."""
    g, t = _G, _T
    out = np.zeros((dh // 8, 32, 4))
    for n in range(acc_p.shape[0]):
        a = acc_p[n][:, [0, 2, 1, 3]]
        for c in range(dh // 32):
            x0, x1 = _load4(b_s, row0 + 8 * n + 2 * t, 8 * c + g, dh), _load4(b_s, row0 + 8 * n + 2 * t + 1, 8 * c + g, dh)
            for i in range(4):
                out[4 * c + i] = _mma_m16n8k8(a, np.stack([x0[:, i], x1[:, i]], 1), out[4 * c + i])
    got = np.zeros((16, dh))
    for r in range(2):
        for c in range(dh // 32):
            for e in range(2):
                for i in range(4):
                    got[g + 8 * r, 32 * c + 8 * t + 4 * e + i] = out[4 * c + i][:, 2 * r + e]
    return got


def _accumulator_layout(x: np.ndarray, row0: int) -> np.ndarray:
    """x [16, ≥ row0 + 8·nt] as an m16n8 accumulator over columns row0 .. →
    [nt, 32, 4]: lane (g, t) element e is x[g + 8(e >> 1), row0 + 8n + 2t + (e & 1)]."""
    nt = (x.shape[1] - row0) // 8
    return np.stack([np.stack([x[_G + 8 * (e >> 1), row0 + 8 * n + 2 * _T + (e & 1)] for e in range(4)], 1)
                     for n in range(nt)])


@pytest.mark.parametrize("dh", [32, 64])
def test_f32_kernel_fragment_maps_and_swizzle(dh):
    """The float32 forward's index design, lane by lane for one warp and one
    key tile, in the kernel's own formulas: Q and K fragments as float4
    loads in the permuted d order give q·kᵀ; the scores' accumulator
    registers taken as P·V's A fragment (keys relabelled 2t, 2t+1) with V's
    B fragment from rows 2t, 2t+1 and float4 columns 4g .. 4g+3 give p·v,
    stored as columns 8t .. 8t+7; and with ``swz32`` the 8 lanes of every
    16-byte load phase (K, V) and store phase (cp.async) fall on 8 distinct
    bank groups."""
    rng = np.random.default_rng(dh)
    q, k, v, p = rng.standard_normal((16, dh)), rng.standard_normal((64, dh)), rng.standard_normal((64, dh)), \
        rng.standard_normal((16, 64))
    k_s, v_s = _staged(k), _staged(v)
    scores = _kernel_scores(q, k_s, 0, 8)
    np.testing.assert_allclose(scores, _accumulator_layout(q @ k.T, 0), atol=1e-12)
    # p in the accumulator layout, then o += p V as the kernel does it
    np.testing.assert_allclose(_kernel_weighted(_accumulator_layout(p, 0), v_s, 0, dh), p @ v, atol=1e-12)


@pytest.mark.parametrize("dh", [32, 64])
def test_f32_backward_keys_kernel_transposed_fragment_maps(dh):
    """The float32 keys kernel's transposed maps, lane by lane for one warp
    and the second 32-query step of a tile, in its own formulas: the warp's
    16 key rows kept as float4 A fragments and the staged q tile's B
    fragments give sᵀ = k·qᵀ; the query statistics read as float2 at
    columns c + 8n + 2t give pᵀ in the accumulator layout; and that
    accumulator taken as the A fragment (queries relabelled 2t, 2t+1) with
    dO's and q's B fragments from rows 2t, 2t+1 gives pᵀ·dO and sᵀ·q, the
    products dv and dk are summed from."""
    rng = np.random.default_rng(100 + dh)
    k, q, d_o = rng.standard_normal((16, dh)), rng.standard_normal((64, dh)), rng.standard_normal((64, dh))
    shift, inv = rng.normal(-2.0, 0.5, 64), rng.uniform(0.01, 0.1, 64)
    q_s, do_s = _staged(q), _staged(d_o)
    c, scale_log2 = 32, 0.18
    s_t = _kernel_scores(k, q_s, c, 4)
    dense = k @ q.T
    np.testing.assert_allclose(s_t, _accumulator_layout(dense, c), atol=1e-12)
    p_t = np.zeros_like(s_t)
    for n in range(4):
        i = c + 8 * n + 2 * _T  # the float2 of each statistic a lane reads: queries i, i + 1
        for e in range(4):
            col1 = e & 1
            p_t[n][:, e] = np.exp2(s_t[n][:, e] * scale_log2 + shift[i + col1]) * inv[i + col1]
    p_dense = np.exp2(dense * scale_log2 + shift) * inv
    np.testing.assert_allclose(p_t, _accumulator_layout(p_dense, c), rtol=1e-12)
    np.testing.assert_allclose(_kernel_weighted(p_t, do_s, c, dh), p_dense[:, c:] @ d_o[c:], atol=1e-10)
    np.testing.assert_allclose(_kernel_weighted(s_t, q_s, c, dh), dense[:, c:] @ q[c:], atol=1e-10)


_WHOLE_WARPS, _WHOLE_ROWS = 4, 16  # csrc/attention_mma.cu: kWholeWarps, kWholeRows


def _distinct_units(byte_offsets: np.ndarray) -> bool:
    """Whether 8 lanes' 16-byte accesses fall on 8 distinct bank groups."""
    return len(set((np.asarray(byte_offsets) // 16) % 8)) == 8


def _swz_bf16(row, chunk, dh: int):
    """``swz<DH>`` of ``csrc/mma_common.cuh``: the element offset of a 16-byte
    chunk in a staged bf16 [rows, DH] matrix."""
    x = (row & 7) if dh == 64 else ((row >> 1) & 3)
    return row * dh + ((chunk ^ x) << 3)


def _whole_groups(s_len: int, rows: int = _WHOLE_ROWS) -> list:
    """(first row, rows, warp) of each group: groups of ``rows`` (8 or 16)
    round the warps, then, with 16, a last group of at most 8 rows on the
    next warp."""
    full = -(-s_len // rows) if rows == 8 or s_len % rows > 8 else s_len // rows
    groups = [(rows * i, rows, i % _WHOLE_WARPS) for i in range(full)]
    if s_len - rows * full > 0:
        groups.append((rows * full, 8, full % _WHOLE_WARPS))
    return groups


def _whole_group(q, k, k_s, v_s, q0: int, rr: int, kv: int, keys: int) -> np.ndarray:
    """One group of ``rr`` rows of ``attn_qkv_fwd_mma_kernel`` in its own index
    formulas → its [rr, DH] output in float64 (before the bf16 rounding)."""
    s_len, dh = q.shape
    chunks, kvp = keys // 32, -(-kv // 16) * 16
    pp, dgs, ch = kvp + 8, dh // 4, dh // 8
    narrow = kv > 32 and kv - 32 * ((kv - 1) // 32) <= 8
    fc, base, tk = chunks - narrow, 32 * (chunks - 1), 8 * rr // 32
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    # Q: piece u of a lane is row (lane + 32u) % rr, 16-byte chunk (lane +
    # 32u) // rr, stored as float32 [DH][rr]; each store at most 32 / rr lanes a bank
    q_s = np.zeros(dh * rr, np.float32)
    for u in range(rr * ch // 32):
        r, c = (lanes + 32 * u) % rr, (lanes + 32 * u) // rr
        row = np.where((q0 + r < s_len)[:, None], q[np.minimum(q0 + r, s_len - 1)], 0.0)  # [32, DH]
        for i in range(8):
            at = (8 * c + i) * rr + r
            assert np.bincount(at % 32).max() <= 32 // rr
            q_s[at] = row[lanes, 8 * c + i]
    q4 = q_s.reshape(-1, 4)
    s = np.zeros((rr, chunks, 32), np.float32)  # rows, chunks, lanes: key 32c + lane
    tr, tk0 = lanes % rr, (lanes // rr) * tk
    tsc = np.zeros((tk, 32), np.float32)  # narrow: lane's keys base + tk0 + i of row tr
    for dg in range(dgs):
        kf = k_s[dg * keys + 32 * np.arange(fc)[:, None] + lanes]  # [fc, 32, 4]
        for j in range(4):
            d = 4 * dg + j
            qv = q4[(rr // 4) * d:(rr // 4) * (d + 1)].reshape(rr)  # broadcast loads
            s[:, :fc] = s[:, :fc] + qv[:, None, None] * kf[None, :, :, j]  # exact products, float32 sums
        if narrow:
            qt = np.stack([q_s[(4 * dg + j) * rr + tr] for j in range(4)], 1)  # [32, 4]
            for i in range(tk):
                kt = k_s[dg * keys + base + tk0 + i]  # [32, 4]
                for j in range(4):
                    tsc[i] = tsc[i] + qt[:, j] * kt[:, j]
    if narrow:  # to lane key % 32 through x_s [rr][8]; lanes past 8 read a padding slot
        x_s = np.zeros(rr * 8, np.float32)
        for i in range(tk):
            x_s[tr * 8 + tk0 + i] = tsc[i]
        s[:, chunks - 1] = x_s.reshape(rr, 8)[:, lanes & 7]
    live_rows = min(rr, s_len - q0)
    chain = np.zeros((live_rows, kv), np.float32)
    for d in range(dh):
        chain = chain + q[q0:q0 + live_rows, None, d] * k[None, :kv, d]
    flat = s.reshape(rr, keys)
    assert np.array_equal(flat[:live_rows, :kv], chain)
    # softmax in torch's warp order: a lane's keys ascending, then the butterfly
    s = s * np.float32(1.0 / np.sqrt(dh))
    live = (32 * np.arange(chunks)[:, None] + lanes) < kv
    mx = np.where(live, s, -np.inf).max(axis=(1, 2))
    e = np.where(live, np.exp((s - mx[:, None, None]).astype(np.float32)), np.float32(0.0)).astype(np.float32)
    total = np.zeros((rr, 32), np.float32)
    for c in range(chunks):
        total = total + e[:, c]
    for off in (16, 8, 4, 2, 1):
        total = total + total[:, lanes ^ off]
    assert (total == total[:, :1]).all()
    p = (e / total[:, None, :]).astype(np.float32).reshape(rr, keys)
    p_s = np.zeros((rr, pp), np.float32)
    p_s[:, :kvp] = torch.from_numpy(p[:, :kvp]).to(torch.bfloat16).float().numpy()
    # P V as oT = vT pT on m16n8k16. B, p's rows 8n .. 8n+7: ldmatrix rows
    # from lanes (row lane & 7 (+8 for lanes 16-31 with two n tiles), column
    # 16ks + 8 · bit 3 of the lane); lane (g, t) gets row g, columns 2t, 2t+1
    # of each matrix. A, VT: the rows of V (keys) that addr_b gives
    # ldmatrix.x4.trans for d tile mt, +16 rows (32·DH bytes) a step.
    nt = rr // 8
    acc = np.zeros((nt, dh // 16, 32, 4))
    p_rows = (lanes & 7) + 8 * ((lanes >> 4) % nt)
    for ks in range(kvp // 16):
        addr = p_rows * pp + 16 * ks + ((lanes >> 3) & 1) * 8
        for m in range(2 * nt):
            assert _distinct_units(2 * addr[8 * m:8 * m + 8])
        b_frag = [np.stack([p_s[addr[8 * m + g] // pp, addr[8 * m + g] % pp + 2 * t + e] for e in range(2)], 1)
                  for m in range(2 * nt)]  # [32, 2] each: b0, b1 of tile 0, then of tile 1
        for mt in range(dh // 16):
            rows = 16 * ks + (lanes & 7) + ((lanes >> 4) << 3)
            chunk = 2 * mt + ((lanes >> 3) & 1)
            offs = _swz_bf16(rows, chunk, dh)
            assert np.array_equal(offs, _swz_bf16(rows - 16 * ks, chunk, dh) + 16 * ks * dh)
            assert all(_distinct_units(2 * offs[i:i + 8]) for i in range(0, 32, 8))
            # .trans: matrix i's lane (g, t) gets its rows 2t, 2t+1 at column g
            a_frag = np.stack([np.stack([v_s[offs[8 * i + 2 * t + e] + g] for e in range(2)], 1)
                               for i in range(4)], 1)  # [32, 4 registers, 2]
            big_a = np.zeros((16, 16))
            for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                for e in range(2):
                    big_a[g + dr, 2 * t + dk + e] = a_frag[:, i, e]
            for n in range(nt):
                big_b = np.zeros((16, 8))
                for m, dk in enumerate((0, 8)):
                    for e in range(2):
                        big_b[2 * t + dk + e, g] = b_frag[2 * n + m][:, e]
                prod = big_a @ big_b  # [16 d, 8 rows]
                acc[n, mt] += np.stack([prod[g, 2 * t], prod[g, 2 * t + 1], prod[g + 8, 2 * t],
                                        prod[g + 8, 2 * t + 1]], 1)
    # the output tile: lane (g, t) writes rows 8n + 2t, 8n + 2t + 1 of d 16mt
    # + g and 16mt + g + 8 at swz; then the rows copied out in 16-byte pieces
    o_s = np.zeros(rr * dh)
    for n in range(nt):
        for mt in range(dh // 16):
            for e in range(4):
                row, d = 8 * n + 2 * t + (e & 1), 16 * mt + g + 8 * (e >> 1)
                at = _swz_bf16(row, d >> 3, dh) + (d & 7)
                assert len(set((at // 2) % 32)) == 16  # pairs of lanes share a word, no two words a bank
                o_s[at] = acc[n, mt][:, e]
    out = np.zeros((rr, dh))
    for i in range(0, rr * ch, 8):
        r, c = np.divmod(np.arange(i, i + 8), ch)
        assert _distinct_units(2 * _swz_bf16(r, c, dh))
        for rrow, cc in zip(r, c):
            out[rrow, 8 * cc:8 * cc + 8] = o_s[_swz_bf16(rrow, cc, dh):_swz_bf16(rrow, cc, dh) + 8]
    v_pad = np.zeros((kvp, dh))
    for r in range(kvp):
        for c in range(ch):
            v_pad[r, 8 * c:8 * c + 8] = v_s[_swz_bf16(r, c, dh):_swz_bf16(r, c, dh) + 8]
    np.testing.assert_allclose(out, p_s[:, :kvp] @ v_pad, rtol=1e-12, atol=1e-12)
    return out[:live_rows]


def _whole_head_forward(q: np.ndarray, k: np.ndarray, v: np.ndarray, kv: int, rows: int) -> np.ndarray:
    """One (image, head) of ``attn_qkv_fwd_mma_kernel`` in numpy, in its own
    index formulas: q, k, v [S, DH] bf16 values as float32 → o [S, DH] in
    float64 (before the bf16 rounding). Checks on the way that the staged K
    and Q give each score as the float32 FMA chain over d in ascending order
    (bit for bit: a product of two bf16 values is exact in float32), the
    narrow last chunk's too, that the lanes' sums in torch's order agree on
    every lane, and that each phase of the K stores, the p and V ldmatrix,
    the output stores and the output copy falls on distinct bank groups."""
    s_len, dh = q.shape
    keys, kvp, ch = 32 * -(-kv // 32), -(-kv // 16) * 16, dh // 8
    # K staging: thread idx -> key idx % keys, 16-byte chunk idx // keys of the
    # key's row, stored as float32 at d groups 2c and 2c + 1; zeros past kv
    k_s = np.zeros((dh // 4 * keys, 4), np.float32)
    idx = np.arange(keys * ch)
    key, c = idx % keys, idx // keys
    for half in range(2):
        unit = (2 * c + half) * keys + key
        assert all(_distinct_units(16 * unit[i:i + 8]) for i in range(0, unit.size, 8))
        vals = k[np.minimum(key, kv - 1)[:, None], (8 * c + 4 * half)[:, None] + np.arange(4)]
        k_s[unit] = np.where((key < kv)[:, None], vals, 0.0)
    v_s = np.zeros(kvp * dh)
    for r in range(kv):
        for c in range(ch):
            v_s[_swz_bf16(r, c, dh):_swz_bf16(r, c, dh) + 8] = v[r, 8 * c:8 * c + 8]
    o = np.zeros((s_len, dh))
    groups = _whole_groups(s_len, rows)
    covered = np.concatenate([np.arange(q0, q0 + rr) for q0, rr, _ in groups])
    assert np.array_equal(covered[:s_len], np.arange(s_len)) and covered.size < s_len + 16
    for q0, rr, _ in groups:
        o[q0:q0 + min(rr, s_len - q0)] = _whole_group(q, k, k_s, v_s, q0, rr, kv, keys)
    return o


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("s,kv,heads,dh", [(197, 197, 2, 64), (208, 197, 2, 32), (5, 5, 1, 64), (40, 1, 1, 32),
                                          (256, 256, 1, 64), (33, 17, 1, 64), (40, 33, 1, 32), (72, 72, 1, 64)])
def test_bf16_whole_head_kernel_maps(s, kv, heads, dh, rows):
    """The bfloat16 whole-head forward's design (``attn_qkv_fwd_mma_kernel``),
    emulated in numpy in the kernel's own index formulas: float32 K staged
    by groups of 4 d and each warp's Q give every score as the FMA chain
    over d in ascending order bit for bit, and so do the last key chunk's
    where it holds at most 8 real keys (197, 33, 72 keys), worked on all
    lanes and moved to lane key % 32 through shared memory; the softmax in
    torch's lane order, p rounded to bf16, and P·V as vT·pT through
    ldmatrix (one or two n tiles) put no output further than one bf16 step
    from the plain version; no shared store or load phase has a bank
    conflict (Q's stores at most 32 / rows lanes a bank). Groups of 16 rows
    (the kernel's) and of 8 (``kWholeRows`` 8, a design variant); either
    way 197 tokens are 56 rows on warp 0 and 48 on each other warp."""
    if s == 197:
        per_warp = np.bincount([w for _, rr, w in _whole_groups(s, rows) for _ in range(rr)], minlength=_WHOLE_WARPS)
        assert per_warp.tolist() == [56, 48, 48, 48]
    rng = np.random.default_rng(s * dh + kv)
    qkv = torch.from_numpy(rng.standard_normal((1, s, 3 * heads * dh)).astype(np.float32)).to(torch.bfloat16)
    parts = qkv.float().numpy()[0].reshape(s, 3, heads, dh)
    got = np.stack([_whole_head_forward(parts[:, 0, h], parts[:, 1, h], parts[:, 2, h], kv, rows) for h in range(heads)],
                   1)
    got = torch.from_numpy(got.reshape(1, s, heads * dh).astype(np.float32)).to(torch.bfloat16)
    assert _outside_one_step(got, attention_qkv_plain(qkv, heads, 0 if kv == s else kv)) == 0


def test_residuals_on_the_cpu_are_the_plain_output():
    """``attention_residuals`` on a CPU tensor is the plain forward and no
    statistics, and ``attention_bwd`` there ignores residuals."""
    rng = np.random.default_rng(3)
    q, k, v, d_o = (torch.from_numpy(rng.standard_normal((1, 2, 9, 8)).astype(np.float32)) for _ in range(4))
    out, stats = attention_residuals(q, k, v)
    assert stats is None and torch.equal(out, attention_unrounded_plain(q, k, v))
    with_res, without = attention_bwd(q, k, v, d_o, (out, stats)), attention_bwd(q, k, v, d_o)
    assert all(torch.equal(a, b) for a, b in zip(with_res, without))
