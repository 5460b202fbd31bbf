"""The port's packed-qkv attention against the JAX package's, forward and
gradients, with and without the ``kv_len`` key mask.

The same numpy-seeded inputs go through
``ssip_tpu.ops.attention.fused_attention_qkv`` (the Pallas kernels in
interpret mode, and the XLA reference) and the port's plain version, which
is what the port's ``fused_attention_qkv`` runs for a CPU tensor. float32
agrees within 1e-5; bfloat16 within one bfloat16 step of the JAX value
(gradients within 1e-2 of each tensor's largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.attention import attention_qkv_xla, attention_xla
from ssip_tpu.ops.attention import fused_attention_qkv as jax_fused_attention_qkv
from ssip_tpu_torch.ops.attention import (
    MAX_KERNEL_SEQ, attention_plain, attention_qkv_bwd, attention_qkv_plain, fused_attention_qkv,
)

torch.set_num_threads(2)

# (batch, tokens, heads, head width, kv_len, type)
CASES = [
    (2, 10, 2, 8, 0, "float32"), (2, 17, 3, 16, 13, "float32"), (1, 50, 2, 64, 37, "float32"),
    (2, 208, 1, 32, 197, "float32"), (3, 16, 4, 8, 16, "float32"),
    (2, 17, 3, 16, 0, "bfloat16"), (2, 48, 2, 64, 41, "bfloat16"),
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
    _assert_close(got, jax_fused_attention_qkv(jqkv, heads, kv_len=kv_len, interpret=True), dtype, "interpret")
    _assert_close(got, attention_qkv_xla(jqkv, heads, kv_len=kv_len), dtype, "xla")
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
    # the plain version has no sequence limit; the kernel's is checked on the card
    long = torch.zeros((1, MAX_KERNEL_SEQ + 8, 3 * 8))
    assert fused_attention_qkv(long, 1).shape == (1, MAX_KERNEL_SEQ + 8, 8)
