"""The port's LayerNorm against the JAX package's, forward and gradients.

The same numpy-seeded inputs go through ``ssip_tpu.ops.layernorm.layer_norm``
(the Pallas kernels in interpret mode, and the XLA reference) and the port's
plain version, which is what the port's ``layer_norm`` runs for a CPU tensor.
float32 agrees within 1e-5; bfloat16 within one bfloat16 step of the JAX value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.ops.layernorm import layer_norm as jax_layer_norm
from ssip_tpu.ops.layernorm import layer_norm_xla
from ssip_tpu_torch.ops.layernorm import (
    LN_EPS, launch_grid, layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain,
)

torch.set_num_threads(2)

# (shape, type): more rows than one 256-row Pallas block, a 3-D stream, a
# width that is no multiple of 32, the final LayerNorm's [B, D] float32
CASES = [
    ((37, 64), "float32"), ((300, 192), "float32"), ((2, 21, 48), "float32"), ((5, 100), "float32"),
    ((260, 64), "bfloat16"), ((3, 17, 96), "bfloat16"),
]


def _inputs(shape, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed + len(shape) * 1000 + shape[-1])
    d = shape[-1]
    x = rng.normal(0.3, 1.5, shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = rng.normal(1.0, 0.2, d).astype(np.float32)
    bias = rng.normal(0.0, 0.2, d).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    as_jax = (jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(dy).astype(jdt))
    as_torch = (torch.from_numpy(x).to(tdt), torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(dy).to(tdt))
    return as_jax, as_torch


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, dtype: str, what: str) -> None:
    """float32 within 1e-5; bfloat16 within one bfloat16 step of the JAX value."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=what)
    else:
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= step).all(), (what, np.abs(got - want).max())


def _assert_grad_close(got, want, dtype: str, what: str) -> None:
    got, want = _f32(got), _f32(want)
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert rel <= (1e-5 if dtype == "float32" else 1e-2), (what, rel)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_forward_matches_pallas_interpret_and_xla(shape, dtype):
    (jx, jscale, jbias, _), (tx, tscale, tbias, _) = _inputs(shape, dtype)
    got = layer_norm(tx, tscale, tbias, LN_EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, jax_layer_norm(jx, jscale, jbias, eps=LN_EPS, interpret=True), dtype, "interpret")
    _assert_close(got, layer_norm_xla(jx, jscale, jbias, LN_EPS), dtype, "xla")
    assert torch.equal(got, layer_norm_plain(tx, tscale, tbias, LN_EPS))  # a CPU tensor takes the plain version


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shape,dtype", CASES)
def test_gradients_match_jax_vjp(shape, dtype, use_pallas):
    """Autograd through the plain version, and the backward written out as
    the kernel computes it, against ``jax.vjp`` of the Pallas custom VJP
    (interpret mode) and of the XLA reference."""
    (jx, jscale, jbias, jdy), (tx, tscale, tbias, tdy) = _inputs(shape, dtype, seed=1)
    kwargs = {"interpret": True} if use_pallas else {"use_pallas": False}
    _, vjp = jax.vjp(lambda x, s, b: jax_layer_norm(x, s, b, eps=LN_EPS, **kwargs), jx, jscale, jbias)
    want = vjp(jdy)

    tx, tscale, tbias = (t.clone().requires_grad_() for t in (tx, tscale, tbias))
    got = torch.autograd.grad(layer_norm(tx, tscale, tbias, LN_EPS), (tx, tscale, tbias), tdy)
    d = shape[-1]
    written_out = layer_norm_bwd(tx.detach().reshape(-1, d), tscale.detach(), tdy.reshape(-1, d), LN_EPS)
    assert got[0].dtype == tx.dtype and got[1].dtype == got[2].dtype == torch.float32
    for name, g, w, o in zip(("dx", "dscale", "dbias"), got, want, written_out):
        _assert_grad_close(g, w, dtype, f"autograd {name}")
        _assert_grad_close(o.reshape(g.shape), w, dtype, f"written out {name}")


@pytest.mark.parametrize("eps", [1e-6, 1e-5, 1e-2])
def test_eps_is_an_argument(eps):
    (jx, jscale, jbias, _), (tx, tscale, tbias, _) = _inputs((9, 32), "float32", seed=2)
    jx, tx = jx * 1e-2, tx * 1e-2  # small variance, so eps shows
    _assert_close(layer_norm(tx, tscale, tbias, eps), layer_norm_xla(jx, jscale, jbias, eps), "float32", f"eps {eps}")


def test_moments_are_of_the_deviations():
    """A large common offset must not cancel the variance away
    (``mean((x − m)²)``, not ``E[x²] − E[x]²``)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 64)) * 1e-2 + 300.0).astype(np.float32)
    ones, zeros = np.ones(64, np.float32), np.zeros(64, np.float32)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(ones), torch.from_numpy(zeros), LN_EPS).numpy()
    want = np.asarray(layer_norm_xla(jnp.asarray(x), jnp.asarray(ones), jnp.asarray(zeros), LN_EPS))
    # float32 holds 300 ± 0.01 to about 3e-5, which is 3e-3 of a unit-variance value
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert 0.9 < got.std() < 1.1  # E[x²] − E[x]² would lose the 1e-4 variance in 9e4


def test_wrapper_raises_on_wrong_operands():
    x = torch.zeros((3, 8))
    with pytest.raises(ValueError, match=r"scale and bias must be \[8\]"):
        layer_norm(x, torch.ones(4), torch.zeros(8))
    with pytest.raises(ValueError, match="same shape, type and device"):
        layer_norm_bwd(x, torch.ones(8), torch.zeros((2, 8)))
    empty = layer_norm_bwd_plain(torch.zeros((0, 8)), torch.ones(8), torch.zeros((0, 8)))
    assert empty[0].shape == (0, 8) and not empty[1].any() and not empty[2].any()


@pytest.mark.parametrize(
    "n,sms,blocks_per_sm,want",
    [
        (128 * 197, 132, 3, 396),  # the main path's stream: one wave, every SM full
        (128 * 208, 132, 1, 132),
        (128, 132, 3, 32),  # the final LayerNorm: a warp a row, no idle blocks
        (1001, 132, 4, 251),
        (5, 132, 4, 2),
        (1, 132, 4, 1),
        (0, 132, 4, 1),
    ],
)
def test_launch_grid_is_one_wave_and_no_more_than_a_row_a_warp(n, sms, blocks_per_sm, want):
    """The kernels' grid (and the backward's [2, grid, D] scratch): at most
    what every SM holds at once, at most a row for each of a block's 4
    warps, at least one block."""
    assert launch_grid(n, sms, blocks_per_sm) == want
