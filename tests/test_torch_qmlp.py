"""The port's int8 MLP against the JAX package's, on the CPU.

The same numpy-seeded stream and the same quantized block (made by the JAX
package's ``quantize_vit_extractor`` on the seeded ``vit_t16`` and carried
into the port) go through ``ssip_tpu.ops.qmlp``'s ``quantized_mlp_xla`` and
``quantized_mlp(interpret=True)`` (the Pallas kernel ``_qmlp_kernel`` in
interpret mode) and through the port's ``quantized_mlp_plain``, which is what
the port's ``quantized_mlp`` runs for a CPU tensor. On the card the MLP is
two launches joined by the int8 hidden; the first half's plain version
(``qmlp_hidden_plain``) is held bitwise to the JAX package's ``_quant``,
``_qdense`` and ``_gelu_erf`` composition, and ``quantized_mlp_plain`` is the
composition of both halves.

Tolerances. The polynomial GELU is held to 1e-6 (the two packages' ``exp``
differ by an ulp). In the MLP the integer sums are exact, so the outputs
agree to 1e-5 (absolute and relative) except where that ulp moves a hidden
value across a ``.5`` tie of the requantize: one int8 step of one hidden
value, at most ``127·m2`` in every output of that row. So at most 1 row in
100 (3 of the 300) may hold elements off by more than 1e-5, and no element
may be off by more than ``2·127·max(m2)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.quantized_vit import _qdense as jax_qdense
from ssip_tpu.models.quantized_vit import _quant as jax_quant
from ssip_tpu.models.quantized_vit import quantize_vit_extractor as jax_quantize_vit_extractor
from ssip_tpu.ops import qmlp as jax_qmlp
from ssip_tpu_torch.models.port import quantized_vit_from_tree
from ssip_tpu_torch.ops.qmlp import (
    KERNEL_HIDDEN_MULTIPLE, KERNEL_WIDTHS, _erf_poly, _gelu_erf, qmlp_hidden_plain, qmlp_output_plain, quantized_mlp,
    quantized_mlp_plain,
)

torch.set_num_threads(2)

ARCH, IMG, ROWS = "vit_t16", 32, 300


@pytest.fixture(scope="module")
def blocks():
    """(JAX int8 tree, the port's module built from it)."""
    model = MODEL_FACTORIES[ARCH](num_classes=None)
    variables = jax_seeded_init_host(model, 42, (1, IMG, IMG, 3))
    x = jnp.asarray(np.random.default_rng(0).normal(0.0, 1.0, (4, IMG, IMG, 3)), jnp.float32)
    qtree = jax_quantize_vit_extractor(variables, x, arch=ARCH)
    return qtree, quantized_vit_from_tree(qtree, ARCH)


def test_gelu_erf_matches_within_1e_6():
    rng = np.random.default_rng(1)
    x = np.concatenate([np.linspace(-9.0, 9.0, 20001), rng.normal(0.0, 2.0, 5000), [0.0, -0.0]]).astype(np.float32)
    np.testing.assert_allclose(_erf_poly(torch.from_numpy(x)).numpy(), np.asarray(jax_qmlp._erf_poly(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_gelu_erf(torch.from_numpy(x)).numpy(), np.asarray(jax_qmlp._gelu_erf(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    # a bfloat16 input is computed in float32, as in the JAX package
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax_qmlp._gelu_erf(jnp.asarray(x).astype(jnp.bfloat16)))
    got = _gelu_erf(xb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # against the true erf the polynomial is within its published 1.5e-7, plus float32 rounding
    np.testing.assert_allclose(_erf_poly(torch.from_numpy(x)).numpy(), torch.erf(torch.from_numpy(x)).numpy(),
                               rtol=0, atol=5e-7)


def _assert_mlp_close(got: np.ndarray, want: np.ndarray, m2: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == np.float32, what
    err = np.abs(got - want)
    rows_off = (err > 1e-5 + 1e-5 * np.abs(want)).any(axis=1)
    assert rows_off.mean() <= 1e-2, (what, int(rows_off.sum()))
    assert err.max() <= 2 * 127 * m2.max(), (what, err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 5, 11])
def test_quantized_mlp_plain_matches_xla_and_pallas_interpret(blocks, layer, dtype):
    """300 rows: the Pallas kernel's last row block is ragged (256 + 44)."""
    qtree, module = blocks
    jblk, blk = qtree["blocks"][layer], module.blocks[layer]
    d = blk.mlp_1.kernel.shape[0]
    y = np.random.default_rng(23 + layer).normal(size=(ROWS, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jy, ty = jnp.asarray(y).astype(jdt), torch.from_numpy(y).to(tdt)
    got = quantized_mlp_plain(ty, blk).numpy()
    m2 = np.asarray(jblk["mlp_2"]["mult"])
    _assert_mlp_close(got, np.asarray(jax_qmlp.quantized_mlp_xla(jy, jblk)), m2, "xla")
    _assert_mlp_close(got, np.asarray(jax_qmlp.quantized_mlp(jy, jblk, interpret=True)), m2, "pallas interpret")
    assert np.abs(got).mean() > 1e-3  # not a comparison of zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 7])
def test_hidden_half_is_bitwise_the_jax_composition(blocks, layer, dtype):
    """The int8 hidden the first kernel writes, as its plain version makes
    it: bitwise the JAX package's quantize → int8 product → dequantize → GELU
    → requantize; and both halves composed are ``quantized_mlp_plain``."""
    qtree, module = blocks
    jblk, blk = qtree["blocks"][layer], module.blocks[layer]
    d = blk.mlp_1.kernel.shape[0]
    y = np.random.default_rng(41 + layer).normal(size=(ROWS, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jy, ty = jnp.asarray(y).astype(jdt), torch.from_numpy(y).to(tdt)
    gq = qmlp_hidden_plain(ty, blk)
    want = jax_quant(jax_qmlp._gelu_erf(jax_qdense(jax_quant(jy, jblk["mlp_1"]["inv_in_scale"]), jblk["mlp_1"])),
                     jblk["mlp_2"]["inv_in_scale"])
    assert gq.dtype == torch.int8 and gq.shape == (ROWS, blk.mlp_1.kernel.shape[1])
    np.testing.assert_array_equal(gq.numpy(), np.asarray(want))
    assert len(np.unique(gq.numpy())) > 100  # the scales spread the hidden over the int8 range
    assert torch.equal(qmlp_output_plain(gq, blk), quantized_mlp_plain(ty, blk))


def test_wrapper_on_the_cpu_runs_the_plain_version(blocks):
    _, module = blocks
    blk = module.blocks[3]
    y = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 5, 192)).astype(np.float32))
    before = quantized_mlp.launches
    got = quantized_mlp(y, blk)
    assert quantized_mlp.launches == before  # a CPU call launches nothing
    assert got.shape == (2, 5, 192) and got.dtype == torch.float32
    assert torch.equal(got, quantized_mlp_plain(y, blk))
    # rows are independent: a row's result does not depend on its neighbours
    assert torch.equal(quantized_mlp(y[1:, 2:3], blk), got[1:, 2:3])


def test_kernel_shape_limits_cover_the_three_vit_configs():
    from ssip_tpu_torch.models.vit import VIT_CONFIGS

    assert sorted(cfg["hidden_dim"] for cfg in VIT_CONFIGS.values()) == sorted(KERNEL_WIDTHS)
    assert all(cfg["mlp_dim"] % KERNEL_HIDDEN_MULTIPLE == 0 for cfg in VIT_CONFIGS.values())
