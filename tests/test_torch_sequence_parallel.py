"""Ring attention and the sequence-parallel ViT (``parallel/sequence.py``) on four gloo ranks.

Mirrors ``tests/test_sequence_parallel.py`` test for test, at its
tolerances (the ring against the one-shot softmax 2e-6, its gradients
1e-5; the forward 2e-5; the model's gradients atol 1e-5 rtol 1e-4, loss
1e-6), with the port's own ranks: 4 shards (model 4, data 1) and data 2 ×
model 2. The sequences do not all divide the shard count: 37 tokens pad
to 40 over 4, and the tiny ViT's 17 tokens (32² images, patch 8) pad to 20
over 4 and 18 over 2. The one-shot reference is the JAX package's
``attention_xla``; the model references are the plain port ViT in one
process and the JAX package's ``make_sp_apply_fn`` step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models.vit import VisionTransformer as JaxViT
from ssip_tpu.ops.attention import attention_xla
from ssip_tpu.parallel.mesh import MeshSpec, build_mesh
from ssip_tpu.parallel.sequence import make_sp_apply_fn as jax_make_sp_apply_fn
from ssip_tpu.train.engine import TrainState as JaxTrainState, make_train_step
from ssip_tpu_torch.models.port import state_dict_from_flax
from tests.test_torch_data_parallel import one_process, spawn_ranks
from tests.test_torch_pipeline_parallel import SMALL, _inputs, _tree
from tests.torch_model_axis_ranks import (
    plain_vit, sp_batch, vit_forward_and_grads, vit_sgd_step,
)

SEQS = (37, 64)  # ragged (pads to 40 over 4) and exact


def _qkv(b, h, seq, dh):
    return [np.asarray(jax.random.normal(jax.random.PRNGKey(i), (b, h, seq, dh), jnp.float32)) for i in range(3)]


def jax_sp_step(tree, images, labels):
    """The JAX engine's SGD (0.1) step through ``make_sp_apply_fn`` at data
    2 × model 4: (loss, argmax, parameters after), torch-named."""
    mesh = build_mesh(MeshSpec(data=2, model=4))
    state = JaxTrainState.create(apply_fn=jax_make_sp_apply_fn(JaxViT(num_classes=2, **SMALL), mesh),
                                 params=tree["params"], batch_stats={}, tx=optax.sgd(0.1))
    with mesh:
        new, loss, preds = make_train_step(augment=False)(
            state, jnp.asarray(images), jnp.asarray(labels.astype(np.int32)), jnp.ones(8, bool), jax.random.key(0))
    return float(loss), np.asarray(preds), state_dict_from_flax({"params": jax.device_get(new.params)})


def reference(tree, features_tree, x, labels, images, qkv_by_seq, grad_case):
    with torch.no_grad():
        forward = plain_vit(tree)(torch.from_numpy(x)).numpy()
        features = plain_vit(features_tree, None)(torch.from_numpy(x)).numpy()

    def one_shot_grads(q, k, v):
        return jax.grad(lambda q, k, v: jnp.sum(attention_xla(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)

    return {
        "forward": forward, "features": features,
        "grads": vit_forward_and_grads(plain_vit(tree), x, labels),
        "step": vit_sgd_step(plain_vit(tree), images, labels, None),
        "jax_step": jax_sp_step(tree, images, labels),
        "ring": {seq: np.asarray(attention_xla(*map(jnp.asarray, qkv))) for seq, qkv in qkv_by_seq.items()},
        "ring_grads": [np.asarray(g) for g in jax.jit(one_shot_grads)(*map(jnp.asarray, grad_case))],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    tree, features_tree = _tree(), _tree(None)
    x, labels, images = _inputs()
    args = (tree, features_tree, x, labels, images, {seq: _qkv(4, 3, seq, 16) for seq in SEQS}, _qkv(2, 2, 37, 8))
    ranks, ref = spawn_ranks(sp_batch, args, out, world=4, meanwhile=lambda: one_process(reference, *args))
    return ranks, ref


@pytest.mark.parametrize("seq", SEQS)
def test_ring_attention_matches_one_shot_softmax(runs, seq):
    ranks, ref = runs
    for rank in ranks:
        full = rank["ring"][seq]
        np.testing.assert_allclose(full[:, :, :seq], ref["ring"][seq], atol=2e-6)
        assert np.isfinite(full).all()  # padded query rows come out finite (clamped, not 0/0)


def test_ring_attention_grads_match_one_shot_softmax(runs):
    ranks, ref = runs
    for got, want in zip(ranks[0]["ring"]["grad"], ref["ring_grads"]):
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mesh_shape", ["1x4", "2x2"])
def test_sp_forward_matches_plain(runs, mesh_shape):
    ranks, ref = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["model"]["forward"][(mesh_shape, 2)], ref["forward"], atol=2e-5)


def test_sp_feature_extractor_mode(runs):
    ranks, ref = runs
    assert ranks[0]["model"]["features"].shape == (8, 64)
    np.testing.assert_allclose(ranks[0]["model"]["features"], ref["features"], atol=2e-5)


def test_sp_gradients_match_plain(runs):
    """Every rank's tokens give part of a block parameter's gradient: summed
    over the axis, they are the plain model's; the patch embedding's and
    the head's are whole on every rank already (summed once, not twice)."""
    ranks, ref = runs
    _, loss1, grads1 = ref["grads"]
    for rank in ranks:
        _, loss, grads = rank["model"]["grads"]
        assert np.isclose(loss, loss1, atol=1e-6)
        assert set(grads) == set(grads1)
        for name, g in grads1.items():
            np.testing.assert_allclose(grads[name], g, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("mesh_shape", ["1x4", "2x2"])
def test_sp_train_step_matches_plain(runs, mesh_shape):
    ranks, ref = runs
    loss1, preds1, state1 = ref["step"]
    for rank in ranks:
        loss, preds, state = rank["model"]["step" if mesh_shape == "1x4" else "step_2x2"]
        assert np.isclose(loss, loss1, atol=1e-6)
        np.testing.assert_array_equal(preds, preds1)
        for name, value in state1.items():
            np.testing.assert_allclose(state[name], value, atol=1e-5, rtol=1e-4, err_msg=name)


def test_sp_train_step_matches_jax_sequence_parallel_step(runs):
    ranks, ref = runs
    loss, preds, state = ranks[0]["model"]["step"]
    loss_j, preds_j, state_j = ref["jax_step"]
    assert np.isclose(loss, loss_j, atol=1e-6)
    np.testing.assert_array_equal(preds, preds_j)
    for name, value in state_j.items():
        np.testing.assert_allclose(state[name], value, atol=1e-5, rtol=1e-4, err_msg=name)
