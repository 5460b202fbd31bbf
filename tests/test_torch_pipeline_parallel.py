"""GPipe over the model axis (``parallel/pipeline.py``) on four gloo ranks.

Mirrors ``tests/test_pipeline_parallel.py`` test for test, at its
tolerances (forward 2e-5, gradients atol 1e-5 and rtol 1e-4, loss 1e-6),
with the port's own ranks: its tiny ViT (4 blocks, width 64, 2 heads, 32²
images) in 4 stages at model 4 (data 1), and in 2 stages at data 2 ×
model 2, each against the plain port model in one process. Plus the JAX
package's pipelined engine step (``make_pp_apply_fn`` on the 8-device CPU
mesh, data 2 × model 4) from the same weights, against the port's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.vit import VisionTransformer as JaxViT
from ssip_tpu.parallel.mesh import MeshSpec, build_mesh
from ssip_tpu.parallel import pipeline as jax_pipeline
from ssip_tpu.train.engine import TrainState as JaxTrainState, make_train_step
from ssip_tpu_torch.models.port import state_dict_from_flax
from ssip_tpu_torch.parallel.pipeline import (
    merge_stage_params, pp_param_shardings, pp_state_dict_from_flax, split_stage_params,
)
from tests.test_torch_data_parallel import one_process, spawn_ranks
from tests.torch_model_axis_ranks import plain_vit, vit_forward_and_grads, vit_parallel_batch, vit_sgd_step

IMG = 32
LAYERS = 4
SMALL = dict(patch_size=8, hidden_dim=64, num_layers=LAYERS, num_heads=2, mlp_dim=128)


def _tree(num_classes=2):
    return jax.device_get(jax_seeded_init_host(JaxViT(num_classes=num_classes, **SMALL), 0, (1, IMG, IMG, 3)))


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, IMG, IMG, 3)).astype(np.float32)
    images = np.random.default_rng(2).integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    return x, np.array([0, 1] * 4), images


def jax_pp_step(tree, images, labels):
    """The JAX engine's SGD (0.1) step through ``make_pp_apply_fn`` at data
    2 × model 4: (loss, argmax, merged parameters after), torch-named."""
    mesh = build_mesh(MeshSpec(data=2, model=4))
    model = JaxViT(num_classes=2, **SMALL)
    outer, stacked = jax_pipeline.split_stage_params(tree["params"], LAYERS, 4)
    pp = jax.device_put({"outer": outer, "stacked": stacked},
                        jax_pipeline.pp_param_shardings(mesh, {"outer": outer, "stacked": stacked}))
    state = JaxTrainState.create(apply_fn=jax_pipeline.make_pp_apply_fn(model, mesh, 2), params=pp, batch_stats={},
                                 tx=optax.sgd(0.1))
    with mesh:
        new, loss, preds = make_train_step(augment=False)(
            state, jnp.asarray(images), jnp.asarray(labels.astype(np.int32)), jnp.ones(8, bool), jax.random.key(0))
    merged = jax_pipeline.merge_stage_params(new.params["outer"], new.params["stacked"])
    return float(loss), np.asarray(preds), state_dict_from_flax({"params": jax.device_get(merged)})


def reference(tree, features_tree, x, labels, images):
    with torch.no_grad():
        forward = plain_vit(tree)(torch.from_numpy(x)).numpy()
        features = plain_vit(features_tree, None)(torch.from_numpy(x)).numpy()
    return {
        "forward": forward, "features": features,
        "grads": vit_forward_and_grads(plain_vit(tree), x, labels),
        "step": vit_sgd_step(plain_vit(tree), images, labels, None),
        "jax_step": jax_pp_step(tree, images, labels),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    tree, features_tree = _tree(), _tree(None)
    x, labels, images = _inputs()
    args = (tree, features_tree, x, labels, images)
    ranks, ref = spawn_ranks(vit_parallel_batch, ("pp", *args), out, world=4,
                             meanwhile=lambda: one_process(reference, *args))
    return ranks, ref


def test_split_merge_roundtrip():
    params = _tree()["params"]
    outer, stacked = split_stage_params(params, LAYERS, 4)
    assert stacked["qkv"]["kernel"].shape[:2] == (4, 1)
    jax.tree.map(np.testing.assert_array_equal, merge_stage_params(outer, stacked), params)
    # the JAX package's split carries across: merged, then the plain ViT's torch state dict
    j_outer, j_stacked = jax_pipeline.split_stage_params(params, LAYERS, 4)
    jax.tree.map(np.testing.assert_array_equal, stacked, jax.device_get(j_stacked))
    got = pp_state_dict_from_flax({"outer": j_outer, "stacked": jax.device_get(j_stacked)})
    want = state_dict_from_flax({"params": params})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    specs = pp_param_shardings({"outer": outer, "stacked": stacked})
    assert specs["stacked"]["qkv"]["kernel"] == ("model",) and specs["outer"]["cls_token"] == ()


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pp_forward_matches_plain(runs, microbatches):
    ranks, ref = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["forward"][("1x4", microbatches)], ref["forward"], atol=2e-5)
        np.testing.assert_allclose(rank["forward"][("2x2", microbatches)], ref["forward"], atol=2e-5)


def test_pp_feature_extractor_mode(runs):
    ranks, ref = runs
    assert ranks[0]["features"].shape == (8, 64)
    np.testing.assert_allclose(ranks[0]["features"], ref["features"], atol=2e-5)


def test_pp_gradients_match_plain(runs):
    ranks, ref = runs
    _, loss, grads = ranks[0]["grads"]
    _, loss1, grads1 = ref["grads"]
    assert np.isclose(loss, loss1, atol=1e-6)
    assert set(grads) == set(grads1)
    for name, g in grads1.items():
        np.testing.assert_allclose(grads[name], g, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("mesh_shape", ["1x4", "2x2"])
def test_pp_train_step_matches_plain(runs, mesh_shape):
    """One engine SGD step: loss, argmax and every parameter after (the
    stages gathered) against the plain step; each rank holds its stage's
    blocks only (1 of 4 at model 4)."""
    ranks, ref = runs
    loss, preds, state = ranks[0]["step" if mesh_shape == "1x4" else "step_2x2"]
    loss1, preds1, state1 = ref["step"]
    assert np.isclose(loss, loss1, atol=1e-6)
    np.testing.assert_array_equal(preds, preds1)
    assert set(state) == set(state1)
    for name, value in state1.items():
        np.testing.assert_allclose(state[name], value, atol=1e-5, rtol=1e-4, err_msg=name)
    assert all(rank["local_blocks"] == 1 for rank in ranks)


def test_pp_train_step_matches_jax_pipelined_step(runs):
    """The port's 4-stage step against the JAX package's ``make_pp_apply_fn``
    step at data 2 × model 4, at the same tolerances."""
    ranks, ref = runs
    loss, preds, state = ranks[0]["step"]
    loss_j, preds_j, state_j = ref["jax_step"]
    assert np.isclose(loss, loss_j, atol=1e-6)
    np.testing.assert_array_equal(preds, preds_j)
    for name, value in state_j.items():
        np.testing.assert_allclose(state[name], value, atol=1e-5, rtol=1e-4, err_msg=name)


def test_pp_rejects_bad_shapes(runs):
    with pytest.raises(ValueError):
        split_stage_params(_tree()["params"], LAYERS, 3)  # 4 blocks, 3 stages
    assert all("not divisible into 3 microbatches" in rank["bad_shape"] for rank in runs[0])
