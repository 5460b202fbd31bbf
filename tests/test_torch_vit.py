"""The port's ViT family against the JAX package: the model with weights
carried from the Flax tree, the seeded init, the checkpoint names, one
supervised train step and ``remat``. (The pipelines:
``tests/test_torch_vit_pipelines.py``.)

The tests run a narrow ViT (hidden 64, 2 layers, 2 heads of 32, MLP 128, 32²
inputs, so 4 patches and a class token). On the CPU the JAX package takes its
XLA reference for LayerNorm and attention, and the port its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models import port_torch
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.vit import VIT_CONFIGS as JAX_VIT_CONFIGS
from ssip_tpu.models.vit import VIT_FACTORIES
from ssip_tpu.models.vit import VisionTransformer as JaxViT
from ssip_tpu.ops.augment import eval_preprocess as jax_eval_preprocess
from ssip_tpu.ops.augment import train_augment as jax_train_augment
from ssip_tpu.train import engine as jeng
from ssip_tpu_torch.models.host_init import arch_leaves, seeded_init_host
from ssip_tpu_torch.models.port import (
    flax_from_state_dict, load_flax_variables, load_state_dict_arrays, read_torch_checkpoint, state_dict_from_flax,
)
from ssip_tpu_torch.models.registry import PORTED_ARCHS, build_model
from ssip_tpu_torch.models.vit import VIT_CONFIGS, VisionTransformer, build_vit
from ssip_tpu_torch.ops.augment import augment_coeffs
from ssip_tpu_torch.train import engine
from ssip_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint

torch.set_num_threads(2)

SIZE = 32
SMALL = dict(patch_size=16, hidden_dim=64, num_layers=2, num_heads=2, mlp_dim=128)
LR, WD = 1e-3, 1e-4


def _leaves(tree):
    return {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _small_tree(num_classes, seed: int = 0, size: int = SIZE):
    """The narrow ViT's Flax tree: the JAX package's seeded init, with the
    leaves it leaves at zero or one (biases, class token, LayerNorm) drawn
    from numpy so that every parameter matters."""
    tree = jax_seeded_init_host(JaxViT(num_classes=num_classes, **SMALL), seed, (1, size, size, 3))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name in ("bias", "cls_token"):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, tree)


def _small_port(tree, num_classes, dtype=torch.float32, remat: bool = False, size: int = SIZE) -> VisionTransformer:
    model = VisionTransformer(num_classes=num_classes, compute_dtype=dtype, remat=remat, image_size=size, **SMALL)
    load_flax_variables(model, tree)
    return model


def _images(n: int, seed: int = 0, size: int = SIZE) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_configs_and_registry_match_the_jax_package():
    assert VIT_CONFIGS == JAX_VIT_CONFIGS
    assert set(VIT_CONFIGS) <= set(PORTED_ARCHS) and "resnet18" in PORTED_ARCHS
    with torch.device("meta"):
        for arch, cfg in VIT_CONFIGS.items():
            assert build_model(arch, num_classes=2).num_features == cfg["hidden_dim"]
    with pytest.raises(ValueError, match="not a dense ViT arch"):
        build_vit("resnet18")


@pytest.mark.parametrize("num_classes", [None, 3])
def test_forward_matches_flax_with_carried_weights(num_classes):
    """float32 features and logits within 1e-4 of ``ssip_tpu.models.vit``."""
    tree = _small_tree(num_classes)
    x = _images(5)
    want = JaxViT(num_classes=num_classes, **SMALL).apply(tree, jnp.asarray(x), train=False, return_features=True)
    model = _small_port(tree, num_classes).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x), return_features=True)
    if num_classes is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
        assert got.shape == (5, 64) and got.dtype == torch.float32
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
        with torch.inference_mode():
            assert torch.equal(model(torch.from_numpy(x)), got[0])  # logits alone by default
            assert torch.equal(model(torch.from_numpy(x), mask=torch.zeros(5, dtype=torch.bool)), got[0])  # mask ignored


def test_forward_past_256_tokens_matches_flax():
    """At image size 256 (257 tokens: past the 256 the packed bf16 kernels
    once stopped at; the JAX model pads them to 272 and masks the pad keys)
    the features are within 1e-4 of ``ssip_tpu.models.vit``."""
    tree = _small_tree(None, seed=4, size=256)
    x = _images(2, seed=4, size=256)
    want = JaxViT(num_classes=None, **SMALL).apply(tree, jnp.asarray(x), train=False, return_features=True)
    model = _small_port(tree, None, size=256).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x), return_features=True)
    assert got.shape == (2, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_bfloat16_forward_tracks_flax_bfloat16():
    """The compute type's rounding points are the JAX package's: features
    stay float32 and agree to bfloat16 accuracy."""
    tree = _small_tree(None, seed=1)
    x = _images(6, seed=1)
    want = np.asarray(JaxViT(compute_dtype=jnp.bfloat16, **SMALL).apply(tree, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = _small_port(tree, None, torch.bfloat16).eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    cos = (got.numpy() * want).sum(1) / np.linalg.norm(got.numpy(), axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() > 0.999, cos.min()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.1)


def test_wrong_image_size_is_refused():
    model = _small_port(_small_tree(None), None)
    with pytest.raises(ValueError, match="position embedding is for 32x32"):
        model(torch.zeros((1, 48, 48, 3)))
    with pytest.raises(ValueError, match="not divisible by patch size"):
        build_vit("vit_t16", image_size=40)


@pytest.mark.parametrize("arch,seed,num_classes", [("vit_t16", 42, None), ("vit_t16", 3, 2), ("vit_s16", 42, 5)])
def test_seeded_init_matches_jax_bitwise(arch, seed, num_classes):
    ref = _leaves(jax_seeded_init_host(VIT_FACTORIES[arch](num_classes=num_classes), seed, (1, SIZE, SIZE, 3)))
    got = _leaves(seeded_init_host(arch, seed, num_classes, image_size=SIZE))
    assert sorted(got) == sorted(ref)
    assert ("['params']['fc']['kernel']" in got) == (num_classes is not None)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert got["['params']['pos_embedding']"].std() == pytest.approx(0.02, rel=0.2)
    assert not got["['params']['cls_token']"].any()


def test_state_dict_names_are_torchvisions_and_round_trip(tmp_path):
    """The keys and arrays ``ssip_tpu.models.port_torch`` exports; the
    port's ``.pt`` read back by ``port_state_dict``; the port's own way
    back; and the extractor's load without the head."""
    tree = _small_tree(3, seed=2)
    want = port_torch.export_state_dict(tree)
    got = state_dict_from_flax(tree)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    for key in ("class_token", "encoder.pos_embedding", "conv_proj.weight", "encoder.ln.bias", "heads.head.weight",
                "encoder.layers.encoder_layer_1.self_attention.in_proj_weight",
                "encoder.layers.encoder_layer_0.self_attention.out_proj.bias",
                "encoder.layers.encoder_layer_0.mlp.0.weight", "encoder.layers.encoder_layer_1.mlp.3.bias",
                "encoder.layers.encoder_layer_0.ln_2.weight"):
        assert key in got, key

    model = _small_port(tree, 3)
    assert sorted(model.state_dict()) == sorted(want)
    path = tmp_path / "vit.pt"
    save_checkpoint(path, model)
    back = port_torch.port_state_dict(torch.load(path, weights_only=True))
    assert not back["batch_stats"]
    ref, got_back = _leaves(tree["params"]), _leaves(back["params"])
    assert sorted(got_back) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got_back[key], value, err_msg=key)

    own = flax_from_state_dict(model.state_dict(), [
        (("params", *p), v.shape) for p, v in
        ((tuple(k.key for k in path), leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0])
    ])
    for key, value in _leaves(own["params"]).items():
        np.testing.assert_array_equal(value, ref[key], err_msg=key)

    reloaded = _small_port(_small_tree(3, seed=9), 3)
    load_checkpoint(path, reloaded)
    assert all(torch.equal(a, b) for a, b in zip(reloaded.state_dict().values(), model.state_dict().values()))

    # the extractor reads the same file without its head; torchvision's
    # older MLP names are accepted
    state = {k.replace(".mlp.0.", ".mlp.linear_1.").replace(".mlp.3.", ".mlp.linear_2."): v
             for k, v in torch.load(path, weights_only=True).items()}
    torch.save({"state_dict": state}, tmp_path / "old_names.pt")
    headless = read_torch_checkpoint(tmp_path / "old_names.pt")
    assert not any(k.startswith("heads.") for k in headless) and not any("linear_" in k for k in headless)
    extractor = VisionTransformer(image_size=SIZE, **SMALL)
    load_state_dict_arrays(extractor, headless, "old_names.pt")
    assert torch.equal(extractor.encoder.ln.weight, model.encoder.ln.weight)


def test_arch_leaves_cover_the_flax_tree():
    for arch, num_classes in (("vit_t16", 2), ("resnet18", None)):
        tree = seeded_init_host(arch, 0, num_classes, image_size=SIZE)
        paths = {tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert {path for path, _ in arch_leaves(arch, num_classes, SIZE)} == paths


@pytest.mark.parametrize("wrong", ["other_width", "other_depth", "other_image_size", "resnet"])
def test_checkpoint_of_another_size_is_refused(wrong):
    """As ``check_weights_match_arch`` refuses it in the JAX package."""
    model = VisionTransformer(image_size=SIZE, **SMALL)
    if wrong == "resnet":
        arrays = state_dict_from_flax(seeded_init_host("resnet18", 0))
    else:
        cfg = dict(SMALL, **{"other_width": {"hidden_dim": 128}, "other_depth": {"num_layers": 3}}.get(wrong, {}))
        size = 48 if wrong == "other_image_size" else SIZE
        arrays = VisionTransformer(image_size=size, **cfg).state_dict()
    with pytest.raises(ValueError, match="does not match the model"):
        load_state_dict_arrays(model, arrays, "<test>")
    if wrong == "other_width":
        tree = seeded_init_host("vit_s16", 0, image_size=SIZE)
        with pytest.raises(ValueError, match="does not match"):
            port_torch.check_weights_match_arch(tree, "vit_t16", "<test>")
        with pytest.raises(ValueError, match="does not match the model"):
            load_flax_variables(build_vit("vit_t16", image_size=SIZE), tree)


def _step_inputs(seed: int, augment: bool):
    """8 rows, 2 of them batch padding (real pixels, valid=False), and the
    augmentation draws JAX makes from one key."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (8, SIZE, SIZE, 3), np.uint8)
    labels = rng.integers(0, 2, 8)
    valid = np.arange(8) < 6
    key = jax.random.PRNGKey(seed)
    coeffs = None
    if augment:
        k_flip, k_rot = jax.random.split(key)
        flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (8,)))
        angles = np.asarray(jax.random.uniform(k_rot, (8,), minval=-10.0, maxval=10.0) * (jnp.pi / 180.0))
        coeffs = augment_coeffs(flip, angles)
    return images, labels, valid, key, coeffs


def _jax_step(tree, images, labels, valid, key, augment):
    """The JAX package's own train step (``make_train_step``) for loss,
    predictions and new parameters, and its loss written out under
    ``jax.grad`` for the gradients."""
    model = JaxViT(num_classes=2, **SMALL)
    state = jeng.TrainState.create(model.apply, tree["params"], {}, jeng.make_optimizer(LR, WD))
    batch = (jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid))
    new_state, loss, pred = jeng.make_train_step(augment=augment)(state, *batch, key)
    x = jax_train_augment(batch[0], key) if augment else jax_eval_preprocess(batch[0])

    def loss_fn(params):
        w = batch[2].astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(model.apply({"params": params}, x, train=True), batch[1])
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    return float(loss), np.asarray(pred), jax.grad(loss_fn)(tree["params"]), new_state.params


def _port_step(tree, images, labels, valid, coeffs, remat: bool = False):
    model = _small_port(tree, 2, remat=remat)
    state = engine.TrainState.create(model, LR, WD)
    loss, pred = engine.train_step(
        state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        None if coeffs is None else torch.from_numpy(coeffs),
    )
    return float(loss), pred.numpy(), {k: p.grad.numpy() for k, p in model.named_parameters()}, model.state_dict()


@pytest.mark.parametrize("augment,seed", [(True, 1), (False, 2)])
def test_train_step_matches_the_jax_engine(augment, seed):
    """Loss ≤ 1e-5 relative, argmax equal, every gradient ≤ 1e-4 relative to
    its tensor's max |g|, and parameters after one AdamW step ≤ 1e-6
    absolute wherever JAX's |g| exceeds 1e-3 of its tensor's max (elsewhere
    Adam's first step follows the sign of a near-zero gradient). The ViT
    has no ReLU and no max-pool, so the seeded weights need no shifting."""
    images, labels, valid, key, coeffs = _step_inputs(seed, augment)
    tree = _small_tree(2, seed=seed)
    loss_j, pred_j, grads_j, params_j = _jax_step(tree, images, labels, valid, key, augment)
    loss_t, pred_t, grads_t, sd = _port_step(tree, images, labels, valid, coeffs)
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(pred_t, pred_j)
    want_grads = state_dict_from_flax({"params": jax.device_get(grads_j)})
    want_params = state_dict_from_flax({"params": jax.device_get(params_j)})
    assert sorted(want_grads) == sorted(grads_t)
    for name, g in want_grads.items():
        assert _rel(grads_t[name], g) <= 1e-4, name
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(sd[name].numpy()[big], want_params[name][big], rtol=0, atol=1e-6, err_msg=name)


def test_remat_equals_plain():
    """Checkpointed blocks give the same loss and gradients, and eval does
    not checkpoint."""
    images, labels, valid, _, coeffs = _step_inputs(3, True)
    tree = _small_tree(2, seed=3)
    loss, pred, grads, _ = _port_step(tree, images, labels, valid, coeffs)
    loss_r, pred_r, grads_r, _ = _port_step(tree, images, labels, valid, coeffs, remat=True)
    assert loss_r == loss and np.array_equal(pred_r, pred)
    for name, g in grads.items():
        np.testing.assert_array_equal(grads_r[name], g, err_msg=name)
    x = torch.from_numpy(_images(2))
    with torch.inference_mode():
        assert torch.equal(_small_port(tree, 2, remat=True).eval()(x), _small_port(tree, 2).eval()(x))


def test_eval_epoch_and_best_state_work_without_batchnorm_buffers():
    """The engine's eval epoch against the JAX engine's on a model with no
    ``batch_stats``, and the best-state snapshot of a model without buffers."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (7, SIZE, SIZE, 3), np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 1])
    tree = _small_tree(2, seed=4)
    loss_j, y_j, pred_j, prob_j = jeng.run_eval_epoch(
        tree, jeng.DeviceDataset.create(jnp.asarray(images), labels), 4, apply_fn=JaxViT(num_classes=2, **SMALL).apply
    )
    model = _small_port(tree, 2)
    dataset = engine.DeviceDataset.create(torch.from_numpy(images), labels)
    loss_t, y_t, pred_t, prob_t = engine.run_eval_epoch(model, dataset, 4)
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(pred_t, pred_j)
    np.testing.assert_allclose(prob_t, prob_j, rtol=1e-5, atol=1e-6)

    state = engine.TrainState.create(model, LR, WD)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not list(model.buffers())
    best, history = engine.train_model(
        state, dataset, dataset, num_epochs=2, batch_size=4, seed=0, stream_name="baseline",
        early_stopping_patience=1,
    )
    assert len(history["val_loss"]) in (1, 2) and np.isfinite(history["train_loss"]).all()
    assert any(not torch.equal(v, before[k]) for k, v in best.model.state_dict().items())
