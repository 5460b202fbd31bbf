"""The port's train step, train-mode BatchNorm, epoch plan and epoch driver
against the JAX package.

ResNet-18 runs at full depth on 32²–48² images, as
``tests/test_training_pipelines.py`` runs it, with the same seeded weights (the
Flax ``fc`` head included) in both packages. The JAX side of the step is written out here: ``model.apply`` in
train mode with ``mask``, the masked cross-entropy and ``jax.value_and_grad``,
then the package's own AdamW (``make_optimizer``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.resnet import MaskedBatchNorm, ResNet18
from ssip_tpu.ops.augment import eval_preprocess as jax_eval_preprocess
from ssip_tpu.ops.augment import train_augment as jax_train_augment
from ssip_tpu.train import engine as jeng
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables, state_dict_from_flax
from ssip_tpu_torch.models.resnet import BatchNorm, build_resnet
from ssip_tpu_torch.ops.augment import augment_coeffs
from ssip_tpu_torch.train import engine

torch.set_num_threads(2)

SIZE = 32
# The one-step comparison runs at 48² (at 32² layer4's BatchNorm normalizes
# 1×1 maps over 4 rows and the two frameworks' losses part by 2e-5) and at
# kink-free weights (``_kink_free``).
STEP_SIZE = 48
LR, WD = 1e-3, 1e-4


def _leaves(tree):
    return {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("seed,num_classes", [(42, 2), (3, 2), (42, 5)])
def test_seeded_init_with_head_matches_jax_bitwise(seed, num_classes):
    ref = _leaves(jax_seeded_init_host(ResNet18(num_classes=num_classes), seed, (1, SIZE, SIZE, 3)))
    got = _leaves(seeded_init_host("resnet18", seed, num_classes))
    assert sorted(got) == sorted(ref)
    assert "['params']['fc']['kernel']" in got
    for key, value in ref.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("masked", [True, False])
def test_train_mode_batchnorm_matches_masked_batchnorm(masked):
    """Statistics over the valid rows only, biased variance in the
    normalization, unbiased variance in the running update."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, (5, 4, 6, 8)).astype(np.float32)  # NHWC, C = 8
    mask = np.array([True, True, False, True, False]) if masked else None
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.3, 8).astype(np.float32)
    ra_mean = rng.normal(0, 0.1, 8).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": ra_mean, "var": ra_var}}
    want, new_state = MaskedBatchNorm().apply(
        variables, jnp.asarray(x), use_running_average=False,
        mask=None if mask is None else jnp.asarray(mask), mutable=["batch_stats"],
    )
    bn = BatchNorm(8, torch.float32)
    bn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(ra_mean), "running_var": torch.from_numpy(ra_var),
        "num_batches_tracked": torch.zeros((), dtype=torch.long),
    })
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), None if mask is None else torch.from_numpy(mask))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    rows = slice(None) if mask is None else mask
    np.testing.assert_allclose(got[rows], np.asarray(want)[rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), new_state["batch_stats"]["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), new_state["batch_stats"]["var"], rtol=1e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == 1


def _kink_free(tree, bn_bias: float = 4.0):
    """The seeded tree with every conv filter re-centred to zero mean and
    every BN bias raised by ``bn_bias``.

    At the seeded init (BN bias 0) half of all ReLU inputs sit at the kink:
    the 1e-6 relative difference between two frameworks' forwards flips a
    few ReLU masks, and each flip moves single gradient entries by percent
    of their tensor's max (measured: up to 15 % under a 1e-6 weight
    perturbation in one framework alone). Raised BN biases keep ReLU inputs
    4 standard deviations off the kink; centred filters keep the next
    conv's outputs near zero mean, so E[x²] − E[x]² does not cancel.
    """
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            value = _kink_free(value, bn_bias)
            if "scale" in value:
                value = {**value, "bias": value["bias"] + np.float32(bn_bias)}
        elif name == "kernel" and value.ndim == 4:
            value = (value - value.mean(axis=(0, 1, 2), keepdims=True)).astype(np.float32)
        out[name] = value
    return out


def _step_inputs(seed: int, augment: bool):
    """8 rows, 2 of them batch padding (real pixels, valid=False), and the
    augmentation draws JAX makes from one key."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (8, STEP_SIZE, STEP_SIZE, 3), np.uint8)
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


@jax.jit
def _jax_loss_and_grad(params, batch_stats, x, labels, mask):
    def loss_fn(params):
        logits, new_state = ResNet18(num_classes=2).apply(
            {"params": params, "batch_stats": batch_stats}, x,
            train=True, mask=mask, mutable=["batch_stats"],
        )
        w = mask.astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0), (logits, new_state)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _jax_step(variables, images, labels, valid, key, augment):
    """The JAX package's step (``engine.py:_step_core``), written out: the
    masked loss of ``model.apply`` in train mode, ``jax.value_and_grad``,
    then the package's AdamW."""
    x = jax_train_augment(jnp.asarray(images), key) if augment else jax_eval_preprocess(jnp.asarray(images))
    (loss, (logits, new_state)), grads = _jax_loss_and_grad(
        variables["params"], variables["batch_stats"], x, jnp.asarray(labels), jnp.asarray(valid)
    )
    tx = jeng.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    return float(loss), np.asarray(jnp.argmax(logits, axis=1)), grads, new_state["batch_stats"], new_params


def _port_step(variables, images, labels, valid, coeffs):
    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    state = engine.TrainState.create(model, LR, WD)
    loss, pred = engine.train_step(
        state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        None if coeffs is None else torch.from_numpy(coeffs),
    )
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return float(loss), pred.numpy(), grads, model.state_dict()


@pytest.mark.parametrize("augment,seed", [(True, 1), (True, 2), (False, 1)])
def test_train_step_matches_jax(augment, seed):
    """Loss ≤ 1e-5 relative, argmax equal, BN running statistics ≤ 1e-5
    relative, every gradient ≤ 1e-4 relative to its tensor's max |g|, and
    parameters after one AdamW step ≤ 1e-6 absolute wherever JAX's |g|
    exceeds 1e-3 of its tensor's max (elsewhere Adam's first step moves a
    parameter by about lr·sign(g), and the sign of a near-zero gradient is
    rounding)."""
    images, labels, valid, key, coeffs = _step_inputs(seed, augment)
    variables = _kink_free(seeded_init_host("resnet18", 42, 2))
    loss_j, pred_j, grads_j, stats_j, params_j = _jax_step(variables, images, labels, valid, key, augment)
    loss_t, pred_t, grads_t, sd = _port_step(variables, images, labels, valid, coeffs)

    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(pred_t, pred_j)
    for name, value in state_dict_from_flax({"batch_stats": jax.device_get(stats_j)}).items():
        assert _rel(sd[name].numpy(), value) <= 1e-5, name
    want_grads = state_dict_from_flax({"params": jax.device_get(grads_j)})
    want_params = state_dict_from_flax({"params": jax.device_get(params_j)})
    assert sorted(want_grads) == sorted(grads_t)
    below = total = 0
    for name, g in want_grads.items():
        assert _rel(grads_t[name], g) <= 1e-4, name
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        total += g.size
        below += int((~big).sum())
        np.testing.assert_allclose(sd[name].numpy()[big], want_params[name][big], rtol=0, atol=1e-6, err_msg=name)
    assert below < 0.25 * total, (below, total)  # 13–17 % of the 11.2 M at these inputs


@pytest.mark.parametrize("balanced,n,batch,epoch", [(True, 13, 4, 0), (True, 20, 16, 3), (False, 13, 4, 1), (False, 9, 9, 2)])
def test_epoch_plan_matches_jax(balanced, n, batch, epoch):
    labels = np.random.default_rng(n).integers(0, 2, n)
    jds = jeng.DeviceDataset.create(jnp.zeros((n, 1, 1, 3), jnp.uint8), labels)
    tds = engine.DeviceDataset.create(torch.zeros((n, 1, 1, 3), dtype=torch.uint8), labels)
    kwargs = dict(seed=42, epoch=epoch, stream_name="baseline", balanced=balanced, batch_size=batch)
    pidx_j, valid_j, keys = jeng.epoch_plan(jds, **kwargs)
    pidx_t, valid_t, coeffs = engine.epoch_plan(tds, **kwargs)
    np.testing.assert_array_equal(pidx_t, pidx_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert pidx_t.dtype == pidx_j.dtype
    assert coeffs.shape == (len(keys), 3, batch) and coeffs.dtype == np.int32


def test_eval_epoch_matches_jax():
    """Mean of per-batch mean losses over a short last batch, predictions
    and softmax probabilities of the eval-mode forward."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (7, SIZE, SIZE, 3), np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 1])
    variables = seeded_init_host("resnet18", 42, 2)
    for bn in ("bn1",):  # non-trivial running statistics for the eval forward
        variables["batch_stats"][bn]["var"] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    loss_j, y_j, pred_j, prob_j = jeng.run_eval_epoch(
        variables, jeng.DeviceDataset.create(jnp.asarray(images), labels), 4, apply_fn=ResNet18(num_classes=2).apply
    )
    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    loss_t, y_t, pred_t, prob_t = engine.run_eval_epoch(
        model, engine.DeviceDataset.create(torch.from_numpy(images), labels), 4
    )
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(pred_t, pred_j)
    np.testing.assert_allclose(prob_t, prob_j, rtol=1e-5, atol=1e-6)


# A validation-loss script that exercises every branch of the driver: tiny
# improvements inside the plateau threshold (new bests, but bad epochs for
# the scheduler, the third of which halves the learning rate), a real
# improvement, then three bad epochs that halve it again and stop the run.
VAL_SCRIPT = [1.0, 0.9, 0.89995, 0.95, 0.89994, 0.96, 0.8, 0.85, 0.86, 0.87, 0.5]


def _jax_driver(monkeypatch, script, num_epochs):
    calls = iter(script)
    monkeypatch.setattr(jeng, "run_eval_epoch", lambda *a, **k: (next(calls), np.zeros(2, int), np.zeros(2, int), None))

    def fake_fused_epoch(**_):
        def run(state, images, labels, valid, keys):
            steps, b = valid.shape
            return state.replace(step=state.step + steps), jnp.zeros(steps), jnp.zeros((steps, b), jnp.int32)
        return run

    monkeypatch.setattr(jeng, "make_fused_epoch", fake_fused_epoch)
    state = jeng.TrainState.create(
        apply_fn=None, params={"w": jnp.zeros(2)}, batch_stats={}, tx=jeng.make_optimizer(LR, WD)
    )
    ds = jeng.DeviceDataset.create(jnp.zeros((10, 1, 1, 3), jnp.uint8), np.arange(10) % 2)
    saved = []
    best, history = jeng.train_model(
        state, ds, ds, num_epochs=num_epochs, batch_size=4, seed=0, stream_name="baseline",
        checkpoint_fn=lambda s: saved.append(int(s.step)),
    )
    return int(best.step), jeng.get_lr(best), history, saved


def _port_driver(monkeypatch, script, num_epochs):
    """The port's driver with scripted validation losses and an epoch that
    adds 1 to every parameter, so the returned state names its epoch."""
    calls = iter(script)
    monkeypatch.setattr(engine, "run_eval_epoch", lambda *a, **k: (next(calls), np.zeros(2, int), np.zeros(2, int), None))

    def fake_epoch(state, dataset, pidx, valid, coeffs, trainable_mask=None):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step += pidx.shape[0]
        return np.zeros(pidx.shape[0]), np.zeros(pidx.shape, np.int64)

    monkeypatch.setattr(engine, "run_train_epoch", fake_epoch)
    model = torch.nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    state = engine.TrainState.create(model, LR, WD)
    ds = engine.DeviceDataset.create(torch.zeros((10, 1, 1, 3), dtype=torch.uint8), np.arange(10) % 2)
    saved = []
    best, history = engine.train_model(
        state, ds, ds, num_epochs=num_epochs, batch_size=4, seed=0, stream_name="baseline",
        checkpoint_fn=lambda s: saved.append(s.step),
    )
    return best, history, saved


@pytest.mark.parametrize("num_epochs", [11, 6])
def test_driver_decisions_match_jax(monkeypatch, num_epochs):
    """Plateau, early stop and the returned best state, step for step as
    JAX ``train_model`` under the same validation-loss script."""
    step_j, lr_j, hist_j, saved_j = _jax_driver(monkeypatch, VAL_SCRIPT, num_epochs)
    best, hist_t, saved_t = _port_driver(monkeypatch, VAL_SCRIPT, num_epochs)
    assert hist_t["val_loss"] == hist_j["val_loss"]
    assert saved_t == saved_j
    assert best.step == step_j
    assert math.isclose(engine.get_lr(best), lr_j, rel_tol=1e-6)
    assert lr_j == pytest.approx(LR * 0.5)  # the best state was taken after the first halving
    epochs_at_best = step_j // 3  # 10 samples in batches of 4: 3 steps an epoch
    np.testing.assert_array_equal(best.model.weight.detach().numpy(), np.full((2, 2), float(epochs_at_best)))
    assert len(hist_t["val_loss"]) == (10 if num_epochs == 11 else 6)  # 11: stops after the 0.8 best


def test_best_state_is_a_copy_not_an_alias(monkeypatch):
    """Later epochs must not reach the captured best state: with the best at
    epoch 1 of 3, the returned parameters carry one epoch's update, not
    three (a ``state_dict()`` kept without cloning would carry three)."""
    best, hist, saved = _port_driver(monkeypatch, [1.0, 2.0, 3.0], 3)
    assert len(hist["val_loss"]) == 3 and saved == [3]
    np.testing.assert_array_equal(best.model.bias.detach().numpy(), np.ones(2))
    assert best.step == 3
