"""The port's FixMatch views, step and epoch loop against the JAX package.

The random draws are made with ``jax.random`` by the key splits of
``ssip_tpu/ops/augment.py:407-426`` and ``train/consistency.py:73`` and
handed to the port as numpy, so both packages see the same flips, angles,
brightness and contrast. The step runs ``make_fixmatch_epoch`` for one step on
carried weights: a full-depth ResNet-18 at 48² and kink-free weights (see
``tests/test_torch_train.py``) and a narrow two-layer ViT at 32². The
optimizer of the step comparison is ``optax.trace(decay=0)``, whose state is
the gradient itself and whose update is ``p + g``; the port runs
``torch.optim.SGD(lr=1, maximize=True)``, the same update (AdamW is held to
optax in ``tests/test_torch_train.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models.resnet import ResNet18
from ssip_tpu.models.vit import VisionTransformer as JaxViT
from ssip_tpu.ops.augment import strong_augment as jax_strong_augment
from ssip_tpu.ops.augment import weak_augment as jax_weak_augment
from ssip_tpu.train import consistency as jcons
from ssip_tpu.train import engine as jeng
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables, state_dict_from_flax
from ssip_tpu_torch.models.resnet import build_resnet
from ssip_tpu_torch.models.vit import VisionTransformer
from ssip_tpu_torch.ops.augment import augment_coeffs, strong_augment, weak_augment
from ssip_tpu_torch.runtime.prng import fixmatch_draws
from ssip_tpu_torch.train import consistency, engine
from tests.test_torch_train import _kink_free, _rel
from tests.test_torch_vit import SMALL, _small_tree

torch.set_num_threads(2)

LR, WD = 1e-3, 1e-4
DEGREES = 10.0
DEG_TO_RAD = jnp.pi / 180.0


def _flips_and_angles(k_flip, k_rot, b):
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))
    angles = np.array(jax.random.uniform(k_rot, (b,), minval=-DEGREES, maxval=DEGREES) * DEG_TO_RAD)
    return flip, angles


def _strong_draws(key, b):
    """(coeffs, brightness, contrast) as ``strong_augment`` draws them."""
    k_flip, k_rot, k_bright, k_contrast = jax.random.split(key, 4)
    coeffs = augment_coeffs(*_flips_and_angles(k_flip, k_rot, b))
    brightness = np.array(jax.random.uniform(k_bright, (b, 1, 1, 1), minval=-32.0, maxval=32.0)).reshape(b)
    contrast = np.array(jax.random.uniform(k_contrast, (b, 1, 1, 1), minval=0.7, maxval=1.3)).reshape(b)
    return coeffs, brightness, contrast


def _step_draws(key, b, u) -> consistency.ViewDraws:
    """One step's draws by the key splits of the JAX step."""
    k_sup, k_weak, k_strong = jax.random.split(key, 3)
    sup = augment_coeffs(*_flips_and_angles(*jax.random.split(k_sup), b))
    weak_flip = np.array(jax.random.bernoulli(k_weak, 0.5, (u,)))
    strong, brightness, contrast = _strong_draws(k_strong, u)
    return consistency.ViewDraws(*(torch.from_numpy(a) for a in (sup, weak_flip, strong, brightness, contrast)))


@pytest.mark.parametrize("seed", [0, 3])
def test_weak_augment_matches_jax_bitwise(seed):
    images = np.random.default_rng(seed).integers(0, 256, (8, 40, 56, 3), np.uint8)
    key = jax.random.PRNGKey(seed)
    flip = np.array(jax.random.bernoulli(key, 0.5, (8,)))
    assert flip.any() and not flip.all()
    for jdtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_weak_augment(jnp.asarray(images), key, dtype=jdtype).astype(jnp.float32))
        got = weak_augment(torch.from_numpy(images), torch.from_numpy(flip), tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("seed,shape", [(1, (8, 48, 48, 3)), (2, (4, 64, 36, 3))])
def test_strong_augment_matches_jax(seed, shape):
    """The rotation is bit-exact; the per-image mean is held in general
    (past a sum of 2^24 XLA's float32 order of adds is not known) to 1e-4
    absolute on normalized values (one uint8 step is 0.017 there) and the
    bfloat16 view to one bfloat16 step of values below 4 (2⁻⁶); the test
    below holds it bit for bit where the sum stays below 2^24."""
    images = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    key = jax.random.PRNGKey(seed)
    coeffs, brightness, contrast = (torch.from_numpy(a) for a in _strong_draws(key, shape[0]))
    want = np.asarray(jax_strong_augment(jnp.asarray(images), key, DEGREES))
    got = strong_augment(torch.from_numpy(images), coeffs, brightness, contrast)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    clipped = (want == want.min()) | (want == want.max())
    assert 0 < clipped.mean() < 0.5  # the clip to [0, 255] is exercised, and is not all there is
    want16 = np.asarray(jax_strong_augment(jnp.asarray(images), key, DEGREES, dtype=jnp.bfloat16).astype(jnp.float32))
    got16 = strong_augment(torch.from_numpy(images), coeffs, brightness, contrast, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=0, atol=2.0**-6)


@pytest.mark.parametrize("seed,shape,high", [(4, (8, 48, 48, 3), 256), (5, (4, 96, 80, 3), 256), (6, (3, 224, 224, 3), 100)])
def test_strong_augment_matches_jax_bitwise_below_2_24(seed, shape, high):
    """Where each image's sum over H, W and C stays below 2^24 (224² at
    values below 100 too), XLA's float32 sum is exact, and the port's exact
    sum times ``f32(1/n)`` is ``jnp.mean``: the float32 view is the JAX
    package's bit for bit, and its bfloat16 rounding too."""
    images = np.random.default_rng(seed).integers(0, high, shape, np.uint8)
    assert images.reshape(shape[0], -1).sum(axis=1, dtype=np.int64).max() < 2**24
    key = jax.random.PRNGKey(seed)
    coeffs, brightness, contrast = (torch.from_numpy(a) for a in _strong_draws(key, shape[0]))
    for jdtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_strong_augment(jnp.asarray(images), key, DEGREES, dtype=jdtype).astype(jnp.float32))
        got = strong_augment(torch.from_numpy(images), coeffs, brightness, contrast, tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_fixmatch_draws_are_seeded_ranged_and_apart():
    a = fixmatch_draws(42, "semi_finetune", 1, 2, 64, 48)
    b = fixmatch_draws(42, "semi_finetune", 1, 2, 64, 48)
    c = fixmatch_draws(42, "semi_finetune", 1, 3, 64, 48)
    for name, want_len, dtype in (
        ("sup_flip", 64, bool), ("sup_angles", 64, np.float32), ("weak_flip", 48, bool),
        ("strong_flip", 48, bool), ("strong_angles", 48, np.float32), ("brightness", 48, np.float32),
        ("contrast", 48, np.float32),
    ):
        x = getattr(a, name)
        assert x.shape == (want_len,) and x.dtype == dtype, name
        np.testing.assert_array_equal(x, getattr(b, name))
        assert not np.array_equal(x, getattr(c, name)), name
    bound = np.float32(DEGREES) * np.float32(np.pi / 180.0)
    assert np.abs(a.sup_angles).max() <= bound and np.abs(a.strong_angles).max() <= bound
    assert -32.0 <= a.brightness.min() < a.brightness.max() <= 32.0
    assert np.float32(0.7) <= a.contrast.min() < a.contrast.max() <= np.float32(1.3)
    assert not np.array_equal(a.weak_flip, a.strong_flip)  # each view has its own stream
    stacked = consistency.epoch_view_draws(42, "semi_finetune", 1, 4, 64, 48, torch.device("cpu"))
    assert stacked.sup_coeffs.shape == (4, 3, 64) and stacked.strong_coeffs.shape == (4, 3, 48)
    np.testing.assert_array_equal(stacked[2].brightness.numpy(), a.brightness)
    np.testing.assert_array_equal(
        stacked[2].strong_coeffs.numpy(), augment_coeffs(a.strong_flip, a.strong_angles))


def _scaled_head(tree_params, factor: float):
    """The parameters with the head's kernel scaled."""
    out = jax.tree_util.tree_map(np.asarray, tree_params)
    out["fc"] = {**out["fc"], "kernel": out["fc"]["kernel"] * np.float32(factor)}
    return out


def _fixmatch_case(arch: str):
    """(JAX model, port model factory, Flax variables, image size)."""
    if arch == "resnet18":
        size = 48
        variables = _kink_free(seeded_init_host("resnet18", 42, 2))
        variables["batch_stats"]["bn1"]["var"] = np.random.default_rng(1).uniform(0.5, 1.5, 64).astype(np.float32)
        return ResNet18(num_classes=2), lambda: build_resnet("resnet18", num_classes=2), variables, size
    variables = _small_tree(2, seed=4)
    make = lambda: VisionTransformer(num_classes=2, compute_dtype=torch.float32, image_size=32, **SMALL)  # noqa: E731
    return JaxViT(num_classes=2, **SMALL), make, {"params": variables["params"], "batch_stats": {}}, 32


@pytest.mark.parametrize("arch,ema_decay", [("resnet18", 0.9), ("vit_small", 0.9), ("vit_small", 0.0)])
def test_fixmatch_step_matches_jax(arch, ema_decay):
    """One step of ``make_fixmatch_epoch`` against ``fixmatch_step``: total,
    supervised and consistency loss ≤ 1e-5 relative, keep rate and argmax
    equal, every gradient ≤ 1e-4 of its tensor's max |g|, BatchNorm running
    statistics (two momentum updates) ≤ 1e-5 relative, and the EMA average
    after the step ≤ 1e-6 absolute. The teacher's head is the student's
    rescaled and the threshold sits inside the teacher's confidences, so a
    weak pass with the student's parameters would keep other rows."""
    jax_model, make_port, variables, size = _fixmatch_case(arch)
    b, u, weight = 8, 8, 0.7
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    unlabeled = rng.integers(0, 256, (u, size, size, 3), np.uint8)
    labels = rng.integers(0, 2, b)
    valid = np.arange(b) < 6
    key = jax.random.PRNGKey(5)

    def weak_confidences(params):
        k_weak = jax.random.split(key, 3)[1]
        logits = jax_model.apply(
            {"params": params, **({"batch_stats": variables["batch_stats"]} if variables["batch_stats"] else {})},
            jax_weak_augment(jnp.asarray(unlabeled), k_weak), train=False,
        )
        return np.asarray(logits), np.asarray(jax.nn.softmax(logits, axis=1).max(axis=1))

    # The student's head is scaled so that its logits differ by at most 2 (at
    # kink-free weights they differ by hundreds, and a cross-entropy of 1e-6
    # holds nothing to 1e-5 relative); the teacher is the student with its
    # head scaled once more, so its confidences are its own.
    logits, _ = weak_confidences(variables["params"])
    variables = {**variables, "params": _scaled_head(
        variables["params"], 2.0 / np.abs(logits[:, 0] - logits[:, 1]).max())}
    teacher = _scaled_head(variables["params"], 1.5) if ema_decay else variables["params"]
    # the threshold: the median of the teacher's confidences on the weak view
    conf = np.sort(weak_confidences(teacher)[1])
    threshold = float((conf[u // 2 - 1] + conf[u // 2]) / 2)
    assert conf[u // 2] - conf[u // 2 - 1] > 1e-4  # no row sits at the threshold

    state = jeng.TrainState.create(jax_model.apply, variables["params"], variables["batch_stats"], optax.trace(decay=0.0))
    epoch = jcons.make_fixmatch_epoch(weight, threshold, ema_decay=ema_decay)
    stacked = tuple(jnp.asarray(a)[None] for a in (images, labels, valid, unlabeled)) + (key[None],)
    if ema_decay:
        new_state, new_ema, losses, sup, cons, keep, preds = epoch(state, teacher, *stacked)
    else:
        new_state, losses, sup, cons, keep, preds = epoch(state, *stacked)
    assert float(keep[0]) == 0.5

    model = make_port()
    load_flax_variables(model, variables)
    port_state = engine.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0, maximize=True))
    ema = None
    if ema_decay:
        ema = {k: torch.from_numpy(v.copy()) for k, v in state_dict_from_flax({"params": teacher}).items()}
    got = consistency.fixmatch_step(
        port_state, ema, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(unlabeled), _step_draws(key, b, u), consistency_weight=weight,
        confidence_threshold=threshold, ema_decay=ema_decay,
    )
    loss_t, sup_t, cons_t, keep_t, pred_t = (x.numpy() for x in got)
    for name, mine, theirs in (("loss", loss_t, losses), ("sup", sup_t, sup), ("cons", cons_t, cons)):
        assert abs(float(mine) - float(theirs[0])) <= 1e-5 * abs(float(theirs[0])), name
    assert float(cons[0]) > 0 and float(keep_t) == float(keep[0]) and port_state.step == 1
    np.testing.assert_array_equal(pred_t, np.asarray(preds[0]))

    want_grads = state_dict_from_flax({"params": jax.device_get(new_state.opt_state.trace)})
    assert sorted(want_grads) == sorted(k for k, _ in model.named_parameters())
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want_grads[name]) <= 1e-4, name
    sd = model.state_dict()
    if variables["batch_stats"]:
        stats = state_dict_from_flax({"batch_stats": jax.device_get(new_state.batch_stats)})
        assert stats
        for name, value in stats.items():
            assert _rel(sd[name].numpy(), value) <= 1e-5, name
        # the momentum was applied twice: one update from the seeded mean 0 would leave |mean| ≤ 0.1·|batch mean|
        assert int(sd["bn1.num_batches_tracked"]) == 2
    if ema_decay:
        for name, value in state_dict_from_flax({"params": jax.device_get(new_ema)}).items():
            np.testing.assert_allclose(ema[name].numpy(), value, rtol=0, atol=1e-6, err_msg=name)


def test_ema_recurrence_and_swapped_parameters():
    model = torch.nn.Linear(3, 2)
    ema = consistency.init_ema(model)
    start = {k: v.clone() for k, v in ema.items()}
    assert all(ema[k].data_ptr() != p.data_ptr() for k, p in model.named_parameters())  # a copy, not an alias
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    consistency.update_ema(ema, model, 0.75)
    for name, p in model.named_parameters():
        torch.testing.assert_close(ema[name], 0.75 * start[name] + 0.25 * p.detach(), rtol=0, atol=1e-7)
    live = {k: p.detach().clone() for k, p in model.named_parameters()}
    x = torch.ones(1, 3)
    with consistency.swapped_parameters(model, ema):
        inside = model(x)
        assert all(torch.equal(p, ema[k]) for k, p in model.named_parameters())
    torch.testing.assert_close(inside, x @ ema["weight"].T + ema["bias"])
    assert all(torch.equal(p, live[k]) for k, p in model.named_parameters())  # restored
    with pytest.raises(RuntimeError, match="boom"):
        with consistency.swapped_parameters(model, ema):
            raise RuntimeError("boom")
    assert all(torch.equal(p, live[k]) for k, p in model.named_parameters())  # restored after an error too
    with consistency.swapped_parameters(model, None):
        assert all(torch.equal(p, live[k]) for k, p in model.named_parameters())


# tiny improvements inside the plateau threshold, a real one, then bad epochs
# that halve the rate and stop the run (the script of tests/test_torch_train.py)
VAL_SCRIPT = [1.0, 0.9, 0.89995, 0.95, 0.89994, 0.96, 0.8, 0.85, 0.86, 0.87, 0.5]
N_LABELED, N_POOL, BATCH, UNLABELED_BATCH, DECAY = 10, 200, 4, 6, 0.5


def _jax_fixmatch_loop(monkeypatch, script, num_epochs, ema_decay):
    calls = iter(script)
    seen, evaluated = [], []

    def fake_eval(state, *a, **k):
        evaluated.append(float(state.params["w"][0]))
        return next(calls), np.zeros(2, int), np.zeros(2, int), None

    def fake_make(*_, **kw):
        def advance(state, ema, unl):
            steps = unl.shape[0]
            seen.append(np.asarray(unl)[:, :, 0, 0, 0])
            for _ in range(steps):
                state = state.replace(step=state.step + 1, params={"w": state.params["w"] + 1.0})
                if ema is not None:
                    ema = {"w": ema["w"] * ema_decay + state.params["w"] * (1.0 - ema_decay)}
            zeros = jnp.zeros(steps)
            return state, ema, (zeros, zeros, zeros + 0.25, zeros + 0.5, jnp.zeros((steps, BATCH), jnp.int32))

        def with_ema(state, ema, images, labels, valid, unl, keys):
            state, ema, metrics = advance(state, ema, unl)
            return (state, ema, *metrics)

        def without(state, images, labels, valid, unl, keys):
            state, _, metrics = advance(state, None, unl)
            return (state, *metrics)

        return with_ema if kw["ema_decay"] > 0 else without

    monkeypatch.setattr(jeng, "run_eval_epoch", fake_eval)
    monkeypatch.setattr(jcons, "make_fixmatch_epoch", fake_make)
    state = jeng.TrainState.create(None, {"w": jnp.zeros(2)}, {}, jeng.make_optimizer(LR, WD))
    ds = jeng.DeviceDataset.create(jnp.zeros((N_LABELED, 1, 1, 3), jnp.uint8), np.arange(N_LABELED) % 2)
    pool = jnp.asarray(np.arange(N_POOL, dtype=np.uint8).reshape(N_POOL, 1, 1, 1).repeat(3, axis=3))
    best, history = jcons.train_fixmatch(
        state, ds, ds, pool, num_epochs=num_epochs, batch_size=BATCH, unlabeled_batch_size=UNLABELED_BATCH, seed=7,
        stream_name="semi_finetune", consistency_weight=1.0, confidence_threshold=0.9, ema_decay=ema_decay,
    )
    return int(best.step), jeng.get_lr(best), float(best.params["w"][0]), history, seen, evaluated


def _port_fixmatch_loop(monkeypatch, script, num_epochs, ema_decay):
    calls = iter(script)
    seen, evaluated = [], []

    def fake_eval(model, *a, **k):
        evaluated.append(float(model.weight.detach()[0, 0]))
        return next(calls), np.zeros(2, int), np.zeros(2, int), None

    def fake_step(state, ema, images, labels, valid, unlabeled, draws, **kw):
        seen.append(unlabeled[:, 0, 0, 0].numpy())
        assert draws.strong_coeffs.shape == (3, UNLABELED_BATCH) and draws.sup_coeffs.shape == (3, BATCH)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step += 1
        if ema is not None:
            consistency.update_ema(ema, state.model, kw["ema_decay"])
        zero = torch.zeros(())
        return zero, zero, zero + 0.25, zero + 0.5, torch.zeros(BATCH, dtype=torch.int64)

    monkeypatch.setattr(consistency, "run_eval_epoch", fake_eval)
    monkeypatch.setattr(consistency, "fixmatch_step", fake_step)
    model = torch.nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    state = engine.TrainState.create(model, LR, WD)
    ds = engine.DeviceDataset.create(torch.zeros((N_LABELED, 1, 1, 3), dtype=torch.uint8), np.arange(N_LABELED) % 2)
    pool = torch.from_numpy(np.arange(N_POOL, dtype=np.uint8).reshape(N_POOL, 1, 1, 1).repeat(3, axis=3))
    best, history = consistency.train_fixmatch(
        state, ds, ds, pool, num_epochs=num_epochs, batch_size=BATCH, unlabeled_batch_size=UNLABELED_BATCH, seed=7,
        stream_name="semi_finetune", consistency_weight=1.0, confidence_threshold=0.9, ema_decay=ema_decay,
    )
    return best, history, seen, evaluated


@pytest.mark.parametrize("num_epochs,ema_decay", [(11, DECAY), (6, DECAY), (11, 0.0)])
def test_epoch_loop_decisions_match_jax(monkeypatch, num_epochs, ema_decay):
    """Plateau, early stop and the returned best state as JAX
    ``train_fixmatch`` under the same validation-loss script, with the
    unlabeled batches index for index. With EMA on, validation sees the EMA
    parameters and the best state holds them, not the student's."""
    step_j, lr_j, w_j, hist_j, seen_j, eval_j = _jax_fixmatch_loop(monkeypatch, VAL_SCRIPT, num_epochs, ema_decay)
    best, hist_t, seen_t, eval_t = _port_fixmatch_loop(monkeypatch, VAL_SCRIPT, num_epochs, ema_decay)
    assert hist_t == hist_j and sorted(hist_t) == sorted(
        ["train_loss", "val_loss", "train_acc", "val_acc", "train_f1", "val_f1", "consistency_loss",
         "consistency_keep_rate"])
    assert hist_t["consistency_loss"][0] == 0.25 and hist_t["consistency_keep_rate"][0] == 0.5
    np.testing.assert_array_equal(np.stack(seen_t), np.concatenate(seen_j).reshape(-1, UNLABELED_BATCH))
    np.testing.assert_allclose(eval_t, eval_j, rtol=1e-6)
    assert best.step == step_j and math.isclose(engine.get_lr(best), lr_j, rel_tol=1e-6)
    got_w = float(best.model.weight.detach()[0, 0])
    assert got_w == pytest.approx(w_j, rel=1e-6)
    if ema_decay:
        assert got_w != float(best.step)  # the EMA average, which trails the student's step count
        assert eval_t[0] != 3.0  # validation after epoch 1 (3 steps) saw the average, not the student
    else:
        assert got_w == float(best.step)
    assert len(hist_t["val_loss"]) == (10 if num_epochs == 11 else 6)
