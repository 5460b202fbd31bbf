"""The port's RandAugment + Cutout strong view against the JAX package's.

The draws are taken from a JAX key by the splits
``ssip_tpu/ops/randaugment.py`` makes (``:282-286`` per layer, ``:313-315``
for the cutout, ``:336-337`` for the policy) and handed to the port as
numpy. The uint8 view before the normalize is held bit for bit to the JAX
one: each of the 14 ops alone (the draws' op forced, through the JAX
package's layer functions), and the composed policy
``strong_augment_randaugment(u8, key)``; the normalized view within 1e-6
(float32) and one bfloat16 rounding of it. One FixMatch step with
``strong_aug="randaugment"`` is held to the JAX step on a narrow ViT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models.vit import VisionTransformer as JaxViT
from ssip_tpu.ops import randaugment as jra
from ssip_tpu.ops.augment import random_flip as jax_random_flip
from ssip_tpu.train import consistency as jcons
from ssip_tpu.train import engine as jeng
from ssip_tpu_torch.models.port import load_flax_variables, state_dict_from_flax
from ssip_tpu_torch.models.vit import VisionTransformer
from ssip_tpu_torch.ops import randaugment
from ssip_tpu_torch.ops.augment import augment_coeffs
from ssip_tpu_torch.runtime.prng import RandAugmentDraws, fixmatch_draws, randaugment_draws
from ssip_tpu_torch.train import consistency, engine
from tests.test_torch_train import _rel
from tests.test_torch_vit import SMALL, _small_tree

torch.set_num_threads(2)


def jax_draws(key, b: int, h: int, w: int, num_layers: int = 2) -> RandAugmentDraws:
    """``strong_augment_randaugment(u8, key)``'s draws, by its key splits."""
    k_flip, k_ra, k_cut = jax.random.split(key, 3)
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))
    op, mag, sign = [], [], []
    k = k_ra
    for _ in range(num_layers):
        k, k_op, k_mag, k_sign = jax.random.split(k, 4)
        op.append(np.array(jax.random.randint(k_op, (b,), 0, jra.NUM_OPS)))
        mag.append(np.array(jax.random.uniform(k_mag, (b,))))
        sign.append(np.where(np.array(jax.random.bernoulli(k_sign, 0.5, (b,))), 1.0, -1.0).astype(np.float32))
    k_y, k_x = jax.random.split(k_cut)
    cy = np.array(jax.random.randint(k_y, (b,), 0, h))
    cx = np.array(jax.random.randint(k_x, (b,), 0, w))
    return RandAugmentDraws(flip, np.stack(op).astype(np.int64), np.stack(mag), np.stack(sign),
                            cy.astype(np.int64), cx.astype(np.int64))


def _tensors(draws: RandAugmentDraws) -> RandAugmentDraws:
    return draws.map(lambda a: torch.from_numpy(np.array(a)))


def _images(seed: int, shape) -> np.ndarray:
    """Seeded uint8 images, one constant (autocontrast's and equalize's
    identity branch) and one of narrow range (their stretch)."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    u8[0] = 97
    u8[1] = rng.integers(40, 90, shape[1:], dtype=np.uint8)
    return u8


def test_pool_and_ranges_match_jax():
    assert randaugment.GEO_OPS == jra._GEO_OPS and randaugment.PIXEL_OPS == jra._PIXEL_OPS
    assert randaugment.NUM_OPS == jra.NUM_OPS == 14
    for name in ("MAX_ROTATE_DEG", "MAX_SHEAR", "MAX_TRANSLATE", "MAX_ENHANCE", "MAX_POSTERIZE_DROP"):
        assert getattr(randaugment, name) == getattr(jra, name), name


@pytest.mark.parametrize("op", range(14))
def test_each_op_matches_jax_bitwise(op):
    """One layer with every image's op forced to ``op``, magnitudes and
    signs from a JAX key: the warp and the pixel bank bit for bit."""
    b, h, w = 16, 40, 36
    u8 = _images(op, (b, h, w, 3))
    draws = jax_draws(jax.random.PRNGKey(100 + op), b, h, w, num_layers=1)
    ops = np.full((1, b), op, np.int64)
    mag, sign = draws.magnitude, draws.sign
    mag[0, :3] = (0.0, 1.0, 0.5)  # the ends of the range and a posterize/solarize tie
    x = jnp.asarray(u8).astype(jnp.float32)
    g_op = jnp.where(jnp.asarray(ops[0]) < jra._N_GEO, jnp.asarray(ops[0]), -1)
    x = jra._affine_nearest(x, *jra._geo_params(g_op, jnp.asarray(mag[0]), jnp.asarray(sign[0]), h, w))
    x = jra._apply_pixel_bank(x, jnp.asarray(ops[0]), jnp.asarray(mag[0]), jnp.asarray(sign[0]))
    want = np.asarray(jnp.clip(x, 0.0, 255.0).astype(jnp.uint8))
    geo = torch.from_numpy(randaugment.geometry(ops, mag, sign, h, w))
    got = randaugment.randaugment(torch.from_numpy(u8), torch.from_numpy(ops), torch.from_numpy(mag),
                                  torch.from_numpy(sign), geo).numpy()
    np.testing.assert_array_equal(got, want)
    if op not in (5,):  # identity (op 5) changes nothing; every other op changes something
        assert (got != u8).any()


@pytest.mark.parametrize("seed,shape", [(0, (16, 40, 36, 3)), (3, (4, 224, 224, 3))])
def test_policy_matches_jax_bitwise(seed, shape):
    """flip → RandAugment(2) → Cutout: uint8 bit for bit; normalized within
    1e-6 in float32, and the same bfloat16 rounding."""
    b, h, w, _ = shape
    u8 = _images(seed, shape)
    key = jax.random.PRNGKey(seed)
    draws = _tensors(jax_draws(key, b, h, w))
    k_flip, k_ra, k_cut = jax.random.split(key, 3)
    want = np.asarray(jra.cutout(jra.randaugment(jax_random_flip(jnp.asarray(u8), k_flip), k_ra), k_cut))
    got = randaugment.strong_view_u8(torch.from_numpy(u8), draws)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    want_n = np.asarray(jra.strong_augment_randaugment(jnp.asarray(u8), key))
    got_n = randaugment.strong_augment_randaugment(torch.from_numpy(u8), draws)
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=0, atol=1e-6)
    want16 = np.asarray(jra.strong_augment_randaugment(jnp.asarray(u8), key, dtype=jnp.bfloat16).astype(jnp.float32))
    got16 = randaugment.strong_augment_randaugment(torch.from_numpy(u8), draws, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), want16)


def test_cutout_matches_jax_at_the_edges():
    u8 = _images(5, (6, 20, 30, 3))
    key = jax.random.PRNGKey(7)
    k_y, k_x = jax.random.split(key)
    cy = np.array([0, 19, 10, 3, 0, 19])
    cx = np.array([0, 29, 15, 28, 29, 0])
    want = np.asarray(jra.cutout(jnp.asarray(u8), key))
    jcy = np.array(jax.random.randint(k_y, (6,), 0, 20))
    jcx = np.array(jax.random.randint(k_x, (6,), 0, 30))
    np.testing.assert_array_equal(
        randaugment.cutout(torch.from_numpy(u8), torch.from_numpy(jcy), torch.from_numpy(jcx)).numpy(), want)
    got = randaugment.cutout(torch.from_numpy(u8), torch.from_numpy(cy), torch.from_numpy(cx)).numpy()
    assert ((got == 127).all(axis=-1).sum(axis=(1, 2)) >= 5 * 5).all()  # a quarter of the square at a corner


def test_host_draws_are_seeded_and_ranged():
    a = fixmatch_draws(42, "semi_finetune", 1, 2, 8, 64, strong_aug="randaugment", image_size=(40, 30))
    b = fixmatch_draws(42, "semi_finetune", 1, 2, 8, 64, strong_aug="randaugment", image_size=(40, 30))
    jitter = fixmatch_draws(42, "semi_finetune", 1, 2, 8, 64)
    assert a.brightness is None and a.strong_flip is None and jitter.randaugment is None
    np.testing.assert_array_equal(a.sup_angles, jitter.sup_angles)  # the other views' streams are untouched
    ra, rb = a.randaugment, b.randaugment
    for name in ("flip", "op", "magnitude", "sign", "cutout_y", "cutout_x"):
        np.testing.assert_array_equal(getattr(ra, name), getattr(rb, name))
    assert ra.op.shape == ra.magnitude.shape == ra.sign.shape == (2, 64)
    assert set(np.unique(ra.op)) <= set(range(14)) and len(np.unique(ra.op)) > 8
    assert 0.0 <= ra.magnitude.min() and ra.magnitude.max() < 1.0 and ra.magnitude.dtype == np.float32
    assert set(np.unique(ra.sign)) == {-1.0, 1.0} and ra.flip.any() and not ra.flip.all()
    assert 0 <= ra.cutout_y.min() and ra.cutout_y.max() < 40 and ra.cutout_x.max() < 30
    again = randaugment_draws(np.random.default_rng(0), 5, 8, 8)
    assert again.op.shape == (2, 5)
    stacked = consistency.epoch_view_draws(42, "semi_finetune", 1, 3, 8, 64, torch.device("cpu"),
                                           "randaugment", (40, 30))
    assert stacked.strong_coeffs is None and stacked.randaugment_geo.shape == (3, 2, 6, 64)
    step = stacked[2]
    np.testing.assert_array_equal(step.randaugment.op.numpy(),
                                  fixmatch_draws(42, "semi_finetune", 1, 2, 8, 64, strong_aug="randaugment",
                                                 image_size=(40, 30)).randaugment.op)
    with pytest.raises(ValueError, match="unknown strong_aug 'autoaugment'"):
        consistency.check_strong_aug("autoaugment")


def test_fixmatch_step_with_randaugment_matches_jax():
    """One step of ``make_fixmatch_epoch(strong_aug="randaugment")`` against
    ``fixmatch_step`` on a narrow ViT at 32², every unlabeled row kept:
    total, supervised and consistency loss ≤ 1e-5 relative, every gradient
    ≤ 1e-4 of its tensor's max |g|."""
    b, u, size, weight = 6, 8, 32, 0.7
    variables = _small_tree(2, seed=4)
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    unlabeled = rng.integers(0, 256, (u, size, size, 3), np.uint8)
    labels = rng.integers(0, 2, b)
    valid = np.arange(b) < 5
    key = jax.random.PRNGKey(8)

    state = jeng.TrainState.create(JaxViT(num_classes=2, **SMALL).apply, variables["params"], {},
                                   optax.trace(decay=0.0))
    epoch = jcons.make_fixmatch_epoch(weight, 0.0, strong_aug="randaugment")
    stacked = tuple(jnp.asarray(a)[None] for a in (images, labels, valid, unlabeled)) + (key[None],)
    new_state, losses, sup, cons, keep, preds = epoch(state, *stacked)

    k_sup, k_weak, k_strong = jax.random.split(key, 3)
    k_flip, k_rot = jax.random.split(k_sup)
    sup_flip = np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))
    sup_angles = np.array(jax.random.uniform(k_rot, (b,), minval=-10.0, maxval=10.0) * (jnp.pi / 180.0))
    ra = jax_draws(k_strong, u, size, size)
    draws = consistency.ViewDraws(
        torch.from_numpy(augment_coeffs(sup_flip, sup_angles)),
        torch.from_numpy(np.array(jax.random.bernoulli(k_weak, 0.5, (u,)))), None, None, None,
        _tensors(ra), torch.from_numpy(randaugment.draws_geometry(ra, size, size)),
    )
    model = VisionTransformer(num_classes=2, compute_dtype=torch.float32, image_size=size, **SMALL)
    load_flax_variables(model, {"params": variables["params"], "batch_stats": {}})
    port_state = engine.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0, maximize=True))
    got = consistency.fixmatch_step(
        port_state, None, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(unlabeled), draws, consistency_weight=weight, confidence_threshold=0.0,
    )
    loss_t, sup_t, cons_t, keep_t, pred_t = (x.numpy() for x in got)
    for name, mine, theirs in (("loss", loss_t, losses), ("sup", sup_t, sup), ("cons", cons_t, cons)):
        assert abs(float(mine) - float(theirs[0])) <= 1e-5 * abs(float(theirs[0])), name
    assert float(keep_t) == float(keep[0]) == 1.0
    np.testing.assert_array_equal(pred_t, np.asarray(preds[0]))
    want_grads = state_dict_from_flax({"params": jax.device_get(new_state.opt_state.trace)})
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want_grads[name]) <= 1e-4, name
