"""The port's MoE ViTs against the JAX package: ``MoEMlp`` in every routing
family, the seeded init, the tower with carried weights, one train step and
one FixMatch step with the auxiliary losses, and the three CLIs.

On the CPU the JAX package takes its XLA reference for LayerNorm and
attention, and the port its plain versions. The tower tests run a narrow
tower (hidden 64, 2 layers, 2 heads of 32, MLP 128, 4 experts, 32² inputs,
so 4 patches and a class token; block 1 is the expert block).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.moe import MOE_CONFIGS as JAX_MOE_CONFIGS
from ssip_tpu.models.moe import MoEMlp as JaxMoEMlp
from ssip_tpu.models.moe import MoEVisionTransformer as JaxMoE
from ssip_tpu.ops.augment import eval_preprocess as jax_eval_preprocess
from ssip_tpu.train import consistency as jcons
from ssip_tpu.train import engine as jeng
from ssip_tpu_torch.cli import feature_extraction as extraction_cli
from ssip_tpu_torch.cli import semi_supervised_training as semi_cli
from ssip_tpu_torch.cli import supervised_training as training_cli
from ssip_tpu_torch.models.host_init import arch_leaves, seeded_init_host
from ssip_tpu_torch.models.moe import MOE_CONFIGS, MoEMlp, MoEVisionTransformer, build_moe, top_k_lower_index_first
from ssip_tpu_torch.models.port import flax_from_state_dict, load_flax_variables, state_dict_from_flax
from ssip_tpu_torch.models.registry import PORTED_ARCHS, build_model
from ssip_tpu_torch.train import consistency, engine
from ssip_tpu_torch.ops.augment import augment_coeffs
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

SIZE = 32
SMALL = dict(patch_size=16, hidden_dim=64, num_layers=2, num_heads=2, mlp_dim=128, num_experts=4)
LR, WD = 1e-3, 1e-4
S, D = 13, 16  # tokens and width of the MoEMlp cases


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _mlp_pair(seed: int, zero_router: bool = False, **kw):
    """The JAX MoEMlp's variables (random biases too) and the port's module
    carrying them."""
    rng = np.random.default_rng(seed)
    e, f = kw["num_experts"], 24
    params = {
        "router": {"kernel": rng.normal(0, 0.5, (D, e)), "bias": rng.normal(0, 0.1, (e,))},
        "w_in": rng.normal(0, D**-0.5, (e, D, f)), "b_in": rng.normal(0, 0.1, (e, f)),
        "w_out": rng.normal(0, f**-0.5, (e, f, D)), "b_out": rng.normal(0, 0.1, (e, D)),
    }
    if zero_router:
        params["router"] = {"kernel": np.zeros((D, e)), "bias": np.zeros(e)}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    jax_layer = JaxMoEMlp(mlp_dim=f, **kw)
    port = MoEMlp(D, f, **kw)
    with torch.no_grad():
        port.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T.copy()))
        port.router.bias.copy_(torch.from_numpy(params["router"]["bias"]))
        for name in ("w_in", "b_in", "w_out", "b_out"):
            getattr(port, name).copy_(torch.from_numpy(params[name]))
    return jax_layer, {"params": params}, port


ROUTINGS = [
    dict(num_experts=4, router_top_k=1),
    dict(num_experts=4, router_top_k=2),
    dict(num_experts=4, routing="expert_choice"),
    dict(num_experts=4, router_top_k=2, router_z_loss_coef=1e-3),
    dict(num_experts=4, routing="expert_choice", router_z_loss_coef=1e-3),
    dict(num_experts=3, router_top_k=1, capacity_factor=0.5),  # overflows: tokens dropped
    dict(num_experts=4, router_top_k=2, capacity_factor=0.6),
]


@pytest.mark.parametrize("kw", ROUTINGS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_mlp_matches_jax(kw, zero_router):
    """Outputs within 1e-5, the aux terms within 1e-6 and with the same
    names, the same tokens dropped (exact zero rows); at a zero router every
    expert ties and the lower index must win, as ``jax.lax.top_k`` has it."""
    jax_layer, variables, port = _mlp_pair(3, zero_router, **kw)
    y = np.random.default_rng(4).normal(size=(3, S, D)).astype(np.float32)
    want, state = jax_layer.apply(variables, jnp.asarray(y), mutable=["aux"])
    want = np.asarray(want)
    jaux = {jax.tree_util.keystr(p).split("'")[-2]: float(np.sum(v))
            for p, v in jax.tree_util.tree_flatten_with_path(dict(state).get("aux", {}))[0]}
    port.train()
    got = port(torch.from_numpy(y)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.all(got == 0, axis=-1), np.all(want == 0, axis=-1))
    assert sorted(port.aux) == sorted(jaux)
    for name, value in jaux.items():
        assert abs(float(port.aux[name].detach()) - value) <= 1e-6, name
    if kw.get("capacity_factor", 1.25) < 1 and kw.get("routing") != "expert_choice":
        assert np.all(got == 0, axis=-1).any()  # the case does drop tokens
    port.eval()
    port(torch.from_numpy(y))
    assert port.aux == {}  # an eval forward leaves no terms


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([[0.5, 0.2, 0.5, 0.2, 0.5]])
    values, idx = top_k_lower_index_first(x, 4)
    assert idx.tolist() == [[0, 2, 4, 1]] and torch.equal(values, x[:, [0, 2, 4, 1]])
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_bfloat16_moe_mlp_tracks_jax():
    """In bfloat16 the dispatch and combine tensors are cast before the
    products (the gate rounded), the router stays float32."""
    kw = dict(num_experts=4, router_top_k=2, compute_dtype=jnp.bfloat16)
    jax_layer, variables, port = _mlp_pair(5, **kw | {"compute_dtype": jnp.bfloat16})
    port = MoEMlp(D, 24, num_experts=4, router_top_k=2, compute_dtype=torch.bfloat16)
    load = _mlp_pair(5, num_experts=4, router_top_k=2)[2]
    port.load_state_dict(load.state_dict())
    y = np.random.default_rng(6).normal(size=(2, S, D)).astype(np.float32)
    want = np.asarray(jax_layer.apply(variables, jnp.asarray(y, jnp.bfloat16)).astype(jnp.float32))
    got = port(torch.from_numpy(y).to(torch.bfloat16)).to(torch.float32).detach().numpy()
    assert port.router.weight.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


def test_configs_and_registry_match_the_jax_package():
    assert MOE_CONFIGS == JAX_MOE_CONFIGS
    assert set(MOE_CONFIGS) <= set(PORTED_ARCHS)
    with torch.device("meta"):
        for arch, cfg in MOE_CONFIGS.items():
            model = build_model(arch, num_classes=2)
            assert isinstance(model, MoEVisionTransformer) and model.num_features == cfg["hidden_dim"]
            assert len(model.moe_layers()) == cfg["num_layers"] // 2
            assert build_moe(arch, num_experts=16).moe_layers()[0].num_experts == 16
    with pytest.raises(ValueError, match="not an MoE arch"):
        build_moe("vit_t16")


@pytest.mark.parametrize("arch,num_classes", [("vit_moe_t16", None), ("vit_moe_s16", 2)])
def test_seeded_init_matches_jax_bitwise(arch, num_classes):
    """Every leaf of ``seeded_init_host`` bit for bit, the router a kernel,
    the expert kernels' fan from axis −2, no ``aux`` collection."""
    want = jax_seeded_init_host(MODEL_FACTORIES[arch](num_classes=num_classes), 7, (1, 224, 224, 3))
    got = seeded_init_host(arch, 7, num_classes)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    w, g = flat(want), flat(got)
    assert sorted(w) == sorted(g) and "aux" not in got
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # the port's tree loads into the port's module and back, leaf for leaf
    model = build_model(arch, num_classes=num_classes)
    load_flax_variables(model, got)
    back = flax_from_state_dict(model.state_dict(), arch_leaves(arch, num_classes))
    for key, value in flat(back).items():
        np.testing.assert_array_equal(value, g[key], err_msg=key)


def _small_tree(num_classes, seed: int = 0, **kw):
    model = JaxMoE(num_classes=num_classes, **SMALL, **kw)
    tree = jax_seeded_init_host(model, seed, (1, SIZE, SIZE, 3))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name in ("bias", "cls_token", "b_in", "b_out"):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.1, leaf.shape).astype(np.float32)
        if name == "kernel" and path[-2].key == "router":  # a router that separates the experts
            return rng.normal(0.0, 1.0, leaf.shape).astype(np.float32)
        return leaf

    return model, jax.tree_util.tree_map_with_path(fill, tree)


def _small_port(tree, num_classes, dtype=torch.float32, **kw):
    model = MoEVisionTransformer(num_classes=num_classes, compute_dtype=dtype, image_size=SIZE, **SMALL, **kw)
    load_flax_variables(model, tree)
    return model


@pytest.mark.parametrize("routing", [dict(), dict(router_top_k=2, capacity_factor=0.5), dict(routing="expert_choice")])
def test_tower_forward_matches_flax(routing):
    """A 2-layer tower from carried weights: features and logits within
    1e-4 of Flax, and the train-mode forward's aux terms within 1e-6."""
    jmodel, tree = _small_tree(3, **routing)
    x = np.random.default_rng(1).standard_normal((5, SIZE, SIZE, 3)).astype(np.float32)
    (logits_j, feats_j), state = jmodel.apply(tree, jnp.asarray(x), train=True, return_features=True,
                                             mutable=["aux"])
    model = _small_port(tree, 3, **routing).train()
    logits_t, feats_t = model(torch.from_numpy(x), return_features=True)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(feats_t.detach().numpy(), np.asarray(feats_j), rtol=0, atol=1e-4)
    jaux = sum(float(np.sum(v)) for v in jax.tree.leaves(dict(state).get("aux", {})))
    assert abs(sum(float(t.detach()) for t in model.aux_losses()) - jaux) <= 1e-6
    model.eval()
    model(torch.from_numpy(x))
    assert model.aux_losses() == []


def test_vit_moe_t16_forward_matches_flax_with_three_heads():
    """``vit_moe_t16`` cut to 2 layers (width 192, 3 heads of 64, 8
    experts) at 32², from the seeded init: features within 1e-4."""
    cfg = dict(JAX_MOE_CONFIGS["vit_moe_t16"], num_layers=2)
    jmodel = JaxMoE(**cfg)
    tree = jax_seeded_init_host(jmodel, 3, (1, SIZE, SIZE, 3))
    x = np.random.default_rng(2).standard_normal((4, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(tree, jnp.asarray(x)))
    model = MoEVisionTransformer(image_size=SIZE, **cfg)
    load_flax_variables(model, tree)
    got = model.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _step_batch(seed: int):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (8, SIZE, SIZE, 3), np.uint8)
    labels = rng.integers(0, 2, 8)
    valid = np.arange(8) < 6
    return images, labels, valid


def test_train_step_adds_aux_and_matches_the_jax_engine():
    """Loss (with the aux term) ≤ 1e-5 relative, the aux term alone within
    1e-6, every gradient (the router's included) ≤ 1e-4 relative to its
    tensor's max |g|: the dense ViT step test's bounds."""
    images, labels, valid = _step_batch(1)
    jmodel, tree = _small_tree(2, seed=1)
    state = jeng.TrainState.create(jmodel.apply, tree["params"], {}, jeng.make_optimizer(LR, WD))
    _, loss_j, pred_j = jeng.make_train_step(augment=False)(
        state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid), jax.random.PRNGKey(0))
    x = jax_eval_preprocess(jnp.asarray(images))

    def loss_fn(params):
        logits, st = jmodel.apply({"params": params}, x, train=True, mutable=["aux"])
        w = jnp.asarray(valid, jnp.float32)
        ce = jnp.sum(optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)) * w) / jnp.sum(w)
        aux = sum(jnp.sum(t) for t in jax.tree.leaves(dict(st)["aux"]))
        return ce + aux, aux

    (_, aux_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(tree["params"])
    model = _small_port(tree, 2)
    pstate = engine.TrainState.create(model, LR, WD)
    loss_t, pred_t = engine.train_step(pstate, torch.from_numpy(images), torch.from_numpy(labels),
                                       torch.from_numpy(valid), None)
    aux_t = sum(float(t.detach()) for t in model.aux_losses())
    assert float(aux_j) > 0 and abs(aux_t - float(aux_j)) <= 1e-6
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    want = state_dict_from_flax({"params": jax.device_get(grads_j)})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(want) == sorted(got)
    assert any(".moe.router.weight" in k for k in got)
    for name, g in want.items():
        assert _rel(got[name], g) <= 1e-4, name


def test_fixmatch_step_counts_aux_once():
    """The FixMatch step's loss is the JAX step's: the labeled view's aux
    terms once, the strong view's and the teacher's dropped."""
    images, labels, valid = _step_batch(2)
    unl = np.random.default_rng(3).integers(0, 256, (8, SIZE, SIZE, 3), np.uint8)
    jmodel, tree = _small_tree(2, seed=2)
    key = jax.random.PRNGKey(5)
    state = jeng.TrainState.create(jmodel.apply, tree["params"], {}, jeng.make_optimizer(LR, WD))
    epoch = jcons.make_fixmatch_epoch(1.0, 0.0)
    _, losses, sup, cons, _keep, _pred = epoch(
        state, jnp.asarray(images)[None], jnp.asarray(labels)[None], jnp.asarray(valid)[None],
        jnp.asarray(unl)[None], key[None])
    model = _small_port(tree, 2)
    pstate = engine.TrainState.create(model, LR, WD)
    draws = jcons_draws(key, 8, 8)
    loss_t, sup_t, cons_t, _k, _p = consistency.fixmatch_step(
        pstate, None, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(unl), draws, consistency_weight=1.0, confidence_threshold=0.0)
    aux_sup = float(losses[0]) - float(sup[0]) - float(cons[0])
    assert aux_sup > 0
    assert abs(float(sup_t) - float(sup[0])) <= 1e-5 * abs(float(sup[0]))
    assert abs(float(loss_t) - float(losses[0])) <= 1e-5 * abs(float(losses[0]))
    # counted once: the loss less the two cross-entropies is one set of terms
    assert abs((float(loss_t) - float(sup_t) - float(cons_t)) - aux_sup) <= 1e-5


def jcons_draws(key, b: int, u: int) -> consistency.ViewDraws:
    """The draws the JAX FixMatch step makes from ``key``, by its key splits,
    as the port's ``ViewDraws`` (as ``tests/test_torch_consistency.py``
    makes them)."""
    k_sup, k_weak, k_strong = jax.random.split(key, 3)

    def flips_and_angles(k_flip, k_rot, n):
        flip = np.array(jax.random.bernoulli(k_flip, 0.5, (n,)))
        angles = np.array(jax.random.uniform(k_rot, (n,), minval=-10.0, maxval=10.0) * (jnp.pi / 180.0))
        return flip, angles

    sup = augment_coeffs(*flips_and_angles(*jax.random.split(k_sup), b))
    weak_flip = np.array(jax.random.bernoulli(k_weak, 0.5, (u,)))
    k_flip, k_rot, k_bright, k_contrast = jax.random.split(k_strong, 4)
    strong = augment_coeffs(*flips_and_angles(k_flip, k_rot, u))
    brightness = np.array(jax.random.uniform(k_bright, (u, 1, 1, 1), minval=-32.0, maxval=32.0)).reshape(u)
    contrast = np.array(jax.random.uniform(k_contrast, (u, 1, 1, 1), minval=0.7, maxval=1.3)).reshape(u)
    return consistency.ViewDraws(*(torch.from_numpy(a) for a in (sup, weak_flip, strong, brightness, contrast)))


def _tree(root, n_per_class: int = 6, pool: int = 6, size: int = 48):
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls in ("cancer", "normal"):
        d = root / "avec_labels" / cls
        d.mkdir(parents=True)
        for i in range(n_per_class):
            Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)).save(d / f"{cls}_{i}.jpg")
    u = root / "sans_label"
    u.mkdir()
    for i in range(pool):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)).save(u / f"u_{i}.jpg")
    return root


def test_three_clis_run_vit_moe_t16_on_the_cpu(tmp_path, capsys):
    """Extraction, supervised and semi-supervised CLIs with ``--arch
    vit_moe_t16`` on the CPU: the artifacts name the arch, the histories are
    finite, and the MoE ``.pt`` loads back into the port's model."""
    data = _tree(tmp_path / "data")
    out = tmp_path / "x"
    extraction_cli.main(["--data-dir", str(data), "--device", "cpu", "--arch", "vit_moe_t16", "--batch-size", "8",
                         "--output-dir", str(out), "--no-cache"])
    meta = json.loads((out / "features" / "metadata.json").read_text())
    assert meta["architecture"] == "vit_moe_t16" and meta["embedding_dimension"] == 192
    assert np.isfinite(np.load(out / "features" / "embeddings.npy")).all()
    train = tmp_path / "t"
    common = ["--strong-data-dir", str(data / "avec_labels"), "--device", "cpu", "--arch", "vit_moe_t16",
              "--image-size", "32", "--batch-size", "4", "--output-dir", str(train)]
    training_cli.main([*common, "--baseline-epochs", "1"])
    payload = json.loads((train / "notes" / "training_history.json").read_text())
    assert payload["arch"] == "vit_moe_t16" and np.isfinite(payload["baseline"]["train_loss"]).all()
    model = build_model("vit_moe_t16", num_classes=2, image_size=32)
    from ssip_tpu_torch.cli import threshold_sweep
    from ssip_tpu_torch.serving import ScreeningPredictor
    from ssip_tpu_torch.train.checkpoints import load_checkpoint

    load_checkpoint(train / "models" / "baseline_resnet18.pt", model)
    threshold_sweep.main(["--strong-data-dir", str(data / "avec_labels"), "--output-dir", str(train), "--model",
                          "baseline", "--device", "cpu"])
    assert (train / "tables" / "threshold_sweep_baseline.csv").exists()
    semi_cli.main([*common, "--weak-data-dir", str(data / "sans_label"), "--baseline-epochs", "1",
                   "--weak-pretrain-epochs", "1", "--finetune-epochs", "1", "--pseudo-threshold", "0.0",
                   "--consistency-weight", "1.0", "--consistency-threshold", "0.0"])
    payload = json.loads((train / "notes" / "training_history.json").read_text())
    assert np.isfinite(payload["semi_finetune"]["train_loss"]).all()
    assert "semi_thresholded" in capsys.readouterr().out
    predictor = ScreeningPredictor.from_artifacts(train, device="cpu")
    probs = predictor.predict_probs(np.zeros((3, 32, 32, 3), np.uint8))
    assert probs.shape == (3, 2) and np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)
