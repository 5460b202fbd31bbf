"""The port's ResNet, seeded init and weight carry-over against the JAX package.

The same numpy-made inputs and the same Flax variable tree go through
``ssip_tpu.models.resnet`` (Flax, CPU) and ``ssip_tpu_torch.models.resnet``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.models import port_torch
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.resnet import MODEL_FACTORIES
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables, state_dict_from_flax
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.models.resnet import build_resnet

torch.set_num_threads(2)

ARCHS = ["resnet18", "resnet34", "resnet50"]


def _leaves(tree):
    return {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _perturbed_init(arch, seed):
    """Seeded init with non-trivial BN parameters and statistics, so the
    forward tests exercise every BN term."""
    tree = seeded_init_host(arch, seed)
    rng = np.random.default_rng(seed)

    def visit(node):
        for name, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif name in ("scale", "var"):
                node[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
            elif name in ("bias", "mean"):
                node[name] = rng.normal(0.0, 0.1, value.shape).astype(np.float32)

    visit(tree)
    return tree


@pytest.mark.parametrize("arch,seed", [("resnet18", 42), ("resnet34", 42), ("resnet50", 42), ("resnet18", 3)])
def test_seeded_init_matches_jax_bitwise(arch, seed):
    """Leaf for leaf, same names, shapes and bits as ``seeded_init_host``."""
    ref = _leaves(jax_seeded_init_host(MODEL_FACTORIES[arch](num_classes=None), seed, (1, 224, 224, 3)))
    got = _leaves(seeded_init_host(arch, seed))
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _with_head(tree, num_classes, seed=0):
    """Add a Flax ``fc`` Dense head ([in, out] kernel) to an extractor tree."""
    rng = np.random.default_rng(seed)
    features = 2048 if "conv3" in tree["params"]["layer1_0"] else 512
    tree["params"]["fc"] = {
        "kernel": rng.normal(0, 0.05, (features, num_classes)).astype(np.float32),
        "bias": rng.normal(0, 0.05, (num_classes,)).astype(np.float32),
    }
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_round_trips_with_port_torch(arch):
    """``state_dict_from_flax`` equals ``port_torch.export_state_dict``, and
    ``port_torch.port_state_dict`` brings it back to the Flax tree."""
    tree = _with_head(seeded_init_host(arch, 5), 3)
    sd = state_dict_from_flax(tree)
    ref = port_torch.export_state_dict(tree)
    assert sorted(sd) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(sd[key], ref[key], err_msg=key)
    back = _leaves(port_torch.port_state_dict(sd))
    for key, value in _leaves(tree).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # the names are exactly the torch module's, minus num_batches_tracked
    module_keys = {
        k for k in build_resnet(arch, num_classes=3).state_dict() if not k.endswith("num_batches_tracked")
    }
    assert set(sd) == module_keys


def _forward_pair(arch, jdtype, tdtype, seed=0):
    tree = _perturbed_init(arch, seed)
    x = np.random.default_rng(seed + 100).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(
        MODEL_FACTORIES[arch](num_classes=None, compute_dtype=jdtype).apply(tree, jnp.asarray(x), train=False)
    )
    model = build_resnet(arch, compute_dtype=tdtype)
    load_flax_variables(model, tree)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_eval_forward_f32_matches_flax(arch):
    """Full widths, 2×64×64, float32: ≤ 1e-4 abs/rel."""
    got, ref = _forward_pair(arch, jnp.float32, torch.float32)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_eval_forward_bf16_close_to_flax_bf16(arch):
    """bfloat16 rounds at the same points in both; convolutions accumulate
    in other orders, so the bound is per-image cosine > 0.995."""
    got, ref = _forward_pair(arch, jnp.bfloat16, torch.bfloat16, seed=1)
    assert got.dtype == np.float32

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    cos = (unit(got) * unit(ref)).sum(axis=1)
    assert cos.min() > 0.995, cos


def test_torchvision_named_state_dict_loads_directly(tmp_path):
    """A torchvision-layout ``.pth`` (with ``fc`` and ``num_batches_tracked``)
    loads with plain ``load_state_dict``, and gives the Flax tree's output."""
    tree = _with_head(_perturbed_init("resnet18", 2), 1000)
    sd = {k: torch.from_numpy(v) for k, v in state_dict_from_flax(tree).items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "resnet18.pth"
    torch.save(sd, path)

    model = build_resnet("resnet18", num_classes=1000)
    model.load_state_dict(torch.load(path, weights_only=True))  # strict
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(MODEL_FACTORIES["resnet18"](num_classes=1000).apply(tree, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_wrong_arch_tree_is_refused():
    model = build_resnet("resnet18")
    with pytest.raises(ValueError, match="does not match"):
        load_flax_variables(model, seeded_init_host("resnet34", 0))


@pytest.mark.parametrize("arch", ["vit_b16", "vit_moe_t16"])
def test_vit_archs_refused_with_roadmap_pointer(arch):
    """``build_resnet`` builds ResNets only; the arch registry builds the
    dense ViTs and the MoE archs."""
    with pytest.raises(ValueError, match="not a ResNet arch"):
        build_resnet(arch)
    with torch.device("meta"):
        assert build_model(arch).num_features == {"vit_b16": 768, "vit_moe_t16": 192}[arch]
