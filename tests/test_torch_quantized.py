"""The port's BN fold and int8 ResNet against the JAX package's, on the CPU,
with ``resnet18`` (basic blocks) and ``resnet50`` (bottleneck blocks) at
32² and 64².

The same seeded weights (BatchNorm statistics and affines drawn from a numpy
seed, so the fold is not the identity) go through
``ssip_tpu.models.inference`` / ``ssip_tpu.models.quantized`` and the port's
``models/inference.py`` / ``models/quantized.py``; the JAX int8 tree is
carried into the port's module (``models/port.py``) so both forwards compute
from the same integers.

Tolerances:

- the fold: float64 numpy on the same float32 weights in both packages, held
  within 1e-6 (observed: equal bits); the folded forward within 1e-4 of the
  plain eval forward (float32, relative to the largest feature);
- quantizer: every int8 kernel equal; ``mult`` and ``inv_in_scale`` within
  1e-5 relative (they hold each site's largest calibration activation, which
  the two float32 forwards sum in another order; observed 1.03e-6 for
  ``resnet18`` and 1.57e-6 for ``resnet50``, eight to thirteen float32 ulps
  gathered over the blocks, so 1e-6 does not hold);
- ``_qconv_raw``: equal integers, at every kernel size, stride and padding
  the ResNets use;
- the forward from one tree: integer sums are exact, so the packages differ
  only where a float32 affine or a bf16 rounding of the block outputs lands
  on the other side of an int8 step; held within 1e-3 relative L2;
- extraction end to end: int8 against float32 cosine above 0.99 per image
  (``tests/test_quantized.py:127-128``'s floor), and the two packages' int8
  embeddings cosine above 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.models import inference as jinference
from ssip_tpu.models import quantized as jquantized
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.resnet import MODEL_STAGES
from ssip_tpu.pipelines.extraction import ExtractionConfig as JaxExtractionConfig
from ssip_tpu.pipelines.extraction import run_extraction as jax_run_extraction
from ssip_tpu_torch.models import inference, quantized
from ssip_tpu_torch.models.port import (
    load_flax_variables, quantized_resnet_from_tree, tree_from_quantized_resnet,
)
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.ops.quant import quantize
from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction

torch.set_num_threads(2)

ARCHS = ("resnet18", "resnet50")


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(np.asarray(want)))


def _perturbed_bn(variables, seed: int):
    """The seeded init with every BatchNorm's statistics and affine drawn
    from a numpy seed (at init they are 0, 1, 1, 0 and the fold is trivial)."""
    rng = np.random.default_rng(seed)

    def walk(node, stats: bool):
        out = {}
        for name, value in node.items():
            if isinstance(value, dict):
                out[name] = walk(value, stats)
                continue
            v = np.asarray(value, np.float32)
            if stats and name == "mean":
                v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif stats and name == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif not stats and name == "scale":
                v = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif not stats and name == "bias" and v.ndim == 1 and "fc" not in name:
                v = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            out[name] = v
        return out

    return {"params": walk(variables["params"], False), "batch_stats": walk(variables["batch_stats"], True)}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """(arch, stages, bottleneck, JAX variables, port f32 module, x)."""
    arch = request.param
    size = 64 if arch == "resnet18" else 32
    variables = _perturbed_bn(jax_seeded_init_host(MODEL_FACTORIES[arch](num_classes=None), 42, (1, size, size, 3)), 5)
    model = build_model(arch, compute_dtype=torch.float32)
    load_flax_variables(model, variables)
    x = (np.random.default_rng(0).standard_normal((4, size, size, 3)) * 1.5).astype(np.float32)
    return arch, MODEL_STAGES[arch], arch == "resnet50", variables, model.eval(), x


def test_fold_matches_jax(setup):
    arch, stages, bottleneck, variables, model, _ = setup
    want = jinference.fold_resnet_extractor(variables, stages, bottleneck, stem_s2d=False)
    got = inference.fold_resnet_extractor(model, stages, bottleneck)
    assert len(got["blocks"]) == len(want["blocks"]) == sum(stages)
    pairs = [(got["stem"], want["stem"])] + [
        (g[name], w[name]) for g, w in zip(got["blocks"], want["blocks"]) for name in w
    ]
    assert [sorted(g) for g in got["blocks"]] == [sorted(w) for w in want["blocks"]]
    for g, w in pairs:
        for leaf in ("kernel", "bias"):
            assert g[leaf].shape == np.shape(w[leaf]) and g[leaf].dtype == np.float32
            np.testing.assert_allclose(g[leaf], np.asarray(w[leaf]), rtol=0, atol=1e-6)
    # a state_dict folds like the module
    from_state = inference.fold_resnet_extractor(model.state_dict(), stages, bottleneck)
    np.testing.assert_array_equal(from_state["blocks"][-1]["conv2"]["kernel"], got["blocks"][-1]["conv2"]["kernel"])


def test_folded_forward_matches_plain_eval(setup):
    arch, stages, bottleneck, variables, model, x = setup
    folded = inference.fold_resnet_extractor(model, stages, bottleneck)
    apply = inference.make_folded_apply(stages, bottleneck, compute_dtype=torch.float32)
    with torch.inference_mode():
        got = apply(folded, torch.from_numpy(x)).numpy()
        plain = model(torch.from_numpy(x)).numpy()
    jax_folded = jinference.make_folded_apply(stages, bottleneck, stem_s2d=False, compute_dtype=jnp.float32)(
        jinference.fold_resnet_extractor(variables, stages, bottleneck, stem_s2d=False), jnp.asarray(x))
    assert got.shape == plain.shape == (4, 2048 if bottleneck else 512)
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() / scale <= 1e-4
    assert np.abs(got - np.asarray(jax_folded)).max() / scale <= 1e-4


def test_folded_bf16_forward_matches_jax():
    """bf16 compute: the same roundings (input, kernel and bias cast, the
    pooled mean rounded) as the JAX folded forward."""
    variables = _perturbed_bn(jax_seeded_init_host(MODEL_FACTORIES["resnet18"](num_classes=None), 3, (1, 32, 32, 3)), 1)
    model = build_model("resnet18")
    load_flax_variables(model, variables)
    x = (np.random.default_rng(2).standard_normal((2, 32, 32, 3))).astype(np.float32)
    got = inference.make_folded_apply()(inference.fold_resnet_extractor(model), torch.from_numpy(x)).numpy()
    want = np.asarray(jinference.make_folded_apply(stem_s2d=False)(
        jinference.fold_resnet_extractor(variables, stem_s2d=False), jnp.asarray(x)))
    assert _rel_l2(got, want) < 2e-2  # bf16 through 8 blocks, two summation orders


def test_space_to_depth_stem_is_refused():
    with pytest.raises(ValueError, match="Do not port"):
        inference.fold_resnet_extractor(build_model("resnet18"), stem_s2d=True)
    with pytest.raises(ValueError, match="space-to-depth"):
        inference.make_folded_apply(stem_s2d=True)


def test_quantize_extractor_matches_jax(setup):
    arch, stages, bottleneck, variables, model, x = setup
    want = jquantized.quantize_extractor(variables, jnp.asarray(x), stages, bottleneck)
    got = quantized.quantize_extractor(model, torch.from_numpy(x), stages, bottleneck)
    pairs = [("stem", got["stem"], want["stem"])] + [
        (f"block{i}.{name}", g[name], w[name])
        for i, (g, w) in enumerate(zip(got["blocks"], want["blocks"])) for name in w
    ]
    assert [sorted(g) for g in got["blocks"]] == [sorted(w) for w in want["blocks"]]
    for name, g, w in pairs:
        assert g["kernel"].dtype == np.int8, name
        np.testing.assert_array_equal(g["kernel"], np.asarray(w["kernel"]), err_msg=name)
        np.testing.assert_array_equal(g["bias"], np.asarray(w["bias"]), err_msg=name)
        for leaf in ("mult", "inv_in_scale"):
            rel = np.abs(np.asarray(g[leaf], np.float64) / np.asarray(w[leaf], np.float64) - 1.0).max()
            assert rel <= 1e-5, (name, leaf, rel)
    assert quantized.calibrate_act_scales(
        quantized.fold_f32_extractor(model, stages, bottleneck), torch.from_numpy(x), stages, bottleneck
    )["blocks"][0]["conv1"] > 0


# (kernel, stride, padding): the stem, the 3×3 convs at stride 1 and 2, the
# 1×1 convs and the 1×1 projections at stride 2
CONV_SHAPES = ((7, 2, 3), (3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0))


@pytest.mark.parametrize("k,stride,pad", CONV_SHAPES)
@pytest.mark.parametrize("size", (9, 16))
def test_qconv_raw_equals_jax(k, stride, pad, size):
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    cin, cout = (3, 64) if k == 7 else (24, 16)
    x = rng.integers(-127, 128, (2, size, size, cin), dtype=np.int8)
    kernel = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    site = quantized.QuantConv(kernel, np.ones(cout), np.zeros(cout), 1.0)
    got = quantized._qconv_raw(torch.from_numpy(x), site, stride, pad).numpy()
    padding = "VALID" if pad == 0 else ((pad, pad), (pad, pad))
    want = np.asarray(jquantized._qconv_raw(jnp.asarray(x), {"kernel": jnp.asarray(kernel)}, stride, padding))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if k == 7:
        assert site.gemm.shape == (152, cout)  # 147 zero-padded to a multiple of 8


@pytest.mark.parametrize("inter", ("float32", "bfloat16"))
def test_quantized_forward_from_the_jax_tree(setup, inter):
    arch, stages, bottleneck, variables, model, x = setup
    tree = jquantized.quantize_extractor(variables, jnp.asarray(x), stages, bottleneck)
    jdt, tdt = (jnp.float32, torch.float32) if inter == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jquantized.make_quantized_apply(stages, bottleneck, inter_dtype=jdt)(tree, jnp.asarray(x)))
    host = jax.tree.map(np.asarray, tree)
    module = quantized_resnet_from_tree(host, arch, inter_dtype=tdt)
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
        functional = quantized.make_quantized_apply(stages, bottleneck, inter_dtype=tdt)(host, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel_l2(got, want) <= 1e-3
    np.testing.assert_array_equal(functional.numpy(), got)
    # against the float32 model: quantization noise only
    with torch.inference_mode():
        ref = model(torch.from_numpy(x)).numpy()
    assert _cosine(got, ref).min() > 0.99


def test_inter_dtype_bf16_rounds_the_block_outputs(setup):
    """bf16 between blocks (the default) moves the features off the float32
    variant, by the order of a bf16 step and not more."""
    arch, stages, bottleneck, _, model, x = setup
    tree = quantized.quantize_extractor(model, torch.from_numpy(x), stages, bottleneck)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        f32 = quantized_resnet_from_tree(tree, arch, inter_dtype=torch.float32)(xt).numpy()
        bf16 = quantized_resnet_from_tree(tree, arch)(xt).numpy()
    assert quantized_resnet_from_tree(tree, arch).inter_dtype == torch.bfloat16
    assert not np.array_equal(f32, bf16)
    assert _rel_l2(bf16, f32) < 5e-2


def test_stem_prequantized_and_tree_round_trip(setup):
    arch, stages, bottleneck, _, model, x = setup
    tree = quantized.quantize_extractor(model, torch.from_numpy(x), stages, bottleneck)
    plain = quantized_resnet_from_tree(tree, arch)
    pre = quantized_resnet_from_tree(tree, arch, stem_prequantized=True)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        np.testing.assert_array_equal(pre(quantize(xt, pre.stem.inv_scale)).numpy(), plain(xt).numpy())
    with pytest.raises(ValueError, match="int8 operand"):
        pre(xt)
    back = tree_from_quantized_resnet(plain)
    for g, w in zip([back["stem"], *[s for b in back["blocks"] for s in b.values()]],
                    [tree["stem"], *[s for b in tree["blocks"] for s in b.values()]]):
        for leaf in ("kernel", "mult", "bias", "inv_in_scale"):
            np.testing.assert_array_equal(g[leaf], w[leaf])
    assert plain.num_features == (2048 if bottleneck else 512)


def test_quantized_tree_checks_refuse_another_arch(setup):
    arch, stages, bottleneck, _, model, x = setup
    tree = quantized.quantize_extractor(model, torch.from_numpy(x), stages, bottleneck)
    other = "resnet34" if arch == "resnet18" else "resnet18"
    with pytest.raises(ValueError, match="blocks|wants"):
        quantized_resnet_from_tree(tree, other)
    with pytest.raises(ValueError, match="int8 ResNet trees"):
        quantized_resnet_from_tree(tree, "vit_t16")


def test_int8_extraction_end_to_end(tiny_image_tree, tmp_path):
    """``run_extraction`` with ``compute_dtype="int8"`` and a ResNet on the
    CPU, beside the float32 run of the same seeded weights and the JAX
    package's int8 run on the same JPEGs."""
    common = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False, resize=36, crop=32)
    f32 = run_extraction(ExtractionConfig(output_dir=tmp_path / "f32", **common))
    int8 = run_extraction(ExtractionConfig(output_dir=tmp_path / "int8", compute_dtype="int8", **common))
    jax_int8 = jax_run_extraction(JaxExtractionConfig(output_dir=tmp_path / "jax", compute_dtype="int8", **common))
    assert int8.embeddings.shape == f32.embeddings.shape == (22, 512) and np.isfinite(int8.embeddings).all()
    assert int8.weights_source == "random_init:seed=42+int8_ptq"
    assert _cosine(int8.embeddings, f32.embeddings).min() > 0.99
    assert _cosine(int8.embeddings, np.asarray(jax_int8.embeddings)).min() > 0.999
