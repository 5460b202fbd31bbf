"""The port's int8 ViT against the JAX package's, on the CPU, with ``vit_t16``
(12 layers, hidden 192, 3 heads of 64) at 32².

The same seeded weights and the same numpy-seeded calibration batch go
through ``ssip_tpu.models.quantized_vit`` and the port's
``models/quantized_vit.py``; the JAX int8 tree is carried into the port's
module (``models/port.py``) so that both forwards compute from the same
leaves; and both extraction pipelines run ``--compute-dtype int8`` on the
same JPEG tree.

Tolerances:

- quantizer: every int8 kernel equal (float64 numpy arithmetic on the same
  weights in both packages); ``mult`` and ``inv_in_scale`` within 1e-5
  relative (they hold a site's largest calibration activation, which the two
  float32 forwards sum in another order);
- forward from the same tree: integer sums are exact, so the two packages
  differ only where LayerNorm, attention or GELU round differently (1e-6
  relative) and that moves an activation across an int8 step. Observed: the
  features (O(1) after the final LayerNorm) agree to 5e-7 for ``inter_dtype``
  float32 and bfloat16; held to 1e-3, which leaves room for a few such steps
  (int8 against the float32 model is only held above cosine 0.99, as
  ``tests/test_quantized_vit.py`` holds it). The JAX forward pads the 5 tokens
  to 16 and masks the pad keys; the port does not pad, so this also shows the
  real rows agree;
- ``stem_prequantized``: equal bits;
- pipelines: int8 embeddings of the two packages cosine above 0.999, and
  above the JAX package's own floor of 0.98 against the float32 run.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.quantized_vit import make_quantized_vit_apply
from ssip_tpu.models.quantized_vit import quantize_vit_extractor as jax_quantize_vit_extractor
from ssip_tpu.pipelines.extraction import ExtractionConfig as JaxExtractionConfig
from ssip_tpu.pipelines.extraction import run_extraction as jax_run_extraction
from ssip_tpu_torch.cli import feature_extraction as extraction_cli
from ssip_tpu_torch.models.port import (
    load_flax_variables, quantized_vit_from_tree, tree_from_quantized_vit,
)
from ssip_tpu_torch.models.quantized_vit import SITES, patches, quantize_vit_extractor
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.ops.quant import quantize
from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

ARCH, IMG = "vit_t16", 32


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """(Flax variables, calibration batch, JAX int8 tree, the port's float
    model with the same weights, the port's int8 tree, float32 features)."""
    model = MODEL_FACTORIES[ARCH](num_classes=None)
    variables = jax_seeded_init_host(model, 42, (1, IMG, IMG, 3))
    x = np.random.default_rng(0).normal(0.0, 1.0, (4, IMG, IMG, 3)).astype(np.float32)
    jtree = _np_tree(jax_quantize_vit_extractor(variables, jnp.asarray(x), arch=ARCH))
    port_model = build_model(ARCH, image_size=IMG)
    load_flax_variables(port_model, jax.tree_util.tree_map(np.asarray, variables))
    ptree = quantize_vit_extractor(port_model, torch.from_numpy(x), arch=ARCH)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    return variables, x, jtree, port_model, ptree, ref


def _sites(tree):
    yield "stem", tree["stem"]
    for i, blk in enumerate(tree["blocks"]):
        for name in SITES:
            yield f"block{i}.{name}", blk[name]


def test_quantizer_matches_quantize_vit_extractor(setup):
    _, _, jtree, _, ptree, _ = setup
    assert len(ptree["blocks"]) == len(jtree["blocks"]) == 12
    for (name, want), (_, got) in zip(_sites(jtree), _sites(ptree)):
        assert got["kernel"].dtype == np.int8 and got["kernel"].shape == want["kernel"].shape, name
        np.testing.assert_array_equal(got["kernel"], want["kernel"], err_msg=name)
        np.testing.assert_array_equal(got["bias"], want["bias"], err_msg=name)
        np.testing.assert_allclose(got["mult"], want["mult"], rtol=1e-5, atol=0, err_msg=name)
        np.testing.assert_allclose(got["inv_in_scale"], want["inv_in_scale"], rtol=1e-5, atol=0, err_msg=name)
        assert got["mult"].dtype == np.float32 and np.asarray(got["inv_in_scale"]).dtype == np.float32
    for leaf in ("cls_token", "pos_embedding"):
        np.testing.assert_array_equal(ptree[leaf], jtree[leaf])
    for name in ("ln_1", "ln_2"):
        np.testing.assert_array_equal(ptree["blocks"][7][name]["scale"], jtree["blocks"][7][name]["scale"])
    # the stem's scale is the batch's largest magnitude, which needs no forward: exact
    assert ptree["stem"]["inv_in_scale"] == jtree["stem"]["inv_in_scale"]


@pytest.mark.parametrize("inter", ["float32", "bfloat16"])
def test_forward_with_the_carried_jax_tree_matches_make_quantized_vit_apply(setup, inter):
    _, x, jtree, _, _, ref = setup
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if inter == "bfloat16" else (jnp.float32, torch.float32)
    want = np.asarray(make_quantized_vit_apply(arch=ARCH, inter_dtype=jdt)(
        jax.tree_util.tree_map(jnp.asarray, jtree), jnp.asarray(x)))
    module = quantized_vit_from_tree(jtree, ARCH, inter_dtype=tdt).eval()
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 192) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert _cosine(got, ref).min() > 0.99  # the noise envelope against the float32 model


def test_stem_prequantized_equals_quantizing_outside(setup):
    _, x, jtree, _, _, _ = setup
    post = quantized_vit_from_tree(jtree, ARCH).eval()
    pre = quantized_vit_from_tree(jtree, ARCH, stem_prequantized=True).eval()
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        a = post(xt)
        b = pre(quantize(xt, post.stem.inv_scale))
        assert torch.equal(a, b)
        assert torch.equal(a, post(xt))  # deterministic
        with pytest.raises(ValueError, match="int8 operand"):
            pre(xt)
        with pytest.raises(ValueError, match="position embedding"):
            post(torch.zeros((1, 48, 48, 3)))


def test_patches_are_the_patch_conv_as_a_product():
    """The (row, column, channel) patch rows against the HWIO kernel reshaped
    to [p·p·3, D] equal the stride-p convolution."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 8, 12, 3)).astype(np.float32))
    kernel = torch.from_numpy(rng.integers(-127, 128, (4, 4, 3, 5)).astype(np.float32))  # HWIO
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=4).permute(0, 2, 3, 1)
    got = (patches(x, 4) @ kernel.reshape(-1, 5)).reshape(2, 2, 3, 5)
    assert torch.equal(got, want)  # integers below 2^24: exact in float32


def test_tree_carries_over_both_ways_and_sizes_are_checked(setup):
    _, _, jtree, _, ptree, _ = setup
    module = quantized_vit_from_tree(ptree, ARCH)
    back = tree_from_quantized_vit(module)
    for (name, want), (_, got) in zip(_sites(ptree), _sites(back)):
        for leaf in ("kernel", "mult", "bias", "inv_in_scale"):
            np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=f"{name}.{leaf}")
    np.testing.assert_array_equal(back["pos_embedding"], ptree["pos_embedding"])
    np.testing.assert_array_equal(back["ln"]["scale"], ptree["ln"]["scale"])
    # every int8 kernel and the MLP's transposed copies are buffers of the module
    state = module.state_dict()
    assert state["blocks.3.mlp_1.kernel"].dtype == torch.int8 and "blocks.3.mlp_2.kernel_t" in state
    assert "blocks.3.qkv.kernel_t" not in state
    # the way back feeds the JAX forward
    again = make_quantized_vit_apply(arch=ARCH)(jax.tree_util.tree_map(jnp.asarray, back), jnp.zeros((1, IMG, IMG, 3)))
    assert np.isfinite(np.asarray(again)).all()
    with pytest.raises(ValueError, match="vit_s16 wants int8"):
        quantized_vit_from_tree(jtree, "vit_s16")
    short = dict(jtree, blocks=jtree["blocks"][:5])
    with pytest.raises(ValueError, match="5 blocks"):
        quantized_vit_from_tree(short, ARCH)
    floats = dict(jtree, stem=dict(jtree["stem"], kernel=jtree["stem"]["kernel"].astype(np.float32)))
    with pytest.raises(ValueError, match="stem.kernel is float32"):
        quantized_vit_from_tree(floats, ARCH)


def test_int8_extraction_matches_the_jax_pipeline(tiny_image_tree, tmp_path, monkeypatch):
    """Both packages calibrate on the tree's first 22 images (fewer than 32)
    and embed it in int8; the port also against its own float32 run."""
    monkeypatch.delenv("SSIP_RESNET18_WEIGHTS", raising=False)
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False, arch=ARCH, resize=36, crop=IMG)
    want = jax_run_extraction(JaxExtractionConfig(output_dir=tmp_path / "jax", compute_dtype="int8", **cfg))
    got = run_extraction(ExtractionConfig(output_dir=tmp_path / "port", compute_dtype="int8", **cfg))
    f32 = run_extraction(ExtractionConfig(output_dir=tmp_path / "port_f32", compute_dtype="float32", **cfg))
    assert got.weights_source == want.weights_source == "random_init:seed=42+int8_ptq"
    assert got.embeddings.shape == want.embeddings.shape == (22, 192) and got.embeddings.dtype == np.float32
    assert np.isfinite(got.embeddings).all()
    assert _cosine(got.embeddings, want.embeddings).min() > 0.999
    assert _cosine(got.embeddings, f32.embeddings).min() > 0.98
    meta = json.loads((tmp_path / "port" / "features" / "metadata.json").read_text())
    assert meta["weights"].endswith("+int8_ptq") and meta["embedding_dimension"] == 192
    rel = "features/embeddings.csv"
    assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_int8_extraction_per_batch_shape_equals_the_resident_one(tiny_image_tree, tmp_path, monkeypatch):
    """A corpus above the resident budget takes the per-batch feed; the int8
    embed step is the same, so the embeddings are."""
    from ssip_tpu_torch.pipelines import extraction as port_extraction

    cfg = ExtractionConfig(data_dir=tiny_image_tree, output_dir=tmp_path / "a", device="cpu", batch_size=8,
                           cache_decoded=False, arch=ARCH, resize=36, crop=IMG, compute_dtype="int8")
    resident = run_extraction(cfg)
    monkeypatch.setattr(port_extraction, "_RESIDENT_BUDGET_BYTES", 1024)
    batched = run_extraction(cfg)
    np.testing.assert_array_equal(batched.embeddings, resident.embeddings)


@pytest.mark.parametrize(
    "arch,match",
    [("resnet18", None), ("resnet50", None), ("vit_moe_t16", "dense ViTs only"), ("vit_moe_s16", "dense ViTs only")],
)
def test_int8_refused_for_resnets_and_moe(arch, match, tmp_path):
    """int8 with an MoE arch is refused, as in the JAX package. The ResNets
    are taken since ``models/quantized.py`` is ported: the config holds, and
    the CLI gets past its checks to the (empty) data directory
    (``tests/test_torch_quantized.py`` runs them)."""
    if match is None:
        assert ExtractionConfig(data_dir=tmp_path, arch=arch, compute_dtype="int8").compute_dtype == "int8"
        with pytest.raises(RuntimeError, match="No image files discovered"):
            extraction_cli.main(["--data-dir", str(tmp_path), "--device", "cpu", "--arch", arch, "--compute-dtype",
                                 "int8", "--output-dir", str(tmp_path / "out")])
        return
    with pytest.raises(ValueError, match=match):
        ExtractionConfig(data_dir=tmp_path, arch=arch, compute_dtype="int8")
    with pytest.raises(ValueError, match=match):
        extraction_cli.main(["--data-dir", str(tmp_path), "--device", "cpu", "--arch", arch, "--compute-dtype", "int8"])


def test_cli_drives_int8_vit_t16_on_the_cpu(tiny_image_tree, tmp_path, capsys):
    out = tmp_path / "cli"
    extraction_cli.main(["--data-dir", str(tiny_image_tree), "--device", "cpu", "--arch", ARCH, "--compute-dtype", "int8",
                         "--batch-size", "8", "--no-cache", "--output-dir", str(out)])
    assert "Extracted 22 embeddings (192-D)" in capsys.readouterr().out
    emb = np.load(out / "features" / "embeddings.npy")
    meta = json.loads((out / "features" / "metadata.json").read_text())
    assert emb.shape == (22, 192) and np.isfinite(emb).all()
    assert meta["weights"] == "random_init:seed=42+int8_ptq" and meta["architecture"] == ARCH
