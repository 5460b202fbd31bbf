"""``ExtractionConfig(fast_inference=True)``, the folded-BN forward, against
the JAX package's and against the port's plain forward.

The JAX package folds in bfloat16 for a ResNet only (``_prepare_inference``,
``ssip_tpu/pipelines/extraction.py:488-507``), with its space-to-depth stem;
the port folds with the plain stem. Bounds: the bfloat16 run's embeddings
per-image cosine > 0.995 against the JAX folded run (the bound of
``tests/test_torch_extraction.py``'s bfloat16 slice) and against the
port's plain bfloat16 run; the folded forward computed in float32 within
1e-4 of the plain forward's largest feature.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.pipelines import extraction as jax_extraction
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.ops.preproc import preprocess_images
from ssip_tpu_torch.pipelines import extraction
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def test_field_has_the_jax_default():
    ours = {f.name: f.default for f in dataclasses.fields(extraction.ExtractionConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jax_extraction.ExtractionConfig)}
    assert ours["fast_inference"] is theirs["fast_inference"] is False
    assert extraction.ExtractionConfig(fast_inference=True).fast_inference


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "vit_t16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("fast", [False, True])
def test_fold_rule_matches_jax(arch, dtype, fast):
    kw = dict(arch=arch, compute_dtype=dtype, fast_inference=fast)
    variables = {} if arch.startswith("vit") else jax_seeded_init_host(
        MODEL_FACTORIES[arch](num_classes=None), 0, (1, 32, 32, 3))
    want, _tree = jax_extraction._prepare_inference(jax_extraction.ExtractionConfig(**kw), variables)
    assert extraction.uses_folded_forward(extraction.ExtractionConfig(**kw)) == want


def test_folded_float32_forward_matches_the_plain_one():
    """The extraction's folded forward in float32 on preprocessed batches:
    within 1e-4 of the plain eval forward (running statistics moved off
    their init, so the fold is not the identity)."""
    model = build_model("resnet18")
    load_flax_variables(model, seeded_init_host("resnet18", 3, image_size=64))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.2, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
    model.eval()
    u8 = torch.from_numpy(rng.integers(0, 256, (4, 80, 72, 3), dtype=np.uint8))
    x = preprocess_images(u8, resize=72, crop=64, out_dtype=torch.float32)
    with torch.inference_mode():
        plain = model(x).numpy()
        folded = extraction.folded_forward("resnet18", model, torch.float32)(x).numpy()
    assert folded.shape == plain.shape == (4, 512)
    assert np.abs(folded - plain).max() / np.abs(plain).max() <= 1e-4


def test_bf16_fast_run_tracks_jax_and_the_plain_run(tiny_image_tree, tmp_path):
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False, compute_dtype="bfloat16",
               fast_inference=True)
    want = jax_extraction.run_extraction(jax_extraction.ExtractionConfig(output_dir=tmp_path / "jax", **cfg))
    got = extraction.run_extraction(extraction.ExtractionConfig(output_dir=tmp_path / "port", **cfg))
    plain = extraction.run_extraction(extraction.ExtractionConfig(
        output_dir=tmp_path / "plain", **{**cfg, "fast_inference": False}))
    assert got.embeddings.shape == want.embeddings.shape == (22, 512) and got.embeddings.dtype == np.float32
    for ref in (want.embeddings, plain.embeddings):
        cos = (_unit(got.embeddings) * _unit(ref)).sum(axis=1)
        assert cos.min() > 0.995, cos.min()
    assert not np.array_equal(got.embeddings, plain.embeddings)  # the folded forward ran


@pytest.mark.parametrize("arch,dtype", [("resnet18", "float32"), ("vit_t16", "bfloat16")])
def test_fast_inference_leaves_other_runs_plain(arch, dtype, tiny_image_tree, tmp_path):
    """Outside a bfloat16 ResNet the flag changes nothing, bit for bit."""
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False, compute_dtype=dtype,
               arch=arch)
    a = extraction.run_extraction(extraction.ExtractionConfig(output_dir=tmp_path / "a", fast_inference=True, **cfg))
    b = extraction.run_extraction(extraction.ExtractionConfig(output_dir=tmp_path / "b", **cfg))
    np.testing.assert_array_equal(a.embeddings, b.embeddings)
