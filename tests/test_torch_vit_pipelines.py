"""The port's two pipelines and CLIs with ``vit_t16`` (12 layers, hidden 192,
3 heads of 64) at 32², against the JAX package's pipelines on the same seeded
JPEG tree, on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.models import port_torch
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.models.vit import VIT_FACTORIES
from ssip_tpu.pipelines.extraction import ExtractionConfig as JaxExtractionConfig
from ssip_tpu.pipelines.extraction import run_extraction as jax_run_extraction
from ssip_tpu.pipelines.supervised import run_supervised as jax_run_supervised
from ssip_tpu.pipelines.train_config import TrainingConfig as JaxTrainingConfig
from ssip_tpu_torch.cli import feature_extraction as extraction_cli
from ssip_tpu_torch.cli import supervised_training as training_cli
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction
from ssip_tpu_torch.pipelines.supervised import TrainingConfig, run_supervised
from ssip_tpu_torch.train.checkpoints import load_checkpoint
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

SIZE = 32


def _leaves(tree):
    return {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def vit_tree(tmp_path_factory):
    """6 + 6 labeled and 4 unlabeled 64² JPEGs, made from a seed."""
    from PIL import Image

    root = tmp_path_factory.mktemp("vit_dataset")
    gen = np.random.default_rng(0)
    for folder, count in (("avec_labels/cancer", 6), ("avec_labels/normal", 6), ("sans_label", 4)):
        (root / folder).mkdir(parents=True)
        for i in range(count):
            Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(root / folder / f"img_{i:02d}.jpg")
    return root


def test_run_extraction_vit_t16_matches_the_jax_pipeline(vit_tree, tmp_path, monkeypatch):
    """Both packages embed the tree with ``vit_t16`` at 32² from the same
    seeded init: 192-wide float32 embeddings within 1e-4, the same CSV
    bytes, the same metadata."""
    monkeypatch.delenv("SSIP_RESNET18_WEIGHTS", raising=False)
    cfg = dict(data_dir=vit_tree, device="cpu", batch_size=8, cache_decoded=False, arch="vit_t16", resize=36, crop=SIZE)
    want = jax_run_extraction(JaxExtractionConfig(output_dir=tmp_path / "jax", **cfg))
    got = run_extraction(ExtractionConfig(output_dir=tmp_path / "port", **cfg))
    assert got.embeddings.shape == want.embeddings.shape == (16, 192) and got.embeddings.dtype == np.float32
    np.testing.assert_allclose(got.embeddings, want.embeddings, rtol=0, atol=1e-4)
    rel = "features/embeddings.csv"
    assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    jm = json.loads((tmp_path / "jax" / "features" / "metadata.json").read_text())
    pm = json.loads((tmp_path / "port" / "features" / "metadata.json").read_text())
    assert pm.keys() == jm.keys()
    for key in ("architecture", "weights", "dataset_digest", "num_images", "embedding_dimension", "input_crop", "layer"):
        assert pm[key] == jm[key], key
    assert pm["embedding_dimension"] == 192 and pm["architecture"] == "vit_t16"
    assert [p["query"] for p in pm["neighbor_probe"]] == [p["query"] for p in jm["neighbor_probe"]]


def test_cli_drives_vit_t16_on_the_cpu(vit_tree, tmp_path, capsys):
    """Both CLIs with ``--arch vit_t16 --device cpu``, and with the MoE
    archs (``vit_moe_t16`` training, ``vit_moe_s16`` extraction; int8 runs with a dense ViT,
    ``tests/test_torch_quantized_vit.py``, and with a ResNet,
    ``tests/test_torch_quantized.py``)."""
    data = vit_tree / "avec_labels"
    out = tmp_path / "train"
    training_cli.main(["--strong-data-dir", str(data), "--device", "cpu", "--arch", "vit_t16", "--image-size", "32",
                       "--batch-size", "4", "--baseline-epochs", "1", "--remat", "--output-dir", str(out)])
    assert "baseline_argmax" in capsys.readouterr().out
    payload = json.loads((out / "notes" / "training_history.json").read_text())
    assert payload["arch"] == "vit_t16" and len(payload["baseline"]["val_loss"]) == 1
    moe = tmp_path / "moe"
    training_cli.main(["--strong-data-dir", str(data), "--device", "cpu", "--arch", "vit_moe_t16", "--image-size", "32",
                       "--batch-size", "4", "--baseline-epochs", "1", "--output-dir", str(moe)])
    payload = json.loads((moe / "notes" / "training_history.json").read_text())
    assert payload["arch"] == "vit_moe_t16" and np.isfinite(payload["baseline"]["train_loss"]).all()
    extraction_cli.main(["--data-dir", str(vit_tree), "--device", "cpu", "--output-dir", str(tmp_path / "x"),
                         "--arch", "vit_moe_s16", "--batch-size", "8"])
    meta = json.loads((tmp_path / "x" / "features" / "metadata.json").read_text())
    assert meta["architecture"] == "vit_moe_s16" and meta["embedding_dimension"] == 384 and meta["num_images"] == 16


def test_run_supervised_vit_t16_writes_what_the_jax_package_reads(vit_tree, tmp_path):
    """``run_supervised`` with ``vit_t16`` at 32²: the artifact set, the
    history's schema, and a ``.pt`` with torchvision's ViT keys that
    ``ssip_tpu.models.port_torch.port_state_dict`` turns into the Flax tree
    of the JAX package's ``vit_t16``; ``remat`` changes nothing."""
    common = dict(strong_data_dir=vit_tree / "avec_labels", device="cpu", image_size=SIZE, batch_size=4,
                  arch="vit_t16", baseline_epochs=2, target_recall=0.9)
    results = run_supervised(TrainingConfig(output_dir=tmp_path / "plain", **common))
    results_remat = run_supervised(TrainingConfig(output_dir=tmp_path / "remat", remat=True, **common))
    history = json.loads((tmp_path / "plain" / "notes" / "training_history.json").read_text())
    history_remat = json.loads((tmp_path / "remat" / "notes" / "training_history.json").read_text())
    assert history["arch"] == "vit_t16" and history["image_size"] == SIZE
    assert len(history["baseline"]["val_loss"]) == 2 and np.isfinite(history["baseline"]["train_loss"]).all()
    assert history_remat["baseline"] == history["baseline"] and history_remat["splits"] == history["splits"]
    drop = {"training_time_sec"}
    assert {k: v for k, v in results_remat["baseline_thresholded"].items() if k not in drop} == {
        k: v for k, v in results["baseline_thresholded"].items() if k not in drop}

    path = tmp_path / "plain" / "models" / "baseline_resnet18.pt"
    state = torch.load(path, weights_only=True)
    assert "heads.head.weight" in state and "encoder.layers.encoder_layer_11.mlp.3.bias" in state
    ported = port_torch.port_state_dict(state)
    port_torch.check_weights_match_arch(ported, "vit_t16", path)
    template = jax_seeded_init_host(VIT_FACTORIES["vit_t16"](num_classes=2), 0, (1, SIZE, SIZE, 3))
    got, want = _leaves(ported["params"]), _leaves(template["params"])
    assert sorted(got) == sorted(want) and all(got[k].shape == want[k].shape for k in want)
    # the Flax model runs on the ported tree and agrees with the port's
    x = np.random.default_rng(5).standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    logits_j = VIT_FACTORIES["vit_t16"](num_classes=2).apply({"params": ported["params"]}, jnp.asarray(x), train=False)
    model = build_model("vit_t16", num_classes=2, image_size=SIZE)
    load_checkpoint(path, model)
    with torch.inference_mode():
        np.testing.assert_allclose(model.eval()(torch.from_numpy(x)).numpy(), np.asarray(logits_j), rtol=0, atol=1e-4)

    # the JAX pipeline on the same tree: the same split, history schema and
    # table header, and a .pt of the same keys and shapes, which the port loads
    jax_out = tmp_path / "jax"
    jax_results = jax_run_supervised(JaxTrainingConfig(output_dir=jax_out, **dict(common, baseline_epochs=1)))
    jax_history = json.loads((jax_out / "notes" / "training_history.json").read_text())
    assert jax_history["splits"] == history["splits"] and jax_history["arch"] == history["arch"]
    assert sorted(jax_history["baseline"]) == sorted(history["baseline"])
    assert list(jax_results["baseline_thresholded"]) == list(results["baseline_thresholded"])
    table = "tables/results_comparison.csv"
    assert (jax_out / table).read_text().splitlines()[0] == (tmp_path / "plain" / table).read_text().splitlines()[0]
    jax_state = torch.load(jax_out / "models" / "baseline_resnet18.pt", weights_only=True)
    assert {k: tuple(v.shape) for k, v in jax_state.items()} == {k: tuple(v.shape) for k, v in state.items()}
    load_checkpoint(jax_out / "models" / "baseline_resnet18.pt", model)
