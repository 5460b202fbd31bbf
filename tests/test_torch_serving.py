"""The port's serving path against the JAX package's, on the CPU: the cases of
``tests/test_serving.py`` on a run the port trained, and the two packages'
``ScreeningPredictor`` and ``predict`` CLI on one run directory.

Tolerances: probabilities within 1e-5 (two float32 convolution orders) on the
same eval-resized uint8 inputs, and against the run's own triage CSV. The
``predict`` CLIs are fed 224² JPEGs, where the resize to the 224² training
size is the identity, so their CSVs hold the same rows. At 512² JPEGs the
two packages' training resizes are equal bit for bit (ROADMAP Queue 3 #1,
closed), and the two convolution orders move ``prob_positive`` by far less
than 1e-3; ``flagged`` is held equal wherever the probability is more than
1e-3 from the threshold.
"""

import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import src.predict as jax_predict_cli
from ssip_tpu.serving import ScreeningPredictor as JaxScreeningPredictor
from ssip_tpu.serving import load_serving_bundle as jax_load_serving_bundle
from ssip_tpu_torch.cli import predict as predict_cli
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.pipelines.semi_supervised import run_pipeline
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from ssip_tpu_torch.serving import ScreeningPredictor, load_serving_bundle
from ssip_tpu_torch.train.checkpoints import save_checkpoint
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """The port's semi-supervised pipeline at 32² on a 48² JPEG tree (8 + 8
    labeled, 10 unlabeled), 1 + 1 + 1 epochs."""
    gen = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("ds")
    for cls, lo, hi in (("cancer", 150, 255), ("normal", 0, 100)):
        d = root / "avec_labels" / cls
        d.mkdir(parents=True)
        for i in range(8):
            Image.fromarray(gen.integers(lo, hi, (48, 48, 3), dtype=np.uint8)).save(d / f"{cls}_{i}.jpg")
    u = root / "sans_label"
    u.mkdir()
    for i in range(10):
        lo, hi = (150, 255) if i % 2 else (0, 100)
        Image.fromarray(gen.integers(lo, hi, (48, 48, 3), dtype=np.uint8)).save(u / f"u_{i:02d}.jpg")
    out = tmp_path_factory.mktemp("out")
    run_pipeline(TrainingConfig(
        strong_data_dir=root / "avec_labels", weak_data_dir=root / "sans_label", batch_size=8, image_size=32,
        baseline_epochs=1, weak_pretrain_epochs=1, finetune_epochs=1, pseudo_label_threshold=0.55,
        target_recall=0.9, output_dir=out, device="cpu",
    ))
    return root, out


@pytest.fixture(scope="module")
def run_224(tmp_path_factory):
    """A seeded ``resnet18`` classifier at the 224² default with drawn
    BatchNorm statistics, and an operating point: a run at the size the
    ``predict`` CLI serves by default."""
    out = tmp_path_factory.mktemp("run224")
    model = build_model("resnet18", num_classes=2)
    load_flax_variables(model, seeded_init_host("resnet18", 5, num_classes=2))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.standard_normal(buf.shape).astype(np.float32)))
    reg = ArtifactRegistry(out)
    save_checkpoint(reg.semi_checkpoint, model)
    reg.operating_point_json.parent.mkdir(parents=True, exist_ok=True)
    reg.operating_point_json.write_text(json.dumps({
        "arch": "resnet18", "positive_class": "cancer", "classes": ["cancer", "normal"], "threshold": 0.5,
    }))
    return out


def test_predictor_matches_jax_and_the_training_triage(trained_run):
    root, out = trained_run
    port = ScreeningPredictor.from_artifacts(out, model="semi", image_size=32, batch_size=8, device="cpu")
    jax = JaxScreeningPredictor.from_artifacts(out, model="semi", image_size=32, batch_size=8)
    images = np.random.default_rng(4).integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    a, b = port.predict_images(images), jax.predict_images(images)
    np.testing.assert_allclose(a.prob_positive, b.prob_positive, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a.flagged, b.flagged)
    assert a.threshold == b.threshold and a.positive_class == b.positive_class == "cancer"

    paths = sorted((root / "sans_label").glob("*.jpg"))
    result = port.predict_paths(paths)
    triage = pd.read_csv(out / "tables" / "unlabeled_predictions_semi.csv")
    np.testing.assert_allclose(result.prob_positive, triage["prob_positive"].to_numpy(), atol=1e-5)
    np.testing.assert_array_equal(result.flagged, triage["flagged"].to_numpy())
    op = json.loads((out / "notes" / "operating_point.json").read_text())
    assert result.threshold == pytest.approx(op["threshold"])
    assert port.predict_images(images[:0]).paths == []


def test_threshold_override(trained_run):
    root, out = trained_run
    predictor = ScreeningPredictor.from_artifacts(out, model="semi", image_size=32, batch_size=8, device="cpu")
    predictor.threshold = 0.0
    result = predictor.predict_paths(sorted((root / "sans_label").glob("*.jpg"))[:4])
    assert result.flagged.all()  # threshold 0 flags everything


def test_bundle_falls_back_to_training_history(trained_run, tmp_path):
    """Without ``operating_point.json`` the bundle takes the arch and the
    resolution from ``training_history.json``, as the JAX package's does."""
    _, out = trained_run
    run2 = tmp_path / "no_op_point"
    shutil.copytree(out, run2)
    (run2 / "notes" / "operating_point.json").unlink()
    hist = json.loads((run2 / "notes" / "training_history.json").read_text())
    assert hist["arch"] == "resnet18" and hist["image_size"] == 32
    bundle = load_serving_bundle(run2, model="semi")
    want = jax_load_serving_bundle(run2, model="semi")
    assert (bundle.arch, bundle.image_size, bundle.threshold, bundle.pos_index) == (
        want.arch, want.image_size, want.threshold, want.pos_index) == ("resnet18", 32, 0.5, 0)
    assert bundle.state["fc.weight"].shape == (2, 512)


def test_bundle_error_names_the_class_count(trained_run, tmp_path):
    _, out = trained_run
    run2 = tmp_path / "three_classes"
    shutil.copytree(out, run2)
    op_path = run2 / "notes" / "operating_point.json"
    op = json.loads(op_path.read_text())
    op_path.write_text(json.dumps({**op, "classes": ["a", "b", "c"]}))
    with pytest.raises(RuntimeError, match="against a 3-class resnet18 head"):
        load_serving_bundle(run2, model="semi", image_size=32)


def _jpeg_tree(root, size: int, n: int, seed: int):
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(root / f"img_{i:02d}.jpg")
    return root


def test_predict_cli_csv_matches_jax(run_224, tmp_path, capsys):
    images = _jpeg_tree(tmp_path / "imgs", 224, 5, 8)
    port_csv, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    predict_cli.main(["--images", str(images), "--output-dir", str(run_224), "--output", str(port_csv),
                      "--batch-size", "4", "--device", "cpu"])
    assert "Predicted 5 images" in capsys.readouterr().out
    jax_predict_cli.main(["--images", str(images), "--output-dir", str(run_224), "--output", str(jax_csv),
                          "--batch-size", "4", "--device", "cpu"])
    got, want = pd.read_csv(port_csv), pd.read_csv(jax_csv)
    assert list(got.columns) == list(want.columns) == ["path", "prob_positive", "flagged"]
    assert got["path"].tolist() == want["path"].tolist() and len(got) == 5
    np.testing.assert_allclose(got["prob_positive"], want["prob_positive"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["flagged"], want["flagged"])
    # the CSV's text is what pandas writes for the same column types
    result = ScreeningPredictor.from_artifacts(run_224, batch_size=4, device="cpu").predict_paths(
        sorted(images.glob("*.jpg")))
    frame = pd.DataFrame({"path": result.paths, "prob_positive": result.prob_positive, "flagged": result.flagged})
    assert port_csv.read_text() == frame.to_csv(index=False)
    # without --output the CSV goes to stdout
    capsys.readouterr()
    predict_cli.main(["--images", str(images / "img_00.jpg"), "--output-dir", str(run_224), "--device", "cpu"])
    assert capsys.readouterr().out.startswith("path,prob_positive,flagged\n")


def test_predict_paths_at_512_against_jax(run_224, tmp_path):
    """512² JPEGs through each package's decode → training resize → predict.
    The resized images are equal bit for bit; ``flagged`` is equal wherever
    ``prob_positive`` is more than 1e-3 from the threshold, and the
    probabilities stay within 1e-5."""
    from ssip_tpu.data.decode import decode_batch as jax_decode_batch
    from ssip_tpu.train.data import _resize_on_device as jax_resize_on_device
    from ssip_tpu_torch.serving import decode_and_resize

    paths = sorted(_jpeg_tree(tmp_path / "big", 512, 8, 9).glob("*.jpg"))
    kept, resized, failures = decode_and_resize(paths, 224, torch.device("cpu"))
    arrays, jax_failures = jax_decode_batch(paths, convert_rgb=True)
    assert kept == paths and not failures and not jax_failures
    np.testing.assert_array_equal(resized.numpy(), np.asarray(jax_resize_on_device(arrays, 224)))
    port = ScreeningPredictor.from_artifacts(run_224, batch_size=8, device="cpu").predict_paths(paths)
    jax = JaxScreeningPredictor.from_artifacts(run_224, batch_size=8).predict_paths(paths)
    assert port.paths == [str(p) for p in paths] == jax.paths
    deviation = np.abs(port.prob_positive - jax.prob_positive)
    assert deviation.max() <= 1e-5, deviation.max()
    clear = np.abs(jax.prob_positive - jax.threshold) > 1e-3
    np.testing.assert_array_equal(port.flagged[clear], jax.flagged[clear])
