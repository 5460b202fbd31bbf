"""The port's training figures against the JAX package's, on the CPU.

``ssip_tpu_torch/report/plots.py`` and ``ssip_tpu/report/plots.py`` draw
the same seeded inputs, and the decoded PNG pixels are held equal (not the
bytes, which carry matplotlib's metadata); ``confusion_matrix_2x2`` and
``average_precision`` are held to the JAX functions exactly. Tiny CPU runs
of both pipelines write the JAX run's figure names, and with
``plots.available`` patched to False they warn once, before any data is
read, and write every table and no figure.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ssip_tpu.ops import metrics as jmetrics
from ssip_tpu.report import plots as jplots
from ssip_tpu.runtime.artifacts import ArtifactRegistry as JaxArtifactRegistry
from ssip_tpu_torch.ops import metrics
from ssip_tpu_torch.pipelines import semi_supervised, supervised
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.report import plots
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

SIZE = 32


def _binary_case(case: str, n: int = 41):
    rng = np.random.default_rng(len(case))
    y_true = rng.integers(0, 2, n)
    y_pred = rng.integers(0, 2, n)
    y_prob = np.round(rng.random(n), 2)  # rounded: ties in the scores
    if case == "no_positive_true":
        y_true[:] = 0
    elif case == "no_positive_pred":
        y_pred[:] = 0
    elif case == "all_right":
        y_pred = y_true.copy()
        y_prob = np.where(y_true == 1, 0.5 + y_prob / 2, y_prob / 2)
    return y_true, y_pred, y_prob


@pytest.mark.parametrize("case", ["random", "no_positive_true", "no_positive_pred", "all_right"])
def test_confusion_matrix_and_average_precision_match_jax(case):
    y_true, y_pred, y_prob = _binary_case(case)
    got = metrics.confusion_matrix_2x2(y_true == 1, y_pred == 1)
    want = np.asarray(jmetrics.confusion_matrix_2x2(jnp.asarray(y_true == 1), jnp.asarray(y_pred == 1)))
    assert got.dtype == want.dtype == np.float32 and got.shape == (2, 2)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == len(y_true)
    ap = metrics.average_precision(y_true, y_prob)
    assert isinstance(ap, float) and ap == jmetrics.average_precision(y_true, y_prob)


def _history(epochs: int, seed: int):
    rng = np.random.default_rng(seed)
    return {f"{split}_{m}": rng.random(epochs).tolist() for split in ("train", "val") for m in ("loss", "acc", "f1")}


def _curves(case: str):
    first, second = _binary_case("random"), _binary_case(case)
    return {"Baseline": (first[0], first[2]), "Semi-supervised": (second[0], second[2])}


def _metric_rows(keys):
    rng = np.random.default_rng(3)
    rows = {name: {key: float(rng.random()) for key in keys} for name in
            ("baseline_argmax", "baseline_thresholded", "semi_argmax", "semi_thresholded")}
    if len(keys) > 2:  # an empty cell and a missing one each draw a bar of 0, as in the JAX figure
        rows["semi_argmax"][keys[1]] = None
        del rows["baseline_argmax"][keys[2]]
    return rows


THREE_CLASS = (np.array([0, 1, 2, 2, 1, 0, 2, 2, 1]), np.array([0, 2, 2, 1, 1, 0, 2, 0, 1]))
BARS = ["TPR", "FPR", "TNR", "precision", "accuracy"]

FIGURES = {
    "training_curves": lambda p, out: p.plot_training_curves(_history(7, 1), out, "Baseline"),
    "training_curves_one_epoch": lambda p, out: p.plot_training_curves(_history(1, 2), out, "Semi-supervised"),
    "confusion_2x2": lambda p, out: p.plot_confusion_matrix(*_binary_case("random")[:2], ["cancer", "normal"], out),
    "confusion_k_class": lambda p, out: p.plot_confusion_matrix(*THREE_CLASS, ["a", "b", "c"], out),
    "roc": lambda p, out: p.plot_roc_curves(_curves("all_right"), out),
    "pr": lambda p, out: p.plot_pr_curves(_curves("all_right"), out),
    "pr_no_positive": lambda p, out: p.plot_pr_curves(_curves("no_positive_true"), out),
    "metrics_bars": lambda p, out: p.plot_metrics_bars(_metric_rows(BARS), out, keys=BARS),
    "metrics_bars_one_panel": lambda p, out: p.plot_metrics_bars(_metric_rows(["TPR"]), out, keys=["TPR"]),
}


def _pixels(path):
    with Image.open(path) as image:
        return np.asarray(image.convert("RGBA"))


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_pixels_match_jax(name, tmp_path):
    FIGURES[name](plots, tmp_path / "port" / "figure.png")
    FIGURES[name](jplots, tmp_path / "jax" / "figure.png")
    got, want = _pixels(tmp_path / "port" / "figure.png"), _pixels(tmp_path / "jax" / "figure.png")
    assert got.shape == want.shape and got.shape[0] > 400
    np.testing.assert_array_equal(got, want)


def test_single_class_roc_warns_in_both_and_matches(tmp_path):
    for package, name in ((plots, "port.png"), (jplots, "jax.png")):
        with pytest.warns(UserWarning, match="no positive samples"):
            package.plot_roc_curves(_curves("no_positive_true"), tmp_path / name)
    np.testing.assert_array_equal(_pixels(tmp_path / "port.png"), _pixels(tmp_path / "jax.png"))


def test_available_is_find_spec(monkeypatch):
    import importlib.util

    assert plots.available() is (importlib.util.find_spec("matplotlib") is not None)
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert plots.available() is False


JAX_REG = JaxArtifactRegistry()
# ``ssip_tpu/pipelines/supervised.py:331-337`` (the PR figure is named there, not in the registry)
SUPERVISED_FIGURES = sorted(
    [JAX_REG.baseline_curves_png.name, JAX_REG.baseline_confusion_png.name, JAX_REG.roc_curves_png.name,
     "pr_curves_baseline.png"]
)
# ``ssip_tpu/pipelines/semi_supervised.py:203, 361-387, 429-433``
SEMI_FIGURES = sorted(path.name for path in (
    JAX_REG.baseline_curves_png, JAX_REG.semi_curves_png, JAX_REG.baseline_confusion_png,
    JAX_REG.baseline_confusion_thresholded_png, JAX_REG.semi_confusion_png, JAX_REG.semi_confusion_thresholded_png,
    JAX_REG.roc_curves_png, JAX_REG.pr_curves_png, JAX_REG.metrics_comparison_png,
))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """6 + 6 labeled 48² JPEGs and a pool of 6."""
    root = tmp_path_factory.mktemp("plots_tree")
    gen = np.random.default_rng(0)
    for bucket in ("cancer", "normal"):
        d = root / "avec_labels" / bucket
        d.mkdir(parents=True)
        for i in range(6):
            Image.fromarray(gen.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(d / f"{bucket}_{i:02d}.jpg")
    weak = root / "sans_label"
    weak.mkdir()
    for i in range(6):
        Image.fromarray(gen.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(weak / f"unlabeled_{i:02d}.jpg")
    return root


def _config(tree, out, semi: bool):
    extra = dict(weak_data_dir=tree / "sans_label", weak_pretrain_epochs=1, finetune_epochs=1,
                 pseudo_label_threshold=0.5, target_recall=0.9) if semi else {}
    return TrainingConfig(strong_data_dir=tree / "avec_labels", output_dir=out, device="cpu", image_size=SIZE,
                          batch_size=4, baseline_epochs=1, **extra)


RUNS = {"supervised": (supervised.run_supervised, False, SUPERVISED_FIGURES),
        "semi": (semi_supervised.run_pipeline, True, SEMI_FIGURES)}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_runs_write_the_jax_figure_names(tree, tmp_path, run, caplog):
    run_fn, semi, names = RUNS[run]
    with caplog.at_level(logging.WARNING):
        run_fn(_config(tree, tmp_path / "out", semi))
    assert "matplotlib" not in caplog.text
    figures = tmp_path / "out" / "figures"
    assert sorted(p.name for p in figures.iterdir()) == names
    for path in figures.iterdir():
        assert _pixels(path).shape[0] > 400  # each one a decodable figure


@pytest.mark.parametrize("run", sorted(RUNS))
def test_without_matplotlib_runs_warn_once_and_write_every_table(tree, tmp_path, run, caplog, monkeypatch):
    run_fn, semi, names = RUNS[run]
    monkeypatch.setattr(plots, "available", lambda: False)
    module = semi_supervised if semi else supervised

    # the warning comes before any data is read
    def no_data(*args, **kwargs):
        raise RuntimeError("data read")

    with monkeypatch.context() as patch, caplog.at_level(logging.WARNING):
        patch.setattr(module, "prepare_datasets", no_data)
        with pytest.raises(RuntimeError, match="data read"):
            run_fn(_config(tree, tmp_path / "refused", semi))
    assert caplog.text.count("matplotlib is not installed") == 1
    caplog.clear()

    out = tmp_path / "out"
    with caplog.at_level(logging.WARNING):
        results = run_fn(_config(tree, out, semi))
    warnings = [r.getMessage() for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warnings) == 1 and all(name in warnings[0] for name in names)
    assert not (out / "figures").exists() or not any((out / "figures").iterdir())
    tables = ["tables/results_comparison.csv", "notes/training_history.json"]
    if semi:
        tables += ["tables/results_comparison_detailed.csv", "notes/operating_point.json",
                   "tables/unlabeled_predictions_semi.csv"]
    for rel in tables:
        assert (out / rel).is_file(), rel
    assert json.loads((out / "notes/training_history.json").read_text())["arch"] == "resnet18"
    assert "baseline_thresholded" in results
