"""The port's supervised slice against the JAX package: the scikit-learn-free
split, the balanced sampler and the metrics (each equal to the JAX
package's), ``run_supervised`` on a tiny JPEG tree with artifacts the JAX
tooling reads, and the training CLI's flags.
"""

import dataclasses
import io
import json

import numpy as np
import pandas as pd
import pytest
import torch

from src import supervised_training as jax_cli
from ssip_tpu.data import splits as jsplits
from ssip_tpu.models.resnet import ResNet18
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.ops import metrics as jmetrics
from ssip_tpu.pipelines.sweep import SweepConfig, run_sweep
from ssip_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
from ssip_tpu_torch.cli import supervised_training as cli
from ssip_tpu_torch.data import splits
from ssip_tpu_torch.models.port import state_dict_from_flax
from ssip_tpu_torch.models.resnet import build_resnet
from ssip_tpu_torch.ops import metrics
from ssip_tpu_torch.pipelines.supervised import TrainingConfig, run_supervised
from ssip_tpu_torch.train.checkpoints import load_checkpoint

torch.set_num_threads(2)


def _targets(n: int, seed: int, positive_share: float = 0.3) -> list:
    """Imbalanced binary labels, at least 4 of each class."""
    y = (np.random.default_rng(n * 100 + seed).random(n) < positive_share).astype(int)
    y[:4], y[4:8] = 1, 0
    return y.tolist()


@pytest.mark.parametrize("val,test", [(0.2, 0.2), (0.1, 0.3)])
@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("n", [20, 57, 100, 1506])
def test_split_dict_matches_scikit_learn_split(n, seed, val, test):
    """Index for index ``ssip_tpu.data.splits.split_dict`` (which runs
    scikit-learn's two-stage ``train_test_split``)."""
    targets = _targets(n, seed)
    want = jsplits.split_dict(targets, val, test, seed)
    got = splits.split_dict(targets, val, test, seed)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype


def test_split_dict_three_classes_and_errors():
    targets = [0] * 10 + [1] * 7 + [2] * 13
    want = jsplits.split_dict(targets, 0.2, 0.2, 5)
    got = splits.split_dict(targets, 0.2, 0.2, 5)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(ValueError, match="only 1 member"):
        splits.split_dict([0] * 9 + [1], 0.2, 0.2, 0)


@pytest.mark.parametrize(
    "labels,epoch,num_samples",
    [([0, 1, 1, 1, 0, 1, 1], 0, None), ([0, 1, 1, 1, 0, 1, 1], 3, 20), ([1, 1, 1], 1, None), (list(range(3)) * 5, 2, 9)],
)
def test_balanced_epoch_indices_match_jax(labels, epoch, num_samples):
    np.testing.assert_array_equal(
        splits.balanced_epoch_indices(labels, seed=42, epoch=epoch, num_samples=num_samples),
        jsplits.balanced_epoch_indices(labels, seed=42, epoch=epoch, num_samples=num_samples),
    )
    np.testing.assert_array_equal(splits.balanced_sample_weights(labels), jsplits.balanced_sample_weights(labels))


@pytest.mark.parametrize("case", ["random", "no_positive_pred", "no_positive_true", "all_right", "empty"])
def test_metrics_match_jax(case):
    rng = np.random.default_rng(3)
    y_true, y_pred = rng.integers(0, 2, 37), rng.integers(0, 2, 37)
    if case == "no_positive_pred":
        y_pred[:] = 0
    elif case == "no_positive_true":
        y_true[:] = 0
    elif case == "all_right":
        y_pred = y_true.copy()
    elif case == "empty":
        y_true, y_pred = y_true[:0], y_pred[:0]
    assert metrics.accuracy_f1(y_true, y_pred) == jmetrics.accuracy_f1(y_true, y_pred)
    if case == "empty":
        return
    assert float(metrics.accuracy(y_true, y_pred)) == float(jmetrics.accuracy(y_true, y_pred))
    got = metrics.precision_recall_f1(y_true == 1, y_pred == 1)
    want = jmetrics.precision_recall_f1(y_true == 1, y_pred == 1)
    assert [float(v) for v in got] == [float(v) for v in want]
    for pos in (0, 1):
        assert metrics.binary_confusion_metrics(y_true, y_pred, pos) == jmetrics.binary_confusion_metrics(
            y_true, y_pred, pos
        )
    y_prob = np.round(rng.random(37), 2)  # rounded: ties in the scores
    with pytest.warns(UserWarning) if case == "no_positive_true" else _no_warning():
        got_roc = metrics.roc_curve(y_true, y_prob)
    with pytest.warns(UserWarning) if case == "no_positive_true" else _no_warning():
        want_roc = jmetrics.roc_curve(y_true, y_prob)
    for g, w in zip(got_roc + metrics.pr_curve(y_true, y_prob), want_roc + jmetrics.pr_curve(y_true, y_prob)):
        np.testing.assert_array_equal(g, w)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``run_supervised`` of the port on a 6 + 6 image 64² JPEG tree, on the
    CPU, 32², 2 epochs, with and without a target recall."""
    from PIL import Image

    root = tmp_path_factory.mktemp("supervised")
    gen = np.random.default_rng(0)
    for bucket in ("cancer", "normal"):
        d = root / "avec_labels" / bucket
        d.mkdir(parents=True)
        for i in range(6):
            Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(d / f"{bucket}_{i:02d}.jpg")
    data = root / "avec_labels"
    common = dict(strong_data_dir=data, device="cpu", image_size=32, batch_size=4)
    out = root / "out"
    results = run_supervised(TrainingConfig(output_dir=out, baseline_epochs=2, target_recall=0.9, **common))
    out_plain = root / "out_plain"
    results_plain = run_supervised(TrainingConfig(output_dir=out_plain, baseline_epochs=1, **common))
    return data, out, results, out_plain, results_plain


def _pandas_csv(rows: dict) -> str:
    buf = io.StringIO()
    pd.DataFrame.from_dict(rows, orient="index").to_csv(buf)
    return buf.getvalue()


def test_run_supervised_writes_the_jax_artifact_set(port_run):
    data, out, results, out_plain, results_plain = port_run
    assert set(results) == {"baseline_thresholded", "baseline_argmax"}
    thr = results["baseline_thresholded"]
    assert thr["threshold_policy"] != "disabled" and 0.0 <= thr["threshold"] <= 1.0
    # the JAX pipeline's column order in both modes, and pandas' text
    text = (out / "tables" / "results_comparison.csv").read_text()
    assert text.splitlines()[0] == (
        ",accuracy,precision,recall,f1,threshold,target_recall,min_precision,max_fpr,threshold_policy,training_time_sec"
    )
    assert text == _pandas_csv({"baseline_thresholded": thr})
    text_plain = (out_plain / "tables" / "results_comparison.csv").read_text()
    assert text_plain.splitlines()[0] == (
        ",accuracy,precision,recall,f1,training_time_sec,threshold,target_recall,min_precision,max_fpr,threshold_policy"
    )
    assert text_plain == _pandas_csv({"baseline_thresholded": results_plain["baseline_thresholded"]})

    payload = json.loads((out / "notes" / "training_history.json").read_text())
    assert sorted(payload) == ["arch", "baseline", "image_size", "splits"]
    assert payload["arch"] == "resnet18" and payload["image_size"] == 32
    hist = payload["baseline"]
    assert sorted(hist) == ["train_acc", "train_f1", "train_loss", "val_acc", "val_f1", "val_loss"]
    assert len(hist["val_loss"]) == 2 and np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    targets = [0] * 6 + [1] * 6  # ImageFolder order: cancer, then normal
    want = jsplits.split_dict(targets, 0.2, 0.2, 42)
    assert payload["splits"] == {k: v.tolist() for k, v in want.items()}


def test_checkpoint_loads_in_both_packages(port_run):
    """The port's ``.pt`` loads into the port's model and, through the JAX
    package's ``load_checkpoint`` (no ``.msgpack`` beside it), into Flax."""
    _, out, _, _, _ = port_run
    path = out / "models" / "baseline_resnet18.pt"
    assert path.is_file() and not path.with_suffix(".pt.msgpack").exists()
    model = build_resnet("resnet18", num_classes=2)
    load_checkpoint(path, model)
    template = jax_seeded_init_host(ResNet18(num_classes=2), 0, (1, 32, 32, 3))
    ported = state_dict_from_flax(jax_load_checkpoint(path, template))
    state = model.state_dict()
    assert sorted(ported) == sorted(k for k in state if not k.endswith("num_batches_tracked"))
    for key, value in ported.items():
        np.testing.assert_array_equal(value, state[key].numpy(), err_msg=key)


def test_jax_threshold_sweep_consumes_the_port_outputs(port_run, capsys):
    data, out, _, _, _ = port_run
    result = run_sweep(SweepConfig(strong_data_dir=data, output_dir=out, model="baseline", device="cpu",
                                   num_workers=1, batch_size=4, image_size=32))
    rows = pd.read_csv(result["csv"])
    test_size = len(json.loads((out / "notes" / "training_history.json").read_text())["splits"]["test"])
    assert len(rows) > 0
    assert (rows[["TP", "FP", "TN", "FN"]].sum(axis=1) == test_size).all()


@pytest.mark.parametrize(
    "argv,item",
    [
        (["--resume"], "item 15c"),
        (["--num-seeds", "2"], "item 18"),
        (["--cv-folds", "3"], "item 18"),
        (["--mesh-model", "2"], "item 22"),
        (["--fsdp"], "item 22"),
        (["--arch", "vit_moe_t16"], "slice 6"),
        (["--arch", "vit_moe_s16"], "slice 6"),
    ],
)
def test_cli_refuses_unported_flags(tmp_path, argv, item):
    with pytest.raises(ValueError, match=rf"not ported to ssip_tpu_torch yet \(ROADMAP\.md, Queue 1 {item}"):
        cli.main(["--strong-data-dir", str(tmp_path / "missing"), "--device", "cpu", *argv])


@pytest.mark.parametrize(
    "argv",
    [[], ["--batch-size", "8", "--target-recall", "0.95", "--compute-dtype", "bfloat16", "--remat",
          "--arch", "resnet34", "--early-stopping", "5", "--output-dir", "o", "--max-fpr", "0.2"]],
)
def test_cli_flags_and_config_match_the_jax_cli(argv):
    argv = ["--strong-data-dir", "d", *argv]
    assert vars(cli.parse_args(argv)) == vars(jax_cli.parse_args(argv))
    # the port keeps its own copy of TrainingConfig: same fields, same values
    assert dataclasses.asdict(cli.config_from_args(cli.parse_args(argv))) == dataclasses.asdict(
        jax_cli.config_from_args(jax_cli.parse_args(argv))
    )
