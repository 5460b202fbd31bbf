"""The port's threshold sweep (``pipelines/sweep.py``, CLI
``cli/threshold_sweep.py``) against the JAX package's ``run_sweep`` on the
same training outputs, on the CPU.

Both read the port's ``training_history.json`` and ``.pt`` and evaluate the
test split in float32. Their images are equal (the training resize is the
JAX package's bit for bit), but the two forwards sum in other orders, so the
probabilities are held to 1e-4 and each row's confusion counts exactly where
no two probabilities lie within that of each other.
"""

import io
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ssip_tpu.models import MODEL_FACTORIES
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.pipelines.sweep import SweepConfig as JaxSweepConfig, run_sweep as jax_run_sweep
from ssip_tpu.train.data import subset as jax_subset
from ssip_tpu.train.engine import run_eval_epoch as jax_run_eval_epoch
from ssip_tpu_torch.cli import threshold_sweep as cli
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.pipelines.supervised import run_supervised
from ssip_tpu_torch.pipelines.sweep import SweepConfig, run_sweep, write_sweep_csv
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.train.data import subset
from ssip_tpu_torch.train.engine import run_eval_epoch
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 10 + 10 image 64² JPEG tree and the port's supervised runs on it
    (resnet18 and vit_t16, 32², 2 epochs)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("sweep")
    gen = np.random.default_rng(1)
    for bucket in ("cancer", "normal"):
        d = root / "avec_labels" / bucket
        d.mkdir(parents=True)
        for i in range(10):
            Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(d / f"{bucket}_{i:02d}.jpg")
    data = root / "avec_labels"
    outs = {}
    for arch in ("resnet18", "vit_t16"):
        outs[arch] = root / f"out_{arch}"
        run_supervised(TrainingConfig(
            strong_data_dir=data, output_dir=outs[arch], device="cpu", image_size=32, batch_size=4,
            baseline_epochs=2, arch=arch,
        ))
    return data, outs


def _copy(out, dest):
    shutil.copytree(out, dest)
    return dest


@pytest.mark.parametrize("arch", ["resnet18", "vit_t16"])
def test_sweep_matches_the_jax_sweep(trained, arch, tmp_path, capsys):
    data, outs = trained
    jout, pout = _copy(outs[arch], tmp_path / "jax"), _copy(outs[arch], tmp_path / "port")
    want = jax_run_sweep(JaxSweepConfig(strong_data_dir=data, output_dir=jout, model="baseline", device="cpu",
                                        num_workers=1))
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = run_sweep(SweepConfig(strong_data_dir=data, output_dir=pout, model="baseline", device="cpu", num_workers=1))
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(got_line) == got and json.loads(want_line) == want
    assert sorted(got) == sorted(want)

    wrows = pd.read_csv(jout / "tables" / "threshold_sweep_baseline.csv")
    grows = pd.read_csv(pout / "tables" / "threshold_sweep_baseline.csv")
    assert list(grows.columns) == list(wrows.columns) and len(grows) == len(wrows)
    np.testing.assert_allclose(grows["threshold"], wrows["threshold"], atol=PROB_TOL)
    gaps = np.diff(np.sort(wrows["threshold"].to_numpy()))
    assert gaps.min() > 2 * PROB_TOL  # so each row's counts must agree exactly
    counts = ["TP", "FP", "TN", "FN"]
    np.testing.assert_array_equal(grows[counts].to_numpy(), wrows[counts].to_numpy())
    np.testing.assert_allclose(grows.drop(columns="threshold").to_numpy(), wrows.drop(columns="threshold").to_numpy(),
                               rtol=1e-12)
    test_size = len(json.loads((pout / "notes" / "training_history.json").read_text())["splits"]["test"])
    assert (grows[counts].sum(axis=1) == test_size).all()
    for key, value in want.items():
        if key != "csv":
            assert got[key] == pytest.approx(value, abs=PROB_TOL), key


def test_sweep_csv_is_the_pandas_text():
    rng = np.random.default_rng(2)
    rows = [{"threshold": float(t), "TP": 3.0, "FP": float(i), "TPR": 1 / 3, "precision": 0.1 * i}
            for i, t in enumerate(rng.random(5))]
    buf = io.StringIO()
    pd.DataFrame(rows).to_csv(buf, index=False)
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "t" / "s.csv"
        write_sweep_csv(path, rows)
        assert path.read_text() == buf.getvalue()


def test_cli_writes_the_csv_and_keeps_the_jax_flags(trained, tmp_path, capsys):
    from src import threshold_sweep as jcli

    data, outs = trained
    out = _copy(outs["resnet18"], tmp_path / "cli")
    cli.main(["--strong-data-dir", str(data), "--output-dir", str(out), "--model", "baseline", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["csv"] == str(out / "tables" / "threshold_sweep_baseline.csv")
    assert (out / "tables" / "threshold_sweep_baseline.csv").is_file()
    argv = ["--strong-data-dir", "d"]
    assert vars(cli.parse_args(argv)) == vars(jcli.parse_args(argv))
    with pytest.raises(FileNotFoundError):  # no semi checkpoint in a supervised run
        cli.main(["--strong-data-dir", str(data), "--output-dir", str(out), "--model", "semi", "--device", "cpu"])


def test_cli_device_auto_needs_the_card(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    data, outs = trained
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.main(["--strong-data-dir", str(data), "--output-dir", str(outs["resnet18"])])


def test_both_eval_epochs_raise_on_an_empty_dataset():
    """Neither package's ``run_eval_epoch`` returns anything on a zero-row
    dataset: the JAX one raises in the gather of ``_stacked_epoch``'s padded
    step, the port's in ``torch.stack`` of no batches."""
    images = np.zeros((4, 32, 32, 3), np.uint8)
    labels = np.array([0, 1, 0, 1])
    empty = np.zeros(0, np.int64)
    model = MODEL_FACTORIES["resnet18"](num_classes=2)
    variables = jax_seeded_init_host(model, 0, (1, 32, 32, 3))
    with pytest.raises(Exception, match="out of range|gather|Slice size"):
        jax_run_eval_epoch(variables, jax_subset(jnp.asarray(images), labels, empty), 4, apply_fn=model.apply)
    port_model = build_model("resnet18", num_classes=2)
    with pytest.raises(RuntimeError, match="non-empty"):
        run_eval_epoch(port_model, subset(torch.from_numpy(images), labels, empty), 4)
