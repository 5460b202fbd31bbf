"""The port's seed and cross-validation fan-outs against the JAX package and
against the port's own solo runs.

- ``stratified_kfold_indices`` and ``epoch_plan(pool=, num_samples=)``
  index for index the JAX package's;
- ``LaneControl`` decision for decision the JAX class on seeded
  validation-loss scripts;
- each lane of ``train_multi_seed`` against a solo ``train_model`` of its
  seed, at the JAX test's envelope (``tests/test_multi_seed.py:180-210``:
  epoch 0 rtol 1e-4, later epochs 5e-2, parameters rtol 5e-2 atol 5e-4);
- a stopped lane freezes (scripted validation losses through both drivers);
- ``seed_sweep.csv`` and ``cv_results.csv`` in pandas' bytes, the saved
  checkpoint the selected lane's, and the CV folds a partition of the pool.
"""

import math

import numpy as np
import pandas as pd
import pytest
import torch

from ssip_tpu.data import splits as jsplits
from ssip_tpu.train import engine as jengine
from ssip_tpu.train.multi_seed import LaneControl as JaxLaneControl
from ssip_tpu_torch.data import splits
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.pipelines import supervised
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.train import engine, multi_seed
from ssip_tpu_torch.train.checkpoints import load_checkpoint
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

SIZE = 32


@pytest.mark.parametrize("n,k,seed", [(20, 2, 0), (57, 3, 42), (100, 5, 7), (31, 4, 1)])
def test_stratified_kfold_matches_jax(n, k, seed):
    targets = (np.random.default_rng(n + seed).random(n) < 0.4).astype(int)
    targets[:k], targets[k:2 * k] = 1, 0
    want = jsplits.stratified_kfold_indices(targets, k, seed)
    got = splits.stratified_kfold_indices(targets, k, seed)
    assert len(got) == len(want) == k
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)
    assert sorted(np.concatenate([v for _, v in got]).tolist()) == list(range(n))  # every index validates once


@pytest.mark.parametrize("targets,k", [([0, 1] * 5, 1), ([0, 1] * 5, 11), ([0, 0, 1, 1, 1], 4)])
def test_stratified_kfold_refuses_like_jax(targets, k):
    with pytest.raises(ValueError) as want:
        jsplits.stratified_kfold_indices(targets, k, 0)
    with pytest.raises(ValueError) as got:
        splits.stratified_kfold_indices(targets, k, 0)
    assert str(got.value) == str(want.value)


def _labels(n: int, seed: int) -> np.ndarray:
    y = (np.random.default_rng(seed).random(n) < 0.35).astype(np.int64)
    y[:2], y[2:4] = 1, 0
    return y


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("pooled", [False, True])
def test_epoch_plan_with_pool_and_num_samples_matches_jax(balanced, pooled):
    """pidx and valid bit for bit, a fold padded to the largest fold's
    length included; the port's per-step draws stay one per step."""
    labels = _labels(23, 3)
    jds = jengine.DeviceDataset.create(np.zeros((23, 1, 1, 3), np.uint8), labels)
    pds = engine.DeviceDataset.create(torch.zeros((23, 1, 1, 3), dtype=torch.uint8), labels)
    folds = splits.stratified_kfold_indices(labels, 3, 42)
    pools = [f[0] for f in folds] if pooled else [None]
    largest = max(len(p) for p in pools) if pooled else None
    for pool in pools:
        for epoch in (0, 2):
            kw = dict(seed=43, epoch=epoch, stream_name="cv", balanced=balanced, batch_size=4, pool=pool,
                      num_samples=largest)
            want_pidx, want_valid, _keys = jengine.epoch_plan(jds, **kw)
            pidx, valid, coeffs = engine.epoch_plan(pds, **kw)
            np.testing.assert_array_equal(pidx, want_pidx)
            np.testing.assert_array_equal(valid, want_valid)
            assert coeffs.shape == (pidx.shape[0], 3, 4)
            if pool is not None:
                assert np.isin(pidx[valid], pool).all() and valid.sum() == largest


def _scripts(n_lanes: int, epochs: int, seed: int) -> np.ndarray:
    """Validation-loss scripts with real gains, gains inside the 1e-4
    plateau threshold and runs of bad epochs."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_lanes, epochs))
    for lane in range(n_lanes):
        v = 1.0
        for e in range(epochs):
            r = rng.random()
            v = v * (0.9 if r < 0.35 else 0.99995 if r < 0.5 else 1.0 + 0.05 * rng.random())
            out[lane, e] = v
    return out


@pytest.mark.parametrize("seed,patience", [(0, 3), (1, 2), (5, 4), (9, 3)])
def test_lane_control_matches_jax(seed, patience):
    n, epochs = 5, 14
    script = _scripts(n, epochs, seed)
    kw = dict(early_stopping_patience=patience, plateau_patience=2, plateau_factor=0.5)
    ours, theirs = multi_seed.LaneControl(n, **kw), JaxLaneControl(n, **kw)
    lr_o = lr_t = np.full(n, 1e-4, np.float32)
    cuts = stops = 0
    for e in range(epochs):
        io, so, lr_o2 = ours.update(script[:, e], lr_o)
        it, st, lr_t2 = theirs.update(script[:, e], lr_t)
        np.testing.assert_array_equal(io, it)
        np.testing.assert_array_equal(so, st)
        np.testing.assert_array_equal(lr_o2, lr_t2)
        assert lr_o2.dtype == lr_t2.dtype == np.float32
        cuts += int((lr_o2 != lr_o).sum())
        stops += int(so.sum())
        lr_o, lr_t = lr_o2, lr_t2
        for name in ("best_val", "early_pat", "plateau_best", "plateau_bad", "stopped"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    assert cuts > 0 and stops > 0  # the scripts reach both rules


def _datasets():
    rng = np.random.default_rng(0)
    train = engine.DeviceDataset.create(
        torch.from_numpy(rng.integers(0, 256, (14, SIZE, SIZE, 3), dtype=np.uint8)), _labels(14, 1))
    val = engine.DeviceDataset.create(
        torch.from_numpy(rng.integers(0, 256, (6, SIZE, SIZE, 3), dtype=np.uint8)), _labels(6, 2))
    return train, val


def _state(seed: int) -> engine.TrainState:
    model = build_model("resnet18", num_classes=2)
    load_flax_variables(model, seeded_init_host("resnet18", seed, 2, image_size=SIZE))
    return engine.TrainState.create(model, 1e-3, 1e-4)


def test_lanes_match_solo_runs():
    """Each lane's history and best parameters against a solo run of its
    seed, at the JAX test's envelope; the two seeds differ."""
    train, val = _datasets()
    seeds = (42, 43)
    kw = dict(num_epochs=3, batch_size=8, stream_name="mstest", balanced=True, augment=True)
    states, histories, summary = multi_seed.train_multi_seed([_state(s) for s in seeds], train, val,
                                                             seeds=list(seeds), **kw)
    for lane, seed in enumerate(seeds):
        solo, solo_hist = engine.train_model(_state(seed), train, val, seed=seed, **kw)
        assert len(histories[lane]["val_loss"]) == len(solo_hist["val_loss"]) == summary[lane]["epochs_run"]
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(histories[lane][key][0], solo_hist[key][0], rtol=1e-4)
            np.testing.assert_allclose(histories[lane][key][1:], solo_hist[key][1:], rtol=5e-2)
        for key in ("train_acc", "val_acc", "train_f1", "val_f1"):
            np.testing.assert_allclose(histories[lane][key][0], solo_hist[key][0])
        got = dict(states[lane].model.named_parameters())
        for name, p in solo.model.named_parameters():
            np.testing.assert_allclose(got[name].detach().numpy(), p.detach().numpy(), rtol=5e-2, atol=5e-4)
        assert summary[lane]["seed"] == seed
        assert summary[lane]["best_val_loss"] == pytest.approx(min(solo_hist["val_loss"]), rel=5e-2)
        assert states[lane].step == solo.step
    assert not np.allclose(histories[0]["train_loss"], histories[1]["train_loss"])


class _Tiny(torch.nn.Module):
    compute_dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(2, 2)


def test_stopped_lane_freezes_as_its_solo_run_stops(monkeypatch):
    """Scripted validation losses through both drivers (the train epoch a
    counted no-op): each lane's history, stop, best state (by its step) and
    final learning rate are its solo run's; a stopped lane trains no more."""
    # lane 0 stops after 5 epochs (a plateau cut on its last); lane 1 runs all
    # 8, with a cut at epoch 4, whose gain is inside the 1e-4 threshold
    script = {0: [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.4], 1: [1.0, 0.8, 0.81, 0.82, 0.79999, 0.6, 0.5, 0.4]}
    trained = {}

    def fake_train(state, dataset, pidx, valid, coeffs, trainable_mask=None):
        state.step += 1
        trained[state.lane] = trained.get(state.lane, 0) + 1
        return np.zeros(pidx.shape[0], np.float32), np.zeros(pidx.shape, np.int64)

    def fake_eval(model, dataset, batch_size, mesh=None):
        lane = model.lane
        loss = script[lane][model.epochs]
        model.epochs += 1
        return loss, np.array([0, 1]), np.array([0, 1]), np.zeros((2, 2), np.float32)

    def states():
        out = []
        for lane in (0, 1):
            model = _Tiny()
            model.lane, model.epochs = lane, 0
            state = engine.TrainState.create(model, 1e-4, 1e-4)
            state.lane = lane
            out.append(state)
        return out

    for module in (engine, multi_seed):
        monkeypatch.setattr(module, "run_train_epoch", fake_train)
        monkeypatch.setattr(module, "run_eval_epoch", fake_eval)
    train, val = _datasets()
    kw = dict(num_epochs=8, batch_size=8, stream_name="s", early_stopping_patience=3)
    lanes, histories, summary = multi_seed.train_multi_seed(states(), train, val, seeds=[1, 2], **kw)
    lane_trained = dict(trained)
    for lane, state in enumerate(states()):
        trained.clear()
        solo, solo_hist = engine.train_model(state, train, val, seed=lane + 1, **kw)
        assert histories[lane]["val_loss"] == solo_hist["val_loss"]
        assert lane_trained[lane] == trained[lane] == len(solo_hist["val_loss"])
        assert lanes[lane].step == solo.step  # the best epoch's state
    assert [r["stopped_early"] for r in summary] == [True, False]
    assert [r["epochs_run"] for r in summary] == [5, 8]
    assert [r["final_lr"] for r in summary] == [float(np.float32(0.5e-4))] * 2  # one plateau cut each


@pytest.mark.parametrize("case", ["seed_sweep", "cv_results", "edges"])
def test_table_csv_matches_pandas(tmp_path, case):
    """``write_table_csv`` writes the bytes of ``pd.DataFrame(rows).to_csv(
    index=False)``, the JAX package's writer of both tables."""
    if case == "seed_sweep":
        rows = [{"seed": 42 + i, "best_val_loss": v, "epochs_run": e, "stopped_early": s, "final_lr": lr,
                 "selected": i == 1}
                for i, (v, e, s, lr) in enumerate([(0.6931471805599453, 3, False, 1e-4),
                                                   (0.123456789, 5, True, 5e-05), (1 / 3, 10, False, 2.5e-05)])]
    elif case == "cv_results":
        rows = [{"fold": f, "n_train": 33 + f, "n_val": 17 - f, "best_val_loss": 0.5 + f / 7, "val_acc": 0.625,
                 "val_f1": 0.6 + f / 9, "epochs_run": 4, "stopped_early": f == 1} for f in range(3)]
        stats = ("best_val_loss", "val_acc", "val_f1")
        df = pd.DataFrame(rows)
        rows.append({"fold": "mean", **{k: float(df[k].mean()) for k in stats}})
        rows.append({"fold": "std", **{k: float(df[k].std(ddof=0)) for k in stats}})
    else:
        rows = [{"a": 1e-05, "b": 100.0, "c": None, "d": "x", "e": 7}, {"a": math.nan, "b": 1e21, "c": 3, "e": 8},
                {"a": 2.5, "b": -0.0, "c": 4, "d": "y,z", "e": 9, "f": True}]
    want = tmp_path / "want.csv"
    pd.DataFrame(rows).to_csv(want, index=False)
    got = tmp_path / "got.csv"
    supervised.write_table_csv(got, rows)
    assert got.read_bytes() == want.read_bytes()


def test_cv_statistics_match_pandas():
    """The mean and ddof-0 std rows: pandas' numbers, bit for bit."""
    rng = np.random.default_rng(4)
    for k in (2, 3, 5, 10):
        values = rng.random(k)
        df = pd.DataFrame({"v": values})
        col = np.array(values.tolist(), np.float64)
        assert float(col.mean()) == float(df["v"].mean())
        assert float(col.std(ddof=0)) == float(df["v"].std(ddof=0))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 7 + 7 image 64² JPEG tree."""
    from PIL import Image

    root = tmp_path_factory.mktemp("fanout")
    gen = np.random.default_rng(3)
    for bucket in ("cancer", "normal"):
        d = root / "avec_labels" / bucket
        d.mkdir(parents=True)
        for i in range(7):
            Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(d / f"{bucket}_{i:02d}.jpg")
    return root / "avec_labels"


def test_seed_fanout_keeps_and_saves_the_best_lane(tree, tmp_path):
    cfg = TrainingConfig(strong_data_dir=tree, device="cpu", image_size=SIZE, batch_size=4, baseline_epochs=2,
                         num_seeds=3, output_dir=tmp_path / "o", num_workers=1)
    device = torch.device("cpu")
    datasets, _classes, _splits = supervised.prepare_datasets(cfg, device)
    state, history, seconds = supervised.train_baseline_multi_seed(cfg, datasets, 2, device)
    rows = pd.read_csv(cfg.artifacts.seed_sweep_csv)
    assert rows.columns.tolist() == ["seed", "best_val_loss", "epochs_run", "stopped_early", "final_lr", "selected"]
    assert rows["seed"].tolist() == [42, 43, 44] and rows["selected"].sum() == 1 and seconds > 0
    best = int(rows["best_val_loss"].idxmin())
    assert bool(rows["selected"][best]) and min(history["val_loss"]) == rows["best_val_loss"][best]
    saved = build_model("resnet18", num_classes=2)
    load_checkpoint(cfg.artifacts.baseline_checkpoint, saved)
    for name, value in state.model.state_dict().items():
        assert torch.equal(saved.state_dict()[name], value), name


def test_cross_validation_rows_and_folds(tree, tmp_path):
    cfg = TrainingConfig(strong_data_dir=tree, device="cpu", image_size=SIZE, batch_size=4, baseline_epochs=2,
                         cv_folds=3, output_dir=tmp_path / "o", num_workers=1)
    device = torch.device("cpu")
    datasets, _classes, _splits = supervised.prepare_datasets(cfg, device)
    rows = supervised.run_cross_validation(cfg, datasets, 2, device)
    pool = len(datasets["train"]) + len(datasets["val"])
    folds = rows[:3]
    assert [r["fold"] for r in rows] == [0, 1, 2, "mean", "std"]
    assert sum(r["n_val"] for r in folds) == pool and all(r["n_train"] + r["n_val"] == pool for r in folds)
    assert rows[3]["val_acc"] == pytest.approx(np.mean([r["val_acc"] for r in folds]))
    written = pd.read_csv(cfg.artifacts.cv_results_csv)
    assert written.columns.tolist() == ["fold", "n_train", "n_val", "best_val_loss", "val_acc", "val_f1",
                                        "epochs_run", "stopped_early"]
    np.testing.assert_allclose(written["best_val_loss"], [r["best_val_loss"] for r in rows])
    with pytest.raises(ValueError, match=r"--cv-folds must be >= 2 \(or 0 to disable\), got 1"):
        supervised.run_supervised(TrainingConfig(strong_data_dir=tree, device="cpu", cv_folds=1))
