"""``--resume`` in the port: interrupted and resumed runs of ``train_model``
and ``train_fixmatch`` against uninterrupted ones, the snapshot file and its
``.best`` sidecar, their failure modes, the driver dict against the JAX
package's, the sharded (DCP) form through both drivers, and the CLIs.
"""

import json
import logging
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.models import ResNet18
from ssip_tpu.models.host_init import seeded_init_host as jax_seeded_init_host
from ssip_tpu.train import checkpoints as jax_checkpoints
from ssip_tpu.train import engine as jeng
from ssip_tpu_torch.cli import semi_supervised_training as semi_cli
from ssip_tpu_torch.cli import supervised_training as training_cli
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.train import checkpoints, consistency, engine
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

IMG = 32
COMMON = dict(batch_size=8, seed=42, stream_name="resume_test", balanced=True, augment=True,
              early_stopping_patience=10)
FIXMATCH = dict(batch_size=8, unlabeled_batch_size=8, seed=42, stream_name="semi_finetune",
                consistency_weight=1.0, confidence_threshold=0.5, early_stopping_patience=10)


@pytest.fixture(autouse=True)
def _remove_tmp_path(request):
    """Each test's tmp_path goes when the test ends: a full-width snapshot
    is 134 MB."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def _state(lr: float = 1e-3) -> engine.TrainState:
    model = build_model("resnet18", num_classes=2)
    load_flax_variables(model, seeded_init_host("resnet18", 0, 2))
    return engine.TrainState.create(model, lr, 1e-4)


def _data(seed: int = 0, n: int = 16):
    rng = np.random.default_rng(seed)
    labels = np.r_[np.zeros(n // 2, np.int64), np.ones(n // 2, np.int64)]
    imgs = np.where(labels[:, None, None, None] == 1, rng.integers(160, 255, (n, IMG, IMG, 3)),
                    rng.integers(0, 96, (n, IMG, IMG, 3))).astype(np.uint8)
    return engine.DeviceDataset.create(torch.from_numpy(imgs), labels)


def _pool(n: int = 24):
    return torch.from_numpy(np.random.default_rng(9).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8))


def _assert_states_equal(a: engine.TrainState, b: engine.TrainState) -> None:
    assert a.step == b.step
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for key, value in oa["state"].items():
        for leaf, tensor in value.items():
            assert torch.equal(tensor, ob["state"][key][leaf]), (key, leaf)


def test_train_model_resumed_equals_uninterrupted(tmp_path):
    """4 epochs straight against 2 epochs, then a resume to 4: the history
    and the returned state (parameters, BN statistics, AdamW's moments and
    learning rate, the step) bit for bit. The plateau rule lowers the
    learning rate across the cut."""
    data, val = _data(0), _data(1)
    common = dict(COMMON, plateau_patience=0)
    full, full_hist = engine.train_model(_state(), data, val, num_epochs=4, **common)
    snap = tmp_path / "baseline.torchsnap"
    engine.train_model(_state(), data, val, num_epochs=2, resume_path=snap, **common)
    resumed, hist = engine.train_model(_state(), data, val, num_epochs=4, resume_path=snap, **common)
    assert hist == full_hist and len(hist["train_loss"]) == 4
    _assert_states_equal(resumed, full)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["baseline.torchsnap", "baseline.torchsnap.best"]


def test_train_fixmatch_resumed_equals_uninterrupted_without_ema(tmp_path):
    data, val, pool = _data(0), _data(1), _pool()
    full, full_hist = consistency.train_fixmatch(_state(), data, val, pool, num_epochs=3, **FIXMATCH)
    snap = tmp_path / "semi_finetune.torchsnap"
    consistency.train_fixmatch(_state(), data, val, pool, num_epochs=1, resume_path=snap, **FIXMATCH)
    resumed, hist = consistency.train_fixmatch(_state(), data, val, pool, num_epochs=3, resume_path=snap, **FIXMATCH)
    assert hist == full_hist and len(hist["consistency_loss"]) == 3
    _assert_states_equal(resumed, full)


def test_ema_teacher_reseeds_from_the_best_sidecar(tmp_path, monkeypatch):
    """With an EMA teacher the resumed run's teacher starts at the ``.best``
    sidecar's parameters (EMA parameters), the JAX package's
    approximation; two resumes from the same snapshot are equal."""
    data, val, pool = _data(0), _data(1), _pool()
    kw = dict(FIXMATCH, ema_decay=0.9)
    snap = tmp_path / "a" / "semi_finetune.torchsnap"
    consistency.train_fixmatch(_state(), data, val, pool, num_epochs=1, resume_path=snap, **kw)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    best, _ = checkpoints.load_train_snapshot(str(snap) + ".best")
    live, _ = checkpoints.load_train_snapshot(snap)
    seen = []
    real_step = consistency.fixmatch_step

    def spy(state, ema_params, *args, **kwargs):
        if not seen:
            seen.append({k: v.clone() for k, v in ema_params.items()})
        return real_step(state, ema_params, *args, **kwargs)

    monkeypatch.setattr(consistency, "fixmatch_step", spy)
    one, hist_one = consistency.train_fixmatch(_state(), data, val, pool, num_epochs=2, resume_path=snap, **kw)
    names = [name for name, _ in one.model.named_parameters()]
    assert sorted(seen[0]) == sorted(names)
    for name in names:
        assert torch.equal(seen[0][name], best.model[name]), name
    assert any(not torch.equal(best.model[n], live.model[n]) for n in names)  # the teacher is not the student
    monkeypatch.setattr(consistency, "fixmatch_step", real_step)
    two, hist_two = consistency.train_fixmatch(_state(), data, val, pool, num_epochs=2,
                                               resume_path=tmp_path / "b" / "semi_finetune.torchsnap", **kw)
    assert hist_one == hist_two
    _assert_states_equal(one, two)


def test_finished_snapshot_ends_the_run_at_once(tmp_path, monkeypatch):
    data, val = _data(0), _data(1)
    snap = tmp_path / "s.torchsnap"
    state1, hist1 = engine.train_model(_state(), data, val, num_epochs=2, resume_path=snap, **COMMON)
    snapshot, driver = checkpoints.load_train_snapshot(snap)
    checkpoints.save_train_snapshot(snap, snapshot, {**driver, "finished": True})
    monkeypatch.setattr(engine, "run_train_epoch", lambda *a, **k: pytest.fail("trained past a finished snapshot"))
    state2, hist2 = engine.train_model(_state(), data, val, num_epochs=5, resume_path=snap, **COMMON)
    assert hist2 == hist1
    _assert_states_equal(state2, state1)


def test_corrupt_snapshot_warns_and_starts_fresh(tmp_path, caplog):
    data, val = _data(0), _data(1)
    snap = tmp_path / "s.torchsnap"
    snap.write_bytes(b"garbage")
    with caplog.at_level(logging.WARNING):
        state, hist = engine.train_model(_state(), data, val, num_epochs=2, resume_path=snap, **COMMON)
    assert "Unreadable resume snapshot" in caplog.text
    fresh, fresh_hist = engine.train_model(_state(), data, val, num_epochs=2, **COMMON)
    assert hist == fresh_hist
    _assert_states_equal(state, fresh)
    _, driver = checkpoints.load_train_snapshot(snap)  # overwritten by a good one
    assert driver["epoch"] == 1


def test_one_file_committed_by_rename_and_no_tmp_left(tmp_path, monkeypatch):
    """The snapshot is written under a temporary name and renamed; a failed
    write leaves the previous snapshot whole."""
    data, val = _data(0), _data(1)
    snap = tmp_path / "s.torchsnap"
    engine.train_model(_state(), data, val, num_epochs=1, resume_path=snap, **COMMON)
    before = snap.read_bytes()
    assert not list(tmp_path.glob("*.tmp"))
    assert before.startswith(b"SSIPTORCHSNAP1\n")

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints.os, "replace", broken)
    with pytest.raises(OSError):
        checkpoints.save_train_snapshot(snap, checkpoints.Snapshot.take(_state()), {"epoch": 9})
    assert snap.read_bytes() == before


def test_best_sidecar_warnings(tmp_path, caplog):
    """An unreadable ``.best`` warns and the current state stands in; a
    missing one with a finite recorded best warns the same way."""
    data, val = _data(0), _data(1)
    snap = tmp_path / "s.torchsnap"
    engine.train_model(_state(), data, val, num_epochs=1, resume_path=snap, **COMMON)
    best = tmp_path / "s.torchsnap.best"
    best.write_bytes(b"broken")
    with caplog.at_level(logging.WARNING):
        driver, _ = checkpoints.restore_resume_state(snap, _state())
    assert driver is not None and "Unreadable best-state snapshot" in caplog.text
    best.unlink()
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        driver, _ = checkpoints.restore_resume_state(snap, _state())
    assert np.isfinite(driver["best_val_loss"]) and "missing (historic best" in caplog.text


def test_driver_dict_matches_the_jax_snapshot_and_neither_package_misreads_the_other(tmp_path, caplog):
    """One epoch of the same run in each package: the driver dicts have the
    same keys and history keys, and the ``.best`` sidecar's driver is
    ``{"epoch": 0}`` in both. Each package calls the other's snapshot
    unreadable."""
    rng = np.random.default_rng(0)
    labels = np.r_[np.zeros(4, np.int64), np.ones(4, np.int64)]
    imgs = rng.integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8)
    jmodel = ResNet18(num_classes=2)
    v = jax_seeded_init_host(jmodel, 0, (1, IMG, IMG, 3))
    jstate = jeng.TrainState.create(apply_fn=jmodel.apply, params=v["params"], batch_stats=v["batch_stats"],
                                    tx=jeng.make_optimizer(1e-3, 1e-4))
    jdata = jeng.DeviceDataset.create(jnp.asarray(imgs), labels)
    jsnap = tmp_path / "jax.msgpack"
    jeng.train_model(jstate, jdata, jdata, num_epochs=1, resume_path=jsnap, **COMMON)
    data = engine.DeviceDataset.create(torch.from_numpy(imgs), labels)
    snap = tmp_path / "port.torchsnap"
    engine.train_model(_state(), data, data, num_epochs=1, resume_path=snap, **COMMON)

    def jax_driver(path):
        raw = path.read_bytes()
        off = len(b"SSIPSNAP1\n")
        n = int.from_bytes(raw[off : off + 8], "big")
        return json.loads(raw[off + 8 : off + 8 + n])

    want, got = jax_driver(jsnap), checkpoints.load_train_snapshot(snap)[1]
    assert sorted(got) == sorted(want) and sorted(got["history"]) == sorted(want["history"])
    assert (got["epoch"], got["finished"]) == (want["epoch"], want["finished"]) == (0, False)
    assert checkpoints.load_train_snapshot(str(snap) + ".best")[1] == jax_driver(tmp_path / "jax.msgpack.best")
    with caplog.at_level(logging.WARNING):
        driver, _ = checkpoints.restore_resume_state(jsnap, _state())
    assert driver is None and "Unreadable resume snapshot" in caplog.text
    _, jdriver, _ = jax_checkpoints.restore_resume_state(snap, jstate)
    assert jdriver is None


@pytest.mark.parametrize("how", ["env", "directory"])
def test_sharded_snapshots_are_refused_with_their_item(how, tmp_path, monkeypatch, caplog):
    """The name is older than the feature: the sharded form
    (``train/orbax_ckpt.py``, ROADMAP item 22's data axis) now runs through
    both drivers. With ``SSIP_SNAPSHOT_FORMAT=orbax``, or at a snapshot path
    that is already a directory (an empty one is an unreadable snapshot: a
    warning, a fresh start), each stream leaves a directory snapshot and its
    ``.best`` sidecar after one epoch, and the run resumed from it to two
    epochs equals an uninterrupted two-epoch run bit for bit: the history
    and the returned state (parameters, BN statistics, AdamW's moments and
    learning rate, the step), for ``train_model`` and ``train_fixmatch``."""
    data, val, pool = _data(0), _data(1), _pool()
    snaps = {"train": tmp_path / "s.torchsnap", "fixmatch": tmp_path / "f.torchsnap"}
    if how == "env":
        monkeypatch.setenv("SSIP_SNAPSHOT_FORMAT", "orbax")
    else:
        for snap in snaps.values():
            snap.mkdir()
    with caplog.at_level(logging.WARNING):
        engine.train_model(_state(), data, val, num_epochs=1, resume_path=snaps["train"], **COMMON)
        consistency.train_fixmatch(_state(), data, val, pool, num_epochs=1, resume_path=snaps["fixmatch"], **FIXMATCH)
    assert ("Unreadable resume snapshot" in caplog.text) == (how == "directory")
    for snap in snaps.values():
        assert snap.is_dir() and (snap / "driver.json").exists() and (tmp_path / f"{snap.name}.best").is_dir()
    straight, straight_hist = engine.train_model(_state(), data, val, num_epochs=2, **COMMON)
    resumed, hist = engine.train_model(_state(), data, val, num_epochs=2, resume_path=snaps["train"], **COMMON)
    assert hist == straight_hist and len(hist["train_loss"]) == 2
    _assert_states_equal(resumed, straight)
    straight, straight_hist = consistency.train_fixmatch(_state(), data, val, pool, num_epochs=2, **FIXMATCH)
    resumed, hist = consistency.train_fixmatch(_state(), data, val, pool, num_epochs=2,
                                               resume_path=snaps["fixmatch"], **FIXMATCH)
    assert hist == straight_hist and len(hist["consistency_loss"]) == 2
    _assert_states_equal(resumed, straight)


def _jpeg_tree(root, per_class: int = 6, pool: int = 6):
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls in ("cancer", "normal"):
        d = root / "avec_labels" / cls
        d.mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(d / f"{cls}_{i}.jpg")
    (root / "sans_label").mkdir()
    for i in range(pool):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(root / "sans_label" / f"u_{i}.jpg")
    return root


def test_the_clis_resume(tmp_path, capsys):
    """The supervised CLI with ``--resume``: 1 epoch, then a resumed run to
    2 equal to a straight 2-epoch run; the semi-supervised CLI snapshots
    its three streams under the JAX package's directory and names."""
    data = _jpeg_tree(tmp_path / "data")
    common = ["--strong-data-dir", str(data / "avec_labels"), "--device", "cpu", "--image-size", "32",
              "--batch-size", "4"]
    out = tmp_path / "r"
    training_cli.main([*common, "--output-dir", str(out), "--resume", "--baseline-epochs", "1"])
    training_cli.main([*common, "--output-dir", str(out), "--resume", "--baseline-epochs", "2"])
    straight = tmp_path / "s"
    training_cli.main([*common, "--output-dir", str(straight), "--baseline-epochs", "2"])
    resumed = json.loads((out / "notes" / "training_history.json").read_text())["baseline"]
    assert resumed == json.loads((straight / "notes" / "training_history.json").read_text())["baseline"]
    cfg = TrainingConfig(strong_data_dir=data, output_dir=out, resume=True)
    assert cfg.resume_path("baseline").exists()
    semi = tmp_path / "semi"
    semi_cli.main([*common, "--weak-data-dir", str(data / "sans_label"), "--output-dir", str(semi), "--resume",
                   "--baseline-epochs", "1", "--weak-pretrain-epochs", "1", "--finetune-epochs", "1",
                   "--pseudo-threshold", "0.0", "--consistency-weight", "1.0", "--consistency-threshold", "0.0"])
    cfg = TrainingConfig(strong_data_dir=data, output_dir=semi, resume=True)
    for stream in ("baseline", "semi_pretrain", "semi_finetune"):
        assert cfg.resume_path(stream).exists(), stream
    capsys.readouterr()
