"""The port's semi-supervised pipeline against the JAX package, on the CPU.

Pseudo-labelling and the frozen-backbone train step run on carried weights
in both packages (ResNet-18 at full depth, 32²–48² images). The pipeline runs
end to end on a small seeded JPEG tree, once per package, and the port's
artifacts are held to the JAX run's: CSV headers and JSON keys equal, the
checkpoints loadable, and ``ssip_tpu``'s threshold sweep reads the port's
outputs.
"""

import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from src import semi_supervised_training as jax_cli
from ssip_tpu.models.resnet import ResNet18
from ssip_tpu.pipelines import semi_supervised as jsemi
from ssip_tpu.pipelines.sweep import SweepConfig, run_sweep
from ssip_tpu.pipelines.train_config import TrainingConfig as JaxTrainingConfig
from ssip_tpu.train import engine as jeng
from ssip_tpu.train import pseudo_label as jpseudo
from ssip_tpu_torch.cli import semi_supervised_training as cli
from ssip_tpu_torch.data.discovery import unlabeled_files
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables, state_dict_from_flax
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.models.resnet import build_resnet
from ssip_tpu_torch.models.vit import VisionTransformer
from ssip_tpu_torch.ops.augment import augment_coeffs
from ssip_tpu_torch.pipelines import semi_supervised as semi
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.train import engine, pseudo_label
from ssip_tpu_torch.train.checkpoints import load_checkpoint
from ssip_tpu_torch.train.data import load_unlabeled_dataset
from tests.test_torch_train import _kink_free, _rel
from tests.test_torch_vit import SMALL, _small_tree
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

SIZE = 32
LR, WD = 1e-3, 1e-1  # a decay large enough to show on a frozen weight, if it reached one


def _eval_variables():
    """The seeded tree with running statistics that are not the init's."""
    variables = seeded_init_host("resnet18", 42, 2)
    variables["batch_stats"]["bn1"]["var"] = np.random.default_rng(2).uniform(0.5, 1.5, 64).astype(np.float32)
    return variables


@pytest.mark.parametrize("n", [7, 8, 0])
def test_pool_probabilities_match_jax(n):
    """Softmax over the pool ≤ 1e-5 of the JAX values, a short last batch and
    the empty pool (``[0, C]``) included."""
    variables = _eval_variables()
    pool = np.random.default_rng(n).integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)
    want = jpseudo.pool_probabilities(ResNet18(num_classes=2).apply, variables, jnp.asarray(pool), 4)
    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    got = pseudo_label.pool_probabilities(model, torch.from_numpy(pool), 4)
    assert got.shape == want.shape == (n, 2) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_generate_pseudo_labels_match_jax_index_for_index():
    variables = _eval_variables()
    pool = np.random.default_rng(5).integers(0, 256, (24, SIZE, SIZE, 3), np.uint8)
    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    conf = pseudo_label.pool_probabilities(model, torch.from_numpy(pool), 8).max(axis=1)
    gaps = np.diff(np.sort(conf))
    threshold = float(np.sort(conf)[np.argmax(gaps)] + gaps.max() / 2)  # in the widest gap: no row sits at it
    want = jpseudo.generate_pseudo_labels(ResNet18(num_classes=2).apply, variables, jnp.asarray(pool), 8, threshold)
    got = pseudo_label.generate_pseudo_labels(model, torch.from_numpy(pool), 8, threshold)
    assert 0 < len(got[0]) < 24
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    none = pseudo_label.generate_pseudo_labels(model, torch.from_numpy(pool), 8, 1.1)
    assert [len(a) for a in none] == [0, 0, 0]


def _jax_head_mask(params):
    """The JAX pipeline's mask, as ``run_pipeline`` builds it."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: str(path[0].key if hasattr(path[0], "key") else path[0]) == "fc", params
    )


@pytest.mark.parametrize("arch", ["resnet18", "vit_small"])
def test_head_only_mask_selects_what_the_jax_mask_selects(arch):
    if arch == "resnet18":
        params = seeded_init_host("resnet18", 42, 2)["params"]
        model = build_resnet("resnet18", num_classes=2)
    else:
        params = _small_tree(2)["params"]
        model = VisionTransformer(num_classes=2, compute_dtype=torch.float32, image_size=SIZE, **SMALL)
    mask = _jax_head_mask(params)
    marked = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32), params, mask)
    want = {name: bool(value.all()) for name, value in state_dict_from_flax({"params": marked}).items()}
    got = engine.head_only_mask(model)
    assert got == want and sum(got.values()) == 2  # the head's weight and bias
    with pytest.raises(ValueError, match="no classifier head"):
        engine.head_only_mask(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="exactly the model's parameters"):
        with engine.only_trainable(model, {"fc.weight": True}):
            pass


def test_masked_train_step_matches_jax():
    """The weak-pretrain step: only the head moves (≤ 1e-6 of the JAX
    values), frozen parameters stay bit for bit (no update, no weight decay,
    though the decay is 0.1), BatchNorm running statistics move as in JAX
    (≤ 1e-5 relative), loss ≤ 1e-5 relative."""
    size = 48
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, size, size, 3), np.uint8)
    labels = rng.integers(0, 2, 8)
    valid = np.arange(8) < 6
    key = jax.random.PRNGKey(3)
    k_flip, k_rot = jax.random.split(key)
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (8,)))
    angles = np.array(jax.random.uniform(k_rot, (8,), minval=-10.0, maxval=10.0) * (jnp.pi / 180.0))
    variables = _kink_free(seeded_init_host("resnet18", 42, 2))

    state = jeng.TrainState.create(
        ResNet18(num_classes=2).apply, variables["params"], variables["batch_stats"], jeng.make_optimizer(LR, WD)
    )
    step = jeng.make_train_step(augment=True, trainable_mask=_jax_head_mask(variables["params"]))
    new_state, loss_j, pred_j = step(state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid), key)

    model = build_resnet("resnet18", num_classes=2)
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    port_state = engine.TrainState.create(model, LR, WD)
    loss_t, pred_t = engine.train_step(
        port_state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(augment_coeffs(flip, angles)), engine.head_only_mask(model),
    )
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))
    after = model.state_dict()
    want_params = state_dict_from_flax({"params": jax.device_get(new_state.params)})
    for name, p in model.named_parameters():
        assert p.requires_grad  # restored after the step
        if name.startswith("fc."):
            assert p.grad is not None and not torch.equal(after[name], before[name])
            np.testing.assert_allclose(after[name].numpy(), want_params[name], rtol=0, atol=1e-6, err_msg=name)
        else:
            assert p.grad is None and torch.equal(after[name], before[name]), name
            np.testing.assert_array_equal(want_params[name], before[name].numpy(), err_msg=name)
    stats = state_dict_from_flax({"batch_stats": jax.device_get(new_state.batch_stats)})
    for name, value in stats.items():
        assert _rel(after[name].numpy(), value) <= 1e-5, name
    assert not torch.equal(after["layer4.1.bn2.running_mean"], before["layer4.1.bn2.running_mean"])


def test_resolve_cohort_paths_match_jax_on_the_four_path_forms(tmp_path):
    weak = tmp_path / "data" / "sans_label"
    weak.mkdir(parents=True)
    for name in "abcde":
        (weak / f"{name}.jpg").touch()
    cohort = tmp_path / "cohort.csv"
    cohort.write_text(
        "path,cluster\n"
        f"{weak / 'a.jpg'},0\n"  # absolute
        "b.jpg,1\n"  # a bare file name
        "sans_label/c.jpg,0\n"  # prefixed with the weak directory's name
        "sub/../d.jpg,1\n"  # relative to the weak directory
        "elsewhere/z.jpg,1\n"
    )
    want = jsemi.resolve_cohort_paths(cohort, weak)
    got = semi.resolve_cohort_paths(cohort, weak)
    assert got == want
    assert {p.name for p in unlabeled_files(weak) if str(p.resolve()) in got} == {"a.jpg", "b.jpg", "c.jpg", "d.jpg"}
    (tmp_path / "no_path.csv").write_text("file\nx.jpg\n")
    for fn in (jsemi.resolve_cohort_paths, semi.resolve_cohort_paths):
        with pytest.raises(ValueError, match="'path' column"):
            fn(tmp_path / "no_path.csv", weak)
        with pytest.raises(FileNotFoundError, match="Cohort CSV not found"):
            fn(tmp_path / "missing.csv", weak)


def test_load_unlabeled_dataset_filters_before_decode_and_drops_failures(tmp_path, caplog):
    from PIL import Image

    weak = tmp_path / "sans_label"
    weak.mkdir()
    gen = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(gen.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(weak / f"u{i}.png")
    (weak / "broken.jpg").write_bytes(b"not an image")
    (weak / "notes.txt").write_text("left out by its suffix")
    with caplog.at_level("WARNING"):
        images, paths = load_unlabeled_dataset(weak, SIZE, torch.device("cpu"), num_threads=2)
    assert images.shape == (4, SIZE, SIZE, 3) and images.dtype == torch.uint8
    assert [p.name for p in paths] == ["u0.png", "u1.png", "u2.png", "u3.png"]
    assert "Dropped 1 undecodable" in caplog.text
    kept, kept_paths = load_unlabeled_dataset(weak, SIZE, torch.device("cpu"), keep_paths=[weak / "u2.png", weak / "u0.png"])
    assert [p.name for p in kept_paths] == ["u0.png", "u2.png"] and torch.equal(kept, images[[0, 2]])
    with pytest.raises(RuntimeError, match="No unlabeled images"):
        load_unlabeled_dataset(weak, SIZE, torch.device("cpu"), keep_paths=[tmp_path / "other.jpg"])
    with pytest.raises(RuntimeError, match="failed to decode"):
        load_unlabeled_dataset(weak, SIZE, torch.device("cpu"), keep_paths=[weak / "broken.jpg"])


ARTIFACTS = (
    "models/baseline_resnet18.pt", "models/semi_resnet18.pt", "tables/results_comparison.csv",
    "tables/results_comparison_detailed.csv", "tables/unlabeled_predictions_semi.csv",
    "notes/training_history.json", "notes/operating_point.json",
)
HISTORY_KEYS = ["train_acc", "train_f1", "train_loss", "val_acc", "val_f1", "val_loss"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pipeline on a 10 + 10 image 64² JPEG tree with a pool of 14, at
    32² on the CPU: the port with the FixMatch fine-tune, an EMA teacher and
    a cohort CSV that keeps 10 of the 14; the port plain, without a target
    recall; and the JAX package once, for the schemas."""
    from PIL import Image

    root = tmp_path_factory.mktemp("semi")
    gen = np.random.default_rng(0)
    for bucket in ("cancer", "normal"):
        d = root / "avec_labels" / bucket
        d.mkdir(parents=True)
        for i in range(10):
            Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(d / f"{bucket}_{i:02d}.jpg")
    weak = root / "sans_label"
    weak.mkdir()
    for i in range(14):
        Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(weak / f"unlabeled_{i:02d}.jpg")
    cohort = root / "cohort.csv"
    cohort.write_text("path\n" + "".join(f"unlabeled_{i:02d}.jpg\n" for i in range(10)))
    common = dict(
        strong_data_dir=root / "avec_labels", weak_data_dir=weak, device="cpu", image_size=SIZE, batch_size=4,
        baseline_epochs=1, weak_pretrain_epochs=1, pseudo_label_threshold=0.5,
    )
    fix = dict(output_dir=root / "out_fixmatch", finetune_epochs=2, target_recall=0.9, unlabeled_cohort_csv=cohort,
               consistency_weight=1.0, consistency_threshold=0.5, ema_decay=0.9, **common)
    plain = dict(output_dir=root / "out_plain", finetune_epochs=1, **common)
    results = {"fixmatch": semi.run_pipeline(TrainingConfig(**fix)), "plain": semi.run_pipeline(TrainingConfig(**plain))}
    jax_out = root / "out_jax"
    jsemi.run_pipeline(JaxTrainingConfig(**{**common, "output_dir": jax_out, "finetune_epochs": 1,
                                            "target_recall": 0.9, "unlabeled_cohort_csv": cohort, "num_workers": 1}))
    return root, results, jax_out


def _header(path):
    with open(path, newline="") as fh:
        return next(csv.reader(fh))


def _key_tree(value):
    """The keys of nested dicts (lists and scalars are leaves)."""
    return {k: _key_tree(v) for k, v in value.items()} if isinstance(value, dict) else None


@pytest.mark.parametrize("run", ["fixmatch", "plain"])
def test_run_pipeline_writes_the_jax_artifact_set(runs, run):
    root, results, jax_out = runs
    out = root / f"out_{run}"
    thresholded = run == "fixmatch"
    for rel in ARTIFACTS:
        assert (out / rel).is_file() == (thresholded or rel != "tables/unlabeled_predictions_semi.csv"), rel
    # the JAX run's nine figures, by name (tests/test_torch_plots.py holds their pixels)
    assert sorted(p.name for p in (out / "figures").iterdir()) == sorted(p.name for p in (jax_out / "figures").iterdir())
    assert set(results[run]) == {"baseline_thresholded", "semi_thresholded"}

    for rel in ("tables/results_comparison.csv", "tables/results_comparison_detailed.csv"):
        assert _header(out / rel) == _header(jax_out / rel), rel
        got, want = pd.read_csv(out / rel, index_col=0), pd.read_csv(jax_out / rel, index_col=0)
        assert list(got.index) == list(want.index)
        if thresholded:  # the same cells are empty, column by column
            pd.testing.assert_frame_equal(got.isna(), want.isna())
    detailed = pd.read_csv(out / "tables/results_comparison_detailed.csv", index_col=0)
    assert detailed.loc["semi_argmax", ["threshold", "min_precision", "max_fpr"]].isna().all()
    assert (detailed[["TP", "FP", "TN", "FN"]].sum(axis=1) == 4).all()  # the test split of 20 images

    payload = json.loads((out / "notes/training_history.json").read_text())
    want_payload = json.loads((jax_out / "notes/training_history.json").read_text())
    assert _key_tree(payload) == _key_tree(want_payload)
    assert list(payload) == list(want_payload)
    assert payload["splits"] == want_payload["splits"] and payload["arch"] == "resnet18"
    assert 0 < payload["pseudo_label_count"] <= (10 if thresholded else 14)
    for phase, epochs in (("baseline", 1), ("semi_pretrain", 1), ("semi_finetune", 2 if thresholded else 1)):
        hist = payload[phase]
        assert sorted(hist) == HISTORY_KEYS  # the FixMatch keys are cut before the file is written
        assert len(hist["val_loss"]) == epochs and np.isfinite(hist["train_loss"] + hist["val_loss"]).all()

    op = json.loads((out / "notes/operating_point.json").read_text())
    want_op = json.loads((jax_out / "notes/operating_point.json").read_text())
    assert list(op) == list(want_op)
    assert op["model"] == "semi_supervised_resnet18" and op["classes"] == ["cancer", "normal"]
    assert (op["policy"] == "disabled") == (not thresholded) and (op["threshold"] is None) == (not thresholded)

    if thresholded:
        triage, want_triage = (pd.read_csv(o / "tables/unlabeled_predictions_semi.csv") for o in (out, jax_out))
        assert list(triage.columns) == list(want_triage.columns)
        assert len(triage) == 14  # the whole pool, though the cohort kept 10
        assert [p.rsplit("/", 1)[1] for p in triage["path"]] == [p.rsplit("/", 1)[1] for p in want_triage["path"]]
        assert triage["flagged"].dtype == want_triage["flagged"].dtype == bool
        assert (triage["flagged"] == (triage["prob_positive"] >= op["threshold"])).all()
    for name in ("baseline_resnet18.pt", "semi_resnet18.pt"):
        load_checkpoint(out / "models" / name, build_model("resnet18", num_classes=2))


def test_jax_threshold_sweep_consumes_the_port_outputs(runs):
    root, _, _ = runs
    result = run_sweep(SweepConfig(strong_data_dir=root / "avec_labels", output_dir=root / "out_fixmatch",
                                   model="semi", device="cpu", num_workers=1, batch_size=4, image_size=SIZE))
    rows = pd.read_csv(result["csv"])
    assert len(rows) > 0 and (rows[["TP", "FP", "TN", "FN"]].sum(axis=1) == 4).all()


def test_phase_c_moves_only_the_head_and_the_statistics(runs, monkeypatch):
    """After the weak pretrain only the head's parameters differ from the
    seeded init, while the frozen backbone's BatchNorm running means do."""
    root, _, _ = runs
    seen = {}
    real = engine.train_model

    def spy(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        if kwargs["stream_name"] == "semi_pretrain":
            seen["mask"] = kwargs["trainable_mask"]
            seen["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
            raise _Stop
        return out

    class _Stop(Exception):
        pass

    monkeypatch.setattr(semi, "train_model", spy)
    with pytest.raises(_Stop):
        semi.run_pipeline(TrainingConfig(
            strong_data_dir=root / "avec_labels", weak_data_dir=root / "sans_label", device="cpu", image_size=SIZE,
            batch_size=4, baseline_epochs=1, weak_pretrain_epochs=1, pseudo_label_threshold=0.5,
            output_dir=root / "out_spy"))
    init = build_model("resnet18", num_classes=2)
    load_flax_variables(init, seeded_init_host("resnet18", 42, 2))
    assert seen["mask"] == engine.head_only_mask(init)
    names = {name for name, _ in init.named_parameters()}
    for name, value in init.state_dict().items():
        changed = not torch.equal(seen["state"][name], value)
        if name in names:
            assert changed == name.startswith("fc."), name
        elif name.endswith("running_mean"):
            assert changed, name


@pytest.mark.parametrize(
    "argv,item",
    [
        (["--consistency-weight", "1.0", "--strong-augment", "randaugment"], None),
        (["--resume"], None),
        (["--num-seeds", "2"], None),
        (["--cv-folds", "3"], None),
        (["--mesh-model", "2"], "needs that many processes"),
        (["--fsdp"], None),
        (["--arch", "vit_moe_t16"], None),
    ],
)
def test_cli_refuses_unported_flags(runs, tmp_path, argv, item):
    """``--mesh-model 2`` started as one process is refused before any
    data is read (a model axis needs two processes or more; the missing
    data directory would fail later); the other flags
    (RandAugment, ``--resume``, the fan-outs, the MoE archs, ``--fsdp``)
    run the pipeline for one epoch a phase and write its artifacts:
    the history names the arch, ``--resume`` leaves the three streams'
    snapshots, ``--num-seeds`` the seed sweep and ``--cv-folds`` the CV
    table; RandAugment's FixMatch fine-tune writes the semi checkpoint."""
    if item is None:
        root, out = runs[0], tmp_path / "o"
        cli.main(["--strong-data-dir", str(root / "avec_labels"), "--weak-data-dir", str(root / "sans_label"),
                  "--device", "cpu", "--image-size", str(SIZE), "--batch-size", "4", "--baseline-epochs", "1",
                  "--weak-pretrain-epochs", "1", "--finetune-epochs", "1", "--pseudo-threshold", "0.0",
                  "--output-dir", str(out), *argv])
        payload = json.loads((out / "notes" / "training_history.json").read_text())
        assert payload["arch"] == (argv[1] if argv[0] == "--arch" else "resnet18")
        assert all(np.isfinite(payload[s]["train_loss"]).all() for s in ("baseline", "semi_pretrain", "semi_finetune"))
        for stream in ("baseline", "semi_pretrain", "semi_finetune"):
            assert (out / "models" / "checkpoints" / f"{stream}.torchsnap").exists() == (argv == ["--resume"])
        sweep, cv = out / "tables" / "seed_sweep.csv", out / "tables" / "cv_results.csv"
        assert sweep.exists() == (argv[0] == "--num-seeds") and cv.exists() == (argv[0] == "--cv-folds")
        if argv[0] == "--num-seeds":
            assert [r["seed"] for r in csv.DictReader(sweep.read_text().splitlines())] == ["42", "43"]
        if argv[0] == "--cv-folds":
            assert [r["fold"] for r in csv.DictReader(cv.read_text().splitlines())] == ["0", "1", "2", "mean", "std"]
        assert (out / "models" / "semi_resnet18.pt").is_file()
        return
    with pytest.raises(RuntimeError, match=item):
        cli.main(["--strong-data-dir", str(tmp_path / "missing"), "--weak-data-dir", str(tmp_path / "missing"),
                  "--device", "cpu", *argv])


@pytest.mark.parametrize(
    "argv",
    [[], ["--weak-pretrain-epochs", "2", "--finetune-epochs", "3", "--pseudo-threshold", "0.8",
          "--unlabeled-cohort-csv", "c.csv", "--consistency-weight", "0.5", "--consistency-threshold", "0.9",
          "--ema-decay", "0.999", "--strong-augment", "randaugment", "--compute-dtype", "bfloat16",
          "--arch", "vit_b16", "--target-recall", "0.95"]],
)
def test_cli_flags_and_config_match_the_jax_cli(argv):
    argv = ["--strong-data-dir", "d", "--weak-data-dir", "w", *argv]
    assert vars(cli.parse_args(argv)) == vars(jax_cli.parse_args(argv))
    assert dataclasses.asdict(cli.config_from_args(cli.parse_args(argv))) == dataclasses.asdict(
        jax_cli.config_from_args(jax_cli.parse_args(argv))
    )


def test_pipeline_needs_a_weak_directory(tmp_path):
    with pytest.raises(ValueError, match="requires weak_data_dir"):
        semi.run_pipeline(TrainingConfig(strong_data_dir=tmp_path, device="cpu"))
