"""The port's own copies of the JAX package's jax-free modules, each held to
its original on seeded inputs: discovery, the artifact registry, the training
config, logging and the threshold policy.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest

from ssip_tpu.data import discovery as jdiscovery
from ssip_tpu.ops import thresholds as jthresholds
from ssip_tpu.pipelines.train_config import TrainingConfig as JaxTrainingConfig
from ssip_tpu.runtime import logging as jlogging
from ssip_tpu.runtime.artifacts import ArtifactRegistry as JaxArtifactRegistry
from ssip_tpu_torch.data import discovery
from ssip_tpu_torch.ops import thresholds
from ssip_tpu_torch.pipelines.train_config import TrainingConfig
from ssip_tpu_torch.runtime import logging as port_logging
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry


@pytest.fixture()
def seeded_tree(tmp_path):
    """A dataset tree with nested class folders, non-image files and fixed
    sizes and mtimes, made from a seed."""
    rng = np.random.default_rng(11)
    rels = [
        "avec_labels/normal/n_2.jpg", "avec_labels/normal/sub/n_1.png", "avec_labels/cancer/c_b.jpeg",
        "avec_labels/cancer/c_a.JPG", "avec_labels/cancer/notes.txt", "sans_label/u_3.bmp",
        "sans_label/u_1.jpg", "sans_label/deep/u_2.jpg",
    ]
    for i, rel in enumerate(rels):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(rng.bytes(int(rng.integers(1, 500))))
        os.utime(path, (1_700_000_000 + 7 * i, 1_700_000_000 + 13 * i))
    return tmp_path


def _as_tuples(records):
    return [(str(r.absolute_path), str(r.relative_path), r.bucket, r.label) for r in records]


def test_discovery_records_order_and_digest_match(seeded_tree):
    want = jdiscovery.discover_image_records(seeded_tree)
    got = discovery.discover_image_records(seeded_tree)
    assert _as_tuples(got) == _as_tuples(want) and len(got) == 8
    assert discovery.compute_dataset_digest(got) == jdiscovery.compute_dataset_digest(want)
    assert discovery.compute_dataset_digest(got[::-1]) == jdiscovery.compute_dataset_digest(want)  # order-free
    assert (discovery.LABELED_BUCKET, discovery.UNLABELED_BUCKET, discovery.IMAGE_SUFFIXES) == (
        jdiscovery.LABELED_BUCKET, jdiscovery.UNLABELED_BUCKET, jdiscovery.IMAGE_SUFFIXES)


def test_labeled_folder_matches(seeded_tree):
    want = jdiscovery.labeled_folder(seeded_tree / "avec_labels")
    got = discovery.labeled_folder(seeded_tree / "avec_labels")
    assert got == want
    assert got[2] == ["cancer", "normal"] and got[1] == [0, 0, 1, 1]  # notes.txt left out


@pytest.mark.parametrize("call", ["discover_image_records", "labeled_folder"])
def test_discovery_errors_match(call, tmp_path):
    (tmp_path / "avec_labels").mkdir()
    root = tmp_path if call == "discover_image_records" else tmp_path / "avec_labels"
    with pytest.raises(RuntimeError) as want:
        getattr(jdiscovery, call)(root)
    with pytest.raises(RuntimeError) as got:
        getattr(discovery, call)(root)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        discovery.discover_image_records(tmp_path / "missing")


def _registry_paths(reg) -> dict:
    cls = type(reg)
    paths = {name: getattr(reg, name) for name in dir(cls) if isinstance(getattr(cls, name), property)}
    paths.update({f"threshold_sweep_csv({m})": reg.threshold_sweep_csv(m) for m in ("baseline", "semi")})
    paths.update({f"serving_artifact({m})": reg.serving_artifact(m) for m in ("baseline", "semi")})
    return paths


@pytest.mark.parametrize("root", ["outputs", "/abs/run_7"])
def test_every_artifact_path_matches(root, tmp_path):
    want, got = _registry_paths(JaxArtifactRegistry(root=tmp_path / root)), _registry_paths(ArtifactRegistry(root=tmp_path / root))
    assert got == want and len(got) > 40
    assert ArtifactRegistry().root == JaxArtifactRegistry().root
    reg = ArtifactRegistry(root=tmp_path / "made")
    reg.ensure_dirs()
    jreg = JaxArtifactRegistry(root=tmp_path / "made_by_jax")
    jreg.ensure_dirs()
    assert sorted(p.name for p in reg.root.iterdir()) == sorted(p.name for p in jreg.root.iterdir())


def test_training_config_fields_and_defaults_match(tmp_path):
    want = {f.name: (f.type, f.default) for f in dataclasses.fields(JaxTrainingConfig)}
    got = {f.name: (f.type, f.default) for f in dataclasses.fields(TrainingConfig)}
    assert list(got) == list(want)  # same fields in the same order
    assert got == want
    cfg = TrainingConfig(strong_data_dir=tmp_path, output_dir=tmp_path / "o", resume=True)
    jcfg = JaxTrainingConfig(strong_data_dir=tmp_path, output_dir=tmp_path / "o", resume=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.resume_path("baseline") == jcfg.resume_path("baseline")
    assert TrainingConfig(strong_data_dir=tmp_path).resume_path("baseline") is None
    assert cfg.artifacts.baseline_checkpoint == jcfg.artifacts.baseline_checkpoint


def test_configure_logging_matches(tmp_path):
    """Same handlers, format and file tee; handlers do not stack."""
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        shapes = []
        for module, name in ((jlogging, "jax.log"), (port_logging, "port.log")):
            module.configure_logging("debug", log_file=tmp_path / "logs" / name)
            module.configure_logging("DEBUG", log_file=tmp_path / "logs" / name)
            module.get_logger("shared.test").info("hello %d", 7)
            shapes.append([(type(h).__name__, h.formatter._fmt) for h in root.handlers] + [root.level])
            for handler in root.handlers:
                handler.flush()
        assert shapes[0] == shapes[1] and len(root.handlers) == 2
        lines = [(tmp_path / "logs" / n).read_text().split(" ", 2)[2] for n in ("jax.log", "port.log")]
        assert lines[0] == lines[1] == "INFO shared.test :: hello 7\n"
    finally:
        for handler in root.handlers[:]:
            root.removeHandler(handler)
            handler.close()
        for handler in saved[0]:
            root.addHandler(handler)
        root.setLevel(saved[1])


def _threshold_case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    n = 60
    y = (rng.random(n) < 0.4).astype(int)
    if kind == "separable":
        prob = np.where(y == 1, rng.uniform(0.6, 1.0, n), rng.uniform(0.0, 0.4, n))
    elif kind == "ties":  # float32 probabilities on a coarse grid: many equal candidates
        prob = (rng.integers(0, 6, n) / 5).astype(np.float32)
    elif kind == "no_positives":
        y[:] = 0
        prob = rng.random(n)
    elif kind == "no_negatives":
        y[:] = 1
        prob = rng.random(n)
    elif kind == "inverted":  # positives score low: the constrained tier is infeasible
        prob = np.where(y == 1, rng.uniform(0.0, 0.3, n), rng.uniform(0.7, 1.0, n))
    else:
        prob = rng.random(n).astype(np.float32)
    return y, prob


@pytest.mark.parametrize("constraints", [{}, {"min_precision": 0.9}, {"max_fpr": 0.05}, {"min_precision": 0.99, "max_fpr": 0.0}])
@pytest.mark.parametrize("target_recall", [0.5, 0.95, 1.0])
@pytest.mark.parametrize("kind", ["random", "separable", "ties", "no_positives", "no_negatives", "inverted"])
def test_select_operating_threshold_matches_bit_for_bit(kind, target_recall, constraints):
    y, prob = _threshold_case(kind, seed=int(target_recall * 100))
    want = jthresholds.select_operating_threshold(y, prob, target_recall, f_beta=2.0, **constraints)
    got = thresholds.select_operating_threshold(y, prob, target_recall, f_beta=2.0, **constraints)
    assert got == want  # threshold, policy and every rate, to the bit
    if kind == "no_positives":
        assert got == (0.5, {"policy": "no_positives", "recall": 0.0, "precision": 0.0, "fpr": 0.0})


@pytest.mark.parametrize("kind", ["random", "ties", "no_positives"])
def test_threshold_helpers_match(kind):
    y, prob = _threshold_case(kind, seed=3)
    for include_one in (True, False):
        np.testing.assert_array_equal(
            thresholds.candidate_thresholds(prob, include_one), jthresholds.candidate_thresholds(prob, include_one))
    thr = thresholds.candidate_thresholds(prob)
    want, got = jthresholds.stats_for_thresholds(y, prob, thr), thresholds.stats_for_thresholds(y, prob, thr)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert thresholds.find_threshold_for_target_recall(y, prob, 0.9) == jthresholds.find_threshold_for_target_recall(y, prob, 0.9)
