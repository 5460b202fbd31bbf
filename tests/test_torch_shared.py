"""The port's own copies of the JAX package's jax-free modules, each held to
its original on seeded inputs: discovery, the artifact registry, the training
config, logging, the threshold policy and sweep, the corpus-scale policy,
the audit and its contract, the host halves of the clustering metrics
(ARI, NMI), and the HTTP serving endpoint.
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
    # the same directory and stream name, the port's own snapshot format
    assert cfg.resume_path("baseline") == jcfg.resume_path("baseline").with_suffix(".torchsnap")
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


@pytest.mark.parametrize("kind", ["random", "ties", "no_positives", "no_negatives"])
def test_sweep_helpers_match_bit_for_bit(kind):
    y, prob = _threshold_case(kind, seed=5)
    labels = np.where(y == 1, 0, 1)  # positive class at index 0
    assert thresholds.sweep_thresholds(labels, prob, 0) == jthresholds.sweep_thresholds(labels, prob, 0)
    for thr in (0.0, 0.3, float(np.median(prob)), 1.0):
        assert thresholds.confusion_from_threshold(labels, prob, 0, thr) == jthresholds.confusion_from_threshold(
            labels, prob, 0, thr)


def test_blocked_policy_matches():
    from ssip_tpu.analysis import blocked as jblocked
    from ssip_tpu_torch.analysis import blocked

    assert (blocked.DENSE_LIMIT, blocked.CHUNK) == (jblocked.DENSE_LIMIT, jblocked.CHUNK) == (8192, 1024)
    blocked.check_embedding_cap(20_000, 20_000, "t-SNE")
    with pytest.raises(ValueError) as got:
        blocked.check_embedding_cap(20_001, 20_000, "UMAP")
    with pytest.raises(ValueError) as want:
        jblocked.check_embedding_cap(20_001, 20_000, "UMAP")
    assert str(got.value) == str(want.value)


def test_audit_contract_matches():
    from ssip_tpu.analysis import audit_contract as jcontract
    from ssip_tpu_torch.analysis import audit_contract as contract

    names = [n for n in dir(jcontract) if n.isupper()]
    assert len(names) == 20 and [n for n in dir(contract) if n.isupper()] == names
    for name in names:
        assert getattr(contract, name) == getattr(jcontract, name), name


@pytest.mark.parametrize("pair", [("labels", "labels"), ("labels", "shuffled"), ("labels", "one"), ("one", "one")])
def test_ari_and_nmi_match_bit_for_bit(pair):
    from ssip_tpu.analysis import cluster_metrics as jmetrics
    from ssip_tpu_torch.analysis import cluster_metrics

    rng = np.random.default_rng(6)
    labels = {"labels": rng.integers(0, 4, 80), "shuffled": rng.permutation(rng.integers(-1, 5, 80)),
              "one": np.zeros(80, int)}
    a, b = labels[pair[0]], labels[pair[1]]
    assert cluster_metrics.adjusted_rand_index(a, b) == jmetrics.adjusted_rand_index(a, b)
    assert cluster_metrics.normalized_mutual_info(a, b) == jmetrics.normalized_mutual_info(a, b)
    strings = np.asarray(["cancer", "normal"])[a % 2]
    assert cluster_metrics.adjusted_rand_index(strings, b) == jmetrics.adjusted_rand_index(strings, b)


@pytest.fixture()
def audit_tree(tmp_path):
    """Two labeled classes, a nested subfolder, an unreadable file and images
    of three sizes and two modes, made from a seed."""
    from PIL import Image

    rng = np.random.default_rng(12)
    root = tmp_path / "ds"
    for rel, size, mode in (
        ("avec_labels/cancer/c_0.jpg", (40, 32), "RGB"), ("avec_labels/cancer/c_1.jpg", (40, 32), "RGB"),
        ("avec_labels/normal/n_0.png", (32, 32), "L"), ("avec_labels/normal/deep/n_1.jpg", (40, 32), "RGB"),
        ("sans_label/u_0.jpg", (40, 32), "RGB"), ("sans_label/u_1.png", (24, 48), "L"),
        ("sans_label/u_2.jpg", (40, 32), "RGB"),
    ):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        shape = (size[1], size[0]) + ((3,) if mode == "RGB" else ())
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
    (root / "sans_label" / "broken.jpg").write_bytes(b"not an image")
    return root


@pytest.mark.parametrize("sample_size", [3, 64])
def test_audit_tables_and_report_match(audit_tree, tmp_path, sample_size):
    """The same inventory, sample, tables and report text as the JAX
    package's audit (the figures are drawn by the same matplotlib calls)."""
    from ssip_tpu.analysis import audit as jaudit
    from ssip_tpu_torch.analysis import audit

    outs = {}
    for name, module in (("jax", jaudit), ("port", audit)):
        out = tmp_path / name
        frame = module.audit_dataset(audit_tree, sample_size, 42, out)
        outs[name] = (frame, out)
    (want, jout), (got, pout) = outs["jax"], outs["port"]
    assert got.equals(want) and len(got) == min(sample_size, 8)
    for rel in ("tables/directory_summary.csv", "tables/image_summary.csv", "notes/data_audit.md"):
        assert (pout / rel).read_text() == (jout / rel).read_text(), rel
    assert sorted(p.name for p in (pout / "figures").iterdir()) == sorted(p.name for p in (jout / "figures").iterdir())


class _StubPredictor:
    """A predictor with the serving surface whose probability is an image's
    mean pixel over 255, whatever array type the server hands it."""

    image_size, threshold, positive_class, arch = 8, 0.5, "cancer", "stub"

    def predict_images(self, images, paths=None):
        from types import SimpleNamespace

        x = np.asarray(images.cpu() if hasattr(images, "cpu") else images, np.float32)
        prob = (x.mean(axis=(1, 2, 3)) / 255.0).astype(np.float32)
        return SimpleNamespace(paths=[str(p) for p in (paths or range(len(prob)))], prob_positive=prob,
                               flagged=prob >= self.threshold, threshold=self.threshold,
                               positive_class=self.positive_class)


def test_http_server_answers_like_the_original(tmp_path):
    """Both packages' ``make_server`` around one predictor give the same
    status and JSON on every endpoint: health, manifest, a raw image (at the
    serving size, so neither resizes), server-side paths with one
    undecodable file, an empty path list, a bad body and an unknown path."""
    import json
    import re
    import threading
    import urllib.error
    import urllib.request

    from PIL import Image

    from ssip_tpu.deploy import server as jserver
    from ssip_tpu_torch.deploy import server

    rng = np.random.default_rng(4)
    img = tmp_path / "a.png"
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(img)
    (tmp_path / "bad.jpg").write_bytes(b"not an image")
    paths = {"paths": [str(img), str(tmp_path / "bad.jpg")]}
    requests = [
        ("GET", "/healthz", None), ("GET", "/manifest", None), ("GET", "/nowhere", None),
        ("POST", "/predict", img.read_bytes()), ("POST", "/predict", b"not an image"),
        ("POST", "/predict_paths", json.dumps(paths).encode()),
        ("POST", "/predict_paths", json.dumps({"paths": []}).encode()), ("POST", "/elsewhere", b"{}"),
    ]

    def answers(module):
        httpd = module.make_server(_StubPredictor(), host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        out = []
        try:
            for method, path, body in requests:
                req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}{path}", data=body,
                                             method=method)
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        out.append((r.status, json.load(r)))
                except urllib.error.HTTPError as err:
                    out.append((err.code, json.load(err)))
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        return out

    def without_addresses(out):  # an error may name a buffer object by its address
        return [(status, re.sub(r"0x[0-9a-f]+", "0x…", json.dumps(body))) for status, body in out]

    want, got = answers(jserver), answers(server)
    assert without_addresses(got) == without_addresses(want)
    assert [status for status, _ in got] == [200, 200, 404, 200, 400, 200, 400, 404]


@pytest.mark.parametrize("shape", [(384, 512, 3), (512, 512, 3), (97, 131, 3)])
def test_native_decoder_copy_matches(shape, tmp_path):
    """``ssip_tpu_torch/native/decode.cpp`` is the JAX package's source byte
    for byte, and its build decodes, DCT-scales and resizes-and-crops as the
    JAX package's library does, bit for bit."""
    from pathlib import Path

    from PIL import Image

    from ssip_tpu.native import decoder as jdecoder
    from ssip_tpu_torch.native import decoder as pdecoder

    root = Path(__file__).resolve().parents[1]
    assert (root / "ssip_tpu_torch/native/decode.cpp").read_bytes() == (root / "ssip_tpu/native/decode.cpp").read_bytes()
    path = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)).save(path, quality=90)
    assert jdecoder.available()
    for fast_scale in (None, 128, 256):
        got, want = pdecoder.decode_one(path, fast_scale), jdecoder.decode_one(path, fast_scale)
        np.testing.assert_array_equal(got, want)
    full = pdecoder.decode_one(path)
    np.testing.assert_array_equal(full, np.asarray(Image.open(path)))
    for resize, crop in ((256, 224), (96, 96)):
        np.testing.assert_array_equal(pdecoder.resize_crop(full, resize, crop), jdecoder.resize_crop(full, resize, crop))
    assert pdecoder.decode_one(tmp_path / "x.png") is None  # JPEG only, as there
