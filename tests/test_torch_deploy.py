"""The port's deployment layer against the JAX package's, on the CPU: the
cases of ``tests/test_deploy.py`` on the port's export (``torch.export``,
symbolic batch), loader, HTTP server and CLIs, and the two packages on one
run directory.

A fabricated run (seeded ``resnet18`` classifier at 32² with drawn BatchNorm
statistics, saved as the ``.pt`` both packages read, and an
``operating_point.json``) is exported by each package's ``export_model``
CLI. Tolerances: the port's artifact against its direct serving forward
within 1e-6 (``tests/test_deploy.py:79``'s bound), against its in-process
predictor and against the JAX package's artifact within 1e-5 (two float32
convolution orders); the int8 artifact against the in-process int8 program
within 1e-6 and against float32 within 0.25 (``tests/test_deploy.py:252``).
A narrow ViT (``vit_t16`` at 32²) shows that the exported program keeps the
LayerNorm and attention operators, which launch the kernels on the card.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import src.export_model as jax_export_cli
from ssip_tpu.deploy.export import ExportedModel as JaxExportedModel
from ssip_tpu_torch.cli import export_model as export_cli
from ssip_tpu_torch.cli import serve as serve_cli
from ssip_tpu_torch.deploy.export import (
    MANIFEST_VERSION, PROGRAM_KEY, ExportedModel, build_serving_fn, build_serving_fn_int8,
    quantized_serving_bundle,
)
from ssip_tpu_torch.deploy.server import make_server
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import load_flax_variables
from ssip_tpu_torch.models.registry import build_model
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from ssip_tpu_torch.serving import ScreeningPredictor, decode_and_resize, load_serving_bundle
from ssip_tpu_torch.train.checkpoints import save_checkpoint
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

SIZE = 32


def fabricate_run(out, arch: str = "resnet18", seed: int = 7, threshold: float = 0.62):
    """A seeded classifier checkpoint and an operating point, as a pipeline
    run leaves them."""
    model = build_model(arch, num_classes=2, image_size=SIZE)
    load_flax_variables(model, seeded_init_host(arch, seed, num_classes=2, image_size=SIZE))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.standard_normal(buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    reg = ArtifactRegistry(out)
    save_checkpoint(reg.semi_checkpoint, model)
    reg.operating_point_json.parent.mkdir(parents=True, exist_ok=True)
    reg.operating_point_json.write_text(json.dumps({
        "model": f"semi_supervised_{arch}", "arch": arch, "positive_class": "cancer",
        "classes": ["cancer", "normal"], "threshold": threshold, "policy": "constrained", "image_size": SIZE,
    }))
    return out


@pytest.fixture(scope="module")
def fabricated_run(tmp_path_factory):
    return fabricate_run(tmp_path_factory.mktemp("run"))


@pytest.fixture(scope="module")
def exported_artifact(fabricated_run, tmp_path_factory):
    path = tmp_path_factory.mktemp("art") / "semi_serving.ssip.npz"
    export_cli.main(["--output-dir", str(fabricated_run), "--model", "semi", "--out", str(path),
                     "--image-size", str(SIZE), "--device", "cpu"])
    return path


@pytest.fixture(scope="module")
def jax_artifact(fabricated_run, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_art") / "semi_serving.ssip.npz"
    jax_export_cli.main(["--output-dir", str(fabricated_run), "--model", "semi", "--out", str(path),
                         "--image-size", str(SIZE)])
    return path


def _images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def test_export_roundtrip_matches_direct_forward(fabricated_run, exported_artifact):
    bundle = load_serving_bundle(fabricated_run, model="semi", image_size=SIZE)
    model = ExportedModel.load(exported_artifact, device="cpu")
    images = _images(3, 4)
    with torch.inference_mode():
        direct = build_serving_fn("resnet18", 2, "float32", bundle.state, SIZE)(torch.from_numpy(images)).numpy()
    got = model.predict_probs(images)
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_export_matches_in_process_predictor_and_the_jax_artifact(fabricated_run, exported_artifact, jax_artifact):
    exported = ExportedModel.load(exported_artifact, device="cpu")
    predictor = ScreeningPredictor.from_artifacts(fabricated_run, model="semi", image_size=SIZE, batch_size=4,
                                                  device="cpu")
    images = _images(5, 6)
    a, b = exported.predict_images(images), predictor.predict_images(images)
    np.testing.assert_allclose(a.prob_positive, b.prob_positive, atol=1e-5)
    assert a.threshold == b.threshold == 0.62
    np.testing.assert_array_equal(a.flagged, b.flagged)
    jax_probs = JaxExportedModel.load(jax_artifact).predict_probs(images)
    np.testing.assert_allclose(exported.predict_probs(images), jax_probs, atol=1e-5)


def test_symbolic_batch_and_bucketing(exported_artifact):
    model = ExportedModel.load(exported_artifact, max_batch=4, device="cpu")
    images = _images(9, 7)
    full = model.predict_probs(images)  # chunks of 4, the last padded to a bucket of 4
    assert full.shape == (7, 2)
    for i in (0, 3, 6):
        one = model.predict_probs(images[i : i + 1])
        np.testing.assert_allclose(full[i], one[0], atol=1e-6)
    assert model.predict_probs(images[:0]).shape == (0, 2)
    assert [model._bucket(n) for n in (1, 3, 4, 9)] == [1, 4, 4, 4]


def test_manifest_and_format(exported_artifact):
    with np.load(exported_artifact) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode("utf-8"))
        files = set(z.files)
    assert manifest["version"] == MANIFEST_VERSION != 1
    assert manifest["arch"] == "resnet18" and manifest["threshold"] == 0.62
    assert manifest["positive_class"] == "cancer" and manifest["pos_index"] == 0
    assert manifest["classes"] == ["cancer", "normal"]
    assert set(manifest["platforms"]) == {"cpu", "cuda"}
    assert manifest["torch_version"] == torch.__version__ and "jax_version" not in manifest
    assert manifest["image_size"] == SIZE and manifest["calibration_images"] == 0
    assert files == {"__manifest__", PROGRAM_KEY}  # the weights live once, inside the program


def test_input_shape_validation(exported_artifact):
    model = ExportedModel.load(exported_artifact, device="cpu")
    with pytest.raises(ValueError, match="eval-resized"):
        model.predict_probs(np.zeros((2, 48, 48, 3), np.uint8))


def test_http_server_end_to_end(exported_artifact, tmp_path):
    """healthz / manifest / predict (raw bytes) / predict_paths (JSON)."""
    from PIL import Image

    model = ExportedModel.load(exported_artifact, device="cpu")
    httpd = make_server(model, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        with urllib.request.urlopen(f"{base}/manifest", timeout=30) as r:
            assert json.load(r)["arch"] == "resnet18"
        arr = _images(1, 1)[0]
        img_path = tmp_path / "img.png"  # PNG: lossless
        Image.fromarray(arr).save(img_path)
        req = urllib.request.Request(f"{base}/predict", data=img_path.read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.load(r)
        expected = model.predict_images(arr[None])
        assert body["threshold"] == 0.62
        assert body["prob_positive"] == pytest.approx(float(expected.prob_positive[0]), abs=1e-5)
        assert body["flagged"] == bool(expected.flagged[0])
        req = urllib.request.Request(f"{base}/predict_paths", data=json.dumps({"paths": [str(img_path)]}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            rows = json.load(r)["rows"]
        assert len(rows) == 1 and rows[0]["prob_positive"] == pytest.approx(float(expected.prob_positive[0]), abs=1e-5)
        req = urllib.request.Request(f"{base}/predict", data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_int8_export_matches_in_process_quantized_path(fabricated_run, tmp_path, tiny_image_tree):
    path = tmp_path / "semi_int8.ssip.npz"
    export_cli.main(["--output-dir", str(fabricated_run), "--model", "semi", "--out", str(path), "--image-size",
                     str(SIZE), "--compute-dtype", "int8", "--calibration-images", str(tiny_image_tree / "sans_label"),
                     "--calibration-count", "8", "--device", "cpu"])
    model = ExportedModel.load(path, device="cpu")
    assert model.manifest["compute_dtype"] == "int8" and model.manifest["calibration_images"] == 8
    images = _images(13, 4)
    got = model.predict_probs(images)

    bundle = load_serving_bundle(fabricated_run, model="semi", image_size=SIZE)
    paths = sorted((tiny_image_tree / "sans_label").glob("*"))[:8]
    _, calib, _ = decode_and_resize(paths, SIZE, torch.device("cpu"))
    qbundle = quantized_serving_bundle(bundle.state, calib, "resnet18")
    assert sorted(qbundle["blocks"]) == [f"block{i:02d}" for i in range(8)]
    with torch.inference_mode():
        direct = build_serving_fn_int8("resnet18", qbundle)(torch.from_numpy(images)).numpy()
        f32 = build_serving_fn("resnet18", 2, "float32", bundle.state, SIZE)(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, f32, atol=0.25)
    with pytest.raises(ValueError, match="ResNet family only"):
        build_serving_fn_int8("vit_t16", qbundle)


def test_server_wraps_in_process_predictor(fabricated_run):
    args = serve_cli.parse_args(["--output-dir", str(fabricated_run), "--model", "semi", "--image-size", str(SIZE),
                                 "--max-batch", "4", "--device", "cpu"])
    httpd = make_server(serve_cli.build_model(args), host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/manifest", timeout=30) as r:
            m = json.load(r)
        assert m["arch"] == "resnet18" and m["threshold"] == 0.62
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_threshold_override_flag(fabricated_run, tmp_path):
    path = tmp_path / "thr.ssip.npz"
    export_cli.main(["--output-dir", str(fabricated_run), "--model", "semi", "--out", str(path), "--image-size",
                     str(SIZE), "--threshold", "0.9", "--device", "cpu"])
    assert ExportedModel.load(path, device="cpu").threshold == 0.9


def test_each_package_refuses_the_others_artifact(exported_artifact, jax_artifact):
    with pytest.raises(ValueError, match="Unsupported serving-artifact version 'ssip_tpu_torch/torch.export/1'"):
        JaxExportedModel.load(exported_artifact)
    with pytest.raises(ValueError, match="not an ssip_tpu_torch artifact: it holds a JAX package program"):
        ExportedModel.load(jax_artifact, device="cpu")


def test_platforms_and_device_are_checked(fabricated_run, exported_artifact, tmp_path):
    with pytest.raises(ValueError, match=r"--platforms cpu,tpu: the PyTorch port \(ssip_tpu_torch\)"):
        export_cli.main(["--output-dir", str(fabricated_run), "--out", str(tmp_path / "a.ssip.npz"),
                         "--image-size", str(SIZE), "--device", "cpu", "--platforms", "cpu,tpu"])
    cpu_only = tmp_path / "cpu.ssip.npz"
    export_cli.main(["--output-dir", str(fabricated_run), "--out", str(cpu_only), "--image-size", str(SIZE),
                     "--device", "cpu", "--platforms", "cpu"])
    assert ExportedModel.load(cpu_only, device="cpu").manifest["platforms"] == ["cpu"]
    assert export_cli.parse_args([]).device == "auto" and export_cli.parse_args([]).platforms == "cpu,cuda"


def test_vit_export_keeps_the_kernel_operators(tmp_path):
    """A served ViT's program holds the port's LayerNorm and attention
    operators (the kernels on the card), not their plain decompositions, and
    its artifact reproduces the direct forward and the predictor."""
    run = fabricate_run(tmp_path / "vit_run", arch="vit_t16", seed=3)
    bundle = load_serving_bundle(run, model="semi")
    assert bundle.arch == "vit_t16" and bundle.image_size == SIZE
    program = build_serving_fn("vit_t16", 2, "float32", bundle.state, SIZE)
    with torch.no_grad():
        exported = torch.export.export(program, (torch.zeros((2, SIZE, SIZE, 3), dtype=torch.uint8),),
                                       dynamic_shapes={"images_u8": {0: torch.export.Dim("b", min=1)}})
    ops = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert ops.count("ssip_tpu_torch.layer_norm.default") == 2 * 12 + 1
    assert ops.count("ssip_tpu_torch.attention_qkv.default") == 12
    path = tmp_path / "vit.ssip.npz"
    export_cli.main(["--output-dir", str(run), "--out", str(path), "--image-size", str(SIZE), "--device", "cpu"])
    model = ExportedModel.load(path, device="cpu")
    images = _images(21, 3)
    with torch.inference_mode():
        direct = program(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(model.predict_probs(images), direct, rtol=0, atol=1e-6)
    predictor = ScreeningPredictor.from_artifacts(run, model="semi", batch_size=2, device="cpu")
    np.testing.assert_allclose(model.predict_images(images).prob_positive,
                               predictor.predict_images(images).prob_positive, atol=1e-5)


@pytest.mark.parametrize(
    "name,argv,differ",
    [("predict", ["--images", "imgs", "--threshold", "0.3"], {}),
     ("export_model", ["--compute-dtype", "int8", "--calibration-count", "8"],
      {"platforms": ("cpu,cuda", "cpu,tpu"), "device": ("auto", "cpu")}),
     ("serve", ["--model-file", "a.ssip.npz", "--port", "0"], {})],
)
def test_cli_flags_match_src(name, argv, differ):
    """The port's three CLIs parse the flags of ``src/`` to the same values,
    but for the differences by rule (``--platforms``, ``--device``)."""
    import importlib

    port = vars(importlib.import_module(f"ssip_tpu_torch.cli.{name}").parse_args(argv))
    want = vars(importlib.import_module(f"src.{name}").parse_args(argv))
    assert set(port) == set(want)
    for key, (got_default, src_default) in differ.items():
        assert (port.pop(key), want.pop(key)) == (got_default, src_default)
    assert port == want
