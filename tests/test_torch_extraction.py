"""The port's extraction slice as a whole, against ``src.feature_extraction``.

Both packages run on the same synthetic JPEG tree (``tiny_image_tree``)
with no weights, so both use the same seeded init.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ssip_tpu.pipelines.extraction as jax_extraction
import ssip_tpu_torch.pipelines.extraction as port_extraction
from src.feature_extraction import main as jax_main
from ssip_tpu.data.discovery import compute_dataset_digest, discover_image_records
from ssip_tpu.pipelines.extraction import ExtractionConfig as JaxConfig
from ssip_tpu.pipelines.extraction import run_extraction as jax_run_extraction
from ssip_tpu_torch.cli.feature_extraction import main as port_main
from ssip_tpu_torch.data.pipeline import ImageStore, iter_device_batches
from ssip_tpu_torch.models.host_init import seeded_init_host
from ssip_tpu_torch.models.port import state_dict_from_flax
from ssip_tpu_torch.models.resnet import build_resnet
from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, _resolve_weights, run_extraction
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def test_cli_reproduces_jax_cli(tiny_image_tree, tmp_path, monkeypatch):
    """Same artifact set and CSV bytes, same metadata keys and provenance,
    same neighbour probe, float32 embeddings within 1e-4."""
    monkeypatch.delenv("SSIP_RESNET18_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    common = ["--data-dir", str(tiny_image_tree), "--device", "cpu", "--batch-size", "8"]
    jax_main(common + ["--output-dir", str(jax_out)])
    port_main(common + ["--output-dir", str(port_out)])

    assert _files(port_out) == _files(jax_out)
    csv_rel = Path("features") / "embeddings.csv"
    assert (port_out / csv_rel).read_bytes() == (jax_out / csv_rel).read_bytes()

    jm = json.loads((jax_out / "features" / "metadata.json").read_text())
    pm = json.loads((port_out / "features" / "metadata.json").read_text())
    assert pm.keys() == jm.keys()
    for key in ("weights", "dataset_digest", "num_images", "failed_images", "embedding_dimension",
                "input_resize", "input_crop", "layer", "channel_policy"):
        assert pm[key] == jm[key], key
    assert pm["weights"] == "random_init:seed=42"
    assert [(p["query"], p["neighbor"]) for p in pm["neighbor_probe"]] == [
        (p["query"], p["neighbor"]) for p in jm["neighbor_probe"]
    ]
    np.testing.assert_allclose(
        [p["similarity"] for p in pm["neighbor_probe"]],
        [p["similarity"] for p in jm["neighbor_probe"]], atol=1e-5,
    )

    je = np.load(jax_out / "features" / "embeddings.npy")
    pe = np.load(port_out / "features" / "embeddings.npy")
    assert pe.shape == je.shape == (22, 512) and pe.dtype == np.float32
    np.testing.assert_allclose(pe, je, rtol=1e-4, atol=1e-4)
    for key in ("mean_abs_mean", "mean_std"):
        np.testing.assert_allclose(pm["sanity_checks"][key], jm["sanity_checks"][key], rtol=1e-4)


def test_bf16_slice_tracks_jax_bf16(tiny_image_tree, tmp_path):
    """bfloat16 throughput mode: per-image cosine > 0.995 against the JAX
    package's bfloat16 run."""
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False,
               compute_dtype="bfloat16")
    ref = jax_run_extraction(JaxConfig(output_dir=tmp_path / "jax", **cfg)).embeddings
    got = run_extraction(ExtractionConfig(output_dir=tmp_path / "port", **cfg)).embeddings
    cos = (_unit(got) * _unit(ref)).sum(axis=1)
    assert cos.min() > 0.995, cos.min()


@pytest.mark.parametrize(
    "extra",
    [
        ["--arch", "vit_moe_s16"],
        ["--streaming", "always"],
        ["--fast-decode"],
        ["--host-preproc"],
        ["--shard-size", "4"],
        ["--arch", "vit_moe_t16"],
    ],
)
def test_unported_flags_refused(extra, tiny_image_tree, tmp_path):
    """The name is older than the ports: none of these flags is refused now.
    The flags ported since the first slice (the MoE archs, the streamed
    shape, ``--fast-decode``, ``--host-preproc``, ``--shard-size``) run and
    write the artifact set, one embedding per image, as wide as the arch;
    ``--shard-size 4`` leaves a shard and a manifest a 4 images."""
    argv = ["--data-dir", str(tiny_image_tree), "--device", "cpu", "--output-dir", str(tmp_path / "o"),
            "--batch-size", "8", "--no-cache", *extra]
    port_main(argv)
    if extra[0] == "--shard-size":
        shards = sorted((tmp_path / "o" / "features" / "shards").glob("shard_*.manifest.json"))
        assert len(shards) == 6  # 22 images in shards of 4
        assert json.loads((tmp_path / "o" / "features" / "metadata.json").read_text())["weights"] == "sharded"
    meta = json.loads((tmp_path / "o" / "features" / "metadata.json").read_text())
    width = {"vit_moe_s16": 384, "vit_moe_t16": 192}.get(extra[-1], 512)
    emb = np.load(tmp_path / "o" / "features" / "embeddings.npy")
    assert emb.shape == (22, width) and np.isfinite(emb).all()
    assert meta["num_images"] == 22 and meta["architecture"] == (extra[1] if extra[0] == "--arch" else "resnet18")


@pytest.mark.parametrize("budget", [1024, 4 * 1024**3])
def test_auto_refuses_what_jax_would_stream(budget, tiny_image_tree, tmp_path, monkeypatch):
    """With the host budget below the corpus the JAX package's
    ``streaming="auto"`` streams, and so does the port: no decode cache is
    written, and the embeddings equal those of ``streaming="never"`` (the
    store path). At the real 4 GiB budget both take the store path."""
    monkeypatch.setattr(jax_extraction, "_HOST_STAGE_BUDGET_BYTES", budget)
    monkeypatch.setattr(port_extraction, "_HOST_STAGE_BUDGET_BYTES", budget)
    records = discover_image_records(tiny_image_tree)
    paths, digest = [r.absolute_path for r in records], compute_dataset_digest(records)
    streams = jax_extraction._should_stream(JaxConfig(data_dir=tiny_image_tree, output_dir=tmp_path / "jax"), paths, digest)
    assert streams == (budget == 1024)
    cfg = dict(data_dir=tiny_image_tree, output_dir=tmp_path / "o", device="cpu", batch_size=8)
    assert port_extraction._should_stream(ExtractionConfig(**cfg), paths, digest) == streams
    auto = run_extraction(ExtractionConfig(**cfg)).embeddings
    assert (tmp_path / "o" / "cache").exists() == (not streams)  # the streamed shape writes no cache
    never = run_extraction(ExtractionConfig(**dict(cfg, output_dir=tmp_path / "n"), streaming="never")).embeddings
    assert auto.shape == (22, 512)
    np.testing.assert_array_equal(auto, never)


def test_port_imports_no_jax_flax_or_triton(tiny_image_tree, tmp_path):
    """Every module of the port, and a CPU run of the slice, in a fresh
    interpreter: jax, flax, optax and triton stay out of ``sys.modules``,
    and no module of the JAX package (``ssip_tpu``) loads: the port keeps
    its own copies of the jax-free modules it needs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ssip_tpu_torch\n"
        "for m in pkgutil.walk_packages(ssip_tpu_torch.__path__, 'ssip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ssip_tpu_torch.cli.feature_extraction import main\n"
        f"main(['--data-dir', {str(tiny_image_tree)!r}, '--device', 'cpu', '--batch-size', '8',\n"
        f"      '--output-dir', {str(tmp_path / 'o')!r}, '--no-cache'])\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'triton', 'sklearn', 'pandas') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "jax_package = sorted(m for m in sys.modules if m.split('.')[0] == 'ssip_tpu')\n"
        "assert not jax_package, jax_package\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop("SSIP_RESNET18_WEIGHTS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN" in proc.stdout
    assert np.load(tmp_path / "o" / "features" / "embeddings.npy").shape == (22, 512)


def test_per_batch_shape_matches_resident(tiny_image_tree, tmp_path):
    """A decode failure sends the run down the per-batch shape (padded
    batches through ``iter_device_batches``); the 22 good images embed as
    in the resident shape and the failure is recorded."""
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False)
    resident = run_extraction(ExtractionConfig(output_dir=tmp_path / "r", **cfg))
    bad = tiny_image_tree / "sans_label" / "zz_corrupt.jpg"
    bad.write_bytes(b"not a jpeg")
    try:
        batched = run_extraction(ExtractionConfig(output_dir=tmp_path / "b", **cfg))
    finally:
        bad.unlink()
    assert [p.name for p in batched.failures] == ["zz_corrupt.jpg"]
    assert [r.relative_path for r in batched.records] == [r.relative_path for r in resident.records]
    np.testing.assert_allclose(batched.embeddings, resident.embeddings, rtol=1e-5, atol=1e-5)
    meta = json.loads((tmp_path / "b" / "features" / "metadata.json").read_text())
    assert meta["failed_images"] == 1 and meta["num_images"] == 22


def test_decode_cache_written_and_reused(tiny_image_tree, tmp_path):
    cfg = ExtractionConfig(data_dir=tiny_image_tree, output_dir=tmp_path / "o", device="cpu", batch_size=8)
    first = run_extraction(cfg)
    cached = sorted(p.name for p in (tmp_path / "o" / "cache").iterdir())
    assert len(cached) == 2 and cached[0].endswith(".meta.json") and cached[1].endswith(".u8.npy")
    second = run_extraction(cfg)  # reads the memmap cache instead of decoding
    np.testing.assert_array_equal(second.embeddings, first.embeddings)


def test_iter_device_batches_pads_last_batch():
    images = np.arange(5 * 4 * 4 * 3, dtype=np.uint8).reshape(5, 4, 4, 3)
    store = ImageStore.from_array(images, [Path(f"{i}.png") for i in range(5)])
    batches = list(iter_device_batches(store, [0, 2, 3, 4], 3, torch.device("cpu")))
    assert [b.valid for b in batches] == [3, 1]
    assert [b.indices.tolist() for b in batches] == [[0, 2, 3], [4]]
    assert all(b.data.shape == (3, 4, 4, 3) and b.data.dtype == torch.uint8 for b in batches)
    np.testing.assert_array_equal(batches[0].data.numpy(), images[[0, 2, 3]])
    np.testing.assert_array_equal(batches[1].data[0].numpy(), images[4])
    assert not batches[1].data[1:].any()


def test_weights_candidates(tmp_path, monkeypatch):
    """An explicit wrong-arch ``--weights`` is fatal; the env default with
    the wrong arch is skipped for the seeded init; a matching one loads."""
    r18 = tmp_path / "resnet18_imagenet1k.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                state_dict_from_flax(seeded_init_host("resnet18", 1)).items()}, r18)
    monkeypatch.setenv("SSIP_RESNET18_WEIGHTS", str(r18))

    cfg34 = ExtractionConfig(arch="resnet34", output_dir=tmp_path / "o")
    assert _resolve_weights(cfg34, build_resnet("resnet34")).startswith("random_init")
    with pytest.raises(ValueError, match="does not match --arch resnet34"):
        _resolve_weights(
            ExtractionConfig(arch="resnet34", weights=r18, output_dir=tmp_path / "o"),
            build_resnet("resnet34"),
        )
    model = build_resnet("resnet18")
    assert _resolve_weights(ExtractionConfig(output_dir=tmp_path / "o"), model) == f"ported:{r18}"
    ref = state_dict_from_flax(seeded_init_host("resnet18", 1))
    np.testing.assert_array_equal(model.conv1.weight.detach().numpy(), ref["conv1.weight"])
    with pytest.raises(FileNotFoundError):
        _resolve_weights(
            ExtractionConfig(weights=tmp_path / "missing.pt", output_dir=tmp_path / "o"), model
        )
