"""``--shard-size``: the port's resumable extraction against the JAX package's.

``pipelines/sharded_extraction.py`` through the port's CLI, on two gloo
ranks (each embeds its share of every global batch, rank 0 writes) and in
one process, against ``ssip_tpu``'s ``run_sharded_extraction`` on the same
tree: the same shard files and manifest keys (``complete``, ``digest``,
``rows``, ``embedded_rows``, ``failures``, ``weights``), the same digests,
the merged artifacts with ``weights`` ``"sharded"`` and the CSV bytes, and
float32 embeddings within 1e-4 (``tests/test_torch_extraction.py``'s
bound). Then the reuse and recompute rules: a changed digest and a removed
manifest recompute their shards, the others are reused.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ssip_tpu.pipelines.extraction import ExtractionConfig as JaxConfig
from ssip_tpu.pipelines.sharded_extraction import run_sharded_extraction as jax_run_sharded
from ssip_tpu_torch.cli.feature_extraction import main as port_main
from ssip_tpu_torch.pipelines import sharded_extraction
from tests.test_torch_data_parallel import cli_on_ranks, spawn_ranks
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

torch.set_num_threads(2)

MODULE = "ssip_tpu_torch.cli.feature_extraction"


def _manifests(root: Path) -> dict:
    return {p.name: json.loads(p.read_text()) for p in sorted((root / "features" / "shards").glob("*.json"))}


def test_shard_size_cli_on_two_ranks_matches_jax(tiny_image_tree, tmp_path, monkeypatch, caplog):
    """``--shard-size 8`` through the port's CLI on two ranks and the JAX
    package's ``run_sharded_extraction`` on the same tree: the same shard
    files and manifests (digests, rows, failures; ``weights`` the run's
    source), the merged artifacts with ``weights`` ``"sharded"``, the CSV
    bytes, float32 embeddings within 1e-4. Then a changed member (its
    shard's digest moves) and a removed manifest: those two shards are
    recomputed, the third reused, and the artifacts are the same again."""
    monkeypatch.delenv("SSIP_RESNET18_WEIGHTS", raising=False)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_run_sharded(JaxConfig(data_dir=tiny_image_tree, output_dir=jax_out, device="cpu", batch_size=5,
                              cache_decoded=False), shard_size=8)
    argv = ["--data-dir", str(tiny_image_tree), "--device", "cpu", "--batch-size", "5", "--no-cache",
            "--output-dir", str(port_out), "--shard-size", "8"]
    spawn_ranks(cli_on_ranks, (MODULE, argv), tmp_path)

    jm, pm = _manifests(jax_out), _manifests(port_out)
    assert sorted(pm) == sorted(jm) == [f"shard_{i:05d}.manifest.json" for i in range(3)]
    for name, want in jm.items():
        assert sorted(pm[name]) == sorted(want) == ["complete", "digest", "embedded_rows", "failures", "rows",
                                                   "weights"]
        for key in ("complete", "digest", "rows", "embedded_rows", "failures"):
            assert pm[name][key] == want[key], (name, key)
        assert pm[name]["weights"] == want["weights"] == "random_init:seed=42"

    def check():
        meta = json.loads((port_out / "features" / "metadata.json").read_text())
        assert meta["weights"] == "sharded" and meta["device"] == "cpu:2" and meta["num_images"] == 22
        csv = Path("features") / "embeddings.csv"
        assert (port_out / csv).read_bytes() == (jax_out / csv).read_bytes()
        np.testing.assert_allclose(np.load(port_out / "features" / "embeddings.npy"),
                                   np.load(jax_out / "features" / "embeddings.npy"), rtol=1e-4, atol=1e-4)

    check()
    before = np.load(port_out / "features" / "shards" / "shard_00002.npy")
    (port_out / "features" / "shards" / "shard_00001.manifest.json").unlink()
    manifest = port_out / "features" / "shards" / "shard_00000.manifest.json"
    manifest.write_text(json.dumps({**json.loads(manifest.read_text()), "digest": "0" * 16}))
    spawn_ranks(cli_on_ranks, (MODULE, argv), tmp_path)
    log = (port_out / "logs" / "feature_extraction.log").read_text()
    assert log.count("reusing completed shard") == 1 and log.count("digest changed") == 1
    assert _manifests(port_out)["shard_00000.manifest.json"]["digest"] == jm["shard_00000.manifest.json"]["digest"]
    np.testing.assert_array_equal(np.load(port_out / "features" / "shards" / "shard_00002.npy"), before)
    check()


@pytest.mark.parametrize("shard_size", [5, 22, 100])
def test_one_process_shards_equal_the_single_shot_run(tiny_image_tree, tmp_path, monkeypatch, shard_size):
    """In one process, any shard size gives the single-shot run's artifacts:
    embeddings bit for bit (the same batches), the CSV bytes; the last
    shard's manifest counts its rows."""
    monkeypatch.delenv("SSIP_RESNET18_WEIGHTS", raising=False)
    common = ["--data-dir", str(tiny_image_tree), "--device", "cpu", "--batch-size", "5", "--no-cache"]
    port_main(common + ["--output-dir", str(tmp_path / "single")])
    port_main(common + ["--output-dir", str(tmp_path / "sharded"), "--shard-size", str(shard_size)])
    single = np.load(tmp_path / "single" / "features" / "embeddings.npy")
    sharded = np.load(tmp_path / "sharded" / "features" / "embeddings.npy")
    if shard_size % 5 == 0 or shard_size >= 22:  # shard boundaries on batch boundaries: the same batches
        np.testing.assert_array_equal(sharded, single)
    else:
        np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
    csv = Path("features") / "embeddings.csv"
    assert (tmp_path / "sharded" / csv).read_bytes() == (tmp_path / "single" / csv).read_bytes()
    manifests = _manifests(tmp_path / "sharded")
    last = manifests[sorted(manifests)[-1]]
    assert last["rows"] == last["embedded_rows"] == 22 - shard_size * (len(manifests) - 1)


def test_refuses_a_non_positive_shard_size(tmp_path):
    from ssip_tpu_torch.pipelines.extraction import ExtractionConfig

    with pytest.raises(ValueError, match="shard_size must be positive"):
        sharded_extraction.run_sharded_extraction(ExtractionConfig(output_dir=tmp_path, device="cpu"), shard_size=0)
