"""The port's streamed extraction shape against its store path and the JAX
package's streamed runs: ``--streaming always``, ``auto`` above the host
budget, ``--host-preproc`` and ``--fast-decode``, decode failures, the
majority shape, and the native decoder's build.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ssip_tpu.pipelines.extraction import ExtractionConfig as JaxConfig
from ssip_tpu.pipelines.extraction import run_extraction as jax_run_extraction
from ssip_tpu_torch.cli.feature_extraction import main as port_main
from ssip_tpu_torch.data import pipeline as port_pipeline
from ssip_tpu_torch.native import build as native_build
from ssip_tpu_torch.native import decoder as native
from ssip_tpu_torch.pipelines import extraction as port_extraction
from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def _paths(summary):
    return [str(r.relative_path) for r in summary.records]


def test_streamed_equals_store_path_and_tracks_jax(tiny_image_tree, tmp_path):
    """``streaming="always"``: the port's embeddings equal its store path's
    (the same batches through the same preprocess and forward), in the same
    order, and lie within 1e-4 of the JAX package's streamed run."""
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False)
    stored = run_extraction(ExtractionConfig(output_dir=tmp_path / "store", streaming="never", **cfg))
    streamed = run_extraction(ExtractionConfig(output_dir=tmp_path / "stream", streaming="always", **cfg))
    np.testing.assert_array_equal(streamed.embeddings, stored.embeddings)
    assert _paths(streamed) == _paths(stored) and not streamed.failures
    ref = jax_run_extraction(JaxConfig(output_dir=tmp_path / "jax", streaming="always", **cfg))
    assert _paths(streamed) == _paths(ref)
    np.testing.assert_allclose(streamed.embeddings, ref.embeddings, rtol=0, atol=1e-4)


@pytest.fixture()
def full_size_tree(tmp_path):
    """Six 384×512 JPEGs: the exact chain is the reference's downscale."""
    gen = np.random.default_rng(11)
    root = tmp_path / "ds"
    (root / "sans_label").mkdir(parents=True)
    for i in range(6):
        Image.fromarray(gen.integers(0, 255, (384, 512, 3), dtype=np.uint8)).save(root / "sans_label" / f"u_{i}.jpg")
    return root


def test_host_preproc_equals_store_path_and_tracks_jax(full_size_tree, tmp_path):
    """``host_preproc``: the host's exact resize and crop, then the card's
    preprocess at crop → crop (the identity resample), gives the store
    path's embeddings exactly, and lies within 1e-4 of the JAX package's
    host-preproc run."""
    cfg = dict(data_dir=full_size_tree, device="cpu", batch_size=4, cache_decoded=False)
    stored = run_extraction(ExtractionConfig(output_dir=tmp_path / "store", streaming="never", **cfg))
    hostprep = run_extraction(ExtractionConfig(output_dir=tmp_path / "hp", host_preproc=True, **cfg))
    np.testing.assert_array_equal(hostprep.embeddings, stored.embeddings)
    assert _paths(hostprep) == _paths(stored)
    ref = jax_run_extraction(JaxConfig(output_dir=tmp_path / "jax", streaming="always", host_preproc=True, **cfg))
    np.testing.assert_allclose(hostprep.embeddings, ref.embeddings, rtol=0, atol=1e-4)


def test_fast_decode_tracks_jax_and_is_deterministic(full_size_tree, tmp_path):
    """``fast_decode`` (DCT-scaled decode, approximate by design): within
    1e-4 of the JAX package's fast-decode run, and two runs equal."""
    cfg = dict(data_dir=full_size_tree, device="cpu", batch_size=4, cache_decoded=False)
    one = run_extraction(ExtractionConfig(output_dir=tmp_path / "a", fast_decode=True, **cfg))
    two = run_extraction(ExtractionConfig(output_dir=tmp_path / "b", fast_decode=True, **cfg))
    np.testing.assert_array_equal(one.embeddings, two.embeddings)
    assert one.embeddings.shape == (6, 512) and np.isfinite(one.embeddings).all()
    ref = jax_run_extraction(JaxConfig(output_dir=tmp_path / "jax", streaming="always", fast_decode=True, **cfg))
    np.testing.assert_allclose(one.embeddings, ref.embeddings, rtol=0, atol=1e-4)


def test_streamed_int8_equals_store_path(tiny_image_tree, tmp_path):
    """int8 on the streamed shape: calibrated on the same first 32 images
    (decoded from their files there, taken from the store here), so the
    quantized model and its embeddings are the store path's."""
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8, cache_decoded=False, compute_dtype="int8")
    stored = run_extraction(ExtractionConfig(output_dir=tmp_path / "store", streaming="never", **cfg))
    streamed = run_extraction(ExtractionConfig(output_dir=tmp_path / "stream", streaming="always", **cfg))
    assert streamed.weights_source.endswith("+int8_ptq") and streamed.weights_source == stored.weights_source
    np.testing.assert_array_equal(streamed.embeddings, stored.embeddings)


def test_streamed_tolerates_a_corrupt_file(tiny_image_tree, tmp_path):
    bad = tiny_image_tree / "sans_label" / "zz_corrupt.jpg"
    bad.write_bytes(b"not a jpeg")
    summary = run_extraction(ExtractionConfig(data_dir=tiny_image_tree, output_dir=tmp_path / "o", device="cpu",
                                              batch_size=8, cache_decoded=False, streaming="always"))
    assert summary.embeddings.shape == (22, 512)
    assert [p.name for p in summary.failures] == ["zz_corrupt.jpg"]
    assert "zz_corrupt.jpg" not in " ".join(_paths(summary))


def test_streamed_keeps_the_majority_shape(tmp_path):
    """A corpus whose first image is of a minority shape: the streamed shape
    canonicalizes to the majority shape, as the store packs it, so both
    shapes give the same embeddings."""
    gen = np.random.default_rng(3)
    root = tmp_path / "ds"
    (root / "sans_label").mkdir(parents=True)
    Image.fromarray(gen.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(root / "sans_label" / "a_odd.jpg")
    for i in range(5):
        Image.fromarray(gen.integers(0, 255, (96, 96, 3), dtype=np.uint8)).save(root / "sans_label" / f"b_{i}.jpg")
    paths = sorted((root / "sans_label").iterdir())
    assert port_extraction._probe_majority_shape(paths) == (96, 96, 3)
    cfg = dict(data_dir=root, device="cpu", batch_size=4, cache_decoded=False)
    stored = run_extraction(ExtractionConfig(output_dir=tmp_path / "o1", streaming="never", **cfg))
    streamed = run_extraction(ExtractionConfig(output_dir=tmp_path / "o2", streaming="always", **cfg))
    np.testing.assert_array_equal(streamed.embeddings, stored.embeddings)
    assert _paths(streamed) == _paths(stored)


def test_auto_streams_above_the_budget(tiny_image_tree, tmp_path, monkeypatch):
    """``streaming="auto"`` with the host budget patched below the corpus:
    the streamed shape runs (no decode cache is written) and gives the store
    path's embeddings; with the cache of a store run present it takes the
    store path again, as the JAX package's ``_should_stream`` decides."""
    monkeypatch.setattr(port_extraction, "_HOST_STAGE_BUDGET_BYTES", 1024)
    cfg = dict(data_dir=tiny_image_tree, device="cpu", batch_size=8)
    auto = run_extraction(ExtractionConfig(output_dir=tmp_path / "auto", **cfg))
    assert not (tmp_path / "auto" / "cache").exists()
    stored = run_extraction(ExtractionConfig(output_dir=tmp_path / "store", streaming="never", **cfg))
    assert (tmp_path / "store" / "cache").exists()
    np.testing.assert_array_equal(auto.embeddings, stored.embeddings)
    paths = [r.absolute_path for r in stored.records]
    from ssip_tpu_torch.data.discovery import compute_dataset_digest, discover_image_records

    digest = compute_dataset_digest(discover_image_records(tiny_image_tree))
    assert port_extraction._should_stream(ExtractionConfig(output_dir=tmp_path / "auto", **cfg), paths, digest)
    assert not port_extraction._should_stream(ExtractionConfig(output_dir=tmp_path / "store", **cfg), paths, digest)


def test_fast_decode_and_host_preproc_exclude_each_other(tiny_image_tree, tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        ExtractionConfig(fast_decode=True, host_preproc=True)
    with pytest.raises(SystemExit):
        port_main(["--data-dir", str(tiny_image_tree), "--device", "cpu", "--fast-decode", "--host-preproc"])


def test_the_library_is_built_under_build_and_the_jax_one_never_loads(tiny_image_tree, tmp_path):
    """In a fresh interpreter a host-preproc run loads the library built from
    the port's own source under ``build/ssip_tpu_torch/native/`` and never
    ``ssip_tpu/native/libssipdecode.so``."""
    lib = native_build.library_path()
    assert lib.parent == REPO / "build" / "ssip_tpu_torch" / "native"
    script = textwrap.dedent(f"""
        from pathlib import Path
        from ssip_tpu_torch.pipelines.extraction import ExtractionConfig, run_extraction
        run_extraction(ExtractionConfig(data_dir=Path({str(tiny_image_tree)!r}), output_dir=Path({str(tmp_path)!r}),
                                        device="cpu", batch_size=8, cache_decoded=False, host_preproc=True))
        maps = Path("/proc/self/maps").read_text()
        print("LOADED", sorted({{l.split()[-1] for l in maps.splitlines() if "ssipdecode" in l}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, check=True).stdout
    loaded = out.split("LOADED", 1)[1]
    assert str(lib) in loaded and "ssip_tpu/native" not in loaded
    assert lib.exists()


@pytest.mark.parametrize("missing", ["compiler", "header"])
def test_the_native_flags_raise_naming_what_is_missing(missing, tiny_image_tree, tmp_path, monkeypatch):
    """Where the library cannot be built, ``--host-preproc`` and
    ``--fast-decode`` raise, naming the missing compiler or header; no PIL
    path takes their place."""
    monkeypatch.setattr(native_build, "library_path", lambda: tmp_path / "none" / "libssipdecode_x.so")
    native.load.cache_clear()
    if missing == "compiler":
        monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
        match = "C\\+\\+ compiler"
    else:
        monkeypatch.setattr(native_build, "JPEG_HEADER", tmp_path / "jpeglib.h")
        match = "jpeglib.h"
    try:
        for flag in ("--host-preproc", "--fast-decode"):
            with pytest.raises(native_build.NativeBuildError, match=match):
                port_main(["--data-dir", str(tiny_image_tree), "--device", "cpu", "--output-dir", str(tmp_path / "o"),
                           flag])
    finally:
        native.load.cache_clear()


def test_the_stream_stays_a_bounded_number_of_batches_ahead(tmp_path, monkeypatch):
    """Host memory is O(prefetch × batch): with the consumer holding one
    batch, the decode thread has made at most prefetch + 2 batches."""
    import threading
    import time

    calls = []
    real = port_pipeline.decode_batch

    def counting(paths, **kw):
        calls.append(len(paths))
        return real(paths, **kw)

    monkeypatch.setattr(port_pipeline, "decode_batch", counting)
    gen = np.random.default_rng(0)
    paths = []
    for i in range(40):
        paths.append(tmp_path / f"{i:02d}.jpg")
        Image.fromarray(gen.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(paths[-1])
    import torch

    stream = port_pipeline.iter_streamed_decode_batches(paths, 2, (16, 16, 3), torch.device("cpu"), num_threads=1,
                                                        prefetch=2)
    first = next(stream)
    time.sleep(0.5)
    assert first.valid == 2 and len(calls) <= 2 + 2
    rest = list(stream)
    assert sum(b.valid for b in rest) + first.valid == 40
    assert not any(t.name == "ssip-decode" for t in threading.enumerate())
