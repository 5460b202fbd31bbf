"""The analysis stage's CLIs, the JAX package's (``src/``) and the port's, on
the same tree and embeddings as ``tests/test_analysis_cli.py``'s fixture:
audit → standardize → clustering → cohort export, on the CPU.

Tables are compared row by row: the audit's text is equal, the cluster
columns and every label-derived number (ARI, NMI, noise rate) are equal,
silhouettes and the embeddings within tolerance (float32 sums in another
order; t-SNE and UMAP by the shape and finiteness of the 2-D maps and by the
PCA spaces they start from, their long optimizations being held in
``test_torch_analysis.py``).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from src.clustering import main as jax_clustering_main
from src.data_audit import main as jax_audit_main
from src.export_unlabeled_cohort import main as jax_cohort_main
from src.standardize_features import main as jax_standardize_main
from ssip_tpu_torch.cli import clustering as port_clustering
from ssip_tpu_torch.cli import data_audit as port_audit
from ssip_tpu_torch.cli import export_unlabeled_cohort as port_cohort
from ssip_tpu_torch.cli import standardize_features as port_standardize
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CLUSTER_ARGS = [
    "--kmeans-range", "2", "3", "--kmeans-n-init", "3", "--tsne-perplexities", "8",
    "--umap-neighbors", "8", "--umap-min-dist", "0.1", "--dbscan-eps", "4.0", "6.0", "--dbscan-min-samples", "3",
]


def _chain(root, out, audit, standardize, clustering, cohort, device_flag):
    audit(["--data-dir", str(root), "--sample-size", "16", "--output-dir", str(out)])
    standardize([
        "--embeddings-npy", str(out / "features" / "embeddings.npy"),
        "--embeddings-csv", str(out / "features" / "embeddings.csv"),
        "--output-npz", str(out / "features" / "standardized_features.npz"), *device_flag,
    ])
    clustering(["--features-npz", str(out / "features" / "standardized_features.npz"), "--output-root", str(out),
                *CLUSTER_ARGS, *device_flag])
    cohort(["--assignments", str(out / "tables" / "cluster_assignments.csv"), "--method", "dbscan",
            "--output", str(out / "tables" / "unlabeled_cohort.csv")])


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The fixture's tree (5 + 5 labeled, 20 unlabeled 32² JPEGs) and 30
    synthetic 24-D embeddings in two clusters, through both chains."""
    from PIL import Image

    from ssip_tpu_torch.data.discovery import discover_image_records

    gen = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("ds")
    for cls in ("cancer", "normal"):
        d = root / "avec_labels" / cls
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(gen.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(d / f"{cls}_{i}.jpg")
    u = root / "sans_label"
    u.mkdir()
    for i in range(20):
        Image.fromarray(gen.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(u / f"u_{i:02d}.jpg")
    centers = gen.normal(0, 8, (2, 24))
    emb = np.vstack([centers[i % 2] + gen.normal(0, 1.0, 24) for i in range(30)]).astype(np.float32)
    records = discover_image_records(root)
    outs = {}
    for name in ("jax", "port"):
        out = tmp_path_factory.mktemp(f"out_{name}")
        (out / "features").mkdir()
        np.save(out / "features" / "embeddings.npy", emb)
        pd.DataFrame([
            {"index": i, "path": str(r.relative_path), "bucket": r.bucket, "label": r.label}
            for i, r in enumerate(records)
        ]).to_csv(out / "features" / "embeddings.csv", index=False)
        outs[name] = out
    _chain(root, outs["jax"], jax_audit_main, jax_standardize_main, jax_clustering_main, jax_cohort_main, [])
    _chain(root, outs["port"], port_audit.main, port_standardize.main, port_clustering.main, port_cohort.main,
           ["--device", "cpu"])
    return root, outs["jax"], outs["port"]


def test_audit_artifacts_equal(chains):
    _, jout, pout = chains
    for rel in ("tables/directory_summary.csv", "tables/image_summary.csv", "notes/data_audit.md"):
        assert (pout / rel).read_text() == (jout / rel).read_text(), rel
    for fig in ("sample_grid.png", "width_hist.png", "height_hist.png", "aspect_hist.png"):
        assert (pout / "figures" / fig).stat().st_size > 0, fig


def test_standardized_bundle_equal(chains):
    _, jout, pout = chains
    with np.load(jout / "features" / "standardized_features.npz") as want, \
            np.load(pout / "features" / "standardized_features.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in ("paths", "is_labeled", "labels"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in ("features", "scaler_mean", "scaler_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


def _metrics_rows_match(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    for col in ("method", "space", "seed"):
        assert got[col].tolist() == want[col].tolist(), col
    for g, w in zip(got["params_json"], want["params_json"]):
        g, w = json.loads(g), json.loads(w)
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key] == (pytest.approx(w[key], rel=1e-5) if isinstance(w[key], float) else w[key]), key
    for col in ("ARI", "NMI", "noise_rate"):  # from equal labels on the host
        np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(got["silhouette"], want["silhouette"], rtol=1e-4, atol=1e-6)


def test_clustering_tables_row_by_row(chains):
    _, jout, pout = chains
    got = pd.read_csv(pout / "tables" / "metrics_clustering.csv")
    want = pd.read_csv(jout / "tables" / "metrics_clustering.csv")
    _metrics_rows_match(got, want)
    assert (pout / "tables" / "cluster_assignments.csv").read_text() == (
        jout / "tables" / "cluster_assignments.csv").read_text()
    assert (pout / "tables" / "unlabeled_cohort.csv").read_text() == (
        jout / "tables" / "unlabeled_cohort.csv").read_text()
    report_lines = lambda out: (out / "notes" / "clustering_report.md").read_text().splitlines()  # noqa: E731
    for g, w in zip(report_lines(pout), report_lines(jout)):
        if "=" not in g:  # the lines of numbers carry float32 sums
            assert g == w


def test_clustering_embeddings_within_tolerance(chains):
    _, jout, pout = chains
    names = sorted(p.name for p in (jout / "features" / "embeddings").glob("*.npz"))
    assert names == sorted(p.name for p in (pout / "features" / "embeddings").glob("*.npz")) and len(names) == 5
    for name in names:
        with np.load(jout / "features" / "embeddings" / name) as want, \
                np.load(pout / "features" / "embeddings" / name) as got:
            assert str(got["params"]) == str(want["params"])
            assert got["data"].shape == want["data"].shape and got["data"].dtype == np.float32
            assert np.isfinite(got["data"]).all()
            if name.startswith("pca"):
                np.testing.assert_allclose(got["data"], want["data"], atol=1e-3)
    figures = lambda out: sorted(p.name for p in (out / "figures").glob("*clusters.png"))  # noqa: E731
    assert figures(pout) == figures(jout) == ["pca2d_clusters.png", "tsne2d_clusters.png", "umap2d_clusters.png"]


@pytest.mark.parametrize("scope, auto", [("unlabeled", True), ("labeled", False)])
def test_dbscan_scope_and_auto_eps_match(chains, tmp_path, scope, auto):
    """``--dbscan-auto`` over one scope (the k-distance figures of each
    min_samples and of the best configuration's scope), and a fixed grid
    scoped to the labeled points."""
    _, jout, _ = chains
    argv = ["--features-npz", str(jout / "features" / "standardized_features.npz"),
            "--kmeans-range", "2", "--kmeans-n-init", "2", "--tsne-perplexities", "--umap-neighbors",
            "--dbscan-min-samples", "3", "--dbscan-scope", scope]
    argv += ["--dbscan-auto"] if auto else ["--dbscan-eps", "4.0"]
    jax_clustering_main([*argv, "--output-root", str(tmp_path / "jax")])
    port_clustering.main([*argv, "--output-root", str(tmp_path / "port"), "--device", "cpu"])
    want = pd.read_csv(tmp_path / "jax" / "tables" / "metrics_clustering.csv")
    got = pd.read_csv(tmp_path / "port" / "tables" / "metrics_clustering.csv")
    _metrics_rows_match(got, want)
    assert len(got[got.method == "dbscan"]) == (3 if auto else 1)
    figs = lambda out: sorted(p.name for p in (out / "figures").glob("kdist_plot_*.png"))  # noqa: E731
    assert figs(tmp_path / "port") == figs(tmp_path / "jax")
    assert f"kdist_plot_{scope}.png" in figs(tmp_path / "port")


def test_cli_flags_match_the_jax_clis_but_the_device_default():
    from src import clustering as jc
    from src import data_audit as ja
    from src import export_unlabeled_cohort as je
    from src import standardize_features as js

    for port, jax_cli, argv in (
        (port_clustering, jc, ["--features-npz", "f.npz"]), (port_standardize, js, []),
        (port_audit, ja, []), (port_cohort, je, []),
    ):
        got, want = vars(port.parse_args(argv)), vars(jax_cli.parse_args(argv))
        assert sorted(got) == sorted(want)
        if "device" in want:
            assert (got.pop("device"), want.pop("device")) == ("auto", "cpu")
        assert got == want


@pytest.mark.parametrize("which", ["standardize", "clustering"])
def test_device_auto_needs_the_card(chains, tmp_path, which):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _, jout, _ = chains
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        if which == "standardize":
            port_standardize.main(["--embeddings-npy", str(jout / "features" / "embeddings.npy"),
                                   "--embeddings-csv", str(jout / "features" / "embeddings.csv"),
                                   "--output-npz", str(tmp_path / "s.npz")])
        else:
            port_clustering.main(["--features-npz", str(jout / "features" / "standardized_features.npz"),
                                  "--output-root", str(tmp_path)])


def test_cohort_export_refusals(chains, tmp_path):
    _, _, pout = chains
    assignments = str(pout / "tables" / "cluster_assignments.csv")
    with pytest.raises(ValueError, match="--cluster-id is required"):
        port_cohort.main(["--assignments", assignments, "--method", "kmeans", "--output", str(tmp_path / "c.csv")])
    with pytest.raises(RuntimeError, match="no rows"):
        port_cohort.main(["--assignments", assignments, "--cluster-id", "99", "--output", str(tmp_path / "c.csv")])
    port_cohort.main(["--assignments", assignments, "--method", "kmeans", "--cluster-id", "0",
                      "--output", str(tmp_path / "k.csv")])
    jax_cohort_main(["--assignments", assignments, "--method", "kmeans", "--cluster-id", "0",
                     "--output", str(tmp_path / "kj.csv")])
    assert (tmp_path / "k.csv").read_text() == (tmp_path / "kj.csv").read_text()


def test_pandas_and_matplotlib_stay_out_of_the_main_paths():
    """``import ssip_tpu_torch``, extraction, training, the sweep, the
    analysis CLIs and the audit load neither pandas nor matplotlib: the
    audit imports pandas when it runs, and matplotlib comes with the first
    figure."""
    code = (
        "import sys\n"
        "import ssip_tpu_torch, ssip_tpu_torch.pipelines.extraction, ssip_tpu_torch.pipelines.supervised\n"
        "import ssip_tpu_torch.pipelines.semi_supervised, ssip_tpu_torch.pipelines.sweep\n"
        "import ssip_tpu_torch.cli.clustering, ssip_tpu_torch.cli.standardize_features\n"
        "import ssip_tpu_torch.cli.export_unlabeled_cohort, ssip_tpu_torch.cli.threshold_sweep\n"
        "import ssip_tpu_torch.report.cluster_plots, ssip_tpu_torch.report.plots\n"
        "loaded = sorted({m.split('.')[0] for m in sys.modules} & {'pandas', 'matplotlib', 'jax', 'ssip_tpu'})\n"
        "assert not loaded, loaded\n"
        "import ssip_tpu_torch.analysis.audit, ssip_tpu_torch.cli.data_audit\n"
        "assert 'pandas' not in sys.modules and 'matplotlib' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
