"""``scripts/run_full_workflow.sh`` on the port's CLIs, on the CPU: audit →
extraction → standardize → clustering → cohort export → supervised →
semi-supervised → both threshold sweeps → the serving export, with the
script's flags, then the three ``scripts/generate_*`` on the port's
``outputs/``.

Cut to run in seconds: 64² JPEGs (8 + 8 labeled, 24 unlabeled) drawn from
three seeded families, so that clusters and a DBSCAN cohort exist; training
at 32² for one epoch a phase. Each device-aware stage gets ``--device cpu``:
the port's ``standardize_features`` and ``clustering`` default to the card,
where the JAX package's default to the CPU. The pseudo-label threshold is 0.5
(the script leaves it at 0.7): seeded weights after one epoch keep their
confidences near 0.5.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ssip_tpu_torch.cli import clustering, data_audit, export_model, export_unlabeled_cohort, feature_extraction
from ssip_tpu_torch.cli import semi_supervised_training, standardize_features, supervised_training, threshold_sweep
from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry
from tests.test_torch_temp_dirs import remove_temp_dirs  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
CUTS = ["--image-size", "32", "--baseline-epochs", "1", "--batch-size", "8"]


def _family_tree(root: Path) -> Path:
    from PIL import Image

    rng = np.random.default_rng(21)
    bases = rng.integers(0, 256, (3, 64, 64, 3))
    layout = [("avec_labels/cancer", 8, 0), ("avec_labels/normal", 8, 1), ("sans_label", 24, None)]
    for rel, count, family in layout:
        (root / rel).mkdir(parents=True)
        for i in range(count):
            base = bases[family if family is not None else i % 3]
            img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / rel / f"img_{i:02d}.jpg")
    return root


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    work = tmp_path_factory.mktemp("workflow")
    data = _family_tree(work / "data")
    out = work / "outputs"
    o = ["--output-dir", str(out)]
    stages = [
        (data_audit.main, ["--data-dir", str(data), *o]),
        (feature_extraction.main, ["--data-dir", str(data), *CPU, *o]),
        (standardize_features.main, [
            "--embeddings-npy", str(out / "features/embeddings.npy"),
            "--embeddings-csv", str(out / "features/embeddings.csv"),
            "--output-npz", str(out / "features/standardized_features.npz"), *CPU]),
        (clustering.main, ["--features-npz", str(out / "features/standardized_features.npz"),
                           "--output-root", str(out), "--dbscan-auto", "--dbscan-scope", "unlabeled", *CPU]),
        (export_unlabeled_cohort.main, ["--assignments", str(out / "tables/cluster_assignments.csv"),
                                        "--method", "dbscan", "--output", str(out / "tables/unlabeled_cohort_dbscan.csv")]),
        (supervised_training.main, ["--strong-data-dir", str(data / "avec_labels"),
                                    "--target-recall", "0.98", "--min-precision", "0.60", *CPU, *CUTS, *o]),
        (semi_supervised_training.main, [
            "--strong-data-dir", str(data / "avec_labels"), "--weak-data-dir", str(data / "sans_label"),
            "--unlabeled-cohort-csv", str(out / "tables/unlabeled_cohort_dbscan.csv"),
            "--target-recall", "0.98", "--min-precision", "0.60", *CPU, *CUTS,
            "--weak-pretrain-epochs", "1", "--finetune-epochs", "1", "--pseudo-threshold", "0.5", *o]),
        (threshold_sweep.main, ["--strong-data-dir", str(data / "avec_labels"), "--model", "baseline", *CPU, *o]),
        (threshold_sweep.main, ["--strong-data-dir", str(data / "avec_labels"), "--model", "semi", *CPU, *o]),
        (export_model.main, ["--model", "semi", *CPU, *o]),
    ]
    for main, argv in stages:
        main(argv)
    for script in ("generate_model_comparison.py", "generate_reporting_assets.py", "generate_outputs_readme.py"):
        subprocess.run([sys.executable, str(REPO / "scripts" / script), *o], cwd=REPO, check=True, timeout=300)
    return data, out


def _rows(path: Path) -> list:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_every_stage_writes_its_artifacts(workflow):
    data, out = workflow
    reg = ArtifactRegistry(out)
    for path in (
        reg.data_audit_md, reg.directory_summary_csv, reg.image_summary_csv,
        reg.embeddings_npy, reg.embeddings_csv, reg.features_metadata_json, out / "features/standardized_features.npz",
        reg.clustering_metrics_csv, reg.cluster_assignments_csv, reg.clustering_report_md,
        out / "tables/unlabeled_cohort_dbscan.csv",
        reg.baseline_checkpoint, reg.semi_checkpoint, reg.results_comparison_csv,
        reg.results_comparison_detailed_csv, reg.training_history_json, reg.operating_point_json,
        reg.threshold_sweep_csv("baseline"), reg.threshold_sweep_csv("semi"), reg.serving_artifact("semi"),
        out / "figures/model_comparison.png", out / "figures/pipeline_architecture.png",
        out / "notes/summary_slides.pdf", reg.outputs_readme_md,
    ):
        assert path.is_file() and path.stat().st_size > 0, path
    for fig in ("sample_grid.png", "pca2d_clusters.png", "tsne2d_clusters.png", "umap2d_clusters.png",
                "kdist_plot_unlabeled.png", "kdist_plot_unlabeled_ms5.png"):
        assert (out / "figures" / fig).is_file(), fig
    assert len(list((out / "features/embeddings").glob("*.npz"))) == 3 + 3 + 6


def test_stage_outputs_are_well_formed(workflow):
    data, out = workflow
    reg = ArtifactRegistry(out)
    emb = np.load(reg.embeddings_npy)
    assert emb.shape == (40, 512) and np.isfinite(emb).all()
    with np.load(out / "features/standardized_features.npz") as z:
        assert z["features"].shape == (40, 512) and int(z["is_labeled"].sum()) == 16
    metrics = _rows(reg.clustering_metrics_csv)
    assert {r["method"] for r in metrics} == {"kmeans", "dbscan"}
    assert sum(r["method"] == "kmeans" for r in metrics) == 9  # k = 2..10
    assert sum(r["method"] == "dbscan" for r in metrics) == 27  # 3 min_samples × (3 × 3 auto eps)
    assert all(r["space"] == "pca_cluster:unlabeled" for r in metrics if r["method"] == "dbscan")
    cohort = _rows(out / "tables/unlabeled_cohort_dbscan.csv")
    assert 0 < len(cohort) <= 24 and all(r["path"].startswith("sans_label/") for r in cohort)
    history = json.loads(reg.training_history_json.read_text())
    assert history["pseudo_label_count"] > 0 and len(history["semi_finetune"]["val_loss"]) == 1
    test_size = len(history["splits"]["test"])
    for model in ("baseline", "semi"):
        rows = _rows(reg.threshold_sweep_csv(model))
        assert rows and all(sum(float(r[c]) for c in ("TP", "FP", "TN", "FN")) == test_size for r in rows)
    readme = reg.outputs_readme_md.read_text()
    for section in ("## Feature extraction", "## Model results", "## Unsupervised analysis"):
        assert section in readme, section
