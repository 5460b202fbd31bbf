"""Artifact-path registry: the reference's ``outputs/`` file contract.

Every inter-stage handoff in the pipeline goes through files under
``outputs/`` (reference: src/training/common.py:68-80,
src/feature_extraction.py:53-62, src/data_audit.py:41-46). This registry is
the single source of truth for those paths so all stages agree; the layout is
byte-identical to the reference's so downstream consumers can switch
frameworks without changing a path.

The port's own copy of ``ssip_tpu/runtime/artifacts.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_shared.py`` holds every path
to the original's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class ArtifactRegistry:
    """Resolves every artifact path below a configurable output root."""

    root: Path = field(default_factory=lambda: Path("outputs"))

    # -- directories ------------------------------------------------------
    @property
    def features_dir(self) -> Path:
        return self.root / "features"

    @property
    def tables_dir(self) -> Path:
        return self.root / "tables"

    @property
    def figures_dir(self) -> Path:
        return self.root / "figures"

    @property
    def notes_dir(self) -> Path:
        return self.root / "notes"

    @property
    def logs_dir(self) -> Path:
        return self.root / "logs"

    @property
    def models_dir(self) -> Path:
        return self.root / "models"

    # -- feature extraction (reference: feature_extraction.py:53-62) ------
    @property
    def embeddings_npy(self) -> Path:
        return self.features_dir / "embeddings.npy"

    @property
    def embeddings_csv(self) -> Path:
        return self.features_dir / "embeddings.csv"

    @property
    def features_metadata_json(self) -> Path:
        return self.features_dir / "metadata.json"

    @property
    def feature_summary_md(self) -> Path:
        return self.notes_dir / "feature_summary.md"

    @property
    def extraction_log(self) -> Path:
        return self.logs_dir / "feature_extraction.log"

    # -- standardization / clustering -------------------------------------
    @property
    def standardized_npz(self) -> Path:
        return self.features_dir / "standardized_features.npz"

    @property
    def clustering_metrics_csv(self) -> Path:
        return self.tables_dir / "metrics_clustering.csv"

    @property
    def cluster_assignments_csv(self) -> Path:
        return self.tables_dir / "cluster_assignments.csv"

    @property
    def clustering_report_md(self) -> Path:
        return self.notes_dir / "clustering_report.md"

    @property
    def unlabeled_cohort_csv(self) -> Path:
        return self.tables_dir / "unlabeled_cohort.csv"

    # -- training (reference: common.py:68-80) -----------------------------
    @property
    def results_comparison_csv(self) -> Path:
        return self.tables_dir / "results_comparison.csv"

    @property
    def results_comparison_detailed_csv(self) -> Path:
        return self.tables_dir / "results_comparison_detailed.csv"

    @property
    def training_history_json(self) -> Path:
        return self.notes_dir / "training_history.json"

    @property
    def baseline_checkpoint(self) -> Path:
        return self.models_dir / "baseline_resnet18.pt"

    @property
    def semi_checkpoint(self) -> Path:
        return self.models_dir / "semi_resnet18.pt"

    @property
    def operating_point_json(self) -> Path:
        return self.notes_dir / "operating_point.json"

    def serving_artifact(self, model: str = "semi") -> Path:
        """AOT serving export (ours — no reference counterpart)."""
        return self.models_dir / f"{model}_serving.ssip.npz"

    @property
    def triage_csv(self) -> Path:
        return self.tables_dir / "unlabeled_predictions_semi.csv"

    @property
    def seed_sweep_csv(self) -> Path:
        """Per-seed results of --num-seeds fan-out training (ours — no
        reference counterpart; train.multi_seed)."""
        return self.tables_dir / "seed_sweep.csv"

    @property
    def cv_results_csv(self) -> Path:
        """Per-fold results of --cv-folds cross-validation (ours — no
        reference counterpart; all folds train as one vmapped program)."""
        return self.tables_dir / "cv_results.csv"

    # -- figures ------------------------------------------------------------
    @property
    def baseline_curves_png(self) -> Path:
        return self.figures_dir / "train_curves_baseline.png"

    @property
    def semi_curves_png(self) -> Path:
        return self.figures_dir / "train_curves_semi.png"

    @property
    def baseline_confusion_png(self) -> Path:
        return self.figures_dir / "confusion_matrix_baseline.png"

    @property
    def baseline_confusion_thresholded_png(self) -> Path:
        return self.figures_dir / "confusion_matrix_baseline_thresholded.png"

    @property
    def semi_confusion_png(self) -> Path:
        return self.figures_dir / "confusion_matrix_semi.png"

    @property
    def semi_confusion_thresholded_png(self) -> Path:
        return self.figures_dir / "confusion_matrix_semi_thresholded.png"

    @property
    def roc_curves_png(self) -> Path:
        return self.figures_dir / "roc_curves.png"

    @property
    def pr_curves_png(self) -> Path:
        return self.figures_dir / "pr_curves.png"

    @property
    def metrics_comparison_png(self) -> Path:
        return self.figures_dir / "metrics_comparison.png"

    # -- data audit (reference: data_audit.py:41-46) ------------------------
    @property
    def data_audit_md(self) -> Path:
        return self.notes_dir / "data_audit.md"

    @property
    def directory_summary_csv(self) -> Path:
        return self.tables_dir / "directory_summary.csv"

    @property
    def image_summary_csv(self) -> Path:
        return self.tables_dir / "image_summary.csv"

    # -- run summary ---------------------------------------------------------
    @property
    def outputs_readme_md(self) -> Path:
        """Run-summary README at the artifact root (the reference ships one
        as ``outputs/README.md``)."""
        return self.root / "README.md"

    # -- helpers ------------------------------------------------------------
    def threshold_sweep_csv(self, model: str) -> Path:
        return self.tables_dir / f"threshold_sweep_{model}.csv"

    def ensure_dirs(self) -> None:
        for d in (
            self.features_dir,
            self.tables_dir,
            self.figures_dir,
            self.notes_dir,
            self.logs_dir,
            self.models_dir,
        ):
            d.mkdir(parents=True, exist_ok=True)
