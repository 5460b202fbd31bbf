"""The data-audit artifact contract, as data.

Every user-visible string, figure spec, and file name the audit emits lives
here, separated from the engine in ``audit.py``. The *text* is contractual:
downstream consumers of the reference diff ``notes/data_audit.md`` and the
CSV schemas (reference src/data_audit.py:282-397 defines the wording), so
these strings must not drift even as the engine is free to change.

The port's own copy of ``ssip_tpu/analysis/audit_contract.py`` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

# bucket directory name → logical bucket label (reference layout,
# docs/dataset.md in the reference repo)
BUCKETS = (("avec_labels", "labeled"), ("sans_label", "unlabeled"))

# PIL modes treated as grayscale for the intensity histogram
GRAYSCALE_MODES = frozenset({"1", "L", "LA", "I", "F"})

# image_summary.csv column order
SUMMARY_COLUMNS = (
    "bucket", "path", "width", "height", "mode", "format",
    "bytes", "readable", "aspect_ratio",
)

# histogram figures: (dataframe column, xlabel, title, bar color, file name)
HISTOGRAMS = (
    ("width", "Width (pixels)", "Sample Width Distribution",
     "#3b7ddd", "width_hist.png"),
    ("height", "Height (pixels)", "Sample Height Distribution",
     "#da5b3b", "height_hist.png"),
    ("aspect_ratio", "Aspect Ratio (W/H)", "Sample Aspect Ratio Distribution",
     "#5bda3b", "aspect_hist.png"),
)
INTENSITY_HIST = (
    "Pixel Intensity", "Frequency", "Grayscale Intensity Distribution",
    "intensity_hist.png",
)

# observation wording (reference data_audit.py:282-315)
OBS_UNREADABLE = "Detected {n} unreadable files in the sample."
OBS_ALL_READABLE = "No unreadable files detected in the sampled set."
OBS_SINGLE_MODE = "Sampled images share a single mode: {mode}."
OBS_RGB_HINT = (
    "Convert to a single grayscale channel if downstream models "
    "expect MRI intensity inputs."
)
OBS_GRAY_HINT = (
    "Grayscale inputs align with typical MRI pipelines; ensure "
    "channel handling stays consistent."
)
OBS_MIXED_MODES = (
    "Mixed image modes detected ({modes}); harmonize channels before training."
)
OBS_DOMINANT_SIZE = (
    "Most sampled images are {w}x{h} ({n}/{total}); "
    "standardize other files to this resolution."
)
OBS_NORMALIZE = (
    "Normalize pixel intensities to [0, 1] and consider per-image "
    "standardization for contrast stability."
)
OBS_VERIFY_LABELS = (
    "Verify labeled subdirectories align with metadata before "
    "splitting into train/val sets."
)

# data_audit.md skeleton
REPORT_TITLE = "# Data Audit Notes"
SECTION_STRUCTURE = "## Directory Structure"
SECTION_STATS = "## Sampled Metadata Summary"
SECTION_OBSERVATIONS = "## Observations"
SECTION_ARTIFACTS = "## Artifacts"
ARTIFACT_LINES = (
    "- Sample grid: `outputs/figures/sample_grid.png`",
    "- Width histogram: `outputs/figures/width_hist.png`",
    "- Height histogram: `outputs/figures/height_hist.png`",
    "- Aspect ratio histogram: `outputs/figures/aspect_hist.png`",
    "- Sample metadata: `outputs/tables/image_summary.csv`",
    "- Directory summary: `outputs/tables/directory_summary.csv`",
)
