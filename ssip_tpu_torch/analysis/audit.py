"""Dataset audit engine: inventory scan → sampled probe → figures → report.

Output parity with the reference audit (reference src/data_audit.py — the
artifact *text and schemas* are the contract, kept verbatim in
``audit_contract.py``): ``tables/{directory_summary,image_summary}.csv``,
``figures/{sample_grid,width_hist,height_hist,aspect_hist,intensity_hist}.png``,
``notes/data_audit.md``, same sampling RNG (``random.Random(seed).sample``
over the bucket-ordered inventory) and the same observation heuristics.

The engine itself is organized differently from the reference: one
DataFrame-centric scan/probe pair feeds declarative figure specs and a
rule table (predicate → message) instead of a function-per-artifact chain.
Host-IO-bound by nature — no device work here.

The port's own copy of ``ssip_tpu/analysis/audit.py`` (the port imports
nothing of the JAX package). pandas is imported by this module's functions
alone in the port, and matplotlib only by the functions that draw, so
importing any module of the port loads neither.
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
from PIL import Image

from ssip_tpu_torch.analysis import audit_contract as contract
from ssip_tpu_torch.report import pyplot
from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)


# --------------------------------------------------------------------------
# scan: one walk over the bucket layout → inventory frame
# --------------------------------------------------------------------------

def scan_dataset(data_dir: Path) -> pd.DataFrame:
    """Inventory frame with one row per file: bucket, subdirectory, path.

    Row order is the sampling order of record: buckets in contract order,
    files in sorted-rglob order within each (this ordering is what makes
    ``sample_inventory`` reproduce the reference's draws).
    """
    import pandas as pd

    data_dir = Path(data_dir)
    rows: List[Tuple[str, str, Path]] = []
    for dirname, bucket in contract.BUCKETS:
        root = data_dir / dirname
        if not root.exists():
            raise FileNotFoundError(f"Missing expected bucket directory: {root}")
        for p in sorted(root.rglob("*")):
            if not p.is_file():
                continue
            rel = p.relative_to(data_dir)
            sub = rel.parts[1] if len(rel.parts) > 2 else "(root)"
            rows.append((bucket, sub, p))
    return pd.DataFrame(rows, columns=["bucket", "subdirectory", "abspath"])


def directory_summary(inventory: pd.DataFrame) -> pd.DataFrame:
    """Per-(bucket, subdirectory) file counts, sorted — directory_summary.csv."""
    import pandas as pd

    if inventory.empty:
        counts = pd.DataFrame(columns=["bucket", "subdirectory", "file_count"])
    else:
        counts = (
            inventory.groupby(["bucket", "subdirectory"], as_index=False)
            .size()
            .rename(columns={"size": "file_count"})
        )
    # buckets with zero files still get a "(root)" row, like the reference
    present = set(counts["bucket"]) if not counts.empty else set()
    fillers = [
        {"bucket": bucket, "subdirectory": "(root)", "file_count": 0}
        for _, bucket in contract.BUCKETS
        if bucket not in present
    ]
    if fillers:
        counts = pd.concat([counts, pd.DataFrame(fillers)], ignore_index=True)
    return counts.sort_values(["bucket", "subdirectory"]).reset_index(drop=True)


def sample_inventory(
    inventory: pd.DataFrame, sample_size: int, seed: int = 42
) -> List[Path]:
    """Deterministic sample over the whole inventory (reference RNG parity:
    ``random.Random(seed).sample`` over the bucket-ordered file list)."""
    paths = list(inventory["abspath"])
    if not paths:
        return []
    return random.Random(seed).sample(paths, min(sample_size, len(paths)))


# --------------------------------------------------------------------------
# probe: PIL header metadata for the sampled files → summary frame
# --------------------------------------------------------------------------

def probe_images(sampled: List[Path], data_dir: Path) -> pd.DataFrame:
    """image_summary rows: header metadata with readable=False tolerance."""
    import pandas as pd

    bucket_of = dict(contract.BUCKETS)
    rows = []
    for p in sampled:
        rel = p.relative_to(data_dir)
        row = {
            "bucket": bucket_of.get(rel.parts[0], rel.parts[0]),
            "path": str(rel),
            "width": None, "height": None, "mode": None, "format": None,
            "bytes": p.stat().st_size,
            "readable": True,
            "abspath": p,
        }
        try:
            with Image.open(p) as img:
                row["width"], row["height"] = img.size
                row["mode"], row["format"] = img.mode, img.format
        except Exception:
            row["readable"] = False
        rows.append(row)
    df = pd.DataFrame(
        rows,
        columns=list(contract.SUMMARY_COLUMNS[:-1]) + ["abspath"],
    )
    df["aspect_ratio"] = df["width"] / df["height"]
    return df.sort_values(["bucket", "path"]).reset_index(drop=True)


# --------------------------------------------------------------------------
# figures: declarative specs over the summary frame
# --------------------------------------------------------------------------

def render_figures(summary: pd.DataFrame, figures_dir: Path) -> None:
    figures_dir.mkdir(parents=True, exist_ok=True)
    _sample_grid(summary, figures_dir / "sample_grid.png")

    numeric = summary.dropna(subset=["width", "height", "bytes", "aspect_ratio"])
    if not numeric.empty:
        for column, xlabel, title, color, name in contract.HISTOGRAMS:
            _hist_figure(
                numeric[column], xlabel, title, figures_dir / name,
                bins=20, color=color,
            )
        _intensity_figure(summary, figures_dir)


def _sample_grid(summary: pd.DataFrame, out: Path) -> None:
    plt = pyplot()
    readable = summary[summary["readable"]]
    if readable.empty:
        return
    n = len(readable)
    cols = min(8, n)
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 2.2, rows * 2.2))
    flat = np.atleast_1d(axes).reshape(-1)
    for ax, (_, row) in zip(flat, readable.iterrows()):
        with Image.open(row["abspath"]) as img:
            ax.imshow(img if img.mode == "RGB" else img.convert("RGB"))
        ax.set_title(Path(row["path"]).name, fontsize=8)
        ax.axis("off")
    for ax in flat[n:]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out, dpi=200)
    plt.close(fig)


def _hist_figure(series, xlabel, title, out: Path, *, bins, color) -> None:
    plt = pyplot()
    fig, ax = plt.subplots()
    ax.hist(series, bins=bins, color=color)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Count")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out, dpi=200)
    plt.close(fig)


def _intensity_figure(summary: pd.DataFrame, figures_dir: Path) -> None:
    plt = pyplot()
    gray = summary[summary["mode"].isin(contract.GRAYSCALE_MODES)]
    if gray.empty:
        return
    xlabel, ylabel, title, name = contract.INTENSITY_HIST
    fig, ax = plt.subplots()
    for _, row in gray.iterrows():
        with Image.open(row["abspath"]) as img:
            ax.hist(
                np.array(img.convert("L")).ravel(), bins=30, alpha=0.4,
                label=Path(row["path"]).stem,
            )
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    if len(gray) <= 10:
        ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(figures_dir / name, dpi=200)
    plt.close(fig)


# --------------------------------------------------------------------------
# observations: rule table (each rule: summary frames → messages)
# --------------------------------------------------------------------------

def _rule_readability(summary, _dirs) -> List[str]:
    n = int((~summary["readable"]).sum())
    return [contract.OBS_UNREADABLE.format(n=n) if n else contract.OBS_ALL_READABLE]


def _rule_modes(summary, _dirs) -> List[str]:
    modes = summary["mode"].dropna().unique()
    if len(modes) == 1:
        out = [contract.OBS_SINGLE_MODE.format(mode=modes[0])]
        if modes[0] == "RGB":
            out.append(contract.OBS_RGB_HINT)
        elif modes[0] in {"L", "1"}:
            out.append(contract.OBS_GRAY_HINT)
        return out
    if len(modes) > 1:
        return [contract.OBS_MIXED_MODES.format(modes=", ".join(modes))]
    return []


def _rule_dominant_size(summary, _dirs) -> List[str]:
    sized = summary.dropna(subset=["width", "height"])
    if sized.empty:
        return []
    counts = sized.groupby(["width", "height"]).size()
    (w, h), n = counts.idxmax(), counts.max()
    return [
        contract.OBS_DOMINANT_SIZE.format(
            w=int(w), h=int(h), n=int(n), total=len(summary)
        )
    ]


def _rule_normalization(_summary, _dirs) -> List[str]:
    return [contract.OBS_NORMALIZE]


def _rule_labeled_bucket(_summary, dirs) -> List[str]:
    labeled_total = dirs.loc[dirs["bucket"] == "labeled", "file_count"].sum()
    return [contract.OBS_VERIFY_LABELS] if labeled_total else []


RULES: Tuple[Callable[[pd.DataFrame, pd.DataFrame], List[str]], ...] = (
    _rule_readability,
    _rule_modes,
    _rule_dominant_size,
    _rule_normalization,
    _rule_labeled_bucket,
)


def generate_observations(
    summary: pd.DataFrame, dirs: pd.DataFrame
) -> List[str]:
    out: List[str] = []
    for rule in RULES:
        out.extend(rule(summary, dirs))
    return out


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

def _structure_section(dirs: pd.DataFrame, data_dir: Path) -> List[str]:
    dir_of = {bucket: dirname for dirname, bucket in contract.BUCKETS}
    lines = []
    for _, bucket in contract.BUCKETS:
        rows = dirs[dirs["bucket"] == bucket]
        total = int(rows["file_count"].sum())
        lines.append(f"- **{bucket}** (`{data_dir / dir_of[bucket]}`): {total} files")
        lines.extend(
            f"  - {r['subdirectory']}: {int(r['file_count'])}"
            for _, r in rows.iterrows()
        )
    return lines


def render_report(
    summary: pd.DataFrame,
    dirs: pd.DataFrame,
    observations: List[str],
    data_dir: Path,
    out_path: Path,
) -> None:
    stats = (
        summary[["width", "height", "bytes"]]
        .dropna().astype(int).describe().round(2)
    )
    sections = [
        (None, [contract.REPORT_TITLE]),
        (contract.SECTION_STRUCTURE, _structure_section(dirs, data_dir)),
        (contract.SECTION_STATS, ["```", str(stats), "```"]),
        (contract.SECTION_OBSERVATIONS, [f"- {o}" for o in observations]),
        (contract.SECTION_ARTIFACTS, list(contract.ARTIFACT_LINES)),
    ]
    lines: List[str] = []
    for header, body in sections:
        if header is not None:
            lines += [header, ""]
        lines += body
        lines.append("")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text("\n".join(lines), encoding="utf-8")


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def audit_dataset(
    data_dir: Path, sample_size: int, seed: int, output_root: Path = Path("outputs")
) -> pd.DataFrame:
    from ssip_tpu_torch.runtime.artifacts import ArtifactRegistry

    reg = ArtifactRegistry(Path(output_root))
    reg.tables_dir.mkdir(parents=True, exist_ok=True)

    inventory = scan_dataset(Path(data_dir))
    dirs = directory_summary(inventory)
    dirs.to_csv(reg.directory_summary_csv, index=False)

    sampled = sample_inventory(inventory, sample_size, seed=seed)
    summary = probe_images(sampled, Path(data_dir))
    summary[list(contract.SUMMARY_COLUMNS)].to_csv(reg.image_summary_csv, index=False)

    render_figures(summary, reg.figures_dir)
    observations = generate_observations(summary, dirs)
    render_report(summary, dirs, observations, Path(data_dir), reg.data_audit_md)
    LOGGER.info(
        "Audit complete: %d files inventoried, %d sampled",
        len(inventory), len(summary),
    )
    return summary[list(contract.SUMMARY_COLUMNS)]
