"""CLI: export an unlabeled cohort CSV from cluster assignments (host only).

Counterpart of ``src/export_unlabeled_cohort.py`` (reference
src/export_unlabeled_cohort.py:55-79), with the same flags, defaults and
artifact: keep the unlabeled rows; DBSCAN keeps the non-noise ones (or one
cluster id), K-Means needs a cluster id; write a single ``path`` column.
Read and written with the stdlib ``csv`` module.

    python -m ssip_tpu_torch.cli.export_unlabeled_cohort --method dbscan
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--assignments", type=Path, default=Path("outputs/tables/cluster_assignments.csv"))
    parser.add_argument("--method", choices=["dbscan", "kmeans"], default="dbscan")
    parser.add_argument("--cluster-id", type=int, default=None)
    parser.add_argument("--output", type=Path, default=Path("outputs/tables/unlabeled_cohort.csv"))
    return parser.parse_args(argv)


def _is_true(cell: str) -> bool:
    """A cell of a boolean column as pandas reads it: ``True``/``False``
    (or 1/0)."""
    return cell.strip().lower() in ("true", "1", "1.0")


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.assignments.exists():
        raise FileNotFoundError(f"Assignments CSV not found: {args.assignments}")
    col = f"cluster_{args.method}"
    with open(args.assignments, newline="", encoding="utf-8") as fh:
        reader = csv.DictReader(fh)
        missing = {"path", "is_labeled", col} - set(reader.fieldnames or [])
        if missing:
            raise KeyError(f"Assignments CSV missing columns: {sorted(missing)}")
        pool = [row for row in reader if not _is_true(row["is_labeled"])]

    if args.cluster_id is not None:
        pool = [row for row in pool if int(row[col]) == args.cluster_id]
    elif args.method == "dbscan":
        pool = [row for row in pool if int(row[col]) != -1]  # all non-noise
    else:
        raise ValueError("--cluster-id is required when --method kmeans")

    if not pool:
        raise RuntimeError("Cohort selection produced no rows")
    args.output.parent.mkdir(parents=True, exist_ok=True)
    with open(args.output, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["path"])
        writer.writerows([row["path"]] for row in pool)
    print(f"Wrote {len(pool)} cohort rows to {args.output}")


if __name__ == "__main__":
    main()
