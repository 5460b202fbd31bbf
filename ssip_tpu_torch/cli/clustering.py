"""CLI: clustering analysis over standardized features, on PyTorch (CUDA or CPU).

Counterpart of ``src/clustering.py`` (reference src/clustering.py:780-927),
with the same flags, defaults and artifacts but one: ``--device`` takes
``auto|cpu|cuda`` and defaults to ``auto``, the card. The JAX CLI defaults
to ``cpu``, a work-around for the TPU's SVD over a remote runtime; the port's
entry points run on the card unless asked for the CPU. ``run_analysis``
writes every table, embedding and note; ``draw_figures`` the figures, which
need matplotlib.

    python -m ssip_tpu_torch.cli.clustering --features-npz outputs/features/standardized_features.npz
"""

from __future__ import annotations

import argparse
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import torch

from ssip_tpu_torch.analysis import clustering as C
from ssip_tpu_torch.analysis.dbscan import auto_eps_from_kdistance
from ssip_tpu_torch.runtime.device import resolve_device
from ssip_tpu_torch.runtime.logging import configure_logging


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--features-npz", type=Path, required=True)
    parser.add_argument("--output-root", type=Path, default=Path("outputs"))
    parser.add_argument("--variance-target", type=float, default=0.9)
    parser.add_argument("--tsne-dim", type=int, default=50)
    parser.add_argument("--tsne-perplexities", type=float, nargs="*", default=[10.0, 30.0, 50.0])
    parser.add_argument("--umap-neighbors", type=int, nargs="*", default=[15, 30, 50])
    parser.add_argument("--umap-min-dist", type=float, nargs="*", default=[0.0, 0.1])
    parser.add_argument("--kmeans-range", type=int, nargs="*", default=list(range(2, 11)))
    parser.add_argument("--kmeans-n-init", type=int, default=10)
    parser.add_argument("--dbscan-eps", type=float, nargs="*", default=[0.5, 0.75, 1.0, 1.25])
    parser.add_argument("--dbscan-min-samples", type=int, nargs="*", default=[5, 10, 15])
    parser.add_argument("--dbscan-scope", choices=["all", "labeled", "unlabeled"], default="all")
    parser.add_argument("--dbscan-auto", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--log-level", choices=["DEBUG", "INFO", "WARNING", "ERROR"], default="INFO")
    parser.add_argument(
        "--device", choices=["auto", "cpu", "cuda"], default="auto",
        help="auto (default) and cuda: the card, and an error when none is visible; cpu: the host. "
        "(src.clustering defaults to cpu, a TPU work-around.)",
    )
    return parser.parse_args(argv)


@dataclass
class ClusteringRun:
    """What the figures are drawn from."""

    bundle: C.FeatureBundle
    pca_results: C.PCAResults
    tsne_results: List[C.EmbeddingResult]
    umap_results: List[C.EmbeddingResult]
    best_kmeans: C.ClusteringResult
    best_dbscan: Optional[C.ClusteringResult]


def run_analysis(args: argparse.Namespace, device: torch.device) -> ClusteringRun:
    """PCA, t-SNE, UMAP, the K-Means and DBSCAN sweeps, the two tables, the
    embeddings and the report: everything but the figures."""
    bundle = C.load_feature_bundle(args.features_npz)
    stats = C.validate_standardization(bundle)

    pca_results = C.run_pca(bundle.features, args.variance_target, args.tsne_dim, args.seed, device=device)
    embedding_dir = args.output_root / "features" / "embeddings"
    C.save_embedding_npz(embedding_dir, pca_results.cluster_space)
    C.save_embedding_npz(embedding_dir, pca_results.pca_2d)
    C.save_embedding_npz(embedding_dir, pca_results.pca_tsne_init)

    tsne_results = C.run_tsne(pca_results.pca_tsne_init, args.tsne_perplexities, args.seed, device=device)
    for result in tsne_results:
        C.save_embedding_npz(embedding_dir, result)
    umap_results = C.run_umap(
        pca_results.pca_tsne_init, args.umap_neighbors, args.umap_min_dist, args.seed, device=device
    )
    for result in umap_results:
        C.save_embedding_npz(embedding_dir, result)

    kmeans_results = C.evaluate_kmeans(
        pca_results.cluster_space, bundle, args.kmeans_range, args.kmeans_n_init, args.seed, device=device
    )

    dbscan_eps_grid = args.dbscan_eps
    if args.dbscan_auto:
        sub_space = pca_results.cluster_space.data[C.scope_mask(bundle, args.dbscan_scope)]
        dbscan_eps_grid = []
        for ms in args.dbscan_min_samples:
            base_eps = auto_eps_from_kdistance(sub_space, int(ms), quantile=0.98, device=device)
            dbscan_eps_grid.extend(max(1e-6, base_eps * f) for f in (0.8, 1.0, 1.2))
        dbscan_eps_grid = sorted(set(float(e) for e in dbscan_eps_grid))

    dbscan_results = C.evaluate_dbscan(
        pca_results.cluster_space, bundle, dbscan_eps_grid, args.dbscan_min_samples,
        args.seed, scope=args.dbscan_scope, device=device,
    )

    C.write_metrics_table(kmeans_results + dbscan_results, args.output_root / "tables" / "metrics_clustering.csv")

    best_kmeans = C.choose_best(kmeans_results)
    if best_kmeans is None:
        raise RuntimeError("K-Means sweep produced no viable solutions.")
    best_dbscan = C.choose_best(dbscan_results)

    C.write_assignments_table(
        bundle, best_kmeans, best_dbscan, pca_results,
        tsne_results[0] if tsne_results else pca_results.pca_2d,
        umap_results[0] if umap_results else pca_results.pca_2d,
        args.output_root / "tables" / "cluster_assignments.csv",
    )
    C.write_report(args.output_root / "notes" / "clustering_report.md", stats, best_kmeans, best_dbscan)
    return ClusteringRun(bundle, pca_results, tsne_results, umap_results, best_kmeans, best_dbscan)


def draw_figures(args: argparse.Namespace, run: ClusteringRun, device: torch.device) -> None:
    """The k-distance curves of ``--dbscan-auto`` and of the best DBSCAN's
    scope, and the PCA, t-SNE and UMAP overlays."""
    from ssip_tpu_torch.report.cluster_plots import plot_embedding, plot_k_distance

    bundle, cluster_space = run.bundle, run.pca_results.cluster_space.data
    figures_dir = args.output_root / "figures"
    if args.dbscan_auto:
        sub_space = cluster_space[C.scope_mask(bundle, args.dbscan_scope)]
        for ms in args.dbscan_min_samples:
            plot_k_distance(
                C.EmbeddingResult(f"pca_cluster:{args.dbscan_scope}", sub_space, {}), int(ms),
                figures_dir / f"kdist_plot_{args.dbscan_scope}_ms{int(ms)}.png", device=device,
            )

    noise_rate = run.best_dbscan.noise_rate if run.best_dbscan is not None else None
    labels = run.best_kmeans.labels
    plot_embedding(
        run.pca_results.pca_2d, bundle, labels, "PCA 2D — labeled overlay",
        figures_dir / "pca2d_clusters.png", dbscan_noise_rate=noise_rate,
    )
    if run.tsne_results:
        plot_embedding(
            run.tsne_results[0], bundle, labels, "t-SNE 2D — labeled overlay",
            figures_dir / "tsne2d_clusters.png", dbscan_noise_rate=noise_rate,
        )
    if run.umap_results:
        plot_embedding(
            run.umap_results[0], bundle, labels, "UMAP 2D — labeled overlay",
            figures_dir / "umap2d_clusters.png", dbscan_noise_rate=noise_rate,
        )
    if run.best_dbscan is not None:
        # the k-distance figure of the BEST DBSCAN's scope, over that scope's
        # points and its min_samples (reference src/clustering.py:898-917)
        scope = str(run.best_dbscan.params.get("scope", args.dbscan_scope))
        plot_k_distance(
            C.EmbeddingResult(f"pca_cluster:{scope}", cluster_space[C.scope_mask(bundle, scope)], {}),
            int(run.best_dbscan.params.get("min_samples", 5)),
            figures_dir / f"kdist_plot_{scope}.png", device=device,
        )


def main(argv=None) -> None:
    args = parse_args(argv)
    configure_logging(args.log_level)
    device = resolve_device(args.device)
    run = run_analysis(args, device)
    draw_figures(args, run, device)
    logging.info("Clustering analysis complete.")


if __name__ == "__main__":
    main()
