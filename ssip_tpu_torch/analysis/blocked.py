"""Corpus-scale policy for the dense analysis kernels.

The analysis stack is exact dense linear algebra — the right shape at the
reference's N=1506 and cheap on the tensor cores up to tens of thousands of points.
Past that, every kernel must either switch to a blocked formulation with
O(CHUNK·N) memory (k-distance, silhouette, DBSCAN neighborhoods) or fail
fast with an actionable message (t-SNE/UMAP, whose optimizers are
inherently O(N²) in this exact form) — never OOM silently.

The port's own copy of ``ssip_tpu/analysis/blocked.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

# Above this many rows, [N, N] matrices stop fitting comfortably and the
# blocked paths take over.
DENSE_LIMIT = 8192
# Row-block size for the blocked paths: one [CHUNK, N] tile at a time.
CHUNK = 1024


def check_embedding_cap(n: int, max_points: int, algorithm: str) -> None:
    """Fail fast when a visualization embedding is asked for too many points."""
    if n > max_points:
        raise ValueError(
            f"{algorithm} is O(N²) in this exact dense formulation and is "
            f"capped at max_points={max_points} (got N={n}). These 2-D "
            "embeddings are visualization-only — subsample the corpus "
            "(deterministically, e.g. rng(seed).choice) before calling, or "
            "raise max_points explicitly if you accept the memory cost."
        )
