"""The port's analysis stack against the JAX package's, module by module, on
the CPU: the same seeded numpy inputs (N ≤ 300, D ≤ 32) through both.

Tolerances, and why:

- host numpy copied as it is (k-means++ seeding, DBSCAN's BFS, ARI, NMI,
  UMAP's ``fit_ab``): bitwise;
- labels (k-means, DBSCAN) on data with no distance near a decision
  boundary: equal;
- float32 reductions summed in another order (scaler statistics, PCA, the
  distance GEMMs): 1e-5 relative, or the rounding of ‖x‖² where a distance
  near 0 comes out of ‖x‖² + ‖y‖² − 2x·y;
- t-SNE and UMAP: their pieces (P, the fuzzy graph, one step, the first
  steps) tightly; the whole 1000- or 200-step run by its KL divergence and by
  which points stay each other's neighbours, since float32 sums in another
  order move a long optimization's coordinates apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssip_tpu.analysis import cluster_metrics as jmetrics
from ssip_tpu.analysis import dbscan as jdbscan
from ssip_tpu.analysis import kmeans as jkmeans
from ssip_tpu.analysis import pca as jpca
from ssip_tpu.analysis import standardize as jstandardize
from ssip_tpu.analysis import tsne as jtsne
from ssip_tpu.analysis import umap_jax as jumap
from ssip_tpu.runtime.prng import host_rng as jax_host_rng
from ssip_tpu_torch.analysis import cluster_metrics, dbscan, kmeans, pca, standardize, tsne, umap
from ssip_tpu_torch.runtime.device import float32_products
from ssip_tpu_torch.runtime.prng import host_rng

CPU = torch.device("cpu")


def _blobs(n=300, d=16, centers=4, std=1.0, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, spread, (centers, d))
    y = rng.integers(0, centers, n)
    return (c[y] + rng.normal(0.0, std, (n, d))).astype(np.float32), y


@pytest.fixture(scope="module")
def blobs():
    return _blobs()


def _sq_rounding(x):
    """The float32 rounding of ‖x‖² at the data's largest norm: the size of a
    distance near 0 that ‖x‖² + ‖y‖² − 2x·y leaves in one summation order or
    another."""
    return float((x.astype(np.float64) ** 2).sum(1).max()) * 2.0**-21


def test_scaler_and_transform_match(blobs):
    x = blobs[0] * 3.0 + 2.0
    x[:, 3] = 7.0  # a zero-variance column keeps scale 1
    want, got = jstandardize.fit_scaler(x), standardize.fit_scaler(x, device=CPU)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-5)
    assert got["scale"][3] == want["scale"][3] == 1.0
    z = standardize.transform(x, got, device=CPU)
    assert z.dtype == np.float32
    np.testing.assert_allclose(z, jstandardize.transform(x, want), atol=1e-5)


def test_standardized_bundle_matches(tmp_path, blobs):
    """The .npz key set and arrays of the JAX package's, from the same
    embeddings and CSV (labels only on labeled rows, rows sorted by index)."""
    emb = blobs[0][:40]
    np.save(tmp_path / "e.npy", emb)
    order = np.random.default_rng(3).permutation(40)
    lines = ["index,path,bucket,label"]
    for i in order:
        labeled = i < 12
        lines.append(f"{i},{'avec_labels/' if labeled else 'sans_label/'}img_{i}.jpg,"
                     f"{'labeled' if labeled else 'unlabeled'},{('cancer', 'normal')[i % 2] if labeled else ''}")
    (tmp_path / "e.csv").write_text("\n".join(lines) + "\n")
    jstandardize.standardize_embeddings(tmp_path / "e.npy", tmp_path / "e.csv", tmp_path / "jax.npz")
    standardize.standardize_embeddings(tmp_path / "e.npy", tmp_path / "e.csv", tmp_path / "port.npz", device=CPU)
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in ("paths", "is_labeled", "labels"):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in ("features", "scaler_mean", "scaler_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("d", [8, 32])
def test_pca_matches(d):
    x, _ = _blobs(n=200, d=d, seed=d)
    want, got = jpca.fit_pca(x), pca.fit_pca(x, device=CPU)
    # distinct singular values here: each axis (sign fixed by svd_flip) is compared
    np.testing.assert_allclose(got.components, want.components, atol=1e-3)
    np.testing.assert_allclose(got.explained_variance_ratio, want.explained_variance_ratio, atol=1e-6)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.transform(x, 4), want.transform(x, 4), atol=1e-3)
    for target in (0.5, 0.9, 0.99):
        assert pca.components_for_variance(got, target) == jpca.components_for_variance(want, target)


@pytest.mark.parametrize("k", [2, 4, 7])
def test_kmeans_inits_bitwise_labels_equal(blobs, k):
    x = blobs[0]
    for seed in (0, 42):
        want = jkmeans._plus_plus_init(x, k, jax_host_rng(seed, f"kmeans/k={k}"))
        got = kmeans._plus_plus_init(x, k, host_rng(seed, f"kmeans/k={k}"))
        np.testing.assert_array_equal(got, want)
    want, got = jkmeans.kmeans(x, k, n_init=10, seed=42), kmeans.kmeans(x, k, n_init=10, seed=42, device=CPU)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.int64 and got.n_iter == want.n_iter
    assert got.inertia == pytest.approx(want.inertia, rel=1e-5)
    np.testing.assert_allclose(got.centers, want.centers, rtol=1e-5, atol=1e-4)


def test_kmeans_lanes_stop_at_their_own_iteration():
    """Each restart keeps its own n_iter, centers and labels: the lanes that
    converge early are frozen while the others run on (the vmapped
    ``while_loop``'s semantics), and an empty cluster is re-seeded from the
    farthest points in the same stable order."""
    x, _ = _blobs(n=240, d=8, centers=6, std=2.5, seed=5)
    rng = np.random.default_rng(9)
    inits = np.stack([x[rng.choice(len(x), 6, replace=False)] for _ in range(5)])
    inits[4, 5] = 1e3  # no point is nearest to this center: an empty cluster
    tol = np.float32(1e-4 * np.mean(np.var(x, axis=0)))
    want = [np.asarray(v) for v in jkmeans._lloyd_batched(jnp.asarray(x), jnp.asarray(inits), jnp.asarray(tol), 300)]
    with float32_products():
        got = [v.numpy() for v in kmeans._lloyd_lanes(torch.as_tensor(x), torch.as_tensor(inits), torch.tensor(tol), 300)]
    assert len(set(want[3].tolist())) > 1  # the lanes really stop at different iterations
    np.testing.assert_array_equal(got[3], want[3])  # n_iter per lane
    np.testing.assert_array_equal(got[1], want[1])  # labels per lane
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    capped = [np.asarray(v) for v in jkmeans._lloyd_batched(jnp.asarray(x), jnp.asarray(inits), jnp.asarray(tol), 2)]
    with float32_products():
        got_capped = kmeans._lloyd_lanes(torch.as_tensor(x), torch.as_tensor(inits), torch.tensor(tol), 2)
    np.testing.assert_array_equal(got_capped[3].numpy(), capped[3])  # max_iter stops every lane at 2


def test_kmeans_ties_take_the_first_center():
    """Duplicate points and duplicate centers: argmin keeps the first index."""
    x = np.repeat(_blobs(n=30, d=4, centers=3, seed=2)[0], 4, axis=0)
    want, got = jkmeans.kmeans(x, 5, n_init=4, seed=1), kmeans.kmeans(x, 5, n_init=4, seed=1, device=CPU)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("eps, min_samples", [(4.5, 5), (5.5, 10), (7.0, 15), (3.0, 3)])
def test_dbscan_labels_equal(blobs, eps, min_samples):
    x = blobs[0]
    sq = (x.astype(np.float64) ** 2).sum(1)
    d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * x.astype(np.float64) @ x.T.astype(np.float64), 0))
    assert np.abs(d - eps).min() > 1e-4  # no distance near the radius (its float32 rounding is ~2e-5)
    want, got = jdbscan.dbscan(x, eps, min_samples), dbscan.dbscan(x, eps, min_samples, device=CPU)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.core_mask, want.core_mask)
    assert (got.n_clusters, got.noise_rate) == (want.n_clusters, want.noise_rate)


def _integer_points(n, d, seed, high=4):
    """Small-integer coordinates: every squared norm, product and distance is
    exact in float32, so distances tie exactly (duplicates at 0) and no
    summation order can move one across a radius."""
    return np.random.default_rng(seed).integers(-high, high + 1, (n, d)).astype(np.float32)


def test_dbscan_blocked_neighbourhoods_match_dense_and_jax():
    """The corpus-scale path, called directly below the limit, on exact
    distances (eps² = 30.5 lies between two integers)."""
    x = _integer_points(1500, 8, seed=2)
    eps = float(np.sqrt(30.5))
    dense = dbscan._neighbor_lists_dense(torch.as_tensor(x), eps)
    blocked = dbscan._neighbor_lists_blocked(torch.as_tensor(x), eps)
    want = jdbscan._neighbor_lists_blocked(jnp.asarray(x), eps)
    assert len(dense) == len(blocked) == len(want) == 1500
    assert 1 < np.mean([len(a) for a in dense]) < 100
    for a, b, c in zip(dense, blocked, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    got, jgot = dbscan.dbscan(x, eps, 10, device=CPU), jdbscan.dbscan(x, eps, 10)
    np.testing.assert_array_equal(got.labels, jgot.labels)


@pytest.mark.parametrize("include_self", [False, True])
def test_k_distance_curve_and_auto_eps(blobs, include_self):
    x = blobs[0]
    atol = np.sqrt(_sq_rounding(x))  # the self-distance's residual, for k counting it
    want = jdbscan.k_distance_curve(x, 5, include_self)
    got = dbscan.k_distance_curve(x, 5, include_self, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    blocked = np.sort(np.sqrt(dbscan._kth_distance_blocked(torch.as_tensor(x), 5, include_self).numpy()))
    np.testing.assert_allclose(blocked, got, rtol=1e-5, atol=atol)
    jblocked = np.sort(np.sqrt(np.asarray(jdbscan._kth_distance_blocked(jnp.asarray(x), 5, include_self))))
    np.testing.assert_allclose(blocked, jblocked, rtol=1e-5, atol=atol)
    assert dbscan.auto_eps_from_kdistance(x, 5, device=CPU) == pytest.approx(
        jdbscan.auto_eps_from_kdistance(x, 5), rel=1e-5)


def test_silhouette_matches(blobs):
    x, y = blobs
    assert cluster_metrics.silhouette_score(x, y, device=CPU) == pytest.approx(jmetrics.silhouette_score(x, y), rel=1e-5)
    mask = y != 0
    assert cluster_metrics.silhouette_score(x, y, mask, device=CPU) == pytest.approx(
        jmetrics.silhouette_score(x, y, mask), rel=1e-5)
    with pytest.raises(ValueError):
        cluster_metrics.silhouette_score(x, np.zeros(len(x)), device=CPU)


def test_silhouette_blocked_sums_match():
    """The blocked path, called directly below the limit, against the dense
    one and the JAX package's blocked path."""
    x, y = _blobs(n=1500, d=8, centers=3, seed=1, spread=1.0)
    one_hot = np.eye(3, dtype=np.float32)[y]
    dense = cluster_metrics._silhouette_sums_dense(torch.as_tensor(x), torch.as_tensor(one_hot)).numpy()
    blocked = cluster_metrics._silhouette_sums_blocked(torch.as_tensor(x), torch.as_tensor(one_hot)).numpy()
    want = np.asarray(jmetrics._silhouette_sums_blocked(jnp.asarray(x), jnp.asarray(one_hot)))
    atol = np.sqrt(_sq_rounding(x))  # the self-distance's residual
    np.testing.assert_allclose(blocked, dense, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(blocked, want, rtol=1e-4, atol=atol)


def _tsne_input():
    x, _ = _blobs(n=150, d=10, centers=3, std=1.5, seed=4, spread=5.0)
    return x


def test_tsne_conditional_and_joint_p_match():
    x = _tsne_input()
    sq = (x * x).sum(1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * x @ x.T, 0).astype(np.float32)
    for perplexity in (10.0, 30.0):
        want = np.asarray(jtsne._conditional_p(jnp.asarray(d2), perplexity))
        got = tsne._conditional_p(torch.as_tensor(d2), perplexity).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    joint = tsne._joint_p(torch.as_tensor(x), 30.0).numpy()
    np.testing.assert_allclose(joint.sum(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(joint, joint.T)


def test_tsne_steps_match():
    """One step and the first ten from the same P and start. Past about ten
    steps of early exaggeration the dynamics are chaotic at this size: a
    one-ulp change of the start moves step 20 by several tenths, in either
    package, so longer runs are held by their objective below."""
    x = _tsne_input()
    p = tsne._joint_p(torch.as_tensor(x), 30.0)
    y0 = np.random.default_rng(0).normal(0, 1e-4, (len(x), 2)).astype(np.float32)
    for steps, rtol in ((1, 1e-5), (10, 1e-4)):
        want = np.asarray(jtsne._optimize(jnp.asarray(p.numpy()), jnp.asarray(y0), jnp.float32(50.0), steps, 250))
        got = tsne._optimize(p, torch.as_tensor(y0), 50.0, steps, 250).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    nudged = tsne._optimize(p, torch.as_tensor(np.nextafter(y0, np.float32(1))), 50.0, 20, 250).numpy()
    assert np.abs(nudged - tsne._optimize(p, torch.as_tensor(y0), 50.0, 20, 250).numpy()).max() > 1e-2


def _knn_sets(y, k=10):
    d = ((y[:, None, :].astype(np.float64) - y[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return [set(row) for row in np.argsort(d, axis=1, kind="stable")[:, :k]]


def neighbour_preservation(x, y, k=10):
    """Mean share of each point's k nearest input neighbours that are also
    among its k nearest in the embedding."""
    return float(np.mean([len(a & b) / k for a, b in zip(_knn_sets(x, k), _knn_sets(y, k))]))


def test_tsne_whole_run_by_kl_and_neighbours():
    """KL within 10 %: a one-ulp change of the input moves this run's KL by
    percents in the port itself (checked here). Neighbour preservation
    within 0.05."""
    x = _tsne_input()
    want = jtsne.tsne(x, perplexity=30.0)
    got = tsne.tsne(x, perplexity=30.0, device=CPU)
    assert got.shape == (len(x), 2) and got.dtype == np.float32 and np.isfinite(got).all()
    kl_want = jtsne.kl_divergence(x, want, 30.0)
    kl_got = tsne.kl_divergence(x, got, 30.0, device=CPU)
    assert kl_got == pytest.approx(kl_want, rel=0.1)
    nudged = tsne.tsne(np.nextafter(x, np.float32(100)), perplexity=30.0, device=CPU)
    assert abs(tsne.kl_divergence(x, nudged, 30.0, device=CPU) / kl_got - 1) > 0.005
    assert tsne.kl_divergence(x, want, 30.0, device=CPU) == pytest.approx(kl_want, rel=1e-4)
    assert neighbour_preservation(x, got) == pytest.approx(neighbour_preservation(x, want), abs=0.05)


def test_umap_ab_and_fuzzy_graph_match():
    assert umap.fit_ab(0.1) == jumap.fit_ab(0.1) and umap.fit_ab(0.0) == jumap.fit_ab(0.0)
    x = _tsne_input()
    for k in (8, 15):
        want = np.asarray(jumap._fuzzy_graph(jnp.asarray(x), k))
        got = umap._fuzzy_graph(torch.as_tensor(x), k).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)  # the same kNN edges
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_umap_knn_ties_keep_the_lower_index():
    """Duplicate rows and equal distances (exact on integer points): the k
    nearest keep the lower indices first, as ``jax.lax.top_k`` does, so the
    graphs have the same edges."""
    base = _integer_points(20, 6, seed=8, high=2)
    x = np.concatenate([base, base, base[:7]])
    for k in (3, 4, 8):
        want = np.asarray(jumap._fuzzy_graph(jnp.asarray(x), k))
        got = umap._fuzzy_graph(torch.as_tensor(x), k).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_umap_steps_and_whole_run():
    x = _tsne_input()
    a, b = umap.fit_ab(0.1)
    p = umap._fuzzy_graph(torch.as_tensor(x), 15)
    y0 = np.random.default_rng(1).normal(0, 10.0, (len(x), 2)).astype(np.float32)
    for epochs, rtol in ((1, 1e-5), (20, 1e-3)):
        want = np.asarray(jumap._optimize(jnp.asarray(p.numpy()), jnp.asarray(y0), a, b, epochs, 15))
        got = umap._optimize(p, torch.as_tensor(y0), a, b, epochs, 15).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    want = jumap.umap(x, 15, 0.1)
    got = umap.umap(x, 15, 0.1, device=CPU)
    assert got.shape == (len(x), 2) and np.isfinite(got).all()
    assert neighbour_preservation(x, got) == pytest.approx(neighbour_preservation(x, want), abs=0.05)


def test_embedding_caps():
    x = _tsne_input()
    for fn in (tsne.tsne, umap.umap):
        with pytest.raises(ValueError, match="capped at max_points=100"):
            fn(x, max_points=100, device=CPU)


@pytest.mark.parametrize("fn", ["pca", "kmeans", "dbscan", "tsne", "silhouette"])
def test_no_card_raises(fn):
    """Asked for the card where none is visible, the stack raises: it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    x, y = _blobs(n=20, d=4, seed=3)
    call = {
        "pca": lambda dev: pca.fit_pca(x, device=dev),
        "kmeans": lambda dev: kmeans.kmeans(x, 2, n_init=1, device=dev),
        "dbscan": lambda dev: dbscan.dbscan(x, 3.0, 3, device=dev),
        "tsne": lambda dev: tsne.tsne(x, n_iter=2, device=dev),
        "silhouette": lambda dev: cluster_metrics.silhouette_score(x, y, device=dev),
    }[fn]
    with pytest.raises((RuntimeError, AssertionError)):
        call(torch.device("cuda"))


def test_float32_products_puts_the_setting_back():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for before in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = before
            with float32_products():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is before
            cluster_metrics.silhouette_score(_tsne_input(), np.arange(150) % 3, device=CPU)
            assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
