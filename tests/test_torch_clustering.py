"""The port's clustering package (``deeplearning4j_tpu_torch/clustering``)
against the JAX package's.

The trees, the VP-tree, Barnes-Hut t-SNE and the kNN server are numpy in
both packages: their answers must be identical. k-means and exact t-SNE
run their step as torch functions (here on the CPU): k-means from the same
initial centroids gives the same labels and centroids within 1e-6
(rel-to-max); t-SNE's affinities P are the reference's bit for bit, its
schedule is the reference's, and each step from the reference's own state
lands within 1e-5 (rel-to-max) of the reference's step, over the first 10
steps and past the switch at step 100 (free-running, rounding doubles
about every step from the fifth, see
``test_tsne_steps_equal_the_reference``). The reference tests' quality
gates then run on the port (``tests/test_clustering.py``,
``tests/test_trees_deepwalk.py``).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as jcl
from deeplearning4j_tpu.clustering import server as jserver
from deeplearning4j_tpu.clustering import tsne as jtsne
from deeplearning4j_tpu_torch import clustering as tcl
from deeplearning4j_tpu_torch.clustering import kmeans as tkmeans
from deeplearning4j_tpu_torch.clustering import server as tserver
from deeplearning4j_tpu_torch.clustering import tsne as ttsne


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# ------------------------------------------------------------------ trees
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
def test_vptree_answers_equal_the_reference(metric):
    r = np.random.default_rng(0)
    pts = r.normal(size=(200, 8))
    a, b = jcl.VPTree(pts, metric=metric, seed=3), \
        tcl.VPTree(pts, metric=metric, seed=3)
    for q in r.normal(size=(6, 8)):
        assert b.knn(q, k=5) == a.knn(q, k=5)
    # tests/test_clustering.py: against brute force
    q = pts[17] + 0.01
    idx, dist = tcl.VPTree(pts).knn(q, k=5)
    assert set(idx) == set(np.argsort(np.linalg.norm(pts - q, axis=1))[:5])
    assert dist == sorted(dist)


def test_kdtree_answers_equal_the_reference():
    r = np.random.default_rng(5)
    pts = r.normal(size=(200, 5))
    a, b = jcl.KDTree(pts), tcl.KDTree(pts)
    assert len(b) == 200
    for q in r.normal(size=(10, 5)):
        assert b.knn(q, 7) == a.knn(q, 7)
        assert b.nn(q) == a.nn(q)
    c = tcl.KDTree(dims=2)
    for p in ([0.0, 0.0], [1.0, 1.0], [-1.0, 0.5]):
        c.insert(p)
    i, d = c.nn([0.9, 0.9])
    assert i == 1 and abs(d - np.sqrt(0.02)) < 1e-9
    with pytest.raises(ValueError):
        c.insert([1.0, 2.0, 3.0])


@pytest.mark.parametrize("dims,theta", [(2, 0.0), (2, 0.5), (3, 0.5)])
def test_sptree_forces_equal_the_reference(dims, theta):
    pts = np.random.default_rng(dims).normal(size=(150, dims))
    a, b = jcl.SpTree.build(pts), tcl.SpTree.build(pts)
    assert b.count == a.count == 150
    np.testing.assert_array_equal(b.cum_center, a.cum_center)
    for i in (0, 17, 99):
        na, nb = np.zeros(dims), np.zeros(dims)
        za = a.compute_non_edge_forces(pts[i], theta, na)
        zb = b.compute_non_edge_forces(pts[i], theta, nb)
        assert zb == za
        np.testing.assert_array_equal(nb, na)


def test_quadtree_equals_the_reference_and_is_2d_only():
    pts = np.random.default_rng(7).normal(size=(50, 2))
    a, b = jcl.QuadTree.build(pts), tcl.QuadTree.build(pts)
    assert b.count == a.count == 50
    na, nb = np.zeros(2), np.zeros(2)
    assert b.compute_non_edge_forces(pts[3], 0.5, nb) == \
        a.compute_non_edge_forces(pts[3], 0.5, na)
    np.testing.assert_array_equal(nb, na)
    with pytest.raises(ValueError):
        tcl.QuadTree(np.zeros(3), np.ones(3))


# ----------------------------------------------------------------- k-means
def _blobs(seed=2, n=50):
    r = np.random.default_rng(seed)
    return np.concatenate([
        r.normal(loc=(0, 0), scale=0.3, size=(n, 2)),
        r.normal(loc=(5, 5), scale=0.3, size=(n, 2)),
        r.normal(loc=(0, 5), scale=0.3, size=(n, 2))])


def _centres(seed, n=600, d=16, k=8):
    r = np.random.default_rng(seed)
    centres = r.normal(scale=4.0, size=(k, d))
    return (centres[r.integers(0, k, n)]
            + r.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "centres", "centres_few_iters"])
def test_kmeans_equals_the_reference(case):
    pts, kw = {"blobs": (_blobs(), dict(k=3, seed=4)),
               "centres": (_centres(1), dict(k=8, seed=2)),
               "centres_few_iters": (_centres(3), dict(k=8, seed=5,
                                                       max_iterations=2))
               }[case]
    ref = jcl.KMeansClustering(**kw).fit(pts)
    port = tcl.KMeansClustering(device="cpu", **kw).fit(pts)
    assert port.centroids.dtype == np.float32
    assert port.centroids.shape == ref.centroids.shape
    assert _rel(port.centroids, np.asarray(ref.centroids)) <= 1e-6
    np.testing.assert_array_equal(port.labels_, np.asarray(ref.labels_))
    np.testing.assert_array_equal(port.predict(pts), ref.predict(pts))


def test_kmeans_separates_blobs():
    """tests/test_clustering.py's gate on the port: each blob maps to one
    cluster (purity above 0.95)."""
    labels = tcl.KMeansClustering(k=3, seed=4, device="cpu").fit(
        _blobs()).predict(_blobs())
    for s in range(3):
        seg = labels[s * 50:(s + 1) * 50]
        assert (seg == np.bincount(seg).argmax()).mean() > 0.95


def test_kmeans_chunks_take_the_same_formula(monkeypatch):
    """The distances over chunks of rows give the labels of one broadcast,
    and the step's centroids are bitwise those of one chunk."""
    pts = torch.from_numpy(_centres(4, n=500))
    cents = pts[:8].clone()
    whole = tkmeans.kmeans_step(pts, cents, 8)
    monkeypatch.setattr(tkmeans, "CHUNK_ELEMENTS", 8 * 16 * 7)
    chunked = tkmeans.kmeans_step(pts, cents, 8)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    d = ((pts[:, None, :] - cents[None]) ** 2).sum(-1)
    assert torch.equal(chunked[1], d.argmin(1))


# ------------------------------------------------------------------- t-SNE
def _two_clusters(seed=3, n=30, d=10):
    r = np.random.default_rng(seed)
    return np.concatenate([r.normal(loc=0, scale=0.1, size=(n, d)),
                           r.normal(loc=3, scale=0.1, size=(n, d))])


def test_tsne_affinities_equal_the_reference(monkeypatch):
    """P over blocks of rows equals the reference's whole broadcast bit
    for bit (blocks of 7 rows here)."""
    X = np.random.default_rng(8).normal(size=(45, 6))
    D = ((X[:, None] - X[None]) ** 2).sum(-1)
    P = jtsne._binary_search_perplexity(D, min(30.0, 44 / 3))
    P = np.maximum((P + P.T) / (2 * 45), 1e-12)
    monkeypatch.setattr(ttsne, "BLOCK_ELEMENTS", 7 * 45 * 6)
    np.testing.assert_array_equal(ttsne._squared_distances(X), D)
    np.testing.assert_array_equal(ttsne.Tsne()._affinities(X), P)


def _recorded_tsne_steps(monkeypatch, kw, X):
    """Both packages' ``fit_transform`` on X, each step call recorded as
    (Y, vel, gains, P, lr, mom) in and (Y, vel, gains) out: the
    reference's jitted ``step`` through ``jax.jit``, the port's
    ``tsne_step`` through its module."""
    import jax
    ref, port = [], []
    real_jit, real_step = jax.jit, ttsne.tsne_step

    def jit(fn, **jkw):
        jitted = real_jit(fn, **jkw)

        def call(*a):
            out = jitted(*a)
            ref.append(([np.asarray(v) if hasattr(v, "shape") else v
                         for v in a], [np.asarray(v) for v in out]))
            return out
        return call

    def step(*a):
        out = real_step(*a)
        port.append(([v.numpy() if torch.is_tensor(v) else v for v in a],
                     [v.numpy() for v in out]))
        return out
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", jit)
        want = np.asarray(jcl.Tsne(**kw).fit_transform(X))
    monkeypatch.setattr(ttsne, "tsne_step", step)
    got = tcl.Tsne(device="cpu", **kw).fit_transform(X)
    return want, got, ref, port


@pytest.mark.parametrize("n_iter", [10, 101])
def test_tsne_steps_equal_the_reference(monkeypatch, n_iter):
    """The port's schedule is the reference's: every step gets the same
    exaggerated P (bitwise), learning rate and momentum (101 steps reach
    the switch at step 100: no exaggeration, momentum 0.8). Each step,
    taken by the port from the reference's own state (Y, vel, gains),
    lands within 1e-5 (rel-to-max) of the reference's step: Y at every
    step, and vel and gains too at the first 10 steps and from step 100.
    (Between them the embedding settles under the exaggeration, vel falls
    to ~1 % of Y and is a difference of nearly cancelling forces: its
    distance relative to its own largest entry reaches 7e-5 while Y's stays
    below 4e-7.) Free-running, the trajectories agree within 1e-5 over the
    first 5 steps; the early exaggeration then doubles the distance about
    every step (after 1, 5 and 10 steps: 6.5e-7, 2.7e-6, 5.4e-5 on this
    input), so the steps are held one by one."""
    X = _two_clusters()
    kw = dict(perplexity=10, n_iter=n_iter, seed=1)
    want, got, ref, port = _recorded_tsne_steps(monkeypatch, kw, X)
    assert got.shape == want.shape == (60, 2) and got.dtype == np.float32
    assert len(ref) == len(port) == n_iter
    for i, ((r_in, r_out), (p_in, _)) in enumerate(zip(ref, port)):
        np.testing.assert_array_equal(p_in[3], r_in[3])       # P x exag
        assert p_in[4:] == r_in[4:] == [
            max(60 / 12.0 / 4.0, 10.0), 0.5 if i < 100 else 0.8]
        Y, vel, gains = (torch.from_numpy(v.copy()) for v in r_in[:3])
        step = ttsne.tsne_step(Y, vel, gains, torch.from_numpy(r_in[3].copy()),
                               r_in[4], r_in[5])
        held = step if i < 10 or i >= 100 else step[:1]
        for a, b in zip(held, r_out):
            assert _rel(a.numpy(), b) <= 1e-5, i
    assert float(ref[-1][0][3].max()) == pytest.approx(
        float(ref[0][0][3].max()) / (12.0 if n_iter > 100 else 1.0))
    for i in range(5):
        assert _rel(port[i][1][0], ref[i][1][0]) <= 1e-5, i


def test_tsne_gradient_is_the_kl_gradient():
    """The autograd gradient of the KL with its clamp equals the closed
    form 4 sum_j (p_ij - q_ij) num_ij (y_i - y_j) (float64; no Q reaches
    the clamp here)."""
    r = np.random.default_rng(4)
    Y = torch.from_numpy(r.normal(size=(20, 2)))
    P = torch.from_numpy(r.random((20, 20)))
    P = (P + P.T) * (1 - torch.eye(20, dtype=P.dtype))
    P = torch.clamp_min(P / P.sum(), 1e-12)
    Yg = Y.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(ttsne._kl(Yg, P), Yg)
    num = 1.0 / (1.0 + torch.cdist(Y, Y) ** 2) * (1 - torch.eye(20,
                                                                 dtype=Y.dtype))
    Q = num / num.sum()
    want = 4 * (((P - Q) * num)[..., None] * (Y[:, None] - Y[None])).sum(1)
    assert float((g - want).abs().max() / want.abs().max()) <= 1e-10


def test_tsne_preserves_clusters():
    """tests/test_clustering.py's gate on the port's whole fit."""
    Y = tcl.Tsne(perplexity=10, n_iter=300, seed=1,
                 device="cpu").fit_transform(_two_clusters())
    assert Y.shape == (60, 2)
    da = np.linalg.norm(Y[:30] - Y[:30].mean(0), axis=1).mean()
    cross = np.linalg.norm(Y[:30].mean(0) - Y[30:].mean(0))
    assert cross > 3 * da, (cross, da)


def test_barnes_hut_equals_the_reference():
    r = np.random.default_rng(5)
    X = np.vstack([r.normal(size=(15, 6)) + 4.0, r.normal(size=(15, 6)) - 4.0])
    kw = dict(perplexity=5, n_iter=12, seed=1, theta=0.5)
    np.testing.assert_array_equal(tcl.BarnesHutTsne(**kw).fit_transform(X),
                                  jcl.BarnesHutTsne(**kw).fit_transform(X))


def test_device_classes_want_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.KMeansClustering(k=2).fit(_blobs())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.Tsne(n_iter=1).fit_transform(_two_clusters())


# ------------------------------------------------------------------ server
def test_server_and_client_round_trip():
    """The port's server and the reference's over the same points answer
    every request alike, to either package's client; a bad request is a
    400 in both."""
    import urllib.error
    pts = np.random.default_rng(9).normal(size=(60, 4))
    servers = [jserver.NearestNeighborsServer(pts),
               tserver.NearestNeighborsServer(pts)]
    try:
        ports = [s.start() for s in servers]
        clients = [mod.NearestNeighborsClient(port=p)
                   for mod, p in zip((jserver, tserver), ports)]
        swapped = [tserver.NearestNeighborsClient(port=ports[0]),
                   jserver.NearestNeighborsClient(port=ports[1])]
        for c_ref, c_port, c_x in zip([clients[0]], [clients[1]],
                                      [swapped[1]]):
            for i, k in ((0, 3), (17, 5), (59, 80)):
                want = c_ref.knn(i, k)
                assert c_port.knn(i, k) == want == c_x.knn(i, k)
                assert i not in want["indices"]
            v = pts[5] + 0.01
            want = c_ref.knn_new(v, 4)
            assert c_port.knn_new(v, 4) == want == swapped[0].knn_new(v, 4)
            assert want["indices"][0] == 5
        for c in clients:
            with pytest.raises(urllib.error.HTTPError) as e:
                c.knn(1000, 2)
            assert e.value.code == 400
    finally:
        for s in servers:
            s.stop()
