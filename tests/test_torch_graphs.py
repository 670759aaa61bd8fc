"""The port's graphs package (``deeplearning4j_tpu_torch/graphs``) against
the JAX package's: the same walks from the same seed, and DeepWalk and
node2vec fits whose tables agree.

The walks are numpy in both packages, so they must be identical: uniform,
weighted and node2vec's biased walks, over two epochs of one iterator. The
fits train through each package's SequenceVectors from the same seed on
the same walks, so both draw the same pairs and negatives and their
tables differ by float32 rounding in another order: ``lookup_table`` is
compared at rel-to-max ``REL`` (largest difference over largest
magnitude) on the reference tests' graph, two cliques of six vertices
with one bridge (``tests/test_trees_deepwalk.py``,
``tests/test_serving_distnlp.py``). Measured on this tree: 2.5e-6
(negative sampling), 1.0e-6 (hierarchical softmax), 7.3e-6 (node2vec).
The reference tests' similarity assertions then run on the port's fits.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graphs as jgraphs
from deeplearning4j_tpu_torch import graphs as tgraphs

REL = 1e-5


def _cliques(pkg, k=6):
    g = pkg.Graph(2 * k)
    for i in range(k):
        for j in range(i + 1, k):
            g.add_edge(i, j)
            g.add_edge(k + i, k + j)
    g.add_edge(0, k)   # single bridge
    return g


def _random_graph(pkg, seed, n=40, m=90, directed=False):
    """A random graph with weights and an isolated last vertex."""
    r = np.random.default_rng(seed)
    g = pkg.Graph(n, directed=directed)
    for a, b, w in zip(r.integers(0, n - 1, m), r.integers(0, n - 1, m),
                       r.random(m) + 0.05):
        g.add_edge(int(a), int(b), weight=float(w))
    return g


def _walks(it, epochs=2):
    return [list(it) for _ in range(epochs)]


@pytest.mark.parametrize("handling", ["self_loop", "cutoff"])
@pytest.mark.parametrize("directed", [False, True])
def test_uniform_walks_equal_the_reference(handling, directed):
    want = _walks(jgraphs.RandomWalkIterator(
        _random_graph(jgraphs, 1, directed=directed), 12, seed=5,
        no_edge_handling=handling))
    got = _walks(tgraphs.RandomWalkIterator(
        _random_graph(tgraphs, 1, directed=directed), 12, seed=5,
        no_edge_handling=handling))
    assert got == want
    assert got[0] != got[1]            # each epoch draws anew


def test_weighted_walks_equal_the_reference():
    want = _walks(jgraphs.WeightedRandomWalkIterator(
        _random_graph(jgraphs, 2), 10, seed=9))
    got = _walks(tgraphs.WeightedRandomWalkIterator(
        _random_graph(tgraphs, 2), 10, seed=9))
    assert got == want


@pytest.mark.parametrize("m", [90, 900])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 0.25), (4.0, 0.5)])
def test_node2vec_walks_equal_the_reference(p, q, m):
    """The port's weighted step does numpy's ``choice`` arithmetic on
    arrays: the same walks on a sparse graph and a dense one (parallel
    edges included)."""
    want = _walks(jgraphs.Node2VecWalkIterator(
        _random_graph(jgraphs, 3, m=m), 15, p=p, q=q, seed=4))
    got = _walks(tgraphs.Node2VecWalkIterator(
        _random_graph(tgraphs, 3, m=m), 15, p=p, q=q, seed=4))
    assert got == want


def test_graph_api_equals_the_reference():
    a, b = _random_graph(jgraphs, 6), _random_graph(tgraphs, 6)
    assert a.num_vertices() == b.num_vertices()
    for v in range(a.num_vertices()):
        assert a.neighbors(v) == b.neighbors(v)
        assert a.weights(v) == b.weights(v)
        assert a.degree(v) == b.degree(v)
    g = tgraphs.Graph(3).add_edges([(0, 1), (1, 2)])
    assert g.neighbors(1) == [0, 2]


FITS = {
    # test_deepwalk_embeds_cliques_closer, with negative sampling
    "deepwalk_ns": ("DeepWalk", dict(vector_size=16, window_size=4,
                                     walk_length=20, walks_per_vertex=8,
                                     epochs=3, seed=7,
                                     use_hierarchical_softmax=False)),
    # the same test as written: the default objective, hierarchical softmax
    "deepwalk_default": ("DeepWalk", dict(vector_size=16, window_size=4,
                                          walk_length=20, walks_per_vertex=8,
                                          epochs=3, seed=7)),
    # test_deepwalk_hierarchical_softmax_embeds_cliques_closer
    "deepwalk_hs": ("DeepWalk", dict(vector_size=16, window_size=3,
                                     walk_length=20, walks_per_vertex=6,
                                     epochs=4, seed=11,
                                     use_hierarchical_softmax=True)),
    # test_node2vec_bias_and_training
    "node2vec": ("Node2Vec", dict(vector_size=16, window_size=4,
                                  walk_length=20, walks_per_vertex=8,
                                  epochs=3, p=1.0, q=0.5, seed=7)),
}


@pytest.mark.parametrize("case", list(FITS))
def test_fit_equals_the_reference(case):
    cls, kw = FITS[case]
    ref = getattr(jgraphs, cls)(**kw).fit(_cliques(jgraphs))
    port = getattr(tgraphs, cls)(device="cpu", **kw).fit(_cliques(tgraphs))
    want, got = ref.lookup_table, port.lookup_table
    assert got.shape == want.shape == (12, 16) and got.dtype == np.float32
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= REL, f"{case}: rel-to-max {rel:.3g}"
    # the reference tests' assertions, on the port's fit
    same = np.mean([port.similarity(i, j) for i in range(1, 6)
                    for j in range(1, 6) if i < j])
    cross = np.mean([port.similarity(i, j) for i in range(1, 6)
                     for j in range(7, 12)])
    assert same > cross
    assert port.similarity(0, 1) > port.similarity(0, 9)
    assert port.verts_nearest(1, 3) == ref.verts_nearest(1, 3)
    np.testing.assert_array_equal(port.vertex_vector(3), got[3])


def test_deepwalk_from_explicit_walks():
    walks = [[0, 1, 2, 1, 0] for _ in range(20)] + \
            [[3, 4, 5, 4, 3] for _ in range(20)]
    ref = jgraphs.DeepWalk(vector_size=8, window_size=2, epochs=2,
                           seed=2).fit(walks)
    port = tgraphs.DeepWalk(vector_size=8, window_size=2, epochs=2, seed=2,
                            device="cpu").fit(walks)
    got, want = port.lookup_table, ref.lookup_table
    assert got.shape == (6, 8)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= REL
    assert port.similarity(0, 1) > port.similarity(0, 4)


def test_node2vec_bias():
    """tests/test_serving_distnlp.py: with a huge p, returning to the
    previous vertex is rare."""
    g = tgraphs.Graph(3)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    returns = total = 0
    for s in range(60):
        for w in tgraphs.Node2VecWalkIterator(g, walk_length=2, p=100.0,
                                              q=1.0, seed=s):
            if w[0] == 0 and len(w) >= 3:
                total += 1
                returns += (w[2] == 0)
    assert total > 0 and returns / total < 0.2


def test_fit_without_a_device_wants_the_card(monkeypatch):
    """No ``device`` means the card: without one the fit raises, it does
    not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tgraphs.DeepWalk, tgraphs.Node2Vec):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(vector_size=4, walk_length=3).fit(_cliques(tgraphs))
