"""Whole fits of the NLP library's trainers (``Word2Vec``, ``Glove``,
``DistributedWord2Vec``) against the JAX package's, and the word-vector
files between the two packages (``ParagraphVectors``:
``test_torch_nlp_paragraph.py``).

Both packages fit from the same seed at the reference tests' sizes
(``tests/test_nlp.py``, ``tests/test_serving_distnlp.py``; its ``slow``
hierarchical-softmax case runs here at its own size, which fits the
budget). They
draw the same pairs and negatives on the host, so their tables differ only
by float32 rounding in another order, which the epochs carry along: every
table is compared at rel-to-max ``REL`` (its largest difference over its
largest magnitude). Measured on this tree: at most 1.45e-5 (Word2Vec with
negative sampling, 10 epochs: syn0), 5.6e-6 and below for the rest. The
reference's similarity assertions then run on the port's fit.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import distributed_w2v as jdist
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.nlp import distributed_w2v as tdist
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

REL = 1e-4


def _corpus(n=300, seed=0):
    """The reference tests' topical corpus: 'day/sun/light' against
    'night/moon/dark' sentences, with filler words."""
    r = np.random.default_rng(seed)
    day_words = ["day", "sun", "light", "morning", "bright"]
    night_words = ["night", "moon", "dark", "evening", "stars"]
    other = ["the", "a", "is", "was", "and"]
    out = []
    for _ in range(n):
        topic = day_words if r.random() < 0.5 else night_words
        sent = []
        for _ in range(r.integers(5, 12)):
            sent.append(topic[r.integers(len(topic))] if r.random() < 0.7
                        else other[r.integers(len(other))])
        out.append(" ".join(sent))
    return out


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.float32, what
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= REL, f"{what}: rel-to-max {rel:.3g}"


def _same_vocab(port, ref):
    assert [port.vocab.word_at(i) for i in range(len(port.vocab))] == \
        [ref.vocab.word_at(i) for i in range(len(ref.vocab))]


W2V = {
    # tests/test_nlp.py test_word2vec_similarity_structure
    "ns": (dict(layer_size=32, window=4, min_word_frequency=2, epochs=10,
                negative=5, learning_rate=0.05, seed=3), 300,
           ("day", "sun", "moon")),
    # its slow hierarchical-softmax twin, at its own size
    "hs": (dict(layer_size=32, window=4, min_word_frequency=2, epochs=20,
                learning_rate=0.05, sample=1e-3, seed=3,
                use_hierarchical_softmax=True), 300, ("day", "sun", "moon")),
    # test_word2vec_hs_cbow_trains
    "cbow_hs": (dict(layer_size=24, window=4, min_word_frequency=2, epochs=10,
                     learning_rate=0.05, seed=5, learning_algorithm="cbow",
                     use_hierarchical_softmax=True), 200,
                ("night", "moon", "sun")),
    "cbow_ns": (dict(layer_size=24, window=4, min_word_frequency=2, epochs=4,
                     negative=5, learning_rate=0.05, seed=5,
                     learning_algorithm="cbow"), 200, None),
}


@pytest.mark.parametrize("variant", list(W2V))
def test_word2vec_fit_equals_the_reference(variant):
    kw, n, sim = W2V[variant]
    ref = jnlp.Word2Vec(**kw).fit(_corpus(n))
    port = tnlp.Word2Vec(device="cpu", **kw).fit(_corpus(n))
    _same_vocab(port, ref)
    _close(port.syn0, ref.syn0, "syn0")
    out = "syn1" if kw.get("use_hierarchical_softmax") else "syn1neg"
    _close(getattr(port, out), getattr(ref, out), out)
    if out == "syn1":
        assert port.syn1.shape[0] == len(port.vocab) - 1
    if sim:
        a, same, cross = sim
        assert port.similarity(a, same) > port.similarity(a, cross)
    if variant in ("ns", "hs"):
        nearest = port.words_nearest("sun", 4)
        assert nearest == ref.words_nearest("sun", 4)
        assert any(w in ("day", "light", "morning", "bright")
                   for w in nearest), nearest


def test_glove_fit_equals_the_reference():
    kw = dict(layer_size=16, window=4, min_word_frequency=2, epochs=20,
              seed=5, batch_size=4096)
    corpus = [s.split() for s in _corpus(200)]
    ref = jnlp.Glove(**kw).fit(corpus)
    port = tnlp.Glove(device="cpu", **kw).fit(corpus)
    _same_vocab(port, ref)
    _close(port.syn0, ref.syn0, "syn0")
    assert port.similarity("day", "sun") > port.similarity("day", "moon")
    with pytest.raises(ValueError, match="Empty co-occurrence"):
        tnlp.Glove(device="cpu").fit([["solo"]])


def test_distributed_word2vec_fit_equals_the_reference():
    """tests/test_serving_distnlp.py's end-to-end case on 4 workers in both
    packages (4 of conftest's virtual devices; the port's logical mesh)."""
    corpus = [("day night sun moon light dark " * 3).split()
              for _ in range(30)] + \
             [("cat dog pet fur paw tail " * 3).split() for _ in range(30)]
    kw = dict(layer_size=16, window=3, epochs=3, negative=4, seed=4,
              learning_rate=0.05)
    ref = jdist.DistributedWord2Vec(mesh=jmake_mesh((4,)), **kw).fit(corpus)
    port = tdist.DistributedWord2Vec(
        mesh=make_mesh((4,), ("data",), "cpu"), device="cpu", **kw)
    port.fit(corpus)
    assert port._n_devices == 4
    _close(port.syn0, ref.syn0, "syn0")
    _close(port.syn1neg, ref.syn1neg, "syn1neg")
    assert port.similarity("day", "night") > port.similarity("day", "dog")


def test_word_vector_files_are_byte_identical_and_cross_read(tmp_path):
    """Both packages write the same bytes for the same tables, in the text
    and the Google binary format, and each reads the other's file."""
    port = tnlp.Word2Vec(layer_size=16, min_word_frequency=1, epochs=2,
                         seed=1, device="cpu")
    port.fit(["one two three", "one two", "three four one", "ünï ｃｏｄｅ"])
    for fmt in ("", "binary_"):
        ours, theirs = tmp_path / f"p{fmt}.v", tmp_path / f"j{fmt}.v"
        getattr(tnlp, f"write_{fmt}word_vectors")(port, str(ours))
        getattr(jnlp, f"write_{fmt}word_vectors")(port, str(theirs))
        assert ours.read_bytes() == theirs.read_bytes()
        for reader, path in ((tnlp, theirs), (jnlp, ours)):
            back = getattr(reader, f"read_{fmt}word_vectors")(str(path))
            assert [back.vocab.word_at(i) for i in range(len(back.vocab))] \
                == [port.vocab.word_at(i) for i in range(len(port.vocab))]
            if fmt:
                assert np.array_equal(back.syn0, port.syn0)
            else:
                np.testing.assert_allclose(back.syn0, port.syn0, atol=5e-7)
    loaded = tnlp.read_word_vectors(str(tmp_path / "j.v"))
    assert isinstance(loaded, tnlp.SequenceVectors) and loaded.device is None
    assert loaded.similarity("one", "two") == pytest.approx(
        port.similarity("one", "two"), abs=1e-5)
