"""Whole fits of ``ParagraphVectors`` (PV-DBOW and PV-DM, with negative
sampling and hierarchical softmax) and ``infer_vector`` against the JAX
package's, at the reference tests' sizes (``tests/test_nlp.py``; its
``slow`` PV-DM case at its own size). The tables are compared as in
``test_torch_nlp_models.py``, at rel-to-max ``REL``; measured on this tree
at most 2.2e-6. ``infer_vector`` seeds its generator from ``hash(text)``
in both packages, so the two agree within one process: atol 1e-6, the
reference's pin for its analytic step.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu_torch import nlp as tnlp

REL = 1e-4


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.float32, what
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= REL, f"{what}: rel-to-max {rel:.3g}"


DOCS = [("doc_day", " ".join(["sun day light bright"] * 5)),
        ("doc_night", " ".join(["moon night dark stars"] * 5))]
CATS = ["the cat sat on the mat and purred softly today",
        "a cat chased the small mouse around the mat",
        "my cat naps on a warm mat every afternoon"]
CARS = ["the car drove down the long road very fast",
        "a fast car raced along the road at night",
        "my car needs fuel before the long road trip"]
DM_DOCS = [(f"cat_{i}", t) for i, t in enumerate(CATS)] + \
          [(f"car_{i}", t) for i, t in enumerate(CARS)]
PV = {
    # test_paragraph_vectors / test_paragraph_vectors_hierarchical_softmax
    "dbow": (dict(layer_size=24, min_word_frequency=1, epochs=15, negative=4,
                  learning_rate=0.05, seed=2), DOCS),
    "dbow_hs": (dict(layer_size=24, min_word_frequency=1, epochs=15,
                     learning_rate=0.05, seed=2,
                     use_hierarchical_softmax=True), DOCS),
    # the slow test_paragraph_vectors_pv_dm, at its own size
    "dm": (dict(layer_size=24, window=3, epochs=40, negative=4, seed=11,
                dm=True, learning_rate=0.05), DM_DOCS),
    "dm_hs": (dict(layer_size=24, window=3, epochs=20, seed=11, dm=True,
                   learning_rate=0.05, use_hierarchical_softmax=True),
              DM_DOCS),
}


@pytest.mark.parametrize("variant", list(PV))
def test_paragraph_vectors_fit_and_infer_equal_the_reference(variant):
    kw, docs = PV[variant]
    ref = jnlp.ParagraphVectors(**kw).fit(docs)
    port = tnlp.ParagraphVectors(device="cpu", **kw).fit(docs)
    assert port.doc_labels == ref.doc_labels
    _close(port.doc_vectors, ref.doc_vectors, "doc_vectors")
    _close(port.syn0, ref.syn0, "syn0")
    out = "syn1" if kw.get("use_hierarchical_softmax") else "syn1neg"
    _close(getattr(port, out), getattr(ref, out), out)
    # infer_vector seeds from hash(text): equal within one process
    text = "sun light bright day" if docs is DOCS else "the cat sat on a mat"
    v = port.infer_vector(text)
    assert v.shape == (24,) and v.dtype == np.float32
    np.testing.assert_allclose(v, ref.infer_vector(text), atol=1e-6)
    if docs is DOCS:
        assert port.similarity_to_label(text, "doc_day") > \
            port.similarity_to_label(text, "doc_night")
    else:
        assert port.doc_vectors.shape == (6, 24)

        def sim(a, b):
            va, vb = port.get_doc_vector(a), port.get_doc_vector(b)
            return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
        if variant == "dm":
            same = np.mean([sim("cat_0", "cat_1"), sim("cat_0", "cat_2"),
                            sim("car_0", "car_1"), sim("car_0", "car_2")])
            cross = np.mean([sim("cat_0", "car_0"), sim("cat_1", "car_1"),
                             sim("cat_2", "car_2")])
            assert same > cross
    assert port.get_doc_vector("no such label") is None
    assert np.array_equal(port.infer_vector("zzz qqq"),
                          ref.infer_vector("zzz qqq"))   # no known word
