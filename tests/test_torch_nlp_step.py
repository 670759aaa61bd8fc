"""The NLP engine's device step (``nlp/sequence_vectors.py``,
``nlp/distributed_w2v.py``) against the JAX package's.

The same tables and indices (numpy, from a seed) go through the JAX
``_build_step`` and the port's on the CPU. Every batch repeats rows on
purpose: frequent centers, contexts and negatives collide, and the
colliding updates must add up (``.at[].add`` in JAX, ``index_add_`` in the
port). The tolerance is the reference's own pin for its analytic step
against autodiff: atol 1e-6 (``tests/test_nlp.py``). Host pair
generation, which the port builds with numpy instead of a Python loop,
must give the reference's pairs and leave the generator where the
reference leaves it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import distributed_w2v as jdist
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.nlp import distributed_w2v as tdist
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

ATOL = 1e-6
V, D, K, L, C = 50, 16, 5, 7, 4


def _batch(seed, B, cbow, hs):
    """Tables and indices with deliberate duplicates: a third of the
    centers, contexts and negatives fall on rows 0-2."""
    r = np.random.default_rng(seed)

    def idx(shape, hi=V):
        x = r.integers(0, hi, shape)
        hot = r.random(shape) < 0.33
        return np.where(hot, r.integers(0, 3, shape), x).astype(np.int64)

    syn0 = (r.normal(size=(V, D)) * 0.1).astype(np.float32)
    syn1 = (r.normal(size=(V - 1 if hs else V, D)) * 0.1).astype(np.float32)
    b = {"syn0": syn0, "syn1": syn1}
    if cbow:
        b["centers"] = idx((B, C))
        lens = r.integers(1, C + 1, B)
        b["ctx_mask"] = (np.arange(C)[None, :] < lens[:, None]
                         ).astype(np.float32)
        # padded slots point at row 0, as PV-DM's do
        b["centers"] = np.where(b["ctx_mask"] > 0, b["centers"], 0)
    else:
        b["centers"] = idx((B,))
        b["ctx_mask"] = None
    if hs:
        b["points"] = idx((B, L), V - 1)
        b["codes"] = r.integers(0, 2, (B, L)).astype(np.float32)
        plen = r.integers(1, L + 1, B)
        b["path_mask"] = (np.arange(L)[None, :] < plen[:, None]
                          ).astype(np.float32)
        b["points"] = np.where(b["path_mask"] > 0, b["points"], 0)
    else:
        b["contexts"] = idx((B,))
        b["negs"] = idx((B, K))
    return b


def _jax_step(b, cbow, hs, lr):
    sv = jsv.SequenceVectors(layer_size=D, negative=K,
                             learning_algorithm="cbow" if cbow else
                             "skipgram", use_hierarchical_softmax=hs)
    step = sv._build_step()
    mask = None if b["ctx_mask"] is None else jnp.asarray(b["ctx_mask"])
    s0, s1 = jnp.asarray(b["syn0"]), jnp.asarray(b["syn1"])
    c = jnp.asarray(b["centers"])
    if hs:
        out = step(s0, s1, c, jnp.asarray(b["points"]),
                   jnp.asarray(b["codes"]), jnp.asarray(b["path_mask"]),
                   lr, mask)
    else:
        out = step(s0, s1, c, jnp.asarray(b["contexts"]),
                   jnp.asarray(b["negs"]), lr, mask)
    return tuple(np.asarray(o) for o in out)


def _port_step(b, cbow, hs, lr):
    sv = tsv.SequenceVectors(layer_size=D, negative=K, device="cpu",
                             learning_algorithm="cbow" if cbow else
                             "skipgram", use_hierarchical_softmax=hs)
    step = sv._build_step()
    t = {k: None if v is None else torch.from_numpy(v.copy())
         for k, v in b.items()}
    if hs:
        s0, s1, loss = step(t["syn0"], t["syn1"], t["centers"], t["points"],
                            t["codes"], t["path_mask"], lr, t["ctx_mask"])
    else:
        s0, s1, loss = step(t["syn0"], t["syn1"], t["centers"],
                            t["contexts"], t["negs"], lr, t["ctx_mask"])
    # in place: the tables handed in are the tables returned
    assert s0 is t["syn0"] and s1 is t["syn1"]
    return s0.numpy(), s1.numpy(), loss.numpy()


@pytest.mark.parametrize("hs", [False, True], ids=["ns", "hs"])
@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
def test_step_equals_the_jax_step_with_duplicate_rows(cbow, hs):
    b = _batch(3 + 2 * cbow + hs, 64, cbow, hs)
    want = _jax_step(b, cbow, hs, 0.05)
    got = _port_step(b, cbow, hs, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # the duplicates moved: both tables changed, row 0 most of all
    assert np.abs(got[0] - b["syn0"]).max() > 1e-3
    assert np.abs(got[1] - b["syn1"]).max() > 1e-3


@pytest.mark.parametrize("hs", [False, True], ids=["ns", "hs"])
def test_duplicates_add_up_and_padding_adds_nothing(hs):
    """A batch whose every pair is the same (center, target): the step
    must move the rows by B times one pair's update, to rounding. Padded
    entries (HS path entries, CBOW slots with mask 0) leave their row 0
    untouched when no real entry points there."""
    B = 32
    b = _batch(11, B, cbow=True, hs=hs)
    b["centers"][:] = 5
    b["ctx_mask"][:] = 0
    b["ctx_mask"][:, 0] = 1
    b["centers"][:, 1:] = 0
    if hs:
        b["points"][:] = np.arange(1, L + 1)
        b["codes"][:] = b["codes"][0]
        b["path_mask"][:] = 1
        b["path_mask"][:, 3:] = 0
        b["points"][:, 3:] = 0
    else:
        b["contexts"][:] = 7
        b["negs"][:] = np.arange(10, 10 + K)
    s0, s1, _ = _port_step(b, True, hs, 0.01)
    one = {k: (v[:1] if isinstance(v, np.ndarray) and v.shape[:1] == (B,)
               else v) for k, v in b.items()}
    s0_1, s1_1, _ = _port_step(one, True, hs, 0.01)
    np.testing.assert_allclose(s0[5] - b["syn0"][5],
                               B * (s0_1[5] - b["syn0"][5]), rtol=1e-4,
                               atol=1e-7)
    assert np.array_equal(s0[0], b["syn0"][0])
    if hs:
        assert np.array_equal(s1[0], b["syn1"][0])


@pytest.mark.parametrize("hs", [False, True], ids=["ns", "hs"])
def test_step_equals_sgd_on_autograd_of_the_dense_loss(hs):
    """The analytic scatter-add step equals SGD on torch autograd of the
    dense loss (the port's counterpart of the reference's check against
    ``jax.grad``)."""
    b = _batch(4, 64, cbow=False, hs=hs)
    s0 = torch.from_numpy(b["syn0"].copy()).requires_grad_()
    s1 = torch.from_numpy(b["syn1"].copy()).requires_grad_()
    c = torch.from_numpy(b["centers"])
    v = s0[c]
    if hs:
        logits = torch.einsum("bd,bld->bl", v, s1[torch.from_numpy(
            b["points"])])
        cds = torch.from_numpy(b["codes"])
        loss = (torch.nn.functional.softplus((2 * cds - 1) * logits)
                * torch.from_numpy(b["path_mask"])).sum()
    else:
        pos = (v * s1[torch.from_numpy(b["contexts"])]).sum(-1)
        neg = torch.einsum("bd,bkd->bk", v, s1[torch.from_numpy(b["negs"])])
        loss = torch.nn.functional.softplus(-pos).sum() + \
            torch.nn.functional.softplus(neg).sum()
    g0, g1 = torch.autograd.grad(loss, (s0, s1))
    got0, got1, got_loss = _port_step(b, False, hs, 0.05)
    np.testing.assert_allclose(got0, (s0 - 0.05 * g0).detach().numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(got1, (s1 - 0.05 * g1).detach().numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(got_loss, loss.item() / 64, rtol=1e-6)


def test_analytic_gradients_equal_the_jax_ones():
    r = np.random.default_rng(9)
    v = r.normal(size=(12, D)).astype(np.float32)
    up = r.normal(size=(12, D)).astype(np.float32)
    un = r.normal(size=(12, K, D)).astype(np.float32)
    want = jsv._sgns_grads(jnp.asarray(v), jnp.asarray(up), jnp.asarray(un))
    got = tsv._sgns_grads(*(torch.from_numpy(a) for a in (v, up, un)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    u = r.normal(size=(12, L, D)).astype(np.float32)
    cds = r.integers(0, 2, (12, L)).astype(np.float32)
    msk = (r.random((12, L)) < 0.7).astype(np.float32)
    want = jsv._hs_grads(*(jnp.asarray(a) for a in (v, u, cds, msk)))
    got = tsv._hs_grads(*(torch.from_numpy(a) for a in (v, u, cds, msk)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _dist_inputs(B, seed=33):
    r = np.random.default_rng(seed)
    Vd, Dd, k = 40, 12, 5
    return (Vd, Dd, k, (r.normal(size=(Vd, Dd)) * 0.1).astype(np.float32),
            (r.normal(size=(Vd, Dd)) * 0.1).astype(np.float32),
            r.integers(0, Vd, B), r.integers(0, Vd, B),
            r.integers(0, Vd, (B, k)))


@pytest.mark.parametrize("B", [64, 61], ids=["even", "padded"])
def test_distributed_step_equals_jax_and_the_single_step(B):
    """``DistributedWord2Vec`` on 8 logical workers against the JAX one on
    conftest's 8 virtual devices and against the single-device step (the
    reference's pin, atol 2e-6), with a batch that 8 does not divide."""
    Vd, Dd, k, s0, s1, c, x, n = _dist_inputs(B)
    jstep = jdist.DistributedWord2Vec(layer_size=Dd, negative=k,
                                      mesh=jmake_mesh((8,)))._build_step()
    j0, j1, jloss = jstep(jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(c),
                          jnp.asarray(x), jnp.asarray(n), 0.05)
    dist = tdist.DistributedWord2Vec(
        layer_size=Dd, negative=k, mesh=make_mesh((8,), ("data",), "cpu"))
    tstep = dist._build_step()
    assert dist._n_devices == 8
    t = [torch.from_numpy(a.copy()) for a in (s0, s1, c, x, n)]
    p0, p1, ploss = tstep(*t, 0.05)
    single = tsv.SequenceVectors(layer_size=Dd, negative=k,
                                 device="cpu")._build_step()
    u = [torch.from_numpy(a.copy()) for a in (s0, s1, c, x, n)]
    q0, q1, qloss = single(*u, 0.05)
    for got, want in ((p0, j0), (p1, j1), (p0, q0), (p1, q1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    assert float(ploss) > 0.0
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ploss), float(qloss), rtol=1e-5)


def test_distributed_cbow_keeps_the_single_step():
    dist = tdist.DistributedWord2Vec(layer_size=8, learning_algorithm="cbow",
                                     mesh=make_mesh((4,), ("data",), "cpu"))
    step = dist._build_step()
    assert not hasattr(dist, "_n_devices")
    b = _batch(5, 16, cbow=True, hs=False)
    t = {k: torch.from_numpy(v.copy()) for k, v in b.items()
         if v is not None}
    s0 = t["syn0"][:, :8].contiguous()
    s1 = t["syn1"][:, :8].contiguous()
    want0, want1 = s0.clone(), s1.clone()
    tsv.sv_step(want0, want1, t["centers"], t["contexts"], 0.05,
                t["ctx_mask"], negs=t["negs"])
    step(s0, s1, t["centers"], t["contexts"], t["negs"], 0.05, t["ctx_mask"])
    assert torch.equal(s0, want0) and torch.equal(s1, want1)


def test_neg_sampling_step_draws_in_range_and_rides_the_shared_step():
    """``make_neg_sampling_step`` draws its negatives with the generator it
    is given, all in [0, V), and then is the shared step on them."""
    r = np.random.default_rng(0)
    Vb, Db, B, k = 1000, 32, 256, 5
    syn0 = torch.from_numpy((r.normal(size=(Vb, Db)) * 0.01
                             ).astype(np.float32))
    syn1 = torch.zeros(Vb, Db)
    centers = torch.from_numpy(r.integers(0, Vb, B))
    contexts = torch.from_numpy(r.integers(0, Vb, B))
    gen = torch.Generator().manual_seed(7)
    twin = torch.Generator().manual_seed(7)
    negs = torch.randint(0, Vb, (B, k), generator=twin)
    assert 0 <= int(negs.min()) and int(negs.max()) < Vb
    assert len(torch.unique(negs)) > B      # not one row over and over
    want0, want1 = syn0.clone(), syn1.clone()
    tsv.sv_step(want0, want1, centers, contexts, 0.025, negs=negs)
    step = tsv.make_neg_sampling_step(lr=0.025, negative=k)
    got0, got1 = step(syn0, syn1, centers, contexts, gen)
    assert got0 is syn0 and got1 is syn1
    assert torch.equal(got0, want0) and torch.equal(got1, want1)
    # the generator moved: the next step draws other negatives
    assert not torch.equal(torch.randint(0, Vb, (B, k), generator=gen), negs)


@pytest.mark.parametrize("sample", [0.0, 1e-2], ids=["all", "subsampled"])
def test_pairs_for_sentence_are_the_references(sample):
    """The port builds each sentence's pairs with numpy; the pairs, their
    order and the generator's state after them are the reference's."""
    from deeplearning4j_tpu.nlp.vocab import VocabCache as JVocab
    r = np.random.default_rng(5)
    sents = [[f"w{int(i)}" for i in r.zipf(1.5, n) % 40]
             for n in (0, 1, 2, 3, 7, 30, 55)]
    vocab = JVocab.build(sents)
    keep = vocab.subsample_keep_probs(sample)
    jm = jsv.SequenceVectors(window=5)
    tm = tsv.SequenceVectors(window=5, device="cpu")
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    for s in sents:
        idxs = np.asarray([vocab.index_of(w) for w in s], np.int32)
        want = jm._pairs_for_sentence(idxs, ra, keep)
        got = tm._pairs_for_sentence(idxs, rb, keep)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ra.random() == rb.random()


def test_a_fit_without_a_card_raises_and_names_the_cpu():
    """The default device is the card: with none, a fit raises (nothing
    falls back to the CPU); reading a model needs no device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default would take it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.SequenceVectors(layer_size=4).fit([["a", "b", "a"]])
    m = tsv.SequenceVectors(layer_size=4)
    assert m.device is None and m.vocab is None
