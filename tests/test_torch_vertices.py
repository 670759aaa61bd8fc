"""The port's nine vertices of ROADMAP A5's second half
(``nn/graph/vertices.py``), the executor's mask and length rules for the
recurrent pair (``nn/graph/graph.py``), and the slice as a whole, against
the JAX package on the same seeded inputs and weights.

Each vertex: its output and the gradient of a weighted sum of it with
respect to its inputs, at 1e-6 (f32). ``LastTimeStepVertex`` takes the
mask of its ``mask_input``, else the mask its input carries, and none
after a vertex that changed the sequence length (a strided 1-D conv).

The slice: a sequence classifier, ids -> ``EmbeddingLayer`` (behind an
explicit ``RnnToFeedForwardPreProcessor``) -> ``GravesLSTM`` (behind
``FeedForwardToRnnPreProcessor(T)``) -> ``LastTimeStepVertex(mask_input=
"in")`` -> softmax, at V 500, E 30, H 16, T 12, B 4 with lengths 3-12 as
a [B,T] features mask: loss at rel 1e-5 and gradients at rel-to-max 1e-4
in f32, parameters after three Adam steps with element-wise clipping at
1e-9 in f64. And the graph of ``examples/seq2seq_tbptt.py`` (encoder LSTM
-> ``LastTimeStepVertex`` -> ``DuplicateToTimeSeriesVertex`` -> decoder
LSTM, tBPTT 5): fits and ``rnn_time_step`` at atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import preprocessors as jp
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import vertices as jv
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.inputs import InputType as JIT
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn import preprocessors as tp
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import vertices as tv
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.optimize import updaters as tupd

R = np.random.default_rng(16)
PKG = {"jax": (jl, jp, jv, JConf, JIT, jupd, JCG),
       "torch": (tl, tp, tv, NeuralNetConfiguration, InputType, tupd,
                 ComputationGraph)}


def _np(tree, dtype):
    return [{k: np.asarray(v, dtype) for k, v in p.items()} for p in tree]


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ------------------------------------------------------------ the vertices
def _f32(*shape):
    return R.normal(size=shape).astype(np.float32)


_LENS = np.array([3, 5, 1])
_VERTICES = {
    "PoolHelperVertex": (lambda V: V.PoolHelperVertex(), [_f32(2, 5, 5, 3)],
                         {}),
    "SubsetVertex": (lambda V: V.SubsetVertex(from_idx=1, to_idx=3),
                     [_f32(2, 4, 6)], {}),
    "StackVertex": (lambda V: V.StackVertex(), [_f32(2, 4), _f32(3, 4)], {}),
    "UnstackVertex": (lambda V: V.UnstackVertex(from_idx=1, stack_size=3),
                      [_f32(6, 4)], {}),
    "ShiftVertex": (lambda V: V.ShiftVertex(shift_factor=-0.75),
                    [_f32(3, 4)], {}),
    "L2Vertex": (lambda V: V.L2Vertex(eps=1e-8), [_f32(5, 4), _f32(5, 4)],
                 {}),
    "PreprocessorVertex": (
        lambda V: V.PreprocessorVertex(
            preprocessor=(jp if V is jv else tp).CnnToFeedForwardPreProcessor(
                2, 3, 2)), [_f32(4, 2, 3, 2)], {}),
    "LastTimeStepVertex": (
        lambda V: V.LastTimeStepVertex(mask_input="in"), [_f32(3, 5, 4)],
        {"mask": (np.arange(5)[None] < _LENS[:, None]).astype(np.float32)}),
    "DuplicateToTimeSeriesVertex": (
        lambda V: V.DuplicateToTimeSeriesVertex(reference_input="in"),
        [_f32(3, 4)], {"timesteps": 6}),
}


@pytest.mark.parametrize("name", sorted(_VERTICES))
def test_vertex_matches_jax(name):
    make, xs, kw = _VERTICES[name]
    jvx, tvx = make(jv), make(tv)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jout, _ = jvx.apply({}, {}, [jnp.asarray(x) for x in xs], **jkw)
    tin = [torch.tensor(x, requires_grad=True) for x in xs]
    tout = tvx(tin, **tkw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    w = R.normal(size=np.asarray(jout).shape).astype(np.float32)

    def jsum(*a):
        return jnp.sum(jvx.apply({}, {}, list(a), **jkw)[0] * w)
    jg = jax.grad(jsum, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    tg = torch.autograd.grad((tout * torch.as_tensor(w)).sum(), tin)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# --------------------------------------------- LastTimeStepVertex's masks
def _last_graph(pkg, where, T=8, dtype="float32"):
    L, P, V, C, IT, U, G = PKG[pkg]
    g = (C(seed=2, updater=U.Sgd(0.1), weight_init="xavier", dtype=dtype)
         .graph_builder().add_inputs("in"))
    if where == "dropped":
        g.add_layer("seq", L.Convolution1DLayer(
            n_out=5, kernel_size=2, stride=2, convolution_mode="truncate",
            activation="tanh"), "in")
    else:
        g.add_layer("seq", L.GravesLSTM(n_out=5, activation="tanh"), "in")
    g.add_vertex("last", V.LastTimeStepVertex(
        mask_input="in" if where == "mask_input" else None), "seq")
    g.add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"), "last")
    conf = g.set_outputs("out").set_input_types(IT.recurrent(4, T)).build()
    return G(conf) if pkg == "jax" else G(conf, device="cpu")


@pytest.mark.parametrize("where", ["mask_input", "propagated", "dropped"])
def test_last_time_step_masks_match_jax(where):
    jnet, pnet = _last_graph("jax", where).init(), \
        _last_graph("torch", where).init()
    load_jax_params(pnet, _np(jnet.params, np.float32))
    x = _f32(3, 8, 4)
    lens = np.array([2, 8, 5])
    mask = (np.arange(8)[None] < lens[:, None]).astype(np.float32)
    jacts, _ = jnet.apply_fn(jnet.params, jnet.state, [jnp.asarray(x)],
                             features_masks=[jnp.asarray(mask)])
    tacts = pnet.apply_fn([torch.as_tensor(x)],
                          features_masks=[torch.as_tensor(mask)])
    last = tacts["last"].detach().numpy()
    np.testing.assert_allclose(last, np.asarray(jacts["last"]), atol=1e-6)
    seq = tacts["seq"].detach().numpy()
    if where == "dropped":          # T 8 -> 4: the literal last step
        np.testing.assert_array_equal(last, seq[:, -1])
    else:                           # each sequence's last real step
        np.testing.assert_array_equal(last, seq[np.arange(3), lens - 1])


# ------------------------------------------------------- the slice, whole
V_, E_, H_, T_, B_ = 500, 30, 16, 12, 4


def _classifier(pkg, dtype):
    L, P, V, C, IT, U, G = PKG[pkg]
    g = (C(seed=3, updater=U.Adam(2e-2), l2=1e-5, weight_init="xavier",
           dtype=dtype,
           gradient_normalization="clipelementwiseabsolutevalue",
           gradient_normalization_threshold=1.0)
         .graph_builder().add_inputs("in")
         .add_layer("emb", L.EmbeddingLayer(n_in=V_, n_out=E_,
                                            activation="identity"), "in",
                    preprocessor=P.RnnToFeedForwardPreProcessor())
         .add_layer("lstm", L.GravesLSTM(n_out=H_, activation="tanh"), "emb",
                    preprocessor=P.FeedForwardToRnnPreProcessor(
                        timestep_length=T_))
         .add_vertex("last", V.LastTimeStepVertex(mask_input="in"), "lstm")
         .add_layer("out", L.OutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent"), "last")
         .set_outputs("out").set_input_types(IT.recurrent(1, T_)))
    conf = g.build()
    return (G(conf) if pkg == "jax" else G(conf, device="cpu")).init()


def _reviews(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V_, (B_, T_, 1)).astype(dtype)
    lens = rng.integers(3, T_ + 1, B_)
    mask = (np.arange(T_)[None] < lens[:, None]).astype(dtype)
    y = np.eye(2, dtype=dtype)[rng.integers(0, 2, B_)]
    return ids, mask, y


def test_sequence_classifier_loss_and_gradients_match_jax():
    jnet, pnet = _classifier("jax", "float32"), _classifier("torch",
                                                            "float32")
    load_jax_params(pnet, _np(jnet.params, np.float32))
    ids, mask, y = _reviews(1)

    def jloss(p):
        return jnet.loss_fn(p, jnet.state, [jnp.asarray(ids)],
                            [jnp.asarray(y)], train=False,
                            features_mask=[jnp.asarray(mask)])[0]
    jl_, jg = jax.value_and_grad(jloss)(jnet.params)
    tl_ = pnet.loss_fn([torch.as_tensor(ids)], [torch.as_tensor(y)],
                       train=False, features_mask=[torch.as_tensor(mask)])
    assert abs(float(tl_.detach()) - float(jl_)) <= 1e-5 * abs(float(jl_))
    pd = pnet.param_dicts()
    names = [(v, k) for v, d in pd.items() for k in d]
    tg = torch.autograd.grad(tl_, [pd[v][k] for v, k in names])
    idx = {n: i for i, n in enumerate(jnet.vertex_names)}
    for (v, k), g in zip(names, tg):
        assert _rel_to_max(g.numpy(), jg[idx[v]][k]) <= 1e-4, (v, k)
    # the padded steps do not reach the loss: a different id there
    # changes nothing
    ids2 = ids.copy()
    ids2[mask == 0] = (ids2[mask == 0] + 7) % V_
    tl2 = pnet.loss_fn([torch.as_tensor(ids2)], [torch.as_tensor(y)],
                       train=False, features_mask=[torch.as_tensor(mask)])
    assert float(tl2.detach()) == float(tl_.detach())


def test_sequence_classifier_fit_matches_jax_in_float64():
    jnet, pnet = _classifier("jax", "float64"), _classifier("torch",
                                                            "float64")
    load_jax_params(pnet, _np(jnet.params, np.float64))
    for seed in (2, 3, 4):
        ids, mask, y = _reviews(seed, np.float64)
        jnet.fit(dataset=JDS(ids, y, features_mask=mask))
        pnet.fit(dataset=DataSet(ids, y, features_mask=mask))
    assert pnet.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-9)


# ---------------------------------------------------- seq2seq (examples/)
def _seq2seq(pkg):
    """``examples/seq2seq_tbptt.py``'s graph, as the example builds it."""
    L, P, V, C, IT, U, G = PKG[pkg]
    g = (C(seed=5, updater=U.Adam(5e-3)).graph_builder()
         .add_inputs("in")
         .add_layer("enc", L.LSTM(n_out=32, activation="tanh"), "in")
         .add_vertex("last", V.LastTimeStepVertex(mask_input="in"), "enc")
         .add_vertex("dup", V.DuplicateToTimeSeriesVertex(
             reference_input="in"), "last")
         .add_layer("dec", L.LSTM(n_out=32, activation="tanh"), "dup")
         .add_layer("out", L.RnnOutputLayer(n_out=3, activation="softmax",
                                            loss="mcxent"), "dec")
         .set_outputs("out")
         .set_input_types(IT.recurrent(4, 20))
         .tbptt_length(5))
    conf = g.build()
    return (G(conf) if pkg == "jax" else G(conf, device="cpu")).init()


class _Losses:
    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration, loss):
        self.losses.append(float(loss))


def _seq2seq_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 20, 4)).astype(np.float32)
    csum = np.cumsum(x.sum(-1), 1)
    y = np.eye(3, dtype=np.float32)[
        (csum > 0).astype(int) + (csum > 3).astype(int)]
    return x, y


def test_seq2seq_tbptt_and_streaming_match_jax():
    jnet, pnet = _seq2seq("jax"), _seq2seq("torch")
    load_jax_params(pnet, _np(jnet.params, np.float32))
    x, y = _seq2seq_data()
    jr, pr = _Losses(), _Losses()
    jnet.set_listeners(jr)
    pnet.set_listeners(pr)
    for _ in range(3):
        jnet.fit(x, y, batch_size=32)
        pnet.fit(x, y, batch_size=32)
    assert pnet.iteration_count == jnet.iteration_count == 12  # 4 chunks
    np.testing.assert_allclose(pr.losses, jr.losses, rtol=1e-5)
    # twelve f32 Adam steps: a near-zero gradient entry's float noise moves
    # its parameter by up to ~lr x noise / eps, so parameters are compared
    # relative to their largest, the outputs absolutely
    assert _rel_to_max(pnet.params_flat().numpy(),
                       np.asarray(jnet.params_flat())) <= 1e-4
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
    jnet.rnn_clear_previous_state()
    pnet.rnn_clear_previous_state()
    steps = []
    for t in range(3):
        js = np.asarray(jnet.rnn_time_step(x[:2, t]))
        ts = pnet.rnn_time_step(x[:2, t]).numpy()
        np.testing.assert_allclose(ts, js, atol=1e-5)
        steps.append(ts)
    assert steps[0].shape == (2, 3)
