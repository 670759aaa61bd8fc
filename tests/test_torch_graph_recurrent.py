"""A ``ComputationGraph``'s recurrent-state carry, ``clone`` and
multi-input feeds, against the JAX package on the same seeded inputs and
weights.

A graph of two GravesLSTM(16) vertices and a softmax head (vocab 11, T
12): tBPTT in chunks of 5 matches JAX's graph tBPTT (parameters 1e-5 after
two fits, the chunk losses rel 1e-5); a chunk as long as the sequence is
the standard step; ``rnn_time_step`` one step at a time equals ``output``
on the whole sequence and JAX's ``rnn_time_step`` (1e-5, K5's pin), and
``rnn_clear_previous_state`` starts it over. ``clone`` on both network
kinds gives equal outputs and is independent after training, as the
reference's. A two-input graph trains from a ``MultiDataSet`` iterator as
JAX's does (1e-5)."""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iterators import \
    ListMultiDataSetIterator as JMultiIter
from deeplearning4j_tpu.datasets.iterators import MultiDataSet as JMDS
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.graph.vertices import MergeVertex as JMerge
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.datasets.iterators import (
    ListMultiDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd

V, H, T = 11, 16, 12


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _lstm_graph(mod, conf_cls, itype, upd, graph_cls, tbptt, device=None):
    g = (conf_cls(seed=9, updater=upd, weight_init="xavier")
         .graph_builder().add_inputs("chars")
         .add_layer("l1", mod.GravesLSTM(n_out=H, activation="tanh"),
                    "chars")
         .add_layer("l2", mod.GravesLSTM(n_out=H, activation="tanh"), "l1")
         .add_layer("out", mod.RnnOutputLayer(n_out=V, activation="softmax",
                                              loss="mcxent"), "l2")
         .set_outputs("out").set_input_types(itype.recurrent(V, T)))
    if tbptt:
        g.tbptt_length(tbptt)
    conf = g.build()
    return graph_cls(conf) if device is None else graph_cls(conf,
                                                            device=device)


def _pair(tbptt=5, rule="rmsprop"):
    jupdater = jupd.RmsProp(1e-2) if rule == "rmsprop" else jupd.Sgd(0.1)
    tupdater = tupd.RmsProp(1e-2) if rule == "rmsprop" else tupd.Sgd(0.1)
    jnet = _lstm_graph(jl, JConf, JInputType, jupdater, JCG, tbptt).init()
    pnet = _lstm_graph(tl, NeuralNetConfiguration, InputType, tupdater,
                       ComputationGraph, tbptt, device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _chars(seed, n=4, t=T):
    ids = np.random.default_rng(seed).integers(0, V, (n, t))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


class _Rec:
    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration, loss):
        self.losses.append((iteration, float(loss)))


def _close_params(jnet, pnet, atol):
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=atol)


def test_graph_tbptt_matches_jax():
    jnet, pnet = _pair()
    jr, pr = _Rec(), _Rec()
    jnet.set_listeners(jr)
    pnet.set_listeners(pr)
    x, y = _chars(1)
    for _ in range(2):
        jnet.fit(x, y, batch_size=4)
        pnet.fit(x, y, batch_size=4)
    assert pnet.iteration_count == jnet.iteration_count == 6   # 3 chunks
    assert [i for i, _ in pr.losses] == [i for i, _ in jr.losses] == [2, 5]
    np.testing.assert_allclose([v for _, v in pr.losses],
                               [v for _, v in jr.losses], rtol=1e-5)
    _close_params(jnet, pnet, 1e-5)


def test_one_chunk_is_the_standard_step():
    _, chunked = _pair(tbptt=T, rule="sgd")
    _, plain = _pair(tbptt=None, rule="sgd")
    x, y = _chars(2)
    chunked.fit(x, y, batch_size=4)
    plain.fit(x, y, batch_size=4)
    assert chunked.conf.backprop_type == "tbptt"
    assert chunked.iteration_count == plain.iteration_count == 1
    torch.testing.assert_close(chunked.params_flat(), plain.params_flat(),
                               rtol=0, atol=1e-6)


def test_graph_rnn_time_step_equals_the_sequence_and_jax():
    jnet, pnet = _pair()
    x, _ = _chars(3)
    whole = pnet.output(x)
    steps = torch.stack([pnet.rnn_time_step(x[:, t]) for t in range(T)],
                        dim=1)
    torch.testing.assert_close(steps, whole, rtol=0, atol=1e-5)
    jsteps = np.stack([np.asarray(jnet.rnn_time_step(x[:, t]))
                       for t in range(T)], axis=1)
    np.testing.assert_allclose(steps.numpy(), jsteps, atol=1e-5)
    # a chunk at a time carries the same state
    pnet.rnn_clear_previous_state()
    chunks = torch.cat([pnet.rnn_time_step(x[:, :5]),
                        pnet.rnn_time_step(x[:, 5:])], dim=1)
    torch.testing.assert_close(chunks, whole, rtol=0, atol=1e-5)
    # cleared, the next step starts from zero states again
    pnet.rnn_clear_previous_state()
    torch.testing.assert_close(pnet.rnn_time_step(x[:, 0]), whole[:, 0],
                               rtol=0, atol=1e-6)
    state = pnet._rnn_state           # by vertex: l1, l2, out
    assert len(state) == 3 and state[2] is None
    assert all(s.shape == (4, H) for v in state[:2] for s in v)


@pytest.mark.parametrize("kind", ["graph", "multilayer"])
def test_clone_is_a_real_copy_like_the_references(kind):
    if kind == "graph":
        jnet, pnet = _pair()
    else:
        def mln(mod, conf_cls, itype, upd):
            return (conf_cls(seed=4, updater=upd)
                    .list(mod.GravesLSTM(n_out=H, activation="tanh"),
                          mod.RnnOutputLayer(n_out=V, activation="softmax",
                                             loss="mcxent"))
                    .set_input_type(itype.recurrent(V, T)).build())
        jnet = JMLN(mln(jl, JConf, JInputType, jupd.RmsProp(1e-2))).init()
        pnet = MultiLayerNetwork(mln(tl, NeuralNetConfiguration, InputType,
                                     tupd.RmsProp(1e-2)), device="cpu").init()
        load_jax_params(pnet, _np(jnet.params))
    x, y = _chars(4)
    pnet.fit(x, y, batch_size=4)
    jnet.fit(x, y, batch_size=4)
    jc, pc = jnet.clone(), pnet.clone()
    assert pc.iteration_count == 0 and pc.listeners == []
    torch.testing.assert_close(pc.output(x), pnet.output(x), rtol=0, atol=0)
    np.testing.assert_allclose(pc.output(x).numpy(), np.asarray(jc.output(x)),
                               atol=1e-5)
    before = pnet.params_flat().clone()
    x2, y2 = _chars(5)
    pc.fit(x2, y2, batch_size=4)
    jc.fit(x2, y2, batch_size=4)
    assert torch.equal(pnet.params_flat(), before)
    assert not torch.equal(pc.params_flat(), before)
    _close_params(jc, pc, 1e-5)
    assert pc.opt_state is not pnet.opt_state


def _two_input(mod, conf_cls, itype, upd, graph_cls, merge, device=None):
    g = (conf_cls(seed=6, updater=upd).graph_builder()
         .add_inputs("a", "b")
         .add_layer("da", mod.DenseLayer(n_out=8, activation="tanh"), "a")
         .add_layer("db", mod.DenseLayer(n_out=8, activation="relu"), "b")
         .add_vertex("m", merge(), "da", "db")
         .add_layer("out", mod.OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"), "m")
         .set_outputs("out")
         .set_input_types(itype.feed_forward(5), itype.feed_forward(4)))
    conf = g.build()
    return graph_cls(conf) if device is None else graph_cls(conf,
                                                            device=device)


def test_two_input_graph_fits_from_a_multidataset_like_jax():
    jnet = _two_input(jl, JConf, JInputType, jupd.Adam(1e-2), JCG,
                      JMerge).init()
    pnet = _two_input(tl, NeuralNetConfiguration, InputType,
                      tupd.Adam(1e-2), ComputationGraph, MergeVertex,
                      device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    r = np.random.default_rng(7)
    a = r.normal(size=(24, 5)).astype(np.float32)
    b = r.normal(size=(24, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 24)]
    jnet.fit(iterator=JMultiIter(JMDS([a, b], [y]), batch_size=8), epochs=2)
    pnet.fit(iterator=ListMultiDataSetIterator(MultiDataSet([a, b], [y]),
                                               batch_size=8), epochs=2)
    assert pnet.iteration_count == jnet.iteration_count == 6
    _close_params(jnet, pnet, 1e-5)
    # lists of arrays feed a multi-input fit whole, as the reference's
    jnet.fit([a, b], [y])
    pnet.fit([a, b], [y])
    assert pnet.iteration_count == 7
    _close_params(jnet, pnet, 1e-5)
    np.testing.assert_allclose(pnet.output(a, b).numpy(),
                               np.asarray(jnet.output(a, b)), atol=1e-5)
