"""The port's input preprocessors (``nn/preprocessors.py``) against the JAX
package's.

Each of the six reshapes the same numpy array as JAX's does, bitwise, and
gives the same output type; ``auto_preprocessor`` inserts, passes and
refuses where JAX's does. A network whose configuration builder inserts a
``CnnToFeedForwardPreProcessor`` (conv -> pool -> dense -> softmax, the
``regression_v1_mln_cnn`` architecture) gives JAX's output and loss on
JAX's weights, and its int8 forward (``int8_forward_fn``) equals JAX's at
atol 1e-6: the preprocessor runs in the walk, where the port used to
raise. A graph vertex with an explicit preprocessor runs it too."""
import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import inputs as jin
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import preprocessors as jp
from deeplearning4j_tpu.ops.kernels import quantized as jq
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import inputs as tin
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn import preprocessors as tp
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.kernels import quantized as tq

R = np.random.default_rng(41)

# (class name, constructor kwargs, input shape, input type kind and args)
CASES = [
    ("CnnToFeedForwardPreProcessor", dict(height=3, width=4, channels=2),
     (5, 3, 4, 2), ("InputTypeConvolutional", (3, 4, 2))),
    ("FeedForwardToCnnPreProcessor", dict(height=3, width=4, channels=2),
     (5, 24), ("InputTypeConvolutionalFlat", (3, 4, 2))),
    ("RnnToFeedForwardPreProcessor", dict(), (4, 6, 3),
     ("InputTypeRecurrent", (3, 6))),
    ("FeedForwardToRnnPreProcessor", dict(timestep_length=6), (24, 3),
     ("InputTypeFeedForward", (3,))),
    ("CnnToRnnPreProcessor", dict(height=2, width=2, channels=3,
                                  timestep_length=5),
     (10, 2, 2, 3), ("InputTypeConvolutional", (2, 2, 3))),
    ("RnnToCnnPreProcessor", dict(height=2, width=3, channels=2),
     (4, 5, 12), ("InputTypeRecurrent", (12, 5))),
]


@pytest.mark.parametrize("name, kw, shape, itype", CASES,
                         ids=[c[0] for c in CASES])
def test_each_preprocessor_matches_jax(name, kw, shape, itype):
    x = R.standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(jp, name)(**kw).apply(jax.numpy.asarray(x)))
    got = getattr(tp, name)(**kw).apply(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    it_name, args = itype
    jt = getattr(jp, name)(**kw).output_type(getattr(jin, it_name)(*args))
    tt = getattr(tp, name)(**kw).output_type(getattr(tin, it_name)(*args))
    assert type(tt).__name__ == type(jt).__name__
    assert vars(tt) == vars(jt)


_ITYPES = [("InputTypeFeedForward", (6,)), ("InputTypeRecurrent", (6, 4)),
           ("InputTypeConvolutional", (3, 4, 2)),
           ("InputTypeConvolutionalFlat", (3, 4, 2))]


@pytest.mark.parametrize("expected", ["ff", "cnn", "rnn", "any"])
def test_auto_preprocessor_inserts_passes_and_refuses_as_jax(expected):
    for it_name, args in _ITYPES:
        try:
            jpre, jt = jp.auto_preprocessor(getattr(jin, it_name)(*args),
                                            expected)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tp.auto_preprocessor(getattr(tin, it_name)(*args), expected)
            assert str(got.value) == str(e)
            continue
        tpre, tt = tp.auto_preprocessor(getattr(tin, it_name)(*args),
                                        expected)
        assert type(tpre).__name__ == type(jpre).__name__, (it_name,
                                                             expected)
        if tpre is not None:
            assert vars(tpre) == vars(jpre)
        assert (type(tt).__name__, vars(tt)) == (type(jt).__name__, vars(jt))


def _cnn(conf_cls, L, it):
    return (conf_cls(seed=7, activation="relu").list(
        L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                           convolution_mode="same"),
        L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
        L.DenseLayer(n_out=16, activation="relu"),
        L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(it.convolutional(8, 8, 2)).build())


@pytest.fixture(scope="module")
def cnn_nets():
    jnet = JMLN(_cnn(JConf, jl, jin.InputType)).init()
    pnet = MultiLayerNetwork(_cnn(TConf, tl, tin.InputType),
                             device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def test_a_built_cnn_net_runs_its_preprocessor_as_jax(cnn_nets):
    jnet, pnet = cnn_nets
    assert isinstance(pnet.conf.preprocessor(2),
                      tp.CnnToFeedForwardPreProcessor)
    x = R.standard_normal((6, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(6) % 3]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    assert pnet.score(x, y) == pytest.approx(float(jnet.score(x, y)),
                                             rel=1e-5)


def test_int8_forward_of_a_net_with_a_preprocessor_matches_jax(cnn_nets):
    jnet, pnet = cnn_nets
    x = R.standard_normal((4, 8, 8, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jq.int8_forward_fn(jnet))(
        jnet.params, jnet.state, x))
    with torch.inference_mode():
        got = tq.int8_forward_fn(pnet)(pnet, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_a_graph_vertex_runs_its_explicit_preprocessor():
    from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
    conf = (TConf(seed=3).graph_builder().add_inputs("in")
            .add_layer("d", tl.DenseLayer(n_out=4, activation="identity"),
                       "in", preprocessor=tp.CnnToFeedForwardPreProcessor(
                           2, 2, 3))
            .add_layer("out", tl.OutputLayer(n_out=2, activation="softmax"),
                       "d")
            .set_outputs("out")
            .set_input_types(tin.InputType.convolutional(2, 2, 3)).build())
    net = ComputationGraph(conf, device="cpu").init()
    assert net.vertices["d"].layer.n_in == 12
    x = torch.tensor(R.standard_normal((3, 2, 2, 3)).astype(np.float32))
    d = net.vertices["d"].layer
    want = x.reshape(3, 12) @ d.W + d.b
    got = net.feed_forward(x)["d"]
    torch.testing.assert_close(got, want)
    auto = (TConf(seed=3).graph_builder().add_inputs("in")
            .add_layer("out", tl.OutputLayer(n_out=2), "in")
            .set_outputs("out")
            .set_input_types(tin.InputType.convolutional(2, 2, 3)).build())
    assert isinstance(auto.vertices["out"].preprocessor,
                      tp.CnnToFeedForwardPreProcessor)
