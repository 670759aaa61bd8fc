"""The port's gradient check (``util/gradcheck.py``) on its own layers, and
its time-series helpers (``util/timeseries.py``) against the JAX
package's.

``check_gradients`` (float64 central differences against
``torch.autograd``) passes on Dense, convolution and pooling, the LSTM
and GravesLSTM under features and labels masks, BatchNormalization, the
embedding, the 1-D layers, the VAE and RBM as supervised layers, a graph
of the new vertices, and the sequence classifier of this slice;
``check_pretrain_gradients`` passes on the VAE's ELBO and the denoising
autoencoder's loss and refuses the RBM's CD-k, as the reference's does.
The check bites: it fails on a layer whose backward is deliberately
wrong (a test double built here), and it refuses a float32 network. The
parameter subset is drawn as the reference draws it."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.util import timeseries as jts
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn import preprocessors as tp
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import vertices as tv
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Sgd
from deeplearning4j_tpu_torch.util import gradcheck as tgc
from deeplearning4j_tpu_torch.util import timeseries as tts

R = np.random.default_rng(42)


def _net(layers, input_type=None, dtype="float64", **kw):
    b = NeuralNetConfiguration(seed=12345, updater=Sgd(0.1), dtype=dtype,
                               **kw).list(*layers)
    if input_type is not None:
        b = b.set_input_type(input_type)
    return MultiLayerNetwork(b.build(), device="cpu").init()


def _onehot(idx, n):
    return np.eye(n)[idx]


# ------------------------------------------------------------- it passes
def _case(name):
    if name == "dense":
        net = _net([tl.DenseLayer(n_in=4, n_out=6, activation="tanh"),
                    tl.OutputLayer(n_out=3, activation="softmax")],
                   l1=1e-2, l2=1e-2)
        return net, R.normal(size=(10, 4)), _onehot(R.integers(0, 3, 10), 3)
    if name == "conv":
        net = _net([tl.ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                        activation="tanh"),
                    tl.SubsamplingLayer(pooling_type="avg",
                                        kernel_size=(2, 2), stride=(1, 1)),
                    tl.OutputLayer(n_out=2, activation="softmax")],
                   InputType.convolutional(5, 5, 2))
        return net, R.normal(size=(3, 5, 5, 2)), _onehot(
            R.integers(0, 2, 3), 2)
    if name in ("lstm", "graves_lstm"):
        cls = tl.LSTM if name == "lstm" else tl.GravesLSTM
        net = _net([cls(n_in=3, n_out=4, activation="tanh"),
                    tl.RnnOutputLayer(n_out=2, activation="softmax")],
                   InputType.recurrent(3, 5))
        mask = (np.arange(5)[None] < np.array([[5], [3], [2]])).astype(float)
        y = _onehot(R.integers(0, 2, 15), 2).reshape(3, 5, 2)
        return net, R.normal(size=(3, 5, 3)), y, dict(
            features_mask=mask, labels_mask=mask)
    if name == "batchnorm":
        net = _net([tl.DenseLayer(n_in=4, n_out=5, activation="identity"),
                    tl.BatchNormalization(),
                    tl.ActivationLayer(activation="tanh"),
                    tl.OutputLayer(n_out=3, activation="softmax")])
        with torch.no_grad():         # running statistics away from 0 / 1
            net.layers[1].mean.copy_(torch.linspace(-0.5, 0.5, 5))
            net.layers[1].var.copy_(torch.linspace(0.5, 2.0, 5))
        return net, R.normal(size=(8, 4)), _onehot(R.integers(0, 3, 8), 3)
    if name == "embedding":
        net = _net([tl.EmbeddingLayer(n_in=7, n_out=5, activation="tanh"),
                    tl.DenseLayer(n_out=6, activation="tanh"),
                    tl.OutputLayer(n_out=3, activation="softmax")])
        return net, R.integers(0, 7, (10, 1)), _onehot(
            R.integers(0, 3, 10), 3)
    if name == "conv1d":
        net = _net([tl.Convolution1DLayer(n_out=4, kernel_size=3, stride=2,
                                          convolution_mode="same",
                                          activation="tanh"),
                    tl.ZeroPadding1DLayer(padding=(1, 0)),
                    tl.Subsampling1DLayer(pooling_type="avg", kernel_size=2,
                                          stride=1),
                    tl.RnnOutputLayer(n_out=2, activation="softmax")],
                   InputType.recurrent(3, 6))
        y = _onehot(R.integers(0, 2, 9), 2).reshape(3, 3, 2)
        return net, R.normal(size=(3, 6, 3)), y
    if name == "vae_rbm":
        net = _net([tl.VariationalAutoencoder(
                        n_in=4, n_out=3, encoder_layer_sizes=(6,),
                        decoder_layer_sizes=(6,), activation="tanh"),
                    tl.RBM(n_out=5),
                    tl.OutputLayer(n_out=3, activation="softmax")])
        return net, R.normal(size=(10, 4)), _onehot(R.integers(0, 3, 10), 3)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["dense", "conv", "lstm", "graves_lstm",
                                  "batchnorm", "embedding", "conv1d",
                                  "vae_rbm"])
def test_check_gradients_passes(name):
    net, x, y, *kw = _case(name)
    assert tgc.check_gradients(net, x, y, **(kw[0] if kw else {}))


def test_check_gradients_on_a_graph_of_the_new_vertices():
    g = (NeuralNetConfiguration(seed=3, updater=Sgd(0.1), dtype="float64")
         .graph_builder().add_inputs("in")
         .add_layer("a", tl.DenseLayer(n_out=5, activation="tanh"), "in")
         .add_vertex("sub", tv.SubsetVertex(from_idx=1, to_idx=3), "a")
         .add_vertex("shift", tv.ShiftVertex(shift_factor=0.5), "sub")
         .add_vertex("stack", tv.StackVertex(), "shift", "sub")
         .add_layer("d", tl.DenseLayer(n_out=4, activation="tanh"), "stack")
         .add_vertex("u0", tv.UnstackVertex(from_idx=0, stack_size=2), "d")
         .add_vertex("u1", tv.UnstackVertex(from_idx=1, stack_size=2), "d")
         .add_vertex("l2", tv.L2Vertex(), "u0", "u1")
         .add_vertex("m", tv.MergeVertex(), "u0", "l2")
         .add_layer("out", tl.OutputLayer(n_out=2, activation="softmax"), "m")
         .set_outputs("out").set_input_types(InputType.feed_forward(4)))
    net = ComputationGraph(g.build(), device="cpu").init()
    assert tgc.check_gradients(net, R.normal(size=(6, 4)),
                               _onehot(R.integers(0, 2, 6), 2))


def test_check_gradients_on_the_sequence_classifier():
    """This slice's classifier at a small size: the embedding, the
    GravesLSTM (its plain recurrence in float64) and the masked last
    step."""
    T = 6
    g = (NeuralNetConfiguration(seed=3, updater=Sgd(0.1), l2=1e-3,
                                dtype="float64")
         .graph_builder().add_inputs("in")
         .add_layer("emb", tl.EmbeddingLayer(n_in=20, n_out=4,
                                             activation="identity"), "in",
                    preprocessor=tp.RnnToFeedForwardPreProcessor())
         .add_layer("lstm", tl.GravesLSTM(n_out=5, activation="tanh"), "emb",
                    preprocessor=tp.FeedForwardToRnnPreProcessor(
                        timestep_length=T))
         .add_vertex("last", tv.LastTimeStepVertex(mask_input="in"), "lstm")
         .add_vertex("dup", tv.DuplicateToTimeSeriesVertex(
             reference_input="lstm"), "last")
         .add_layer("dec", tl.LSTM(n_out=3, activation="tanh"), "dup")
         .add_vertex("last2", tv.LastTimeStepVertex(), "dec")
         .add_layer("out", tl.OutputLayer(n_out=2, activation="softmax"),
                    "last2")
         .set_outputs("out").set_input_types(InputType.recurrent(1, T)))
    net = ComputationGraph(g.build(), device="cpu").init()
    ids = R.integers(0, 20, (3, T, 1)).astype(float)
    mask = (np.arange(T)[None] < np.array([[6], [2], [4]])).astype(float)
    assert tgc.check_gradients(net, [ids], [_onehot(R.integers(0, 2, 3), 2)],
                               features_mask=[mask])


@pytest.mark.parametrize("which", ["vae", "vae_bernoulli_2samples", "ae"])
def test_check_pretrain_gradients_passes(which):
    if which == "ae":
        layer = tl.AutoEncoder(n_in=5, n_out=3, corruption_level=0.4,
                               activation="sigmoid", loss="xent")
        x = R.random((6, 5))
    else:
        bern = which != "vae"
        layer = tl.VariationalAutoencoder(
            n_in=5, n_out=2, encoder_layer_sizes=(6,),
            decoder_layer_sizes=(6,), activation="tanh",
            num_samples=2 if bern else 1,
            reconstruction_distribution=(
                tl.BernoulliReconstructionDistribution() if bern else None))
        x = (R.random((6, 5)) > 0.5).astype(float) if bern \
            else R.normal(size=(6, 5))
    net = _net([tl.DenseLayer(n_in=5, n_out=5, activation="identity"),
                layer])
    if which == "ae":               # keep the encoder's input in [0, 1]
        net.layers[0].activation = "sigmoid"
    assert tgc.check_pretrain_gradients(net, 1, x)


def test_check_pretrain_gradients_refuses_the_rbm():
    net = _net([tl.RBM(n_in=4, n_out=3)])
    with pytest.raises(ValueError, match="CD-k"):
        tgc.check_pretrain_gradients(net, 0, R.random((4, 4)))


# --------------------------------------------------------------- it bites
class _WrongBackward(torch.autograd.Function):
    """x @ W whose backward scales W's gradient by 1.5: a fault the check
    must find."""

    @staticmethod
    def forward(ctx, x, W):
        ctx.save_for_backward(x, W)
        return x @ W

    @staticmethod
    def backward(ctx, g):
        x, W = ctx.saved_tensors
        return g @ W.T, 1.5 * (x.T @ g)


class _BrokenDense(tl.DenseLayer):
    def pre_output(self, x, *, train=False, gen=None):
        return _WrongBackward.apply(x, self.W) + self.b


def test_check_gradients_fails_on_a_wrong_backward(capsys):
    net, x, y = _case("dense")[:3]
    net.conf.l1 = net.conf.l2 = 0.0
    broken = _BrokenDense(n_in=4, n_out=6, activation="tanh")
    broken.init_params(InputType.feed_forward(4), torch.float64,
                       torch.device("cpu"), torch.Generator())
    with torch.no_grad():
        broken.W.copy_(net.layers[0].W)
        broken.b.copy_(net.layers[0].b)
    broken.l1 = broken.l2 = 0.0
    net.layers[0] = broken
    assert not tgc.check_gradients(net, x, y, print_results=True)
    out = capsys.readouterr().out
    assert "failures" in out and " 0 failures" not in out


def test_check_gradients_refuses_float32_and_draws_the_references_subset():
    net = _net([tl.DenseLayer(n_in=4, n_out=6, activation="tanh"),
                tl.OutputLayer(n_out=3, activation="softmax")],
               dtype="float32")
    with pytest.raises(ValueError, match="float64"):
        tgc.check_gradients(net, R.normal(size=(2, 4)),
                            _onehot([0, 1], 3))
    net, x, y = _case("dense")[:3]
    seen = []
    real = tgc._perturbed_losses

    def spy(loss, params, idxs, epsilon):
        seen.append(np.asarray(idxs))
        return real(loss, params, idxs, epsilon)
    tgc._perturbed_losses = spy
    try:
        assert tgc.check_gradients(net, x, y, subset=20, seed=3)
    finally:
        tgc._perturbed_losses = real
    want = np.random.default_rng(3).choice(net.num_params(), size=20,
                                           replace=False)
    np.testing.assert_array_equal(seen[0], want)


# ---------------------------------------------------------- timeseries
def test_timeseries_helpers_match_jax():
    x = R.normal(size=(3, 7, 4))
    np.testing.assert_array_equal(tts.moving_average(x[0, :, 0], 3),
                                  jts.moving_average(x[0, :, 0], 3))
    np.testing.assert_array_equal(tts.moving_average(x[1, :, 2], 5),
                                  jts.moving_average(x[1, :, 2], 5))
    flat = tts.reshape_3d_to_2d(x)
    np.testing.assert_array_equal(flat, jts.reshape_3d_to_2d(x))
    np.testing.assert_array_equal(tts.reshape_2d_to_3d(flat, 3), x)
    with pytest.raises(ValueError, match="divisible"):
        tts.reshape_2d_to_3d(flat[:-1], 3)
    m = (R.random((3, 7)) > 0.3).astype(float)
    v = tts.reshape_time_series_mask_to_vector(m)
    np.testing.assert_array_equal(v, jts.reshape_time_series_mask_to_vector(m))
    np.testing.assert_array_equal(
        tts.reshape_vector_to_time_series_mask(v, 3), m)


@pytest.mark.parametrize("obs", ["indices", "probabilities"])
def test_viterbi_matches_jax(obs):
    labels = ["a", "b", "c", "d"]
    if obs == "indices":
        seq = np.array([0, 0, 1, 0, 0, 2, 2, 2, 3, 2, 2])
    else:
        seq = R.dirichlet(np.ones(4) * 0.5, size=15)
    for stay in (0.6, 0.9):
        ll, path = tts.Viterbi(labels, stay).decode(seq)
        jll, jpath = jts.Viterbi(labels, stay).decode(seq)
        assert ll == jll
        np.testing.assert_array_equal(path, jpath)
    with pytest.raises(ValueError, match="meta_stability"):
        tts.Viterbi(labels, 1.0)
