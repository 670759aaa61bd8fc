"""Keras HDF5 import in the port (``keras_import/importer.py``) against
the JAX package's importer, one counterpart for each test of
``tests/test_keras_import.py`` but the applications test (that one is in
``tests/test_torch_keras_applications.py``).

Each test saves a real Keras model to ``.h5`` and imports the same file
through both packages (the port's on the CPU): the vertex names and the
layer classes are equal, the outputs agree with the JAX network's within
1e-5 and with ``model.predict`` at the reference test's tolerance, and a
model the reference refuses is refused with the same message."""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

from deeplearning4j_tpu.keras_import import importer as jki
from deeplearning4j_tpu.util.serialization import restore_model as jrestore
from deeplearning4j_tpu_torch.keras_import.importer import (
    import_keras_model, import_keras_model_and_weights,
    import_keras_sequential_model_and_weights)
from deeplearning4j_tpu_torch.util.serialization import restore_model

from keras import layers


def _save_h5(model, path):
    model.save(path)  # .h5 suffix selects legacy HDF5 with model_config attr


def _structure(net):
    """(vertex or layer names, layer or vertex classes) of either
    package's network."""
    if hasattr(net, "vertex_names"):
        names = list(net.vertex_names)
        verts = (net.vertices if isinstance(net.vertices, (list, tuple))
                 else [net.vertices[n] for n in names])
        return names, [type(getattr(v, "layer", None) or v).__name__
                       for v in verts]
    return (list(range(len(net.conf.layers))),
            [type(layer).__name__ for layer in net.conf.layers])


def _out(net, *xs):
    if hasattr(net, "param_dicts"):
        y = net.output(*[torch.as_tensor(x) for x in xs])
        return ([t.detach().numpy() for t in y] if isinstance(y, list)
                else y.detach().numpy())
    y = net.output(*xs)
    return [np.asarray(t) for t in y] if isinstance(y, list) else np.asarray(y)


def _check(model, path, jimport, timport, xs, tol, **kw):
    """Import ``path`` through both packages and hold the port against
    the JAX network (structure, outputs at 1e-5) and Keras (``tol``).
    Returns the port's network."""
    jnet, net = jimport(path, **kw), timport(path, device="cpu", **kw)
    assert _structure(net) == _structure(jnet)
    ours, theirs = _out(net, *xs), _out(jnet, *xs)
    keras_out = model.predict(xs if len(xs) > 1 else xs[0], verbose=0)
    if not isinstance(ours, list):
        ours, theirs, keras_out = [ours], [theirs], [keras_out]
    for o, j, k in zip(ours, theirs, keras_out):
        np.testing.assert_allclose(o, j, atol=1e-5, rtol=0)
        assert np.allclose(np.asarray(k), o, atol=tol), \
            np.abs(np.asarray(k) - o).max()
    return net


def test_import_sequential_mlp(tmp_path):
    model = keras.Sequential([
        keras.Input(shape=(4,)),
        layers.Dense(8, activation="relu"),
        layers.Dense(3, activation="softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "mlp.h5")
    _save_h5(model, path)
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    net = _check(model, path, jki.import_keras_sequential_model_and_weights,
                 import_keras_sequential_model_and_weights, [x], 1e-5)
    assert type(net).__name__ == "MultiLayerNetwork"
    assert net.device == torch.device("cpu")
    # the updater state is made afresh for the copied weights
    assert net.opt_state.keys() == net.param_dicts().keys()


def test_import_sequential_cnn(tmp_path):
    model = keras.Sequential([
        keras.Input(shape=(8, 8, 2)),
        layers.Conv2D(4, (3, 3), padding="same", activation="relu"),
        layers.MaxPooling2D((2, 2)),
        layers.Flatten(),
        layers.Dense(5, activation="softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "cnn.h5")
    _save_h5(model, path)
    x = np.random.default_rng(1).normal(size=(3, 8, 8, 2)).astype(np.float32)
    _check(model, path, jki.import_keras_sequential_model_and_weights,
           import_keras_sequential_model_and_weights, [x], 1e-4)


def test_import_via_model_guesser(tmp_path):
    """``restore_model`` sniffs the ``.h5`` in both packages."""
    model = keras.Sequential([
        keras.Input(shape=(6,)),
        layers.Dense(4, activation="tanh"),
        layers.Dense(2, activation="softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "g.h5")
    _save_h5(model, path)
    x = np.random.default_rng(14).normal(size=(3, 6)).astype(np.float32)
    net = _check(model, path, lambda p: jrestore(p),
                 lambda p, device: restore_model(p, device=device), [x], 1e-5)
    assert _out(net, np.zeros((1, 6), np.float32)).shape == (1, 2)
    net = import_keras_model(path, device="cpu")
    assert type(net).__name__ == "MultiLayerNetwork"


def test_import_functional_branching(tmp_path):
    """Two-branch functional model: Add + Concatenate merge vertices."""
    inp = keras.Input(shape=(8,))
    a = layers.Dense(4, activation="relu", name="d1")(inp)
    b = layers.Dense(4, activation="tanh", name="d2")(inp)
    m = layers.Add(name="add")([a, b])
    c = layers.Concatenate(name="cat")([m, a])
    out = layers.Dense(3, activation="softmax", name="out")(c)
    model = keras.Model(inp, out)
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "func.h5")
    _save_h5(model, path)
    x = np.random.default_rng(2).normal(size=(5, 8)).astype(np.float32)
    net = _check(model, path, jki.import_keras_model_and_weights,
                 import_keras_model_and_weights, [x], 1e-5)
    assert type(net).__name__ == "ComputationGraph"
    with pytest.raises(ValueError, match="Use import_keras_model_and_weights"):
        import_keras_sequential_model_and_weights(path, device="cpu")


def test_import_functional_cnn_residual(tmp_path):
    """Mini residual CNN (conv + BN + add + global pool), the ResNet-50
    building block, through the sniffing entry point; the BN running
    statistics land in the layer state."""
    inp = keras.Input(shape=(8, 8, 3))
    c1 = layers.Conv2D(4, (3, 3), padding="same", name="c1")(inp)
    bn = layers.BatchNormalization(name="bn")(c1)
    r = layers.Activation("relu", name="act")(bn)
    c2 = layers.Conv2D(4, (3, 3), padding="same", name="c2")(r)
    sc = layers.Conv2D(4, (1, 1), padding="same", name="sc")(inp)
    s = layers.Add(name="add")([c2, sc])
    g = layers.GlobalAveragePooling2D(name="gap")(s)
    out = layers.Dense(2, activation="softmax", name="out")(g)
    model = keras.Model(inp, out)
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    rng = np.random.default_rng(15)
    bn_layer = model.get_layer("bn")
    bn_layer.set_weights([rng.uniform(0.5, 1.5, 4), rng.normal(0, 0.1, 4),
                          rng.normal(0, 0.5, 4), rng.uniform(0.5, 2.0, 4)])
    path = str(tmp_path / "rescnn.h5")
    _save_h5(model, path)
    x = np.random.default_rng(3).normal(size=(2, 8, 8, 3)).astype(np.float32)
    net = _check(model, path, jki.import_keras_model, import_keras_model,
                 [x], 1e-4)
    np.testing.assert_array_equal(net.state_dicts()["bn"]["var"].numpy(),
                                  bn_layer.get_weights()[3])


def test_import_functional_multi_input_output(tmp_path):
    in1 = keras.Input(shape=(4,), name="in1")
    in2 = keras.Input(shape=(6,), name="in2")
    h1 = layers.Dense(5, activation="relu", name="h1")(in1)
    h2 = layers.Dense(5, activation="relu", name="h2")(in2)
    m = layers.Concatenate(name="cat")([h1, h2])
    o1 = layers.Dense(3, activation="softmax", name="o1")(m)
    o2 = layers.Dense(1, activation="linear", name="o2")(m)
    model = keras.Model([in1, in2], [o1, o2])
    model.compile(loss={"o1": "categorical_crossentropy", "o2": "mse"},
                  optimizer="sgd")
    path = str(tmp_path / "mimo.h5")
    _save_h5(model, path)
    rng = np.random.default_rng(4)
    x1 = rng.normal(size=(3, 4)).astype(np.float32)
    x2 = rng.normal(size=(3, 6)).astype(np.float32)
    net = _check(model, path, jki.import_keras_model, import_keras_model,
                 [x1, x2], 1e-5)
    losses = [net.vertices[n].layer.loss for n in ("o1", "o2")]
    assert losses == ["mcxent", "mse"]


def test_import_sequential_dense_plus_activation_head(tmp_path):
    """Dense(linear) + Activation('softmax') tail imports as a scoring
    layer, and the score equals the JAX network's."""
    model = keras.Sequential([
        keras.Input(shape=(4,)),
        layers.Dense(3),
        layers.Activation("softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "densact.h5")
    _save_h5(model, path)
    x = np.random.default_rng(5).normal(size=(4, 4)).astype(np.float32)
    net = _check(model, path, jki.import_keras_sequential_model_and_weights,
                 import_keras_sequential_model_and_weights, [x], 1e-5)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(6).integers(0, 3, 4)]
    jnet = jki.import_keras_sequential_model_and_weights(path)
    s = net.score(x, y)
    assert np.isfinite(s)
    assert s == pytest.approx(float(jnet.score(x, y)), rel=1e-5)


def test_enforce_training_config_raises_on_unknown_loss(tmp_path):
    model = keras.Sequential([
        keras.Input(shape=(4,)),
        layers.Dense(2, activation="softmax"),
    ])
    model.compile(loss="huber", optimizer="sgd")
    path = str(tmp_path / "huber.h5")
    _save_h5(model, path)
    with pytest.raises(ValueError, match="huber") as je:
        jki.import_keras_sequential_model_and_weights(
            path, enforce_training_config=True)
    with pytest.raises(ValueError, match="huber") as te:
        import_keras_sequential_model_and_weights(
            path, enforce_training_config=True, device="cpu")
    assert str(te.value) == str(je.value)
    x = np.zeros((1, 4), np.float32)
    net = _check(model, path, jki.import_keras_sequential_model_and_weights,
                 import_keras_sequential_model_and_weights, [x], 1e-5)
    assert _out(net, x).shape == (1, 2)
    assert net.conf.layers[-1].loss == "mcxent"    # the lenient default


def test_import_functional_lstm_last_step(tmp_path):
    """LSTM(return_sequences=False): the port's LSTM with tanh/sigmoid
    plus a LastTimeStep vertex, as in the reference."""
    inp = keras.Input(shape=(7, 5))
    h = layers.LSTM(6, return_sequences=False, name="enc")(inp)
    out = layers.Dense(2, activation="softmax", name="out")(h)
    model = keras.Model(inp, out)
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "lstm.h5")
    _save_h5(model, path)
    x = np.random.default_rng(7).normal(size=(3, 7, 5)).astype(np.float32)
    net = _check(model, path, jki.import_keras_model, import_keras_model,
                 [x], 1e-4)
    layer = net.vertices["enc__seq"].layer
    assert (layer.activation, layer.gate_activation) == ("tanh", "sigmoid")


def test_import_sequential_conv1d_stack(tmp_path):
    """Conv1D + MaxPooling1D + GlobalMaxPooling1D."""
    model = keras.Sequential([
        keras.Input(shape=(12, 5)),
        layers.Conv1D(8, 3, padding="same", activation="relu"),
        layers.MaxPooling1D(2),
        layers.Conv1D(6, 3, padding="valid", activation="tanh"),
        layers.GlobalMaxPooling1D(),
        layers.Dense(3, activation="softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "conv1d.h5")
    _save_h5(model, path)
    x = np.random.default_rng(8).normal(size=(4, 12, 5)).astype(np.float32)
    _check(model, path, jki.import_keras_sequential_model_and_weights,
           import_keras_sequential_model_and_weights, [x], 1e-4)


def test_import_sequential_zeropad1d_avgpool1d(tmp_path):
    model = keras.Sequential([
        keras.Input(shape=(10, 4)),
        layers.ZeroPadding1D(2),
        layers.Conv1D(6, 3, padding="valid", activation="relu"),
        layers.AveragePooling1D(2),
        layers.GlobalAveragePooling1D(),
        layers.Dense(2, activation="softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "zp1d.h5")
    _save_h5(model, path)
    x = np.random.default_rng(9).normal(size=(3, 10, 4)).astype(np.float32)
    _check(model, path, jki.import_keras_sequential_model_and_weights,
           import_keras_sequential_model_and_weights, [x], 1e-4)


def test_import_time_distributed_dense(tmp_path):
    """TimeDistributed(Dense) as the last layer becomes the
    RnnOutputLayer scoring head."""
    model = keras.Sequential([
        keras.Input(shape=(6, 4)),
        layers.LSTM(5, return_sequences=True),
        layers.TimeDistributed(layers.Dense(3, activation="softmax")),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "td.h5")
    _save_h5(model, path)
    x = np.random.default_rng(10).normal(size=(2, 6, 4)).astype(np.float32)
    net = _check(model, path, jki.import_keras_sequential_model_and_weights,
                 import_keras_sequential_model_and_weights, [x], 1e-4)
    assert _out(net, x).shape == (2, 6, 3)
    y = np.eye(3, dtype=np.float32)[
        np.random.default_rng(11).integers(0, 3, (2, 6))]
    assert np.isfinite(net.score(x, y))


def test_pool_helper_vertex():
    """PoolHelperVertex strips the first row and column (NHWC) in both
    packages' graphs from the same weights."""
    from deeplearning4j_tpu import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.graph import vertices as jv
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn.inputs import InputType as JIT
    from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
    from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
    from deeplearning4j_tpu_torch.nn.conf.config import \
        NeuralNetConfiguration as TConf
    from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph import vertices as tv
    from deeplearning4j_tpu_torch.nn import layers as tl
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd

    def build(Conf, G, l, v, IT, upd, **kw):
        b = (Conf(seed=3, updater=upd(0.1)).graph_builder()
             .add_inputs("in")
             .add_layer("c", l.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                                convolution_mode="same"), "in")
             .add_vertex("ph", v.PoolHelperVertex(), "c")
             .add_layer("gp", l.GlobalPoolingLayer(pooling_type="avg"), "ph")
             .add_layer("out", l.OutputLayer(n_out=2, activation="softmax",
                                             loss="mcxent"), "gp")
             .set_outputs("out")
             .set_input_types(IT.convolutional(6, 6, 2)))
        return G(b.build(), **kw).init()

    jnet = build(JConf, JCG, jl, jv, JIT, JSgd)
    net = build(TConf, ComputationGraph, tl, tv, InputType, Sgd,
                device="cpu")
    load_jax_params(net, [{k: np.asarray(a) for k, a in p.items()}
                          for p in jnet.params], jnet.vertex_names)
    x = np.random.default_rng(12).normal(size=(2, 6, 6, 2)).astype(np.float32)
    acts = net.feed_forward(torch.as_tensor(x))
    assert tuple(acts["ph"].shape) == (2, 5, 5, 3)
    np.testing.assert_allclose(acts["ph"].detach().numpy(),
                               np.asarray(jnet.feed_forward(x)["ph"]),
                               atol=1e-5)
    np.testing.assert_allclose(_out(net, x), _out(jnet, x), atol=1e-5)


def test_import_avgpool1d_same_odd_length(tmp_path):
    """AveragePooling1D(padding='same') over an odd length averages the
    edge windows over the valid frames only."""
    model = keras.Sequential([
        keras.Input(shape=(7, 3)),
        layers.AveragePooling1D(2, padding="same"),
        layers.GlobalAveragePooling1D(),
        layers.Dense(2, activation="softmax"),
    ])
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / "ap1same.h5")
    _save_h5(model, path)
    x = np.random.default_rng(13).normal(size=(3, 7, 3)).astype(np.float32)
    _check(model, path, jki.import_keras_sequential_model_and_weights,
           import_keras_sequential_model_and_weights, [x], 1e-5)


def _refusal(jfn, tfn, path, match):
    with pytest.raises(ValueError, match=match) as je:
        jfn(path)
    with pytest.raises(ValueError, match=match) as te:
        tfn(path, device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("case", ["channels_first", "causal_conv1d",
                                  "time_distributed_lstm",
                                  "embedding_into_lstm"])
def test_refusals_carry_over(tmp_path, case):
    """What the reference refuses, the port refuses with its message."""
    if case == "channels_first":
        model = keras.Sequential([
            keras.Input(shape=(2, 8, 8)),
            layers.Conv2D(4, (3, 3), data_format="channels_first"),
            layers.Flatten(),
            layers.Dense(2, activation="softmax")])
        fns, match = (jki.import_keras_sequential_model_and_weights,
                      import_keras_sequential_model_and_weights), \
            "channels_first"
    elif case == "causal_conv1d":
        model = keras.Sequential([
            keras.Input(shape=(8, 3)),
            layers.Conv1D(4, 3, padding="causal"),
            layers.GlobalMaxPooling1D(),
            layers.Dense(2, activation="softmax")])
        fns, match = (jki.import_keras_sequential_model_and_weights,
                      import_keras_sequential_model_and_weights), "causal"
    elif case == "time_distributed_lstm":
        inp = keras.Input(shape=(3, 4, 5))
        h = layers.TimeDistributed(layers.LSTM(2))(inp)
        model = keras.Model(inp, h)
        fns, match = (jki.import_keras_model, import_keras_model), \
            "TimeDistributed"
    else:
        inp = keras.Input(shape=(10,))
        e = layers.Embedding(50, 8)(inp)
        h = layers.LSTM(4)(e)
        model = keras.Model(inp, layers.Dense(2, activation="softmax")(h))
        fns, match = (jki.import_keras_model, import_keras_model), \
            "FeedForwardToRnnPreProcessor"
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    path = str(tmp_path / f"{case}.h5")
    _save_h5(model, path)
    _refusal(*fns, path, match)
    # restore_model turns every import failure into "Cannot determine"
    _refusal(jrestore, restore_model, path, "Cannot determine")
