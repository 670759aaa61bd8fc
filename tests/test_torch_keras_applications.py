"""Keras applications in the port's importer against the JAX package's.

The models are the committed fixtures of ``tests/fixtures/keras`` (made
by its ``build.py`` from ``keras.applications`` and Keras's
``lstm_text_generation`` example). Each is written to ``.h5`` in Keras's
legacy layout with seeded weights in its manifest's shapes and imported
through both packages (the port's on the CPU):

- ResNet-50 and VGG-16 at 32x32x3 with 10 classes (Keras's smallest
  input): the port's forward agrees with the JAX graph's within 1e-5;
- ResNet-50 at 224x224x3 with 1000 classes: the structure only (vertex
  names, layer classes, parameter and state shapes);
- the text-generation LSTM: its forward too, within 1e-5.

Only ``h5py`` is needed, not ``keras``."""
import _torch_threads  # noqa: F401
import json
import os

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu.keras_import import importer as jki
from deeplearning4j_tpu_torch.keras_import import importer as tki
from deeplearning4j_tpu_torch.util.serialization import restore_model

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "keras")


def _fixture(name):
    with open(os.path.join(FIX, name + ".json")) as f:
        return json.load(f)


def seeded_weights(fixture, seed):
    """Seeded float32 arrays in the fixture's weight shapes: kernels at He
    scale, biases and betas 0, gammas and variances 1, means 0, so
    activations stay finite through a deep network."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, entries in fixture["weights"].items():
        arrays = []
        for wname, shape in entries:
            leaf = wname.rsplit("/", 1)[-1]
            if leaf in ("gamma", "moving_variance"):
                a = np.ones(shape, np.float32)
            elif leaf in ("beta", "bias", "moving_mean"):
                a = np.zeros(shape, np.float32)
            else:
                fan_in = int(np.prod(shape[:-1]))
                a = (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
                     ).astype(np.float32)
            arrays.append(a)
        out[layer] = arrays
    return out


def write_legacy_h5(path, fixture, weights):
    """``model_config``, ``training_config`` and ``model_weights`` as
    Keras's legacy ``.h5`` writer lays them out."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(fixture["model_config"])
        f.attrs["training_config"] = json.dumps(fixture["training_config"])
        g = f.create_group("model_weights")
        for layer, entries in fixture["weights"].items():
            lg = g.create_group(layer)
            lg.attrs["weight_names"] = [n.encode() for n, _ in entries]
            for (wname, _), arr in zip(entries, weights[layer]):
                lg.create_dataset(wname, data=arr)


def _structure(jnet, net):
    """The same vertex names and layer classes, and every parameter and
    layer-state tensor of the JAX graph in the port's with its shape."""
    assert list(net.vertex_names) == list(jnet.vertex_names)
    jclasses = [type(getattr(v, "layer", None) or v).__name__
                for v in jnet.vertices]
    classes = [type(getattr(net.vertices[n], "layer", None)
                    or net.vertices[n]).__name__ for n in net.vertex_names]
    assert classes == jclasses
    for i, name in enumerate(jnet.vertex_names):
        for mine, theirs in ((net.param_dicts()[name], jnet.params[i]),
                             (net.state_dicts()[name], jnet.state[i])):
            assert {k: tuple(v.shape) for k, v in mine.items()} == \
                {k: tuple(np.shape(v)) for k, v in theirs.items()}, name


@pytest.mark.parametrize("app", ["resnet50_32", "vgg16_32"])
def test_keras_applications_at_32(tmp_path, app):
    fx = _fixture(app)
    path = str(tmp_path / f"{app}.h5")
    write_legacy_h5(path, fx, seeded_weights(fx, 0))
    jnet, net = jki.import_keras_model(path), \
        tki.import_keras_model(path, device="cpu")
    _structure(jnet, net)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    ours = net.output(torch.as_tensor(x)).detach().numpy()
    assert ours.shape == (2, 10) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, np.asarray(jnet.output(x)), atol=1e-5,
                               rtol=0)


def test_resnet50_224_fixture_structure(tmp_path):
    fx = _fixture("resnet50_224")
    path = str(tmp_path / "resnet50_224.h5")
    write_legacy_h5(path, fx, seeded_weights(fx, 1))
    jnet = jki.import_keras_model(path)
    net = restore_model(path, device="cpu")
    _structure(jnet, net)
    assert len(net.vertex_names) == len(jnet.vertex_names) > 170
    assert net.num_params() == 25_583_592   # Keras's trainable count


def test_lstm_text_generation_fixture_forward(tmp_path):
    fx = _fixture("lstm_text_generation")
    weights = seeded_weights(fx, 2)
    path = str(tmp_path / "lstm_text_generation.h5")
    write_legacy_h5(path, fx, weights)
    jnet = jki.import_keras_model(path)
    net = restore_model(path, device="cpu")
    _structure(jnet, net)
    # the build alone, from the configuration and arrays, gives the same
    built = tki._build(fx["model_config"], fx["training_config"]["loss"],
                       weights, device="cpu")
    x = np.random.default_rng(3).random((4, 40, 57)).astype(np.float32)
    ours = net.output(torch.as_tensor(x)).detach().numpy()
    assert ours.shape == (4, 57)
    np.testing.assert_allclose(ours, np.asarray(jnet.output(x)), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(
        built.output(torch.as_tensor(x)).detach().numpy(), ours)
