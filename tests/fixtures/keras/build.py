"""Write the Keras model fixtures of this directory: each model's
``model_config`` and ``training_config`` as its legacy ``.h5`` file holds
them, and each layer's weight names and shapes in the order of the
layer's ``weight_names`` attribute. No weight values are kept.

- ``resnet50_224.json``: ``keras.applications.ResNet50(weights=None)``
  (224x224x3, 1000 classes), compiled with ``categorical_crossentropy``
  and SGD.
- ``resnet50_32.json`` and ``vgg16_32.json``: ``ResNet50`` and ``VGG16``
  with ``weights=None, classes=10, input_shape=(32, 32, 3)`` (Keras's
  smallest input), compiled as ResNet-50 at 224 is.
- ``lstm_text_generation.json``: the functional form of Keras's
  ``lstm_text_generation`` example, ``Input(shape=(40, 57))`` ->
  ``LSTM(128)`` -> ``Dense(57, activation='softmax')``, compiled with
  ``categorical_crossentropy`` and ``RMSprop(learning_rate=0.01)``.

Run from the repository root with keras and h5py installed:
    python tests/fixtures/keras/build.py
The committed files were made so with keras 3.13.1 (TensorFlow backend)
and h5py 3.14.0; each file records both versions.
"""
import json
import os
import sys
import tempfile

import h5py
import keras

HERE = os.path.dirname(os.path.abspath(__file__))


def _attr(f, name):
    raw = f.attrs.get(name)
    return None if raw is None else json.loads(
        raw if isinstance(raw, str) else raw.decode())


def describe(model) -> dict:
    """The model as its ``.h5`` file describes it, without weight values."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.h5")
        model.save(path)
        with h5py.File(path, "r") as f:
            g = f["model_weights"]
            weights = {}
            for name in g:
                names = [n.decode() if isinstance(n, bytes) else n
                         for n in g[name].attrs.get("weight_names", [])]
                if names:
                    weights[name] = [[n, list(g[name][n].shape)]
                                     for n in names]
            return {"keras_version": keras.__version__,
                    "h5py_version": h5py.__version__,
                    "model_config": _attr(f, "model_config"),
                    "training_config": _attr(f, "training_config"),
                    "weights": weights}


def resnet50_224():
    model = keras.applications.ResNet50(weights=None)
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    return model


def resnet50_32():
    model = keras.applications.ResNet50(weights=None, classes=10,
                                        input_shape=(32, 32, 3))
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    return model


def vgg16_32():
    model = keras.applications.VGG16(weights=None, classes=10,
                                     input_shape=(32, 32, 3))
    model.compile(loss="categorical_crossentropy", optimizer="sgd")
    return model


def lstm_text_generation():
    inp = keras.Input(shape=(40, 57))
    h = keras.layers.LSTM(128)(inp)
    out = keras.layers.Dense(57, activation="softmax")(h)
    model = keras.Model(inp, out)
    model.compile(loss="categorical_crossentropy",
                  optimizer=keras.optimizers.RMSprop(learning_rate=0.01))
    return model


if __name__ == "__main__":
    keras.utils.set_random_seed(0)
    for name, make in (("resnet50_224", resnet50_224),
                       ("resnet50_32", resnet50_32), ("vgg16_32", vgg16_32),
                       ("lstm_text_generation", lstm_text_generation)):
        path = os.path.join(HERE, name + ".json")
        with open(path, "w") as fh:
            json.dump(describe(make()), fh, separators=(",", ":"))
        print(path, os.path.getsize(path), file=sys.stderr)
