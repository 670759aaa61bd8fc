"""The port's pretrained-weight machinery (``models/pretrained.py``,
``digits_cnn(pretrained=True)``) and estimator wrappers (``ml.py``)
against the JAX package's.

``init_pretrained`` restores the committed textgen fixture into
``text_generation_lstm`` and must give the fixture's expected outputs at
the reference test's pin (atol 1e-5, ``tests/test_zoo_datasets.py``); the
checksum, cache and shape errors are the reference's. The restored
``digits_cnn`` must reach 0.95 on the 400 held-out scans of
``tests/test_pretrained_digits.py``'s split (``tests/fixtures/
digits_heldout_400.npz``, written once from scikit-learn's copy of the UCI
optical digits, which this test also checks it equals) and answer as the
reference's restored network does (atol 1e-5). The estimators wrap
networks whose weights ``interop/jax_params.py`` carries across; after
the same fits their predictions are within 1e-5 of the reference's.
"""
import _torch_threads  # noqa: F401
import importlib
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ml as jml
from deeplearning4j_tpu.datasets.fetchers import load_iris
from deeplearning4j_tpu.models import pretrained as jpre
from deeplearning4j_tpu.models.zoo_extra import \
    text_generation_lstm as jtextgen
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
from deeplearning4j_tpu_torch import ml as tml
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.models import pretrained as tpre
from deeplearning4j_tpu_torch.models.zoo_extra import text_generation_lstm
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Sgd

# the JAX package's ``models`` exports the function ``lenet``, which hides
# the module of that name
jlenet = importlib.import_module("deeplearning4j_tpu.models.lenet")
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TEXTGEN = os.path.join(FIX, "pretrained_textgen_small.zip")
TEXTGEN_CHECKSUM = 530652660


# -------------------------------------------------------------- pretrained
def test_textgen_fixture_restores_to_its_expected_outputs(tmp_path):
    """tests/test_zoo_datasets.py's round trip on the port: fetch into the
    cache, verify, restore, predict; the cached copy is reused; a wrong
    checksum fails after one retry."""
    expected = np.load(os.path.join(FIX,
                                    "pretrained_textgen_small_expected.npz"))
    net = text_generation_lstm(vocab_size=12, hidden=16, max_length=8,
                               seed=99, device="cpu")
    cache = str(tmp_path / "cache")
    assert tpre.init_pretrained(net, TEXTGEN, checksum=TEXTGEN_CHECKSUM,
                                cache_dir=cache) is net
    out = net.output(expected["x"]).numpy()
    np.testing.assert_allclose(out, expected["out"], atol=1e-5)
    cached = os.path.join(cache, "pretrained_textgen_small.zip")
    assert os.path.exists(cached)
    # a cached copy with the right checksum is used without the source
    assert tpre.fetch_cached(str(tmp_path / "nowhere.zip"),
                             checksum=TEXTGEN_CHECKSUM, cache_dir=cache,
                             filename="pretrained_textgen_small.zip") == cached
    with pytest.raises(IOError, match="Checksum"):
        tpre.init_pretrained(net, TEXTGEN, checksum=12345,
                             cache_dir=str(tmp_path / "cache2"))
    with pytest.raises(FileNotFoundError):
        tpre.fetch_cached(str(tmp_path / "nowhere.zip"),
                          cache_dir=str(tmp_path / "cache3"))


def test_corrupt_cache_entry_is_fetched_again(tmp_path):
    cache = tmp_path / "c"
    cache.mkdir()
    (cache / "pretrained_textgen_small.zip").write_bytes(b"corrupt")
    for pkg in (tpre, jpre):
        path = pkg.fetch_cached(TEXTGEN, checksum=TEXTGEN_CHECKSUM,
                                cache_dir=str(cache))
        assert pkg.adler32_of(path) == TEXTGEN_CHECKSUM
        (cache / "pretrained_textgen_small.zip").write_bytes(b"corrupt")


def test_restored_textgen_equals_the_reference(tmp_path):
    """Both packages restore the fixture into a net of another seed and
    answer alike; an uninitialised port net is initialised first."""
    expected = np.load(os.path.join(FIX,
                                    "pretrained_textgen_small_expected.npz"))
    ref = jtextgen(vocab_size=12, hidden=16, max_length=8, seed=99)
    jpre.init_pretrained(ref, TEXTGEN, cache_dir=str(tmp_path / "j"))
    port = text_generation_lstm(vocab_size=12, hidden=16, max_length=8,
                                seed=5, device="cpu")
    assert not port.initialized
    tpre.init_pretrained(port, TEXTGEN, cache_dir=str(tmp_path / "t"))
    np.testing.assert_array_equal(port.params_flat().numpy(),
                                  np.asarray(ref.params_flat()))
    np.testing.assert_allclose(port.output(expected["x"]).numpy(),
                               np.asarray(ref.output(expected["x"])),
                               atol=1e-6)


def test_shape_mismatch_raises(tmp_path):
    net = text_generation_lstm(vocab_size=30, hidden=16, max_length=8,
                               device="cpu")
    with pytest.raises(ValueError, match="params"):
        tpre.init_pretrained(net, TEXTGEN, cache_dir=str(tmp_path))


def test_adler32_equals_the_reference():
    for path in (TEXTGEN, tlenet.DIGITS_CNN_ARTIFACT):
        assert tpre.adler32_of(path) == jpre.adler32_of(path)
    assert tpre.adler32_of(tlenet.DIGITS_CNN_ARTIFACT) == \
        tlenet.DIGITS_CNN_CHECKSUM == jlenet.DIGITS_CNN_CHECKSUM
    with open(tlenet.DIGITS_CNN_ARTIFACT, "rb") as a, \
            open(jlenet.DIGITS_CNN_ARTIFACT, "rb") as b:
        assert a.read() == b.read()              # byte for byte


def _held_out():
    z = np.load(os.path.join(FIX, "digits_heldout_400.npz"))
    return (z["images"] / 16.0).astype(np.float32)[..., None], z["labels"]


def test_heldout_fixture_is_the_reference_tests_split():
    """The fixture holds tests/test_pretrained_digits.py's 400 held-out
    scans and labels (its ``_held_out``), read from scikit-learn."""
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = (digits.images / 16.0).astype(np.float32)[..., None]
    order = np.random.default_rng(0).permutation(len(x))
    got_x, got_y = _held_out()
    np.testing.assert_array_equal(got_x, x[order][:400])
    np.testing.assert_array_equal(got_y, digits.target[order][:400])


def test_digits_cnn_pretrained_generalizes_and_equals_the_reference():
    """No fit: the restored weights classify the held-out scans at 0.95 or
    better, as the reference's do, and answer as the reference's."""
    x, y = _held_out()
    net = tlenet.digits_cnn(pretrained=True, device="cpu")
    out = net.output(x).numpy()
    acc = float(np.mean(out.argmax(1) == y))
    assert acc >= 0.95, acc
    ref = np.asarray(jlenet.digits_cnn(pretrained=True).output(x))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    fresh = tlenet.digits_cnn(seed=123, device="cpu").init()
    assert float(np.mean(fresh.output(x).numpy().argmax(1) == y)) < 0.5


# --------------------------------------------------------------- estimators
def _mlp(pkg_layers, conf_cls, updater, n_out, loss, act):
    return conf_cls(seed=3, updater=updater, weight_init="xavier").list(
        pkg_layers.DenseLayer(n_in=4, n_out=10, activation="tanh"),
        pkg_layers.OutputLayer(n_out=n_out, activation=act, loss=loss)
    ).build()


def _pair(n_out, loss, act):
    jnet = JMLN(_mlp(jl, JConf, JSgd(0.1), n_out, loss, act)).init()
    pnet = MultiLayerNetwork(_mlp(tl, NeuralNetConfiguration, Sgd(0.1),
                                  n_out, loss, act), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v, np.float32)
                            for k, v in p.items()} for p in jnet.params])
    return jnet, pnet


def test_classifier_fits_as_the_reference():
    x, y1h = load_iris(seed=1)
    y = y1h.argmax(1)
    jnet, pnet = _pair(3, "mcxent", "softmax")
    before = pnet.params_flat().clone()
    ref = jml.NeuralNetClassifier(jnet, epochs=6, batch_size=30)
    port = tml.NeuralNetClassifier(pnet, epochs=6, batch_size=30)
    ref.fit(x, y)
    port.fit(x, y)
    assert port.n_classes_ == ref.n_classes_ == 3
    proba = port.predict_proba(x)
    assert isinstance(proba, np.ndarray) and proba.shape == (150, 3)
    np.testing.assert_allclose(proba, np.asarray(ref.predict_proba(x)),
                               atol=1e-5)
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    assert port.score(x, y1h) == ref.score(x, y1h) > 0.6
    # the wrapper trained a clone: the wrapped network did not move
    assert torch.equal(pnet.params_flat(), before)
    assert port.net is not pnet
    # a refit restarts from the wrapped network
    port.fit(x, y)
    np.testing.assert_allclose(port.predict_proba(x), proba, atol=1e-6)
    assert set(port.get_params()) == {"conf_or_net", "epochs", "batch_size",
                                      "device"}
    port.set_params(epochs=2)
    assert port.epochs == 2 and port.net is not None
    port.set_params(conf_or_net=pnet)
    assert port.net is None and port.n_classes_ is None


def test_regressor_fits_as_the_reference():
    r = np.random.default_rng(6)
    x = r.normal(size=(96, 4)).astype(np.float32)
    y = (x @ np.array([0.5, -1.0, 0.25, 2.0]) + 0.1).astype(np.float32)
    jnet, pnet = _pair(1, "mse", "identity")
    ref = jml.NeuralNetRegressor(jnet, epochs=5, batch_size=16).fit(x, y)
    port = tml.NeuralNetRegressor(pnet, epochs=5, batch_size=16).fit(x, y)
    pred = port.predict(x)
    assert pred.shape == (96,)
    np.testing.assert_allclose(pred, np.asarray(ref.predict(x)), atol=1e-5)
    assert port.score(x, y) == pytest.approx(ref.score(x, y), abs=1e-5)


def test_estimator_from_a_configuration():
    """From a configuration the estimator builds its own network on its
    ``device``; before a fit it refuses to predict; without a card and
    without ``device`` it raises rather than run on the CPU."""
    x, y1h = load_iris(seed=2)
    conf = _mlp(tl, NeuralNetConfiguration, Sgd(0.1), 3, "mcxent", "softmax")
    clf = tml.NeuralNetClassifier(conf, epochs=30, batch_size=30,
                                  device="cpu")
    with pytest.raises(ValueError, match="not fitted"):
        clf.predict(x)
    clf.fit(x, y1h)
    assert clf.net.device == torch.device("cpu") and clf.n_classes_ == 3
    assert clf.score(x, y1h) > 0.6


def test_estimator_without_a_device_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y1h = load_iris(seed=2)
    conf = _mlp(tl, NeuralNetConfiguration, Sgd(0.1), 3, "mcxent", "softmax")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tml.NeuralNetClassifier(conf, epochs=1).fit(x, y1h)

