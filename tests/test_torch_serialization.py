"""Model zips across the two packages: the port's ``util/serialization.py``,
``util/checkpointing.py`` (read side) and ``serving.registry.load_net``
against the JAX package's.

- The three v1 regression fixtures restore in the port on the CPU and
  predict their ``_expected.npz`` at atol 1e-5 (the JAX test's pin), and
  the restored ``mln_cnn`` with its Adam state takes one ``fit`` step equal
  to the JAX package's restored step (loss rel 1e-5, parameters 1e-5).
- For ``transformer_lm`` (2 blocks, d 32), ``text_generation_lstm``
  (hidden 16), ``googlenet`` at 32x32 and 10 classes, the ``cg_merge``
  graph and ``resnet50`` at 32x32 and 10 classes: JAX ``write_model`` ->
  port ``restore_model`` and port ``write_model`` -> JAX
  ``restore_model`` give equal outputs at 1e-5, and the two packages
  write equal ``coefficients.bin``, ``updaterState.bin`` and
  ``state.bin`` bytes (the JAX updater state and ResNet-50's running
  statistics are filled with seeded random numbers first, so the order
  of every leaf shows).
- A frozen layer, ``Sgd`` (no updater state) and a per-layer updater each
  give the JAX package's bytes and counts.
- ``latest_checkpoint`` skips a truncated newest zip, as in the JAX
  ``test_checkpointing.py``; ``load_net`` takes a zip or a directory;
  a Java DL4J zip restores with the reference's parameters, and a bogus
  HDF5 file or junk raises "Cannot determine" as the reference's does."""
import _torch_threads  # noqa: F401
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.models import zoo_extra as jzoo
from deeplearning4j_tpu.models import zoo as jzoo_cnn
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as ju
from deeplearning4j_tpu.util import serialization as jser
from deeplearning4j_tpu.util.checkpointing import CheckpointListener
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models import zoo_extra as tzoo
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tu
from deeplearning4j_tpu_torch.serving.registry import load_net
from deeplearning4j_tpu_torch.util import serialization as tser
from deeplearning4j_tpu_torch.util.checkpointing import (
    CheckpointListener as TCheckpointListener, fit_with_checkpointing,
    is_valid_checkpoint, latest_checkpoint, list_checkpoints,
    read_checkpoint_manifest)
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
V1 = ["regression_v1_mln_cnn", "regression_v1_mln_lstm",
      "regression_v1_cg_merge"]


def _np(out):
    if isinstance(out, (list, tuple)):
        out = out[0]
    return out.detach().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)


def _entries(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _params(net):
    """Every parameter of a port net by (group, name), as numpy."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        flat_param_order
    return {(g, n): p.detach().float().numpy()
            for g, n, p in flat_param_order(net)}


# ------------------------------------------------------------ v1 fixtures
@pytest.mark.parametrize("name", V1)
def test_v1_fixture_restores_and_predicts_identically(name):
    net = tser.restore_model(os.path.join(FIXTURES, f"{name}.zip"),
                             device="cpu")
    exp = np.load(os.path.join(FIXTURES, f"{name}_expected.npz"))
    np.testing.assert_allclose(_np(net.output(exp["x"])), exp["out"],
                               atol=1e-5)
    assert net.iteration_count == 2
    assert net.device == torch.device("cpu")


def test_v1_fixture_fit_step_equals_the_jax_restored_step():
    path = os.path.join(FIXTURES, "regression_v1_mln_cnn.zip")
    exp = np.load(os.path.join(FIXTURES,
                               "regression_v1_mln_cnn_expected.npz"))
    x = exp["x"]
    y = np.eye(3, dtype=np.float32)[np.arange(len(x)) % 3]
    jnet = jser.restore_model(path, load_updater=True)
    pnet = tser.restore_model(path, load_updater=True, device="cpu")
    assert pnet.conf.updater == tu.Adam(learning_rate=0.001)
    jnet.fit(x, y, epochs=1, batch_size=len(x))
    pnet.fit(x, y, epochs=1, batch_size=len(x))
    assert pnet.iteration_count == jnet.iteration_count == 3
    assert pnet.score(x, y) == pytest.approx(float(jnet.score(x, y)),
                                             rel=1e-5)
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=1e-5)


# --------------------------------------------------- zips across packages
def _cg_merge():
    return jser.restore_model(os.path.join(FIXTURES,
                                           "regression_v1_cg_merge.zip"))


MODELS = {
    "transformer_lm": (
        lambda: jzoo.transformer_lm(vocab_size=40, d_model=32, n_heads=2,
                                    n_blocks=2, max_length=32).init(),
        (2, 12, 40)),
    "text_generation_lstm": (
        lambda: jzoo.text_generation_lstm(23, hidden=16).init(),
        (2, 9, 23)),
    "googlenet": (
        lambda: jzoo.googlenet(n_classes=10, height=32, width=32).init(),
        (2, 32, 32, 3)),
    "cg_merge": (_cg_merge, (3, 5)),
    # running statistics in state.bin
    "resnet50": (
        lambda: jzoo_cnn.resnet50(n_classes=10, height=32, width=32).init(),
        (2, 32, 32, 3)),
}


def _fill_updater_state(jnet, seed):
    rng = np.random.default_rng(seed)
    jnet.opt_state = jax.tree.map(
        lambda a: jax.numpy.asarray(rng.standard_normal(a.shape), a.dtype),
        jnet.opt_state)
    # a running state away from its initial zeros and ones
    jnet.state = jax.tree.map(
        lambda a: jax.numpy.asarray(rng.uniform(0.5, 2.0, a.shape), a.dtype),
        jnet.state)
    jnet.iteration_count = 5


@pytest.fixture
def conv_interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_KERNEL_CONV1X1_BIAS_RELU_INTERPRET", "1")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_zips_cross_both_ways_with_equal_bytes(model, tmp_path,
                                               conv_interpret):
    make, shape = MODELS[model]
    jnet = make()
    _fill_updater_state(jnet, 3)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = _np(jnet.output(x))
    jzip, tzip = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jser.write_model(jnet, jzip)
    pnet = tser.restore_model(jzip, device="cpu")
    assert type(pnet).__name__ == type(jnet).__name__
    assert pnet.iteration_count == 5
    np.testing.assert_allclose(_np(pnet.output(x)), want, atol=1e-5)
    tser.write_model(pnet, tzip)
    je, te = _entries(jzip), _entries(tzip)
    assert set(je) == set(te)
    for entry in ("coefficients.bin", "updaterState.bin", "state.bin"):
        assert te[entry] == je[entry], entry
    n_state = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jnet.state))
    assert len(te["state.bin"]) == 4 * n_state
    assert (n_state > 0) == (model == "resnet50")
    assert json.loads(te["manifest.json"]) == json.loads(je["manifest.json"])
    assert json.loads(te["configuration.json"]) == \
        json.loads(je["configuration.json"])
    back = jser.restore_model(tzip)
    np.testing.assert_allclose(_np(back.output(x)), want, atol=1e-5)
    for a, b in zip(jax.tree.leaves(back.opt_state),
                    jax.tree.leaves(jnet.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _mlp(pkg, layer_updater=None, frozen=False, global_updater="adam"):
    L, Conf, U = (jl, JConf, ju) if pkg == "jax" else (tl, TConf, tu)
    upd = {"adam": U.Adam(learning_rate=0.01),
           "sgd": U.Sgd(learning_rate=0.1)}[global_updater]
    own = None if layer_updater is None else \
        {"sgd": U.Sgd(learning_rate=0.5),
         "nesterovs": U.Nesterovs(learning_rate=0.2, momentum=0.8)}[
            layer_updater]
    conf = (Conf(seed=11, updater=upd).list(
        L.DenseLayer(n_in=4, n_out=6, activation="tanh", frozen=frozen,
                     updater=own),
        L.DenseLayer(n_out=5, activation="relu"),
        L.OutputLayer(n_out=3, activation="softmax")).build())
    if pkg == "jax":
        return JMLN(conf).init()
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("case", ["frozen", "sgd", "per_layer_sgd",
                                  "per_layer_nesterovs"])
def test_updater_variants_write_the_jax_bytes(case, tmp_path):
    kw = {"frozen": dict(frozen=True), "sgd": dict(global_updater="sgd"),
          "per_layer_sgd": dict(layer_updater="sgd"),
          "per_layer_nesterovs": dict(layer_updater="nesterovs")}[case]
    jnet, pnet = _mlp("jax", **kw), _mlp("torch", **kw)
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    x = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    jnet.fit(x, y, epochs=1, batch_size=8)
    pnet.fit(x, y, epochs=1, batch_size=8)
    jzip, tzip = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jser.write_model(jnet, jzip)
    tser.write_model(pnet, tzip)
    je, te = _entries(jzip), _entries(tzip)
    jm, tm = json.loads(je["manifest.json"]), json.loads(te["manifest.json"])
    assert tm == jm
    assert len(te["updaterState.bin"]) == len(je["updaterState.bin"]) \
        == 4 * jm["n_updater_state"]
    np.testing.assert_allclose(
        np.frombuffer(te["coefficients.bin"], np.float32),
        np.frombuffer(je["coefficients.bin"], np.float32), atol=1e-6)
    np.testing.assert_allclose(
        np.frombuffer(te["updaterState.bin"], np.float32),
        np.frombuffer(je["updaterState.bin"], np.float32), atol=1e-6)
    if case == "sgd":
        assert jm["n_updater_state"] == 0
    restored = tser.restore_model(jzip, device="cpu")
    np.testing.assert_array_equal(
        restored.params_flat().numpy(), np.asarray(jnet.params_flat()))
    assert restored.layers[0].frozen is kw.get("frozen", False)


def test_a_bf16_network_writes_float32_and_restores_to_bf16(tmp_path):
    net = tzoo.text_generation_lstm(11, hidden=8, dtype="bfloat16",
                                    device="cpu").init()
    path = str(tmp_path / "bf16.zip")
    tser.write_model(net, path)
    e = _entries(path)
    assert len(e["coefficients.bin"]) == 4 * net.num_params()
    back = tser.restore_model(path, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in back.parameters())
    for (k, a), b in zip(_params(net).items(), _params(back).values()):
        np.testing.assert_array_equal(a, b)


def test_load_updater_false_gives_a_fresh_state(tmp_path):
    net = tser.restore_model(os.path.join(FIXTURES,
                                          "regression_v1_cg_merge.zip"),
                             load_updater=False, device="cpu")
    assert all(float(t.abs().sum()) == 0.0
               for g in net.opt_state.values() for s in g.values()
               for t in s.values())


def test_a_restored_net_shares_the_warmed_buckets_of_a_built_one():
    """The zip's JSON holds lists where a built configuration holds tuples
    (kernel sizes, strides); a hot swap from the zip must still see the
    same architecture and share the warmed buckets."""
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    path = os.path.join(FIXTURES, "regression_v1_mln_cnn.zip")
    conf = (TConf(seed=7, activation="sigmoid",
                  updater=tu.Adam(learning_rate=0.001)).list(
        tl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                            convolution_mode="same", activation="relu"),
        tl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
        tl.DenseLayer(n_out=16, activation="tanh"),
        tl.OutputLayer(n_out=3, activation="softmax"))
        .set_input_type(InputType.convolutional(8, 8, 2)).build())
    restored = tser.restore_model(path, device="cpu")
    assert json.loads(conf.to_json())["config"]["layers"] == \
        json.loads(restored.conf.to_json())["config"]["layers"]
    eng = InferenceEngine(MultiLayerNetwork(conf, device="cpu").init(),
                          feature_shape=(8, 8, 2), buckets=(4,))
    try:
        warm = eng.trace_count
        assert eng.hot_swap("default", path) == 2
        assert eng.trace_count == warm
        exp = np.load(os.path.join(FIXTURES,
                                   "regression_v1_mln_cnn_expected.npz"))
        np.testing.assert_allclose(eng.predict(exp["x"]), exp["out"],
                                   atol=1e-5)
    finally:
        eng.stop()


# -------------------------------------------------------------- sniffing
def test_restore_model_reads_a_bare_configuration_json(tmp_path):
    conf = tzoo.googlenet(n_classes=4, height=32, width=32,
                          device="cpu").conf
    path = tmp_path / "conf.json"
    path.write_text(conf.to_json())
    net = tser.restore_model(str(path), device="cpu")
    assert type(net).__name__ == "ComputationGraph"
    mlp = _mlp("torch")
    path.write_text(mlp.conf.to_json())
    assert type(tser.restore_model(str(path), device="cpu")).__name__ == \
        "MultiLayerNetwork"


def test_what_the_port_cannot_read_yet_names_its_item(tmp_path):
    # a Java DL4J zip restores through interop/dl4j_zip.py, as the
    # reference's does (tests/test_torch_dl4j_zip.py holds the rest)
    java = os.path.join(FIXTURES, "dl4j", "080_mlp_3_4_5.zip")
    net, ref = (tser.restore_model(java, device="cpu"),
                jser.restore_model(java))
    assert type(net).__name__ == "MultiLayerNetwork"
    for i, p in enumerate(ref.params):
        for k, v in p.items():
            np.testing.assert_array_equal(
                net.param_dicts()[i][k].detach().numpy(), np.asarray(v))
    # an HDF5 header that Keras cannot read fails as the reference's does
    h5 = tmp_path / "model.h5"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="Cannot determine"):
        jser.restore_model(str(h5))
    with pytest.raises(ValueError, match="Cannot determine"):
        tser.restore_model(str(h5), device="cpu")
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00\x01garbage")
    with pytest.raises(ValueError, match="Cannot determine"):
        tser.restore_model(str(junk), device="cpu")
    src = os.path.join(FIXTURES, "regression_v1_mln_lstm.zip")
    # layer state restores since ROADMAP A5 (the zips test above); a
    # state.bin the network has no room for fails as the reference's
    # restore does, naming the entry
    stateful = str(tmp_path / "state.zip")
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(stateful, "w") as zout:
        for n in zin.namelist():
            zout.writestr(n, zin.read(n) if n != "state.bin"
                          else np.ones(4, np.float32).tobytes())
    with pytest.raises(ValueError, match="state.bin"):
        tser.restore_model(stateful, device="cpu")
    # the write side is ported (ROADMAP A8, part 1): the listener makes
    # its directory, and a resumable fit with nothing to resume from trains
    # and writes a checkpoint (tests/test_torch_checkpointing.py)
    lis = TCheckpointListener(str(tmp_path / "ck"))
    assert os.path.isdir(lis.directory) and lis.keep_last == 3
    net = _mlp("torch")
    x = np.random.default_rng(9).standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ListDataSetIterator as TIt)
    _, ran = fit_with_checkpointing(
        net, TIt(features=x, labels=y, batch_size=8), epochs=1,
        checkpoint_dir=str(tmp_path / "ck"))
    assert ran == 1 and net.iteration_count == 2
    assert os.path.exists(str(tmp_path / "ck" / "checkpoint_epoch1.zip"))


# ------------------------------------------------------------ checkpoints
def _jax_checkpoints(directory, epochs=3):
    net = _mlp("jax")
    x = np.random.default_rng(9).standard_normal((16, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    net.set_listeners(CheckpointListener(directory, keep_last=5))
    net.fit(x, y, epochs=epochs, batch_size=8)
    return net


def test_latest_checkpoint_skips_truncated_newest(tmp_path):
    d = str(tmp_path)
    _jax_checkpoints(d)
    assert [os.path.basename(p) for p, _ in list_checkpoints(d)] == \
        [f"checkpoint_epoch{e}.zip" for e in (1, 2, 3)]
    newest = os.path.join(d, "checkpoint_epoch3.zip")
    with open(newest, "r+b") as f:
        f.truncate(40)
    assert not is_valid_checkpoint(newest)
    assert latest_checkpoint(d).endswith("epoch2.zip")
    assert latest_checkpoint(d, validate=False).endswith("epoch3.zip")
    assert read_checkpoint_manifest(newest) == {}
    assert read_checkpoint_manifest(latest_checkpoint(d))["epochs_done"] == 2


def test_load_net_takes_a_zip_or_a_checkpoint_directory(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(d)
    _jax_checkpoints(d)
    with open(os.path.join(d, "checkpoint_epoch3.zip"), "r+b") as f:
        f.truncate(40)
    net = load_net(d, device="cpu")
    want = jser.restore_model(os.path.join(d, "checkpoint_epoch2.zip"))
    np.testing.assert_allclose(net.params_flat().numpy(),
                               np.asarray(want.params_flat()), atol=0)
    zipped = load_net(os.path.join(d, "checkpoint_epoch1.zip"),
                      device="cpu")
    assert zipped.iteration_count == 2
    with pytest.raises(FileNotFoundError):
        load_net(str(tmp_path / "empty_dir_does_not_exist"), device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_net(str(tmp_path / "empty"), device="cpu")
