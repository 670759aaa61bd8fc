"""Transfer learning in the port against the JAX package.

``TransferLearning`` (a ``MultiLayerNetwork``), ``TransferLearningHelper``
and ``TransferLearningGraph`` (SimpleCNN, with BatchNorms in its frozen
trunk) are built in both packages from the same trained weights: the
frozen layers keep the source's weights and state, the new heads have the
new shapes, and with the re-initialized heads' JAX weights carried across
K fit steps give the same parameters and running statistics. A frozen
parameter stays bitwise unchanged; a frozen BatchNorm still moves its
statistics in training mode, as JAX's does. Last, the slice's K7 path as a
whole: a small GoogLeNet (``tests/test_torch_googlenet.py``'s 32x32, B 2
per batch) through the same ``TransferLearningGraph`` and a two-epoch
``EarlyStoppingTrainer`` in both packages (JAX's K7 interpreted, the
port's its plain version): ``score_vs_epoch`` at rel 1e-5 and the trained
head at rel-to-max 1e-4, float32. Dropout is off in every compared fit
(``FineTuneConfiguration(dropout=0.0)``): the port's masks draw from its
own generator. The compared fits use ``Sgd``: Adam moves an entry whose
gradient is near its epsilon by lr·g/(|g| + eps), which turns float32
noise in such a gradient into head differences of 3e-3 of the largest
entry after 8 steps."""
import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import transfer as jtr
from deeplearning4j_tpu.nn.inputs import InputType as JIT
from deeplearning4j_tpu.optimize import updaters as ju
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_params,
                                                         load_jax_state)
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.models import zoo_extra as tzoo_extra
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn import transfer as ttr
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tu

jzoo = importlib.import_module("deeplearning4j_tpu.models.zoo")
jzoo_extra = importlib.import_module("deeplearning4j_tpu.models.zoo_extra")


def _np(tree, dtype=np.float32):
    return [{k: np.asarray(v, dtype) for k, v in p.items()} for p in tree]


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _load(pnet, jnet, dtype=np.float32):
    load_jax_params(pnet, _np(jnet.params, dtype))
    load_jax_state(pnet, _np(jnet.state))


def _assert_same(pnet, jnet, atol, names=None):
    names = names or list(pnet.param_dicts())
    for key, jp, js in zip(names, jnet.params, jnet.state):
        for k, v in pnet.param_dicts()[key].items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]),
                                       atol=atol, rtol=0, err_msg=f"{key}.{k}")
        for k, v in pnet.state_dicts()[key].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js[k]),
                                       atol=max(atol, 1e-7), rtol=1e-6,
                                       err_msg=f"state {key}.{k}")


# ------------------------------------------------ MultiLayerNetwork
def _mln(pkg):
    L = jl if pkg == "jax" else tl
    conf = (JConf if pkg == "jax" else TConf)(
        seed=4, updater=(ju if pkg == "jax" else tu).Sgd(0.1),
        weight_init="relu", dtype="float64").list(
        L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                           convolution_mode="same", activation="relu"),
        L.BatchNormalization(),
        L.DenseLayer(n_out=10, activation="tanh"),
        L.DenseLayer(n_out=6, activation="tanh"),
        L.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
    conf = conf.set_input_type((JIT if pkg == "jax" else TIT)
                               .convolutional(6, 6, 2)).build()
    return JMLN(conf).init() if pkg == "jax" else \
        MultiLayerNetwork(conf, device="cpu").init()


def _mln_data(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 6, 6, 2)),
            np.eye(3)[r.integers(0, 3, n)])


def _edit(tr_mod, upd_mod, net):
    return (tr_mod.TransferLearning(net)
            .fine_tune_configuration(tr_mod.FineTuneConfiguration(
                updater=upd_mod.Sgd(0.05), seed=11))
            .set_feature_extractor(1)
            .n_out_replace(2, 7)
            .remove_output_layer()
            .add_layer((jl if tr_mod is jtr else tl).OutputLayer(
                n_out=3, activation="softmax", loss="mcxent"))
            .build())


def test_transfer_learning_matches_jax():
    jsrc, psrc = _mln("jax"), _mln("torch")
    x, y = _mln_data(16, 1)
    jsrc.fit(x, np.eye(5)[np.argmax(y, 1)], batch_size=8)
    _load(psrc, jsrc, np.float64)
    jnew, pnew = _edit(jtr, ju, jsrc), _edit(ttr, tu, psrc)
    assert [bool(layer.frozen) for layer in pnew.layers] == \
        [bool(layer.frozen) for layer in jnew.layers] == \
        [True, True, False, False, False]
    assert pnew.conf.seed == jnew.conf.seed == 11
    for i, (jp, js) in enumerate(zip(jnew.params, jnew.state)):
        assert {k: tuple(v.shape) for k, v in pnew.param_dicts()[i].items()} \
            == {k: tuple(v.shape) for k, v in jp.items()}, i
    # the survivors are the source's, copied (not shared)
    for i in (0, 1):
        for k, v in pnew.param_dicts()[i].items():
            torch.testing.assert_close(v, psrc.param_dicts()[i][k], rtol=0,
                                       atol=0)
            assert v.data_ptr() != psrc.param_dicts()[i][k].data_ptr()
        for k, v in pnew.state_dicts()[i].items():
            torch.testing.assert_close(v, psrc.state_dicts()[i][k], rtol=0,
                                       atol=0)
    _load(pnew, jnew, np.float64)         # the re-initialized heads' weights
    frozen = {k: v.detach().clone() for k, v in
              pnew.param_dicts()[0].items()}
    stats = pnew.state_dicts()[1]["mean"].clone()
    x, y = _mln_data(24, 2)
    jnew.fit(x, y, batch_size=8)
    pnew.fit(x, y, batch_size=8)
    _assert_same(pnew, jnew, atol=1e-9)
    for k, v in pnew.param_dicts()[0].items():
        torch.testing.assert_close(v, frozen[k], rtol=0, atol=0)
    # a frozen BatchNorm still moves its statistics in training mode
    assert not torch.equal(pnew.state_dicts()[1]["mean"], stats)


def test_transfer_learning_helper_matches_jax():
    jsrc, psrc = _mln("jax"), _mln("torch")
    _load(psrc, jsrc, np.float64)
    jnew = jtr.TransferLearning(jsrc).set_feature_extractor(2).build()
    pnew = ttr.TransferLearning(psrc).set_feature_extractor(2).build()
    jh, ph = jtr.TransferLearningHelper(jnew), ttr.TransferLearningHelper(pnew)
    assert ph.frozen_until == jh.frozen_until == 2
    x, _ = _mln_data(5, 3)
    np.testing.assert_allclose(ph.featurize(x).numpy(),
                               np.asarray(jh.featurize(x)), atol=1e-12)
    tail = ph.unfrozen_network()
    assert len(tail.layers) == 2
    assert tail.layers[0].n_out == 6
    feats = ph.featurize(x)
    np.testing.assert_allclose(tail.output(feats).numpy(),
                               pnew.output(x).numpy(), atol=1e-12)
    tail.fit(feats.numpy(), np.eye(5)[[0, 1, 2, 3, 4]], batch_size=5)
    assert not torch.equal(tail.param_dicts()[0]["W"],
                           pnew.param_dicts()[3]["W"])


# ------------------------------------------------ ComputationGraph
def _graph_edit(tr_mod, upd_mod, net):
    return (tr_mod.TransferLearningGraph(net)
            .set_feature_extractor("p1")
            .n_out_replace("out", 3, weight_init="xavier")
            .fine_tune_configuration(tr_mod.FineTuneConfiguration(
                updater=upd_mod.Sgd(0.05), dropout=0.0))
            .build())


def test_transfer_learning_graph_matches_jax():
    kw = dict(n_classes=5, height=16, width=16)
    jsrc = jzoo.simple_cnn(**kw).init()
    psrc = tzoo.simple_cnn(**kw, device="cpu").init()
    _load(psrc, jsrc)
    jnew, pnew = _graph_edit(jtr, ju, jsrc), _graph_edit(ttr, tu, psrc)
    frozen = sorted(n for n in pnew.vertex_names
                    if getattr(getattr(pnew.vertices[n], "layer", None),
                               "frozen", False))
    assert frozen == ["bn0", "bn1", "c0", "c1", "p0", "p1"]
    assert tuple(pnew.vertices["out"].layer.W.shape) == (256, 3)
    _load(pnew, jnew)
    before = {n: {k: v.detach().clone() for k, v in
                  pnew.param_dicts()[n].items()} for n in frozen}
    stats = pnew.state_dicts()["bn0"]["var"].clone()
    r = np.random.default_rng(5)
    x = r.standard_normal((24, 16, 16, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 24)]
    jnew.fit(x, y, batch_size=8)
    pnew.fit(x, y, batch_size=8)
    _assert_same(pnew, jnew, atol=1e-5, names=pnew.vertex_names)
    for n in frozen:
        for k, v in pnew.param_dicts()[n].items():
            torch.testing.assert_close(v, before[n][k], rtol=0, atol=0)
    assert not torch.equal(pnew.state_dicts()["bn0"]["var"], stats)
    assert pnew.evaluate(x, y).confusion.sum() == 24


def test_n_out_replace_refuses_a_consumer_without_n_in():
    net = tzoo.simple_cnn(n_classes=5, height=16, width=16,
                          device="cpu").init()
    with pytest.raises(ValueError, match="bn0"):
        ttr.TransferLearningGraph(net).n_out_replace("c0", 8).build()
    with pytest.raises(ValueError, match="Unknown vertex"):
        ttr.TransferLearningGraph(net).set_feature_extractor("nope").build()


# ------------------------------------------------ the slice's K7 path
def _es(es_mod, tr_mod, upd_mod, net, train, val):
    new = (tr_mod.TransferLearningGraph(net)
           .set_feature_extractor("avg3")
           .n_out_replace("output", 5, weight_init="xavier")
           .fine_tune_configuration(tr_mod.FineTuneConfiguration(
               updater=upd_mod.Sgd(0.05), dropout=0.0))
           .build())
    cfg = es_mod.EarlyStoppingConfiguration(
        score_calculator=es_mod.DataSetLossCalculator(val),
        model_saver=es_mod.InMemoryModelSaver(),
        epoch_termination_conditions=[
            es_mod.MaxEpochsTerminationCondition(2),
            es_mod.ScoreImprovementEpochTerminationCondition(1)])
    return new, cfg


def test_googlenet_transfer_under_early_stopping_matches_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_KERNEL_CONV1X1_BIAS_RELU_INTERPRET", "1")
    kw = dict(n_classes=10, height=32, width=32)
    jsrc = jzoo_extra.googlenet(**kw).init()
    psrc = tzoo_extra.googlenet(**kw, device="cpu").init()
    _load(psrc, jsrc)
    r = np.random.default_rng(7)
    x = r.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[r.integers(0, 5, 8)]
    jnew, jcfg = _es(jes, jtr, ju, jsrc, None, JIter(features=x, labels=y,
                                                     batch_size=4))
    pnew, pcfg = _es(tes, ttr, tu, psrc, None, ListDataSetIterator(
        features=x, labels=y, batch_size=4))
    _load(pnew, jnew)
    trunk = {n: {k: v.detach().clone() for k, v in
                 pnew.param_dicts()[n].items()}
             for n in pnew.vertex_names if n not in ("fc1", "output")}
    jres = jes.EarlyStoppingTrainer(jcfg, jnew, JIter(
        features=x, labels=y, batch_size=2)).fit()
    pres = tes.EarlyStoppingTrainer(pcfg, pnew, ListDataSetIterator(
        features=x, labels=y, batch_size=2)).fit()
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch) == [0, 1]
    for e, s in jres.score_vs_epoch.items():
        assert pres.score_vs_epoch[e] == pytest.approx(s, rel=1e-5)
    assert (pres.best_model_epoch, pres.termination_reason,
            pres.termination_details, pres.total_epochs) == \
        (jres.best_model_epoch, jres.termination_reason,
         jres.termination_details, jres.total_epochs)
    names = list(jnew.vertex_names)
    for n in ("fc1", "output"):
        jp = jnew.params[names.index(n)]
        for k, v in pnew.param_dicts()[n].items():
            assert _rel_to_max(v.detach().numpy(), np.asarray(jp[k])) <= 1e-4
    for n, params in trunk.items():
        for k, v in pnew.param_dicts()[n].items():
            torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    best = pres.best_model
    assert best is not pnew
    assert best.evaluate(x, y).confusion.sum() == 8
