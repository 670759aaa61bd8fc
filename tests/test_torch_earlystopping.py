"""Early stopping in the port against the JAX package.

On the same data and weights (a small MLP, and a conv network with a
BatchNorm for the savers), ``EarlyStoppingTrainer`` gives JAX's
``score_vs_epoch`` (rel 1e-5), best epoch, termination reason and details
and epoch count: under patience, where a large learning rate makes the
score rise, and under the invalid-score iteration condition, where it
turns NaN. ``LocalFileModelSaver`` writes the port's model zip, running
statistics in ``state.bin`` included, and restores the best model; the
reference's own patience case (``tests/test_checkpoint_eval.py:105``)
runs, and ``EarlyStoppingParallelTrainer`` on 2 logical workers follows
the JAX trainer on 2 devices."""
import _torch_threads  # noqa: F401
import math
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.earlystopping.parallel_trainer import \
    EarlyStoppingParallelTrainer as JESPT
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.inputs import InputType as JIT
from deeplearning4j_tpu.optimize import updaters as ju
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_params,
                                                         load_jax_state)
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tu
from deeplearning4j_tpu_torch.parallel import make_mesh


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _mlp(pkg, lr):
    L = jl if pkg == "jax" else tl
    U = ju if pkg == "jax" else tu
    conf = (JConf if pkg == "jax" else TConf)(
        seed=2, updater=U.Sgd(lr)).list(
        L.DenseLayer(n_in=6, n_out=16, activation="tanh"),
        L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")).build()
    return JMLN(conf).init() if pkg == "jax" else \
        MultiLayerNetwork(conf, device="cpu").init()


def _pair(lr):
    jnet, pnet = _mlp("jax", lr), _mlp("torch", lr)
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _data(n=128, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 0).astype(int)]
    return x, y


def _config(es, it_cls, x, y, epochs, patience, iteration=(), saver=None):
    return es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            it_cls(features=x, labels=y, batch_size=64)),
        model_saver=saver or es.InMemoryModelSaver(),
        epoch_termination_conditions=[
            es.MaxEpochsTerminationCondition(epochs),
            es.ScoreImprovementEpochTerminationCondition(patience)],
        iteration_termination_conditions=list(iteration))


def _same_result(t, j):
    assert sorted(t.score_vs_epoch) == sorted(j.score_vs_epoch)
    for e, s in j.score_vs_epoch.items():
        if math.isnan(s):
            assert math.isnan(t.score_vs_epoch[e])
        else:
            assert t.score_vs_epoch[e] == pytest.approx(s, rel=1e-5), e
    assert (t.best_model_epoch, t.termination_reason,
            t.termination_details, t.total_epochs) == \
        (j.best_model_epoch, j.termination_reason, j.termination_details,
         j.total_epochs)


@pytest.mark.parametrize("lr, epochs, patience", [
    (0.5, 8, 2),          # falls, then stops at the epoch limit
    (5.0, 20, 0),         # overshoots: the score rises, patience stops it
], ids=["max_epochs", "patience"])
def test_trainer_matches_jax(lr, epochs, patience):
    jnet, pnet = _pair(lr)
    x, y = _data()
    jres = jes.EarlyStoppingTrainer(
        _config(jes, JIter, x, y, epochs, patience), jnet,
        JIter(features=x, labels=y, batch_size=32)).fit()
    tres = tes.EarlyStoppingTrainer(
        _config(tes, ListDataSetIterator, x, y, epochs, patience), pnet,
        ListDataSetIterator(features=x, labels=y, batch_size=32)).fit()
    _same_result(tres, jres)
    np.testing.assert_allclose(tres.best_model.output(x).numpy(),
                               np.asarray(jres.best_model.output(x)),
                               atol=1e-4)
    if patience == 0:
        assert tres.termination_details == \
            "ScoreImprovementEpochTerminationCondition"
        assert tres.total_epochs < epochs


def test_invalid_score_stops_as_in_jax():
    jnet, pnet = _pair(0.1)
    x, y = _data()
    bad = x.copy()
    bad[40] = np.nan          # the second batch's loss is NaN
    jres = jes.EarlyStoppingTrainer(
        _config(jes, JIter, x, y, 5, 2,
                [jes.InvalidScoreIterationTerminationCondition()]), jnet,
        JIter(features=bad, labels=y, batch_size=32)).fit()
    tres = tes.EarlyStoppingTrainer(
        _config(tes, ListDataSetIterator, x, y, 5, 2,
                [tes.InvalidScoreIterationTerminationCondition()]), pnet,
        ListDataSetIterator(features=bad, labels=y, batch_size=32)).fit()
    _same_result(tres, jres)
    assert tres.termination_reason == "IterationTerminationCondition"
    assert tres.termination_details == \
        "InvalidScoreIterationTerminationCondition"
    assert pnet.listeners == []           # the guard is taken off again


def test_the_reference_patience_case_runs():
    x, y = _data(128, seed=3)
    net = MultiLayerNetwork(TConf(seed=2, updater=tu.Adam(1e-2)).list(
        tl.DenseLayer(n_in=6, n_out=8, activation="tanh"),
        tl.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .build(), device="cpu").init()
    cfg = tes.EarlyStoppingConfiguration(
        score_calculator=tes.DataSetLossCalculator(
            ListDataSetIterator(features=x, labels=y, batch_size=64)),
        model_saver=tes.InMemoryModelSaver(),
        epoch_termination_conditions=[
            tes.MaxEpochsTerminationCondition(30),
            tes.ScoreImprovementEpochTerminationCondition(3, 1e-5)],
        iteration_termination_conditions=[
            tes.InvalidScoreIterationTerminationCondition()])
    result = tes.EarlyStoppingTrainer(cfg, net, ListDataSetIterator(
        features=x, labels=y, batch_size=32)).fit()
    assert result.total_epochs <= 30
    assert result.best_model is not None
    assert result.best_model_score <= min(result.score_vs_epoch.values()) \
        + 1e-9


def _bn_net(pkg):
    L = jl if pkg == "jax" else tl
    conf = (JConf if pkg == "jax" else TConf)(
        seed=6, updater=(ju if pkg == "jax" else tu).Sgd(0.1)).list(
        L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                           convolution_mode="same", activation="relu"),
        L.BatchNormalization(),
        L.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
    conf = conf.set_input_type((JIT if pkg == "jax" else TIT)
                               .convolutional(4, 4, 2)).build()
    return JMLN(conf).init() if pkg == "jax" else \
        MultiLayerNetwork(conf, device="cpu").init()


def test_local_file_saver_round_trips_the_state(tmp_path):
    jnet, pnet = _bn_net("jax"), _bn_net("torch")
    load_jax_params(pnet, _np(jnet.params))
    load_jax_state(pnet, _np(jnet.state))
    r = np.random.default_rng(4)
    x = r.standard_normal((64, 4, 4, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum((1, 2, 3)) > 0).astype(int)]
    saver = tes.LocalFileModelSaver(str(tmp_path), device="cpu")
    cfg = _config(tes, ListDataSetIterator, x, y, 3, 5, saver=saver)
    cfg.save_last_model = True
    res = tes.EarlyStoppingTrainer(cfg, pnet, ListDataSetIterator(
        features=x, labels=y, batch_size=16)).fit()
    jres = jes.EarlyStoppingTrainer(
        _config(jes, JIter, x, y, 3, 5), jnet,
        JIter(features=x, labels=y, batch_size=16)).fit()
    _same_result(res, jres)
    with zipfile.ZipFile(tmp_path / "bestModel.bin") as z:
        assert len(z.read("state.bin")) == 4 * 2 * 4      # mean, var [4]
    latest = saver.get_latest_model()
    for k, t in pnet.state_dicts()[1].items():
        torch.testing.assert_close(latest.state_dicts()[1][k], t, rtol=0,
                                   atol=0)
    np.testing.assert_array_equal(latest.output(x).numpy(),
                                  pnet.output(x).numpy())
    best = res.best_model
    assert best.state_dicts()[1]["mean"].abs().max() > 0
    np.testing.assert_allclose(best.output(x).numpy(),
                               np.asarray(jres.best_model.output(x)),
                               atol=1e-5)


def test_parallel_trainer_on_two_logical_workers_matches_jax():
    jnet, pnet = _pair(0.5)
    x, y = _data(256, seed=5)
    jres = JESPT(_config(jes, JIter, x, y, 4, 2), jnet,
                 JIter(features=x, labels=y, batch_size=64),
                 mesh=jmesh.make_mesh((2,), ("data",),
                                      jax.devices()[:2])).fit()
    tres = tes.EarlyStoppingParallelTrainer(
        _config(tes, ListDataSetIterator, x, y, 4, 2), pnet,
        ListDataSetIterator(features=x, labels=y, batch_size=64),
        mesh=make_mesh((2,), ("data",), "cpu")).fit()
    assert tres.total_epochs == 4
    _same_result(tres, jres)
    assert pnet.iteration_count == jnet.iteration_count == 16
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=1e-5)
    pnet.fit(x, y, epochs=1, batch_size=64)     # the plain path still fits
