"""Evaluation in the port against the JAX package.

The port's ``eval`` modules are numpy copies of the reference's: each class
is held against the JAX one on the same arrays (accuracy, precision,
recall, F1, top-N, the binary MCC, AUC, AUPRC, calibration, the regression
statistics, and the ``stats()`` text), and each ``to_json`` written by one
package is read by the other. ``evaluate`` on both network kinds (a small
ResNet-50 graph with running statistics and a ``MultiLayerNetwork``), with
the JAX weights carried across, gives JAX's confusion matrix and the same
prediction records from per-example metadata and a labels mask. The JAX
package's committed trained ``digits_cnn.zip``, restored by the port,
reaches at least 0.97 held-out accuracy on scikit-learn's bundled digits
(the split of ``tests/test_pretrained_digits.py``), and its ``Evaluation``
equals the JAX network's."""
import importlib
import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import eval as jeval
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.util import serialization as jser
from deeplearning4j_tpu_torch import eval as teval
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_params,
                                                         load_jax_state)
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import serialization as tser

jzoo = importlib.import_module("deeplearning4j_tpu.models.zoo")
jlenet = importlib.import_module("deeplearning4j_tpu.models.lenet")

R = np.random.default_rng(0)
N, C = 60, 4
LABELS = np.eye(C)[R.integers(0, C, N)]
SCORES = R.dirichlet(np.ones(C), N)
BIN_LABELS = (R.random((N, 3)) > 0.5).astype(np.float64)
BIN_SCORES = R.random((N, 3))
REG_LABELS = R.standard_normal((N, 2))
REG_PREDS = REG_LABELS + 0.3 * R.standard_normal((N, 2))


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _same_evaluation(a, b):
    np.testing.assert_array_equal(a.confusion, b.confusion)
    assert a.accuracy() == b.accuracy()
    assert a.f1() == b.f1()
    assert a.stats() == b.stats()


# ------------------------------------------------------ the classes alone
@pytest.mark.parametrize("top_n", [1, 3])
def test_evaluation_matches_jax(top_n):
    j, t = jeval.Evaluation(top_n=top_n), teval.Evaluation(top_n=top_n)
    for e in (j, t):
        e.eval(LABELS[:40], SCORES[:40])
        e.eval(LABELS[40:], SCORES[40:], mask=np.arange(20) % 3 != 0)
    _same_evaluation(t, j)
    for f in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert getattr(t, f)() == getattr(j, f)(), f
    for c in range(C):
        assert t.precision(c) == j.precision(c)
        assert t.false_positive_rate(c) == j.false_positive_rate(c)


def test_binary_and_calibration_match_jax():
    jb, tb = jeval.EvaluationBinary(), teval.EvaluationBinary()
    jc, tc = jeval.EvaluationCalibration(), teval.EvaluationCalibration()
    for e in (jb, tb):
        e.eval(BIN_LABELS, BIN_SCORES)
    for e in (jc, tc):
        e.eval(LABELS, SCORES)
    for i in range(3):
        for f in ("accuracy", "precision", "recall", "f1",
                  "matthews_correlation"):
            assert getattr(tb, f)(i) == getattr(jb, f)(i), (f, i)
    assert tb.stats() == jb.stats()
    for c in range(C):
        assert tc.expected_calibration_error(c) == \
            jc.expected_calibration_error(c)
        for a, b in zip(tc.reliability_diagram(c), jc.reliability_diagram(c)):
            np.testing.assert_array_equal(a, b)


def test_roc_and_regression_match_jax():
    jr, tr = jeval.ROC(), teval.ROC()
    jm, tm = jeval.ROCMultiClass(), teval.ROCMultiClass()
    jg, tg = jeval.RegressionEvaluation(), teval.RegressionEvaluation()
    for e in (jr, tr):
        e.eval(BIN_LABELS[:, 0], BIN_SCORES[:, 0])
    for e in (jm, tm):
        e.eval(LABELS, SCORES)
    for e in (jg, tg):
        e.eval(REG_LABELS, REG_PREDS)
    assert tr.calculate_auc() == jr.calculate_auc()
    assert tr.calculate_auprc() == jr.calculate_auprc()
    for c in range(C):
        assert tm.calculate_auc(c) == jm.calculate_auc(c)
    for col in range(2):
        for f in ("mean_squared_error", "mean_absolute_error",
                  "relative_squared_error", "correlation_r2", "r_squared"):
            assert getattr(tg, f)(col) == getattr(jg, f)(col), f
    assert tg.stats() == jg.stats()


@pytest.mark.parametrize("cls", ["Evaluation", "ROC", "ROCMultiClass"])
def test_json_crosses_both_ways(cls):
    j, t = getattr(jeval, cls)(), getattr(teval, cls)()
    if cls == "ROC":
        args = (BIN_LABELS[:, 0], BIN_SCORES[:, 0])
    else:
        args = (LABELS, SCORES)
    j.eval(*args)
    t.eval(*args)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    back_t = getattr(teval, cls).from_json(j.to_json())
    back_j = getattr(jeval, cls).from_json(t.to_json())
    assert json.loads(back_t.to_json()) == json.loads(back_j.to_json())


# ------------------------------------------------------------ evaluate()
def _mlp(pkg):
    L = jl if pkg == "jax" else tl
    conf = (JConf if pkg == "jax" else TConf)(seed=5).list(
        L.DenseLayer(n_in=6, n_out=8, activation="tanh"),
        L.OutputLayer(n_out=C, activation="softmax", loss="mcxent")).build()
    return JMLN(conf).init() if pkg == "jax" else \
        MultiLayerNetwork(conf, device="cpu").init()


def _batches(make, x, y, n):
    """n DataSets with per-example metadata, the last one masked."""
    out = []
    for i, (xs, ys) in enumerate(zip(np.array_split(x, n),
                                     np.array_split(y, n))):
        md = [f"rec{i}-{k}" for k in range(len(xs))]
        mask = None if i < n - 1 else (np.arange(len(xs)) % 2 == 0)
        out.append(make(xs, ys, labels_mask=mask, metadata=md))
    return out


def _same_records(t, j):
    _same_evaluation(t, j)
    te, je = t.get_prediction_errors(), j.get_prediction_errors()
    assert [(p.actual_class, p.predicted_class, p.record_meta_data)
            for p in te] == [(p.actual_class, p.predicted_class,
                              p.record_meta_data) for p in je]


def test_multilayer_evaluate_matches_jax():
    jnet, pnet = _mlp("jax"), _mlp("torch")
    load_jax_params(pnet, _np(jnet.params))
    x = R.standard_normal((30, 6)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[R.integers(0, C, 30)]
    j = jnet.evaluate(_batches(JDataSet, x, y, 3))
    t = pnet.evaluate(_batches(DataSet, x, y, 3))
    _same_records(t, j)
    _same_evaluation(pnet.evaluate(x, y), jnet.evaluate(x, y))


def test_resnet_evaluate_matches_jax():
    kw = dict(n_classes=C, height=32, width=32)
    jnet = jzoo.resnet50(**kw).init()
    pnet = tzoo.resnet50(**kw, device="cpu").init()
    r = np.random.default_rng(3)
    state = [{k: (r.standard_normal(v.shape) if k == "mean"
                  else r.uniform(0.5, 2.0, v.shape)).astype(np.float32)
              for k, v in s.items()} for s in jnet.state]
    load_jax_params(pnet, _np(jnet.params))
    load_jax_state(pnet, state)
    jnet.state = tuple({k: np.asarray(v) for k, v in s.items()}
                       for s in state)
    x = r.standard_normal((12, 32, 32, 3)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[r.integers(0, C, 12)]
    j = jnet.evaluate(_batches(JDataSet, x, y, 2))
    t = pnet.evaluate(_batches(DataSet, x, y, 2))
    _same_records(t, j)
    want = np.zeros((C, C), np.int64)
    out = pnet.output(x).numpy()
    keep = np.ones(12, bool)
    keep[6:] = np.arange(6) % 2 == 0
    np.add.at(want, (y.argmax(1)[keep], out.argmax(1)[keep]), 1)
    np.testing.assert_array_equal(t.confusion, want)


def _held_out():
    """The held-out split the JAX package's digits tool never trained on
    (``tests/test_pretrained_digits.py``)."""
    from sklearn.datasets import load_digits
    digits = load_digits()
    x = (digits.images / 16.0).astype(np.float32)[..., None]
    order = np.random.default_rng(0).permutation(len(x))
    return x[order][:400], digits.target[order][:400]


def test_the_committed_digits_zip_generalizes_in_the_port():
    path = jlenet.DIGITS_CNN_ARTIFACT
    assert os.path.exists(path)
    pnet = tser.restore_multilayer_network(path, device="cpu")
    jnet = jser.restore_multilayer_network(path)
    x, labels = _held_out()
    y = np.eye(10, dtype=np.float32)[labels]
    t, j = pnet.evaluate(x, y), jnet.evaluate(x, y)
    assert t.accuracy() >= 0.97, t.accuracy()
    _same_evaluation(t, j)
