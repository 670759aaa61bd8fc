"""The training listeners (``optimize/listeners.py``) and their fan-out in
``Solver.fit`` and ``ParallelWrapper.fit``, against the JAX package's
``optimize/listeners.py`` on the same fits.

Each stock listener is attached to a JAX network and to the port's with
the same weights, and the two fits' records are compared: the iterations a
listener acts on, the scores (at 1e-5: the packages' losses differ in the
last bits), the record keys. ``PerformanceListener``'s window-aligned
reports are checked with ``time.perf_counter`` replaced by a clock the test
moves, in both packages, so no wall-clock threshold is involved."""
import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import listeners as jlis
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import DevicePrefetchIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import listeners as tlis
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper

R = np.random.default_rng(31)
X = R.normal(size=(96, 5)).astype(np.float32)
Y = np.eye(2, dtype=np.float32)[(X.sum(-1) > 0).astype(int)]


def _layers(L):
    return [L.DenseLayer(n_in=5, n_out=8, activation="tanh"),
            L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]


def _pair():
    jnet = JMLN(JConf(seed=3, updater=jupd.Sgd(0.1)).list(
        *_layers(jl)).build()).init()
    pnet = MultiLayerNetwork(NeuralNetConfiguration(
        seed=3, updater=tupd.Sgd(0.1)).list(*_layers(tl)).build(),
        device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def _fit_both(make, epochs=2, bs=16, **fit_kw):
    """The same listener (``make(module)``) on both packages' fits of 6
    batches a epoch; returns (jax listener, port listener)."""
    jnet, pnet = _pair()
    jlist, plist = make(jlis), make(tlis)
    jnet.set_listeners(jlist)
    pnet.set_listeners(plist)
    jnet.fit(iterator=JIter(features=X, labels=Y, batch_size=bs),
             epochs=epochs, **fit_kw)
    pnet.fit(iterator=ListDataSetIterator(features=X, labels=Y,
                                          batch_size=bs),
             epochs=epochs, **fit_kw)
    return jlist, plist


def test_score_to_float_reads_tensors_and_numbers():
    assert tlis.score_to_float(torch.tensor(1.5)) == 1.5
    assert tlis.score_to_float(torch.tensor(2.0, dtype=torch.bfloat16)) == 2.0
    assert tlis.score_to_float(3) == 3.0
    assert str(tlis._LazyScoreStr(torch.tensor(0.25))) == "0.25"


@pytest.mark.parametrize("k", [1, 4])
def test_collect_scores_equal_the_references(k):
    jlst, plst = _fit_both(
        lambda m: m.CollectScoresIterationListener(frequency=2,
                                                   flush_every=3),
        steps_per_dispatch=k)
    assert [i for i, _ in plst.scores] == [i for i, _ in jlst.scores] == \
        list(range(0, 12, 2))
    np.testing.assert_allclose([s for _, s in plst.scores],
                               [s for _, s in jlst.scores], rtol=1e-5)
    plst.scores = []
    assert plst.scores == [] and plst._raw == []


def test_collect_scores_flush_every_bounds_the_raw_scores():
    lst = tlis.CollectScoresIterationListener(flush_every=4)
    for i in range(10):
        lst.iteration_done(None, i, torch.tensor(float(i)))
    assert len(lst._raw) == 2 and len(lst._scores) == 8
    assert lst.scores == [(i, float(i)) for i in range(10)]


def test_score_and_time_listeners_log_the_references_lines(caplog):
    with caplog.at_level(logging.INFO):
        _fit_both(lambda m: m.ScoreIterationListener(print_iterations=4))
    jlines = [r.getMessage() for r in caplog.records
              if r.name == "deeplearning4j_tpu"
              and r.getMessage().startswith("Score")]
    plines = [r.getMessage() for r in caplog.records
              if r.name == "deeplearning4j_tpu_torch"
              and r.getMessage().startswith("Score")]
    assert len(plines) == len(jlines) == 3
    for a, b in zip(plines, jlines):
        assert a.split(" is ")[0] == b.split(" is ")[0]
        np.testing.assert_allclose(float(a.split(" is ")[1]),
                                   float(b.split(" is ")[1]), rtol=1e-5)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _fit_both(lambda m: m.TimeIterationListener(12, frequency=5))
    its = {name: [r.getMessage().split(",")[0] for r in caplog.records
                  if r.name == name and "ETA" in r.getMessage()]
           for name in ("deeplearning4j_tpu", "deeplearning4j_tpu_torch")}
    assert its["deeplearning4j_tpu"] == its["deeplearning4j_tpu_torch"] == [
        "iteration 5/12", "iteration 10/12"]


def test_evaluative_and_sleepy_listeners():
    jlst, plst = _fit_both(lambda m: m.EvaluativeListener(
        (JIter if m is jlis else ListDataSetIterator)(
            features=X, labels=Y, batch_size=32), frequency=5))
    assert len(plst.evaluations) == len(jlst.evaluations) == 2
    for a, b in zip(plst.evaluations, jlst.evaluations):
        assert a.accuracy() == pytest.approx(b.accuracy())
    slept = tlis.SleepyTrainingListener(sleep_ms=1.0)
    _, pnet = _pair()
    pnet.set_listeners(slept).fit(X, Y, batch_size=48)
    assert pnet.iteration_count == 2


@pytest.mark.parametrize("k", [1, 3])
def test_performance_listener_records_have_the_references_keys(k):
    jlst, plst = _fit_both(lambda m: m.PerformanceListener(frequency=3),
                           steps_per_dispatch=k)
    assert len(plst.history) == len(jlst.history) > 0
    cost = {"mfu", "achieved_tflops"}
    for a, b in zip(plst.history, jlst.history):
        # the port counts its step's cost at the first step (the reference
        # captures it after 256): its records carry the cost keys, and on
        # the CPU there is no peak, so no MFU
        assert set(a) - cost == set(b) - cost
        assert a["mfu"] is None and a["achieved_tflops"] > 0
        assert a["iteration"] == b["iteration"]
        assert a["steps_per_dispatch"] == b["steps_per_dispatch"]
        assert a["score"] == pytest.approx(b["score"], rel=1e-5)
    if k == 3:
        assert all(r["steps_per_dispatch"] == 3.0 for r in plst.history)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("module", [jlis, tlis], ids=["jax", "port"])
def test_performance_listener_defers_a_report_to_the_window_end(
        module, monkeypatch):
    """With a clock the test moves: a report due mid-window (iteration 4
    of the window 3..6) waits for the window's last step and counts all
    the window's steps against the window's wall time; both packages give
    the same records."""
    clock = _Clock()
    monkeypatch.setattr(module.time, "perf_counter", clock)
    lst = module.PerformanceListener(frequency=4)
    lst.iteration_done(None, 0, 1.0)             # the clock's start
    for it in (1, 2):                            # two single steps, 10 s
        clock.t += 5.0
        lst.note_batch(8, etl_wait_ms=2.0, device_ms=3.0)
        lst.iteration_done(None, it, 1.0)
    assert lst.history == []
    clock.t += 40.0                              # a window of 4, 40 s
    lst.note_window(4)
    for it in (3, 4, 5, 6):
        lst.note_batch(8, etl_wait_ms=1.0, device_ms=9.0)
        lst.iteration_done(None, it, 0.5)
        if it < 6:
            assert lst.history == []
    rec = lst.history[-1]
    assert rec["iteration"] == 6
    assert rec["batches_per_sec"] == pytest.approx(6 / 50.0)
    assert rec["samples_per_sec"] == pytest.approx(48 / 50.0)
    assert rec["steps_per_dispatch"] == pytest.approx(6 / 3)
    assert rec["etl_wait_ms_per_iteration"] == pytest.approx(8.0 / 6)
    assert rec["device_ms_per_iteration"] == pytest.approx(42.0 / 6)
    assert rec["score"] == 0.5


def test_performance_listener_reads_the_prefetchers_wait():
    """The waits note_batch receives add up to the prefetcher's
    ``total_wait_ms``, per step and in windows; ``etl_wait_ms_per_batch``
    is their mean."""
    class Noting(tlis.PerformanceListener):
        def __init__(self):
            super().__init__(frequency=1)
            self.waits = []

        def note_batch(self, n, etl_ms=0.0, etl_wait_ms=None, device_ms=0.0):
            self.waits.append(etl_wait_ms)
            super().note_batch(n, etl_ms, etl_wait_ms, device_ms)

    for k in (1, 3):
        _, pnet = _pair()
        lst = Noting()
        pre = DevicePrefetchIterator(
            ListDataSetIterator(features=X, labels=Y, batch_size=16),
            device="cpu")
        pnet.set_listeners(lst).fit(iterator=pre, steps_per_dispatch=k)
        assert len(lst.waits) == 6
        assert sum(lst.waits) == pytest.approx(pre.total_wait_ms)
        assert pre.etl_wait_ms_per_batch() == pytest.approx(
            pre.total_wait_ms / 6)
        assert all(r["etl_wait_ms_per_iteration"] >= 0 for r in lst.history)


class _Hooks(tlis.TrainingListener):
    def __init__(self):
        self.calls = []

    def on_epoch_start(self, model):
        self.calls.append(("start", model.iteration_count))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.iteration_count))

    def iteration_done(self, model, iteration, score):
        self.calls.append(("it", iteration))


def _graph():
    conf = (NeuralNetConfiguration(seed=3, updater=tupd.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .set_input_types(InputType.feed_forward(5))
            .add_layer("h", tl.DenseLayer(n_in=5, n_out=8,
                                          activation="tanh"), "in")
            .add_layer("out", tl.OutputLayer(n_out=2, activation="softmax",
                                             loss="mcxent"), "h")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


@pytest.mark.parametrize("kind", ["multilayer", "graph", "wrapper"])
def test_epoch_hooks_fire_on_both_network_kinds(kind):
    """on_epoch_start / on_epoch_end around each epoch, iteration_done with
    the iteration just run, as the reference's fit loop calls them (its
    order is pinned against the JAX MultiLayerNetwork below)."""
    net = _pair()[1] if kind != "graph" else _graph()
    hooks = _Hooks()
    net.set_listeners(hooks)
    it = ListDataSetIterator(features=X[:48], labels=Y[:48], batch_size=16)
    if kind == "wrapper":
        ParallelWrapper(net, workers=2).fit(it, epochs=2)
    else:
        net.fit(iterator=it, epochs=2)
    want = [("start", 0), ("it", 0), ("it", 1), ("it", 2), ("end", 3),
            ("start", 3), ("it", 3), ("it", 4), ("it", 5), ("end", 6)]
    assert hooks.calls == want
    if kind == "multilayer":
        class JHooks(_Hooks, jlis.TrainingListener):
            pass
        jnet, _ = _pair()
        jh = JHooks()
        jh.calls = []
        jnet.set_listeners(jh).fit(
            iterator=JIter(features=X[:48], labels=Y[:48], batch_size=16),
            epochs=2)
        assert jh.calls == want


def test_pretrain_fires_no_epoch_hooks():
    conf = NeuralNetConfiguration(seed=3, updater=tupd.Sgd(0.1)).list(
        tl.AutoEncoder(n_in=5, n_out=4, activation="sigmoid"),
        tl.OutputLayer(n_out=2, activation="softmax", loss="mcxent")).build()
    net = MultiLayerNetwork(conf, device="cpu").init()
    hooks = _Hooks()
    net.set_listeners(hooks).pretrain(
        ListDataSetIterator(features=X, labels=X, batch_size=32))
    assert hooks.calls == []
