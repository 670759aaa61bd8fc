"""Telemetry on the fit path: the port's ``Solver.fit`` against the JAX
package's, per step and in windows of 2, on a tiny dense network (its
weights carried from the JAX network by ``interop/jax_params.py``).

Pinned, each exactly unless named:

- the parameters bitwise equal with the registry on (a ``TrainingWatch``
  armed, step accounting and the cost count on) and off, both modes;
- the span tree, as the reference's: ``fit`` -> ``epoch`` -> ``window`` ->
  ``dispatch`` in windows, ``fit`` -> ``epoch`` -> ``step`` per step, one
  ``fit`` and one ``epoch`` an epoch, one window a window, and every span
  under one trace id;
- 0 host reads on the loop thread (``HostSyncDetector`` with its CPU
  flag), watch armed, and 0 warm runs or captures in a second fit
  (``RecompileDetector``), both modes;
- a NaN planted in one batch's features flagged ``nonfinite`` at the
  step the reference's watch flags, both modes;
- ``PerformanceListener`` records with ``mfu`` None on the CPU (no peak),
  ``achieved_tflops`` from the counted cost, and the ``train.*`` gauges;
  the ``perf.step.*`` histograms and the cost entries of both modes, the
  same flops a step;
- the parameters and optimiser state tagged for the memory profiler.
The watch's losses and gradient norms match the reference's at rel 1e-4
(float32 dense steps on two frameworks)."""
import _torch_threads  # noqa: F401
import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import \
    ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import PerformanceListener
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


J = importlib.import_module("deeplearning4j_tpu.telemetry")
P = importlib.import_module("deeplearning4j_tpu_torch.telemetry")
R = np.random.default_rng(31)
X = R.normal(size=(32, 4)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[R.integers(0, 3, size=32)]
NAN_ROW = 18                     # batch 4 of 8-row batches: step 2


def _jnet():
    conf = (JConf(seed=12, updater=JAdam(1e-2), dtype="float32")
            .list(jl.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  jl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent")).build())
    return JMLN(conf).init()


def _pnet(jnet):
    conf = (NeuralNetConfiguration(seed=12, updater=Adam(1e-2),
                                   dtype="float32")
            .list(DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax",
                              loss="mcxent")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    load_jax_params(net, [{k: np.asarray(v, np.float32)
                           for k, v in p.items()} for p in jnet.params])
    return net


@pytest.fixture
def regs():
    jr, pr = J.MetricsRegistry(enabled=True), P.MetricsRegistry(enabled=True)
    jp, pp = J.set_registry(jr), P.set_registry(pr)
    try:
        yield jr, pr
    finally:
        J.set_registry(jp)
        P.set_registry(pp)


def _fit(net, x, k, it_cls, epochs=1, **kw):
    net.fit(iterator=it_cls(features=x, labels=Y, batch_size=8),
            epochs=epochs, steps_per_dispatch=k, async_prefetch=False, **kw)
    return net


def _watched(T, fit, **kw):
    """``fit()`` with a watch armed on package ``T``; the drained watch."""
    watch = T.TrainingWatch(dump_on_unhealthy=False, **kw)
    prev = T.set_training_watch(watch)
    try:
        fit()
        assert watch.drain(30)
    finally:
        T.set_training_watch(prev)
        watch.close()
    return watch


def _params(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


@pytest.mark.parametrize("k", [1, 2])
def test_parameters_bitwise_with_the_registry_on_and_off(regs, k):
    jnet = _jnet()
    on, off = _pnet(jnet), _pnet(jnet)
    perf = PerformanceListener(frequency=2)
    on.set_listeners(perf)
    _watched(P, lambda: _fit(on, X, k, ListDataSetIterator, epochs=2),
             window=2)
    reg = regs[1]
    reg.enabled = False
    try:
        off.set_listeners(PerformanceListener(frequency=2))
        _fit(off, X, k, ListDataSetIterator, epochs=2)
    finally:
        reg.enabled = True
    a, b = _params(on), _params(off)
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert perf.history and all(r["mfu"] is None and r["achieved_tflops"] > 0
                                for r in perf.history)
    snap = reg.snapshot()
    assert snap["counters"]["train.iterations"] == 8
    assert {"train.samples_per_sec", "train.windowed_steps_per_sec"} <= \
        set(snap["gauges"])
    # one observation a dispatch (a window's totals over its K steps)
    assert snap["histograms"]["perf.step.compute_ms"]["count"] == 8 // k
    if k == 2:
        assert snap["counters"]["train.windows"] == 4
        assert snap["histograms"]["perf.fit.dispatch_ms"]["count"] == 4


def _span_tree(T, reg, fit):
    fit()
    spans = [e for e in reg.trace_events() if e.get("cat") == "span"]
    counts = {}
    for e in spans:
        counts[e["args"]["path"]] = counts.get(e["args"]["path"], 0) + 1
    return counts, len({e["args"].get("trace_id") for e in spans})


@pytest.mark.parametrize("k", [1, 2])
def test_span_tree_as_the_reference(regs, k):
    jnet = _jnet()
    pnet = _pnet(jnet)
    ref = _span_tree(J, regs[0], lambda: _fit(jnet, X, k, JIter, epochs=2))
    got = _span_tree(P, regs[1], lambda: _fit(pnet, X, k, ListDataSetIterator,
                                              epochs=2))
    assert got == ref
    want = {"fit/epoch/window/dispatch": 4, "fit/epoch/window": 4} if k == 2 \
        else {"fit/epoch/step": 8}
    assert got[0] == dict(want, fit=1, **{"fit/epoch": 2})
    assert got[1] == 1


@pytest.mark.parametrize("k", [1, 2])
def test_watch_armed_fit_reads_nothing_on_the_loop_thread(regs, k):
    net = _pnet(_jnet())

    def fits():
        _fit(net, X, k, ListDataSetIterator)          # warm: counted cost
        with P.HostSyncDetector(action="count", include_cpu=True) as det, \
                P.RecompileDetector(allowed=0, warn=False) as comp:
            _fit(net, X, k, ListDataSetIterator)
        assert det.count == 0, [e["span_path"] for e in det.events]
        assert comp.count == 0, comp.events
    watch = _watched(P, fits, window=2)
    assert watch.steps_seen == 8 and watch.healthy


@pytest.mark.parametrize("k", [1, 2])
def test_watch_flags_a_planted_nan_at_the_reference_step(regs, k):
    x = X.copy()
    x[NAN_ROW] = np.nan
    jnet = _jnet()
    pnet = _pnet(jnet)
    ref = _watched(J, lambda: _fit(jnet, x, k, JIter), window=2)
    got = _watched(P, lambda: _fit(pnet, x, k, ListDataSetIterator),
                   window=2)
    flag = lambda w: [(u["iteration"], u["reason"]) for u in w.unhealthy]
    assert flag(got) == flag(ref)
    assert flag(got)[0] == (NAN_ROW // 8, "nonfinite")
    clean = lambda w: [u for u in w.unhealthy if u["iteration"] < 2]
    assert clean(got) == clean(ref) == []


def test_watch_losses_and_norms_match_the_reference(regs):
    jnet = _jnet()
    pnet = _pnet(jnet)
    seen = {}
    for T, reg, fit in ((J, regs[0], lambda: _fit(jnet, X, 1, JIter)),
                        (P, regs[1], lambda: _fit(pnet, X, 1,
                                                  ListDataSetIterator))):
        _watched(T, fit, window=4)
        g = reg.snapshot()["gauges"]
        seen[T] = (g["training_watch.loss"]["value"],
                   g["training_watch.grad_norm"]["value"])
    np.testing.assert_allclose(seen[P], seen[J], rtol=1e-4)


def test_costs_tags_and_memory_of_a_fit(regs):
    memprof = importlib.import_module(
        "deeplearning4j_tpu_torch.telemetry.memprof")
    memprof.clear_tags()
    idx = P.ProgramCostIndex()
    prev = P.set_cost_index(idx)
    try:
        net = _pnet(_jnet())
        _fit(net, X, 1, ListDataSetIterator)
        _fit(net, X, 2, ListDataSetIterator)
    finally:
        P.set_cost_index(prev)
    step, win = idx.get("fit/epoch/step"), idx.get("fit/epoch/window")
    assert step.flops_per_step == win.flops_per_step > 0
    assert win.steps_per_call == 2 and step.steps_per_call == 1
    assert win.timing_metric == "perf.fit.dispatch_ms"
    assert step.timing_metric == "perf.step.compute_ms"
    assert step.dtype == "float32" and step.device == "cpu"
    owners = {r["owner"] for r in memprof.snapshot(top_k=50)["top"]}
    assert {"params", "opt_state"} <= owners
    rows = idx.fold(regs[1])
    assert {r["path"] for r in rows} == {"fit/epoch/step",
                                         "fit/epoch/window"}
    assert all(r["mfu"] is None and r["roofline"] == "unknown"
               for r in rows)


def test_prefetch_reports_queue_ship_and_stall_as_the_reference(regs):
    """``DevicePrefetchIterator``'s metrics (reference ``prefetch.py:269-345``):
    the same names and counts, the host-to-device rate aside (the port has
    no copy to time on the CPU)."""
    from deeplearning4j_tpu.datasets.prefetch import \
        DevicePrefetchIterator as JPrefetch
    from deeplearning4j_tpu_torch.datasets.prefetch import \
        DevicePrefetchIterator
    got = list(DevicePrefetchIterator(ListDataSetIterator(
        features=X, labels=Y, batch_size=4), depth=2, device="cpu",
        dtype="float32"))
    ref = list(JPrefetch(JIter(features=X, labels=Y, batch_size=4),
                         depth=2, dtype="float32"))
    assert len(got) == len(ref) == 8
    sj, sp = regs[0].snapshot(), regs[1].snapshot()
    gbps = "prefetch.host_to_device_gbps"
    for kind in ("counters", "gauges", "histograms"):
        assert set(sp[kind]) == set(sj[kind]) - {gbps}, kind
    assert sp["counters"]["prefetch.batches"] == 8
    for h in ("prefetch.wait_ms", "prefetch.ship_ms"):
        assert sp["histograms"][h]["count"] == sj["histograms"][h]["count"]


def test_accounting_kill_switch(regs, monkeypatch):
    """``DL4J_TPU_PERF_ACCOUNTING=0``: no cost counted, no step accounting
    (the spans and the watch stay)."""
    monkeypatch.setenv("DL4J_TPU_PERF_ACCOUNTING", "0")
    idx = P.ProgramCostIndex()
    prev = P.set_cost_index(idx)
    try:
        _fit(_pnet(_jnet()), X, 2, ListDataSetIterator)
    finally:
        P.set_cost_index(prev)
    assert idx.paths() == []
    snap = regs[1].snapshot()
    assert "perf.step.compute_ms" not in snap["histograms"]
    assert snap["histograms"]["span.window_ms"]["count"] == 2
