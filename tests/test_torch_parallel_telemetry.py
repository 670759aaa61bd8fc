"""The parallel layer's telemetry against the JAX package's: the same tiny
fits through both packages' ``ParallelWrapper`` (4 of conftest's 8 CPU
devices; 4 workers of the port's logical mesh), ``ElasticTrainer`` under
one injected kill, ``ZeroUpdateEngine.profile`` and
``overlap.profile_schedule``, each package into a fresh registry.

Pinned exactly:

- the spans of each path by name and count (``fit`` / ``epoch`` /
  ``window`` / ``dispatch`` / ``step``; ``elastic.fit``,
  ``elastic.recover``, ``checkpoint_write``; the profiles' collective
  spans);
- the deterministic counters' values: ``train.iterations``,
  ``train.windows``, ``parallel.collective_launches``,
  ``elastic.recoveries``, ``elastic.checkpoint.written``;
- the ``parallel.*``, ``zero.*`` and ``elastic.*`` metric names, and the
  gauges that count layout (buckets, groups, shard and gathered bytes,
  a rank's parameter and updater bytes on a model axis) by value;
- the profiles' rows (buckets, groups, bytes) and result keys.

Times (``*_ms``) are compared by name only: the port's mesh is logical."""
import _torch_threads  # noqa: F401
import importlib
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.models.zoo_extra import \
    transformer_lm as jtransformer_lm
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import ElasticTrainer as JElastic
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import ZeroUpdateEngine as JZero
from deeplearning4j_tpu.parallel import faults as jf
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import overlap as jov
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import (ElasticTrainer, FaultInjector,
                                               FaultPlan, KillWorker,
                                               ParallelWrapper,
                                               ZeroUpdateEngine, make_mesh)
from deeplearning4j_tpu_torch.parallel import overlap as tov
from deeplearning4j_tpu_torch.parallel.data_parallel import flat_param_order
from _torch_flightrec import _port_flightrec_dir  # noqa: F401

J = importlib.import_module("deeplearning4j_tpu.telemetry")
P = importlib.import_module("deeplearning4j_tpu_torch.telemetry")
R = np.random.default_rng(53)
X = R.normal(size=(64, 6)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[R.integers(0, 3, 64)]
WRAPPER_SPANS = {"fit", "epoch", "window", "dispatch", "step"}
COUNTERS = ("train.iterations", "train.windows",
            "parallel.collective_launches")


@pytest.fixture
def regs():
    jr, pr = J.MetricsRegistry(enabled=True), P.MetricsRegistry(enabled=True)
    jp, pp = J.set_registry(jr), P.set_registry(pr)
    try:
        yield jr, pr
    finally:
        J.set_registry(jp)
        P.set_registry(pp)


def _layers(L):
    return [L.DenseLayer(n_in=6, n_out=24, activation="tanh"),
            L.DenseLayer(n_in=24, n_out=16, activation="tanh"),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _jnet():
    return JMLN(JConf(seed=7, updater=jupd.Adam(5e-3), dtype="float32")
                .list(*_layers(jl)).build()).init()


def _pnet(jnet):
    conf = NeuralNetConfiguration(seed=7, updater=tupd.Adam(5e-3),
                                  dtype="float32").list(
        *_layers(tl)).build()
    net = MultiLayerNetwork(conf, device="cpu").init()
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    return net


def _spans(reg, names):
    return Counter(e["name"] for e in reg.trace_events()
                   if e.get("ph") == "X" and e["name"] in names)


def _named(snap, prefixes):
    return {kind: sorted(n for n in snap[kind]
                         if n.startswith(prefixes))
            for kind in ("counters", "gauges", "histograms")}


_MODES = {
    "per_step": {},
    "windows": dict(steps_per_dispatch=2),
    "overlap": dict(overlap_sync=True, bucket_bytes=256),
    "zero2_windows": dict(zero_stage=2, bucket_bytes=256,
                          steps_per_dispatch=2),
    "zero1": dict(zero_stage=1, bucket_bytes=512),
    "averaging": dict(training_mode="averaging", averaging_frequency=2),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_wrapper_spans_and_counters_equal_the_references(regs, mode):
    jr, pr = regs
    kw = _MODES[mode]
    jnet = _jnet()
    pnet = _pnet(jnet)
    JPW(jnet, mesh=jmesh.make_mesh((4,), ("data",), jax.devices()[:4]),
        **kw).fit(JIter(features=X, labels=Y, batch_size=16), epochs=2)
    ParallelWrapper(pnet, mesh=make_mesh((4,), ("data",), "cpu"),
                    **kw).fit(ListDataSetIterator(features=X, labels=Y,
                                                  batch_size=16), epochs=2)
    assert _spans(pr, WRAPPER_SPANS) == _spans(jr, WRAPPER_SPANS)
    js, ps = jr.snapshot(), pr.snapshot()
    for name in COUNTERS:
        assert ps["counters"].get(name) == js["counters"].get(name), name
    assert ps["counters"]["train.iterations"] == 8
    prefixes = ("train.", "parallel.", "zero.")
    assert _named(ps, prefixes) == _named(js, prefixes)
    for name in ("parallel.bucket_count", "zero.groups", "zero.shard_bytes",
                 "zero.gathered_bytes"):
        assert ps["gauges"].get(name) == js["gauges"].get(name), name
    # the spans nest as the reference's (each one's path)
    paths = lambda reg: {e["args"]["path"] for e in reg.trace_events()
                         if e.get("ph") == "X"
                         and e["name"] in WRAPPER_SPANS}
    assert paths(pr) == paths(jr)


V = 32


def _lm_cfg():
    return dict(vocab_size=V, d_model=16, n_heads=4, n_blocks=1,
                max_length=16, token_input=True)


def _lm_feed():
    rs = np.random.RandomState(0)
    return [(rs.randint(1, V, (8, 8)).astype(np.int32),
             np.eye(V)[rs.randint(0, V, (8, 8))].astype(np.float32))
            for _ in range(2)]


def test_model_axis_gauges_equal_the_references(regs):
    """On ``(2, 2)`` a rank's parameter and updater bytes are the
    reference's: the model-sharded leaves count one row of two."""
    jr, pr = regs
    jnet = jtransformer_lm(**_lm_cfg(), seed=11).init()
    pnet = transformer_lm(**_lm_cfg(), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    JPW(jnet, mesh_shape=(2, 2)).fit([JDataSet(x, y) for x, y in
                                      _lm_feed()], epochs=1)
    ParallelWrapper(pnet, mesh_shape=(2, 2)).fit(
        [DataSet(x, y) for x, y in _lm_feed()], epochs=1)
    js, ps = jr.snapshot()["gauges"], pr.snapshot()["gauges"]
    for name in ("parallel.model_axis", "parallel.param_bytes_per_replica",
                 "parallel.opt_bytes_per_replica"):
        assert ps[name] == js[name], name
    assert ps["parallel.model_axis"]["value"] == 2
    whole = sum(p.numel() * p.element_size()
                for _, _, p in flat_param_order(pnet))
    assert ps["parallel.param_bytes_per_replica"]["value"] < whole


ELASTIC_SPANS = WRAPPER_SPANS | {"elastic.fit", "elastic.recover",
                                 "checkpoint_write"}


def test_elastic_telemetry_equals_the_references(regs, tmp_path):
    """A kill at step 6 with a save every 4 steps: one recovery from the
    step-4 save, 6 + 4 steps run, two saves written (step 4 before the
    recovery's flush, step 8 after; the final save finds step 8 there)."""
    jr, pr = regs
    jnet = _jnet()
    pnet = _pnet(jnet)
    JElastic(jnet, checkpoint_dir=str(tmp_path / "jax"),
             devices=jax.devices()[:4], checkpoint_every_n_steps=4,
             fault_injector=jf.FaultInjector(jf.FaultPlan(
                 jf.KillWorker(step=6, worker=1, rejoin=True)))).fit(
        JIter(features=X, labels=Y, batch_size=8), num_steps=8)
    tr = ElasticTrainer(pnet, checkpoint_dir=str(tmp_path / "port"),
                        devices=[0, 1, 2, 3], checkpoint_every_n_steps=4,
                        fault_injector=FaultInjector(FaultPlan(
                            KillWorker(step=6, worker=1, rejoin=True))))
    tr.fit(ListDataSetIterator(features=X, labels=Y, batch_size=8),
           num_steps=8)
    assert tr.recoveries == 1
    js, ps = jr.snapshot(), pr.snapshot()
    for name in ("train.iterations", "elastic.recoveries",
                 "elastic.checkpoint.written",
                 "elastic.checkpoint.submitted"):
        assert ps["counters"].get(name) == js["counters"].get(name), name
    assert ps["counters"]["train.iterations"] == 10
    assert ps["counters"]["elastic.recoveries"] == 1
    assert ps["counters"]["elastic.checkpoint.written"] == 2
    assert _named(ps, ("elastic.",)) == _named(js, ("elastic.",))
    assert ps["gauges"]["elastic.mesh_devices"] == \
        js["gauges"]["elastic.mesh_devices"]
    assert _spans(pr, ELASTIC_SPANS) == _spans(jr, ELASTIC_SPANS)


def _jmesh(n):
    return jmesh.make_mesh((n,), ("data",), jax.devices()[:n])


def _profile_spans(reg):
    return Counter((e["name"], e.get("cat"), e["args"].get("bucket"),
                    e["args"].get("group"), e["args"].get("bytes"))
                   for e in reg.trace_events() if e.get("ph") == "X"
                   and e.get("cat") in ("collective", "span"))


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_profile_equals_the_references(regs, stage):
    jr, pr = regs
    jnet = _jnet()
    pnet = _pnet(jnet)
    jout = JZero.from_net(jnet, _jmesh(4), stage=stage,
                          bucket_bytes=512).profile(repeats=1)
    pout = ZeroUpdateEngine.from_net(pnet, make_mesh((4,), ("data",), "cpu"),
                                     stage=stage,
                                     bucket_bytes=512).profile(repeats=1)
    assert set(pout) == set(jout)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"}
                          for r in rows]
    for key in ("reduce_scatter", "all_gather"):
        assert strip(pout[key]) == strip(jout[key]), key
    for key in ("shard_state_bytes", "replicated_state_bytes"):
        assert pout[key] == jout[key]
    assert _profile_spans(pr) == _profile_spans(jr)
    js, ps = jr.snapshot()["gauges"], pr.snapshot()["gauges"]
    assert sorted(n for n in ps if n.startswith("zero.")) == \
        sorted(n for n in js if n.startswith("zero."))
    assert ps["zero.reduce_scatter_ms"]["value"] >= 0.0


def test_profile_schedule_equals_the_references(regs):
    jr, pr = regs
    jnet = _jnet()
    pnet = _pnet(jnet)
    jout = jov.profile_schedule(
        _jmesh(4), jov.build_bucket_schedule(jnet.params, 256), repeats=1)
    pout = tov.profile_schedule(
        make_mesh((4,), ("data",), "cpu"),
        tov.build_bucket_schedule([p for _, _, p in flat_param_order(pnet)],
                                  256), repeats=1)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"}
                          for r in rows]
    assert strip(pout["buckets"]) == strip(jout["buckets"])
    assert set(pout) == set(jout)
    assert _profile_spans(pr) == _profile_spans(jr)
    js, ps = jr.snapshot()["gauges"], pr.snapshot()["gauges"]
    assert ps["parallel.bucket_count"] == js["parallel.bucket_count"]
    assert "parallel.collective_ms" in ps and "parallel.collective_ms" in js
    torch.testing.assert_close(
        ps["parallel.collective_ms"]["value"],
        sum(r["ms"] for r in pout["buckets"]), atol=1e-3, rtol=0)
