"""The port's forward ``InferenceEngine`` on the CPU, against the network's own
``output`` and the JAX package's ``InferenceEngine`` on the same weights.

The model is the JAX engine tests' small MultiLayerNetwork (Dense 4 -> 16
tanh, softmax 3). Responses equal ``net.output`` of each request alone and
the JAX engine's at atol 1e-6; traffic after warm-up warms nothing; a
same-shape hot swap shares the warmed buckets and serves the new weights.
Also served: GoogLeNet (32x32) through a ``forward_fn`` that returns its
one output, and the int8 tier through ``int8_forward_fn``."""
import _torch_threads  # noqa: F401
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.ops.kernels import quantized as jq
from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
from deeplearning4j_tpu.serving import InferenceEngine as JEngine
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import googlenet
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.kernels import quantized as tq
from deeplearning4j_tpu_torch.optimize.updaters import Sgd
from deeplearning4j_tpu_torch.serving import (BucketLadder,
                                              DeadlineExceededError,
                                              DrainingError, InferenceEngine,
                                              ProgramSet, QueueFullError,
                                              ServingError, ShapeMismatchError,
                                              UnknownModelError, warm_count)
from deeplearning4j_tpu_torch.telemetry import (MetricsRegistry,
                                                get_flight_recorder,
                                                new_trace_context,
                                                set_registry,
                                                use_trace_context)
from _torch_flightrec import _port_flightrec_dir  # noqa: F401

R = np.random.default_rng(77)
REPO = Path(__file__).resolve().parents[1]


def _net(seed=3, n_in=4, n_out=3, act="tanh", hidden=16):
    conf = (NeuralNetConfiguration(seed=seed, updater=Sgd(0.1),
                                   dtype="float32")
            .list(DenseLayer(n_in=n_in, n_out=hidden, activation=act),
                  OutputLayer(n_out=n_out, activation="softmax",
                              loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _jnet(seed=3):
    conf = (JConf(seed=seed, updater=JSgd(0.1), dtype="float32")
            .list(jl.DenseLayer(n_in=4, n_out=16, activation="tanh"),
                  jl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _carry(jnet, pnet):
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return pnet


def _x(n, f=4):
    return R.normal(size=(n, f)).astype(np.float32)


def test_bucket_ladder_is_the_references():
    lad = BucketLadder((32, 1, 8, 8))
    assert lad.rungs == (1, 8, 32)
    assert [lad.bucket_for(n) for n in (1, 2, 8, 9, 32)] == [1, 8, 8, 32, 32]
    assert lad.padding_waste(24) == pytest.approx(8 / 32)
    for bad in ((), (0, 4)):
        with pytest.raises(ValueError):
            BucketLadder(bad)
    with pytest.raises(ValueError):
        lad.bucket_for(33)


def test_responses_equal_net_output_and_the_jax_engine():
    jnet = _jnet()
    pnet = _carry(jnet, _net())
    sizes = [1, 2, 5, 8, 17, 32, 40]           # 40 > the top bucket: chunked
    xs = [_x(n) for n in sizes]
    jeng = JEngine(jnet, feature_shape=(4,), buckets=(1, 8, 32),
                   batch_window_ms=0.5)
    eng = InferenceEngine(pnet, feature_shape=(4,), buckets=(1, 8, 32),
                          batch_window_ms=0.5)
    try:
        for x in xs:
            got = eng.predict(x)
            assert got.dtype == np.float32 and got.shape == (len(x), 3)
            np.testing.assert_allclose(got, pnet.output(x).numpy(),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(got, np.asarray(jeng.predict(x)),
                                       atol=1e-6, rtol=0)
        assert eng.predict(xs[0][0]).shape == (1, 3)   # one bare row
    finally:
        eng.stop()
        jeng.stop()
    snap = eng.metrics()["default"]
    assert snap["requests"] == len(sizes) + 1
    assert set(snap["per_bucket"]) <= {1, 8, 32}


def test_bucket_choice_and_zero_padding():
    seen, threads = [], []

    def fwd(net, x):
        seen.append(x.clone())
        threads.append(threading.current_thread().name)
        return net._output_pure(x)

    net = _net(seed=4)
    eng = InferenceEngine(net, feature_shape=(4,), buckets=(2, 8),
                          batch_window_ms=0.5, forward_fn=fwd)
    try:
        assert [tuple(s.shape) for s in seen] == [(2, 4), (8, 4)]  # warm-up
        # warmed on the thread that serves (CUDA libraries keep per-thread
        # handles), not on the caller's
        assert threads == ["serving-batcher-default"] * 2
        seen.clear()
        x = _x(3)
        out = eng.predict(x)
        assert [tuple(s.shape) for s in seen] == [(8, 4)]
        np.testing.assert_array_equal(seen[0][:3].numpy(), x)
        assert (seen[0][3:] == 0).all()
        assert out.shape == (3, 3)
        seen.clear()
        eng.predict(_x(2))
        assert [tuple(s.shape) for s in seen] == [(2, 4)]
    finally:
        eng.stop()
    snap = eng.metrics()["default"]
    assert snap["per_bucket"] == {8: 1, 2: 1}
    assert snap["batch_occupancy"] == pytest.approx(5 / 10)


def test_a_failing_warm_up_raises_from_the_constructor():
    def fwd(net, x):
        raise RuntimeError("no kernel for this shape")

    with pytest.raises(RuntimeError, match="no kernel"):
        InferenceEngine(_net(), model_name="failing", feature_shape=(4,),
                        buckets=(2,), forward_fn=fwd)
    assert "serving-batcher-failing" not in [t.name
                                             for t in threading.enumerate()]


def test_no_warm_run_under_traffic():
    net = _net(seed=9)
    eng = InferenceEngine(net, feature_shape=(4,), buckets=(4, 8),
                          batch_window_ms=1.0)
    assert eng.trace_count == 2                 # one warm run per bucket
    traces0, warms0 = eng.trace_count, warm_count()
    assert InferenceEngine.compile_count() == warms0
    results = {}

    def worker(i, n):
        x = _x(n)
        results[i] = (x, eng.predict(x, timeout=30))

    threads = [threading.Thread(target=worker, args=(i, n))
               for i, n in enumerate([1, 3, 4, 8, 6, 2, 7, 5])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    eng.stop()
    for x, out in results.values():
        np.testing.assert_allclose(out, net.output(x).numpy(), atol=1e-6,
                                   rtol=0)
    assert eng.trace_count == traces0, "traffic warmed a program"
    assert warm_count() == warms0
    assert eng.metrics()["default"]["requests"] == 8


def test_unwarmed_engine_raises_then_serves_after_warm_up():
    eng = InferenceEngine(_net(seed=90), feature_shape=(4,), buckets=(8,),
                          batch_window_ms=0.5, warm=False)
    try:
        with pytest.raises(ServingError, match="no warmed program"):
            eng.predict(np.zeros((2, 4), np.float32), timeout=5)
        assert eng.metrics()["default"]["rejected"]["error"] == 1
        eng.warm_up()
        assert eng.models()["default"]["warmed"]
        assert eng.predict(np.zeros((2, 4), np.float32)).shape == (2, 3)
    finally:
        eng.stop()


def test_a_dispatch_errors_dump_lands_in_the_tmp_dir(monkeypatch):
    rec = get_flight_recorder()
    where = Path(rec.directory).resolve()
    assert REPO not in where.parents and where != REPO
    # the batcher's dump is rate-limited a trigger; an earlier test's
    # dispatch error must not suppress this one
    monkeypatch.setattr(rec, "min_interval_s", 0.0)
    before = set(where.glob("*serving_dispatch_error.json"))
    eng = InferenceEngine(_net(seed=91), feature_shape=(4,), buckets=(8,),
                          batch_window_ms=0.5, warm=False)
    try:
        with pytest.raises(ServingError, match="no warmed program"):
            eng.predict(np.zeros((2, 4), np.float32), timeout=5)
        # the dump follows the callers' release, on the dispatch thread
        deadline = time.monotonic() + 10.0
        while set(where.glob("*serving_dispatch_error.json")) == before \
                and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        eng.stop(drain=False)
    (path,) = set(where.glob("*serving_dispatch_error.json")) - before
    record = json.loads(path.read_text())
    assert record["trigger"] == "serving_dispatch_error"
    assert record["info"]["model"] == "default"


def test_queue_full_fast_fails():
    eng = InferenceEngine(_net(), feature_shape=(4,), buckets=(1,),
                          queue_limit=2, batch_window_ms=0.1)
    entry = eng.registry.get()
    real_runner = entry.batcher._runner
    gate = threading.Event()
    entry.batcher._runner = lambda padded: gate.wait(10.0) and \
        real_runner(padded)
    x = _x(1)
    done = []
    threads = [threading.Thread(
        target=lambda: done.append(eng.predict(x, timeout=20)))
        for _ in range(3)]           # 1 in flight (gated) + 2 queued
    try:
        for t in threads:
            t.start()
            time.sleep(0.05)
        assert eng.queue_depths() == {"default": 2}
        with pytest.raises(QueueFullError):
            eng.predict(x, timeout=5)
        assert eng.metrics()["default"]["rejected"]["full"] == 1
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        eng.stop()
    assert len(done) == 3


def test_deadline_draining_shape_and_unknown_model():
    eng = InferenceEngine(_net(), feature_shape=(4,), buckets=(1, 8),
                          batch_window_ms=500.0)    # a long collect window
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceededError):
            eng.predict(_x(1), timeout=0.05)
        assert time.monotonic() - t0 < 2.0
        assert eng.metrics()["default"]["rejected"]["deadline"] == 1
        with pytest.raises(ShapeMismatchError):
            eng.predict(np.zeros((2, 5), np.float32))
        with pytest.raises(UnknownModelError):
            eng.predict(_x(1), model="nope")
    finally:
        eng.stop(drain=False)
    assert eng.draining
    with pytest.raises(DrainingError):
        eng.predict(_x(1))


def test_drain_then_stop_resolves_everything():
    # each client runs under its own trace id, so the batcher's
    # ``serving.admit`` event says when its request is in: the drain starts
    # only once all five are admitted (a client that has not reached the
    # queue yet is refused by a drain, as the contract says)
    reg = MetricsRegistry(enabled=True)
    prev = set_registry(reg)
    eng = InferenceEngine(_net(), feature_shape=(4,), buckets=(8,),
                          batch_window_ms=50.0)
    outs, errs, ids = [], [], []

    def client():
        ctx = new_trace_context()
        ids.append(ctx.trace_id)
        try:
            with use_trace_context(ctx):
                outs.append(eng.predict(_x(2), timeout=10))
        except Exception as e:           # pragma: no cover - must not happen
            errs.append(e)

    def admitted() -> int:
        return sum(1 for e in reg.trace_events()
                   if e["name"] == "serving.admit"
                   and e["args"].get("trace_id") in ids)

    threads = [threading.Thread(target=client) for _ in range(5)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while admitted() < 5 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert admitted() == 5
    finally:
        set_registry(prev)
    eng.stop(drain=True)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not errs and len(outs) == 5


def test_multi_model_routing_and_removal():
    a, b = _net(seed=1), _net(seed=2, n_in=6, n_out=2)
    eng = InferenceEngine(a, feature_shape=(4,), buckets=(4,),
                          batch_window_ms=0.5)
    try:
        eng.add_model("b", b, feature_shape=(6,), buckets=(2, 4))
        with pytest.raises(ValueError, match="already registered"):
            eng.add_model("b", b, feature_shape=(6,))
        assert sorted(eng.models()) == ["b", "default"]
        assert eng.models()["b"]["buckets"] == [2, 4]
        assert eng.predict(_x(3, 6), model="b").shape == (3, 2)
        assert eng.predict(_x(3)).shape == (3, 3)     # the default model
        eng.remove_model("b")
        with pytest.raises(UnknownModelError):
            eng.predict(_x(3, 6), model="b")
    finally:
        eng.stop()


def test_same_shape_hot_swap_shares_the_warmed_buckets():
    old, new = _net(seed=5), _net(seed=6)
    x = _x(3)
    want_old, want_new = old.output(x).numpy(), new.output(x).numpy()
    assert not np.allclose(want_old, want_new)
    eng = InferenceEngine(old, feature_shape=(4,), buckets=(4, 8),
                          batch_window_ms=0.5)
    try:
        np.testing.assert_allclose(eng.predict(x), want_old, atol=1e-6)
        set0, traces0 = eng.registry.get().active, eng.trace_count
        assert eng.hot_swap("default", new) == 2
        set1 = eng.registry.get().active
        assert eng.trace_count == traces0             # no warm run
        assert set1 is not set0 and set1._warmed is set0._warmed
        assert set1.net is new and set0.net is old    # in flight: old set
        np.testing.assert_allclose(eng.predict(x), want_new, atol=1e-6)
        np.testing.assert_allclose(set0.run(np.pad(x, ((0, 1), (0, 0))))[:3],
                                   want_old, atol=1e-6)
        assert eng.metrics()["default"]["hot_swaps"] == 1
    finally:
        eng.stop()


def test_hot_swap_under_load_fails_no_request():
    old, new = _net(seed=5), _net(seed=6)
    x = _x(3)
    want = {"old": old.output(x).numpy(), "new": new.output(x).numpy()}
    eng = InferenceEngine(old, feature_shape=(4,), buckets=(4, 8),
                          batch_window_ms=0.5)
    swapped, failures, outs = threading.Event(), [], []

    def client():
        post = 0
        for _ in range(200):
            after = swapped.is_set()
            try:
                outs.append((after, eng.predict(x, timeout=10)))
            except Exception as e:       # pragma: no cover - must not happen
                failures.append(e)
                return
            post += after
            if post >= 3:
                return

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    eng.hot_swap("default", new)
    swapped.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    eng.stop()
    assert not failures
    for after, out in outs:
        which = [k for k, w in want.items()
                 if np.allclose(out, w, atol=1e-6, rtol=0)]
        assert which in (["old"], ["new"])
        assert not (after and which == ["old"]), \
            "a request submitted after the cutover was served by the old net"


def test_changed_architecture_hot_swap_warms_before_cutover():
    """Same shapes, other activation (tanh -> relu): the signature tells
    them apart and the new set is warmed (one run per bucket); a seed-only
    difference stays on the shared-bucket path. The JAX engine's same test
    fails on this tree (ROADMAP §C)."""
    eng = InferenceEngine(_net(seed=94, act="tanh"), feature_shape=(4,),
                          buckets=(4,), batch_window_ms=0.5)
    try:
        x = _x(2)
        relu = _net(seed=94, act="relu")
        traces0 = eng.trace_count
        eng.hot_swap("default", relu)
        assert eng.trace_count == traces0 + 1
        np.testing.assert_allclose(eng.predict(x), relu.output(x).numpy(),
                                   atol=1e-6)
        relu2 = _net(seed=12345, act="relu")
        eng.hot_swap("default", relu2)
        assert eng.trace_count == traces0 + 1
        np.testing.assert_allclose(eng.predict(x), relu2.output(x).numpy(),
                                   atol=1e-6)
        wide = _net(seed=94, act="relu", hidden=24)     # other shapes
        eng.hot_swap("default", wide)
        assert eng.trace_count == traces0 + 2
        assert eng.metrics()["default"]["hot_swaps"] == 3
    finally:
        eng.stop()


class _Storage:
    """A StatsStorage stand-in: keeps every ``put_update``."""

    def __init__(self):
        self.updates = []

    def put_update(self, session_id, worker_id, snap):
        self.updates.append((session_id, worker_id, snap))


def test_publish_metrics_pushes_each_models_snapshot():
    """``publish_metrics`` (ported with the telemetry): one update a model,
    the snapshot ``metrics()`` gives, under the reference's session and
    worker ids."""
    eng = InferenceEngine(_net(), feature_shape=(4,), buckets=(4,))
    jeng = JEngine(_jnet(), feature_shape=(4,), buckets=(4,))
    try:
        eng.predict(_x(2))
        jeng.predict(_x(2))
        ours, ref = _Storage(), _Storage()
        eng.publish_metrics(ours)
        jeng.publish_metrics(ref)
        assert [u[:2] for u in ours.updates] == [u[:2] for u in ref.updates] \
            == [("serving", "default")]
        assert set(ours.updates[0][2]) == set(ref.updates[0][2])
        assert ours.updates[0][2]["requests"] == 1
    finally:
        eng.stop()
        jeng.stop()


def test_the_parts_left_for_later_name_their_roadmap_item(tmp_path):
    from deeplearning4j_tpu_torch.util.serialization import write_model
    eng = InferenceEngine(_net(), feature_shape=(4,), buckets=(4,))
    try:
        # a path (A2b, ported since): a model zip, then a checkpoint dir
        other = _net(seed=21)
        write_model(other, str(tmp_path / "model.zip"))
        assert eng.hot_swap("default", str(tmp_path / "model.zip")) == 2
        (tmp_path / "ck").mkdir()
        write_model(other, str(tmp_path / "ck" / "checkpoint_epoch1.zip"))
        assert eng.reload_from_checkpoint("default",
                                          str(tmp_path / "ck")) == 3
        x = _x(2)
        np.testing.assert_allclose(eng.predict(x), other.output(x).numpy(),
                                   atol=1e-6)
        with pytest.raises(UnknownModelError):
            eng.hot_swap("nope", _net())
    finally:
        eng.stop()
    # a mesh (A7b-2, ported): the default ladder's rung 1 does not divide
    # over a data axis of 2, refused as the reference refuses it
    from deeplearning4j_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="not divisible"):
        InferenceEngine(_net(), feature_shape=(4,),
                        mesh=make_mesh((2,), ("data",), "cpu"))
    with pytest.raises(ValueError, match="feature_shape"):
        InferenceEngine(_net())


def test_concurrent_hammer_keeps_every_result_with_its_request():
    """More client threads than cores, a short switch interval: every
    response is its own request's output."""
    import sys
    net = _net(seed=21)
    eng = InferenceEngine(net, feature_shape=(4,), buckets=(1, 8, 32),
                          batch_window_ms=0.5)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def client(c):
        rng = np.random.default_rng(c)
        for _ in range(10):
            x = rng.normal(size=(int(rng.integers(1, 12)), 4)).astype(
                np.float32)
            got = eng.predict(x, timeout=30)
            if not np.allclose(got, net.output(x).numpy(), atol=1e-6,
                               rtol=0):
                errors.append(c)

    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        eng.stop()
    assert not errors
    assert eng.metrics()["default"]["requests"] == 160


def test_googlenet_engine_with_a_single_output_forward_fn():
    net = googlenet(n_classes=10, height=32, width=32, device="cpu").init()
    fwd = lambda n, x: n._output_pure(x)[0]
    eng = InferenceEngine(net, feature_shape=(32, 32, 3), buckets=(1, 4),
                          forward_fn=fwd, batch_window_ms=0.5)
    try:
        x = R.standard_normal((3, 32, 32, 3)).astype(np.float32)
        got = eng.predict(x)
        assert got.shape == (3, 10)
        np.testing.assert_allclose(got, net.output(x).numpy(), atol=1e-6)
    finally:
        eng.stop()
    # the default forward keeps the reference's graph behaviour: a list of
    # outputs, so a leading axis of length 1 (ROADMAP §C)
    ps = ProgramSet(net, feature_shape=(32, 32, 3), ladder=BucketLadder((2,)))
    assert ps.warm().run(np.zeros((2, 32, 32, 3), np.float32)).shape == \
        (1, 2, 10)


def test_int8_tier_through_forward_fn_matches_jax():
    jnet = _jnet(seed=8)
    pnet = _carry(jnet, _net(seed=8))
    jeng = JEngine(jnet, feature_shape=(4,), buckets=(8, 32),
                   forward_fn=jq.int8_forward_fn(jnet), batch_window_ms=0.5)
    eng = InferenceEngine(pnet, feature_shape=(4,), buckets=(8, 32),
                          forward_fn=tq.int8_forward_fn(pnet),
                          batch_window_ms=0.5)
    try:
        for n in (1, 5, 13, 32):
            x = _x(n)
            got = eng.predict(x)
            with torch.inference_mode():
                alone = tq.int8_forward_fn(pnet)(pnet, torch.tensor(x))
            np.testing.assert_allclose(got, alone.numpy(), atol=1e-7,
                                       rtol=0)
            np.testing.assert_allclose(got, np.asarray(jeng.predict(x)),
                                       atol=1e-6, rtol=0)
            y32 = pnet.output(x).numpy()
            assert np.max(np.abs(got - y32)) / np.max(np.abs(y32)) < 0.05
    finally:
        eng.stop()
        jeng.stop()
    # a same-shape swap re-quantizes from the new network's weights
    other = _net(seed=9)
    eng2 = InferenceEngine(pnet, feature_shape=(4,), buckets=(8,),
                           forward_fn=tq.int8_forward_fn(pnet))
    try:
        eng2.hot_swap("default", other)
        x = _x(4)
        with torch.inference_mode():
            want = tq.int8_forward_fn(other)(other, torch.tensor(x)).numpy()
        np.testing.assert_allclose(eng2.predict(x), want, atol=1e-7, rtol=0)
    finally:
        eng2.stop()
