"""The port's legacy serving and streaming routes
(``parallel/inference.py``, ``parallel/model_server.py``,
``parallel/streaming.py``): the reference's cases from
``tests/test_parallel.py`` (ParallelInference, the model server),
``tests/test_serving_distnlp.py`` (the model server, streaming ingest) and
``tests/test_prefetch_pipeline.py`` (a streamed topic behind the
prefetcher), on the CPU, and the served output against the JAX network's
on the same weights."""
import _torch_threads  # noqa: F401
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
from deeplearning4j_tpu.parallel.inference import \
    ParallelInference as JParallelInference
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.prefetch import DevicePrefetchIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.parallel import ParallelInference, make_mesh
from deeplearning4j_tpu_torch.parallel.mesh import data_sharding
from deeplearning4j_tpu_torch.parallel.model_server import ModelServingServer
from deeplearning4j_tpu_torch.parallel.streaming import (
    StreamingDataSetIterator, StreamingIngestServer)
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


R = np.random.default_rng(3)


def _net(n_in=10, n_out=4, seed=2):
    conf = (NeuralNetConfiguration(seed=seed, updater=Adam(5e-3),
                                   dtype="float32")
            .list(tl.DenseLayer(n_in=n_in, n_out=16, activation="tanh"),
                  tl.OutputLayer(n_out=n_out, activation="softmax",
                                 loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n, n_in=10):
    return R.normal(size=(n, n_in)).astype(np.float32)


# ---------------------------------------------------------- ParallelInference
def test_parallel_inference_batched():
    net = _net()
    x = _data(64)
    expected = net.output(x).numpy()
    pi = ParallelInference(net, batch_limit=64)
    results = {}

    def worker(i):
        results[i] = pi.output(x[i * 8:(i + 1) * 8])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pi.shutdown()
    for i in range(8):
        assert isinstance(results[i], np.ndarray)
        np.testing.assert_allclose(results[i], expected[i * 8:(i + 1) * 8],
                                   atol=1e-6)


def test_parallel_inference_sequential():
    net = _net()
    x = _data(16)
    pi = ParallelInference(net, inference_mode="sequential")
    out = pi.output(x)
    np.testing.assert_allclose(out, net.output(x).numpy(), atol=1e-6)
    pi.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output(x)


class _RecordingNet:
    """A stub with the one method ParallelInference needs; records every
    merged batch size it is asked to serve."""

    def __init__(self, block_event=None):
        self.batch_sizes = []
        self._block = block_event

    def output(self, x):
        if self._block is not None:
            self._block.wait(10.0)
        self.batch_sizes.append(x.shape[0])
        return torch.as_tensor(np.asarray(x) * 2.0)


def test_parallel_inference_never_exceeds_batch_limit():
    """An overflow request is carried to the next batch, never merged past
    ``batch_limit``, and every row is served once."""
    gate = threading.Event()
    stub = _RecordingNet(block_event=gate)
    pi = ParallelInference(stub, batch_limit=8, max_wait_ms=50.0)
    xs = [np.full((5, 3), float(i), np.float32) for i in range(4)]
    results = {}

    def worker(i):
        results[i] = pi.output(xs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
        time.sleep(0.02)         # deterministic arrival order
    gate.set()                   # release the first dispatch
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    pi.shutdown()
    assert stub.batch_sizes, "nothing dispatched"
    assert max(stub.batch_sizes) <= 8, stub.batch_sizes
    assert sum(stub.batch_sizes) == 20
    for i in range(4):
        np.testing.assert_allclose(results[i], xs[i] * 2.0)


def test_parallel_inference_shutdown_contract():
    """A submit after ``shutdown`` raises and every pending request is
    resolved (served or failed): nobody hangs."""
    gate = threading.Event()
    stub = _RecordingNet(block_event=gate)
    pi = ParallelInference(stub, batch_limit=4, max_wait_ms=1.0)
    outcomes = []

    def worker():
        try:
            outcomes.append(("ok", pi.output(np.ones((2, 3), np.float32))))
        except RuntimeError as e:
            outcomes.append(("err", e))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)             # the first batch blocks, the rest queue
    shut = threading.Thread(target=pi.shutdown)
    shut.start()
    time.sleep(0.05)
    gate.set()
    shut.join(timeout=10)
    assert not shut.is_alive(), "shutdown() hung"
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive(), "caller left waiting across shutdown()"
    assert len(outcomes) == 3
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output(np.ones((1, 3), np.float32))


def test_parallel_inference_delivers_errors_to_each_request():
    class _Boom:
        def output(self, x):
            raise ValueError("bad batch")

    pi = ParallelInference(_Boom(), batch_limit=8)
    errs = []

    def worker():
        try:
            pi.output(np.ones((2, 3), np.float32))
        except ValueError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    pi.shutdown()
    assert errs == ["bad batch"] * 3


def test_parallel_inference_output_matches_the_jax_network():
    """The same weights behind the JAX package's ParallelInference and the
    port's: each response within atol 1e-5."""
    jconf = (JConf(seed=2, updater=JAdam(5e-3), dtype="float32")
             .list(jl.DenseLayer(n_in=10, n_out=16, activation="tanh"),
                   jl.OutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
             .build())
    jnet = JMLN(jconf).init()
    net = _net()
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    x = _data(24)
    jpi, pi = JParallelInference(jnet, batch_limit=16), \
        ParallelInference(net, batch_limit=16)
    try:
        for s in (0, 5, 13):
            want = np.asarray(jpi.output(x[s:s + 7]))
            got = pi.output(x[s:s + 7])
            np.testing.assert_allclose(got, want, atol=1e-5)
    finally:
        jpi.shutdown()
        pi.shutdown()


# --------------------------------------------------------------- model server
def _post(base, payload_bytes):
    req = urllib.request.Request(f"{base}/predict", payload_bytes,
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=10)


def test_model_server_status_codes_and_drain_health():
    """Malformed payloads 400, model failures 500; /health reports the
    queue depth and 503 while draining."""
    class _FlakyNet:
        def __init__(self):
            self.fail = False

        def output(self, x):
            if self.fail:
                raise RuntimeError("device-side boom")
            return torch.as_tensor(np.asarray(x) * 2.0)

    net = _FlakyNet()
    srv = ModelServingServer(net, batched=False)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        body = json.dumps({"features": [[1.0, 2.0]]}).encode()
        with _post(base, body) as r:
            assert r.status == 200
            assert json.loads(r.read())["output"] == [[2.0, 4.0]]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, b"{nope")
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, json.dumps({"features": [["a"]]}).encode())
        assert ei.value.code == 400
        net.fail = True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, body)
        assert ei.value.code == 500
        net.fail = False
        with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["queue_depth"] == 0
        assert h["requests_served"] == 1
        srv._draining = True
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/health", timeout=10)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, body)
        assert ei.value.code == 503
        srv._draining = False
    finally:
        srv.stop()


def test_model_serving_server_batched():
    net = _net(n_in=4, n_out=3)
    srv = ModelServingServer(net, batched=True)
    port = srv.start()
    try:
        x = R.normal(size=(5, 4)).astype(np.float32).tolist()
        with _post(f"http://127.0.0.1:{port}",
                   json.dumps({"features": x}).encode()) as r:
            out = json.loads(r.read())["output"]
        want = net.output(np.asarray(x, np.float32)).numpy()
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=10) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["requests_served"] == 1
        assert h["model"] == "MultiLayerNetwork"
    finally:
        srv.stop()


# ------------------------------------------------------------------ streaming
def test_streaming_ingest_trains_live_bitwise_the_list_iterator():
    """A producer thread POSTs minibatches while ``net.fit`` consumes the
    live topic (through the prefetcher): training sees every published
    batch, ends bitwise the same batches through a ListDataSetIterator,
    and /stats shows published == consumed and closed."""
    a, b = _net(n_in=6, n_out=2, seed=1), _net(n_in=6, n_out=2, seed=1)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(192, 6)).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X.sum(-1) > 0).astype(int)]
    s0 = a.score(X, Y)
    topic = StreamingDataSetIterator(capacity=4)
    srv = StreamingIngestServer(topic).start()
    url = f"http://127.0.0.1:{srv.port}"

    def post(path, payload):
        req = urllib.request.Request(url + path,
                                     json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    def producer():
        for s in range(0, 192, 32):
            while not post("/publish", {"features": X[s:s + 32].tolist(),
                                        "labels": Y[s:s + 32].tolist()})["ok"]:
                time.sleep(0.01)          # full: back off and publish again
        post("/end", {})

    t = threading.Thread(target=producer)
    t.start()
    a.fit(iterator=topic, epochs=1)
    t.join()
    stats = json.loads(urllib.request.urlopen(url + "/stats").read())
    srv.stop()
    assert stats["published"] == 6 and stats["consumed"] == 6
    assert stats["closed"] and stats["queued"] == 0
    b.fit(iterator=ListDataSetIterator(features=X, labels=Y, batch_size=32),
          epochs=1)
    assert torch.equal(a.params_flat(), b.params_flat())
    assert a.score(X, Y) < s0


def test_streaming_ingest_bad_requests():
    topic = StreamingDataSetIterator(capacity=1)
    srv = StreamingIngestServer(topic).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        req = urllib.request.Request(url + "/publish",
                                     json.dumps({"labels": [[1.0]]}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        ok = {"features": [[1.0]], "labels": [[1.0]]}
        for want in (200, 503):          # the second finds the topic full
            req = urllib.request.Request(url + "/publish",
                                         json.dumps(ok).encode())
            try:
                code = urllib.request.urlopen(req, timeout=10).status
            except urllib.error.HTTPError as e:
                code = e.code
            assert code == want
    finally:
        srv.stop()


def test_streaming_topic_backpressure_and_timeout():
    topic = StreamingDataSetIterator(capacity=2, timeout=0.2)
    x = np.zeros((4, 3), np.float32)
    y = np.zeros((4, 2), np.float32)
    assert topic.publish(x, y, block=False)
    assert topic.publish(x, y, block=False)
    assert not topic.publish(x, y, block=False)   # full: back-pressure
    assert sum(1 for _ in topic) == 2             # drains 2, then times out
    topic.end_of_stream()
    assert not topic.publish(x, y)                # closed


def test_streaming_close_never_hangs_on_full_topic():
    topic = StreamingDataSetIterator(capacity=2)
    x = np.zeros((1, 2), np.float32)
    y = np.zeros((1, 2), np.float32)
    assert topic.publish(x, y, block=False)
    assert topic.publish(x, y, block=False)   # full
    t0 = time.perf_counter()
    topic.end_of_stream()                      # must not block
    assert time.perf_counter() - t0 < 0.5
    assert sum(1 for _ in topic) == 2          # accepted batches all drain


def test_streaming_back_pressure_preserved_under_prefetch():
    """The prefetcher's bounded queue keeps a live stream bounded: once the
    topic's capacity, the prefetch depth and one batch in flight are full,
    non-blocking publishes are refused; consuming frees a slot."""
    topic = StreamingDataSetIterator(capacity=2)
    pf = DevicePrefetchIterator(topic, depth=1, device="cpu")
    x = np.ones((2, 3), np.float32)
    y = np.ones((2, 1), np.float32)
    assert topic.publish(x, y, block=False)
    it = iter(pf)
    next(it)
    accepted, rejections = 0, 0
    for _ in range(200):
        if topic.publish(x, y, block=False):
            accepted += 1
            rejections = 0
        else:
            rejections += 1
            if rejections >= 5:
                break
        time.sleep(0.01)
    assert rejections >= 5, "publish never saw back-pressure"
    assert accepted <= 2 + 1 + 1
    next(it)
    ok = False
    for _ in range(100):
        if topic.publish(x, y, block=False):
            ok = True
            break
        time.sleep(0.01)
    assert ok, "slot did not free after consuming"
    topic.end_of_stream()
    list(it)


def test_prefetch_with_a_data_sharding():
    """``prefetch(sharding=data_sharding(mesh))`` lands batches on the
    mesh's device and refuses a batch that does not tile its data axis."""
    mesh = make_mesh((4,), ("data",), "cpu")
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    it = ListDataSetIterator(features=x, labels=x, batch_size=8)
    got = list(it.prefetch(2, sharding=data_sharding(mesh)))
    assert len(got) == 1 and got[0].features.device == mesh.device
    assert torch.equal(got[0].features, torch.as_tensor(x))
    bad = ListDataSetIterator(features=x[:6], labels=x[:6], batch_size=6)
    with pytest.raises(ValueError, match="does not tile the 4 workers"):
        list(bad.prefetch(1, sharding=data_sharding(mesh)))
