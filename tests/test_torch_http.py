"""The port's ``ServingHTTPServer`` (``serving/http.py``) against the JAX
package's.

Each side serves its own engine over the same weights, carried across by a
model zip (JAX ``write_model`` -> port ``restore_model(device="cpu")``),
and takes the same requests: predict, predict to a named model, a
malformed body (400), an unknown model (404), a full queue (429, the
batcher gated on both sides), draining (503), ``/generate`` streamed and
blocking, a mid-stream deadline that still ends with a ``done`` line,
KV-pool exhaustion (429 without a retry hint), and ``/reload`` from a zip
and from a checkpoint directory whose newest zip is truncated. Status
codes and bodies are equal; outputs match at atol 1e-6 and tokens are
equal. The cases follow the JAX ``tests/test_serving_engine.py``
(``:386-490``) and ``tests/test_generation_http.py``. The five telemetry
routes answer on both with the same status, content type and body keys
and echo ``X-Trace-Id`` (``tests/test_torch_telemetry_serving.py`` holds
their bodies against the reference's), and ``/metrics`` carries the same
top-level keys (``perf`` with the registry on)."""
import _torch_threads  # noqa: F401
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.models.decode import (TransformerDecodeSpec,
                                              naive_generate)
from deeplearning4j_tpu.models.zoo_extra import transformer_lm
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
from deeplearning4j_tpu.serving import GenerationEngine as JGen
from deeplearning4j_tpu.serving import InferenceEngine as JEngine
from deeplearning4j_tpu.serving import ServingHTTPServer as JServer
from deeplearning4j_tpu.util.serialization import write_model as jwrite
from deeplearning4j_tpu_torch.serving import InferenceEngine as TEngine
from deeplearning4j_tpu_torch.serving import ServingHTTPServer as TServer
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine as \
    TGen
from deeplearning4j_tpu_torch.serving.http import status_for
from deeplearning4j_tpu_torch.util.serialization import restore_model
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


R = np.random.default_rng(23)


# ------------------------------------------------------------------ helpers
def _post(base, path, payload, timeout=30, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(base, payload, path="/generate", timeout=30):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return [json.loads(line) for line in r if line.strip()]


def _jmlp(seed):
    conf = (JConf(seed=seed, updater=JSgd(0.1), dtype="float32")
            .list(jl.DenseLayer(n_in=4, n_out=16, activation="tanh"),
                  jl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _jlm(seed, max_length=32):
    return transformer_lm(vocab_size=29, d_model=16, n_heads=2, n_blocks=1,
                          max_length=max_length, seed=seed, dtype="float32",
                          token_input=True).init()


def _across(jnet, tmp_path, name):
    """The JAX net written to a zip and restored by the port."""
    path = str(tmp_path / f"{name}.zip")
    jwrite(jnet, path)
    return path, restore_model(path, device="cpu")


class _Pair:
    """A JAX server and a port server over the same weights."""

    def __init__(self, jkw, tkw):
        self.j = JServer(**jkw)
        self.t = TServer(**tkw)
        self.jb = f"http://127.0.0.1:{self.j.start()}"
        self.tb = f"http://127.0.0.1:{self.t.start()}"

    def post(self, path, payload=None, raw=None):
        return (_post(self.jb, path, payload, raw=raw),
                _post(self.tb, path, payload, raw=raw))

    def stop(self):
        self.j.stop()
        self.t.stop()


def _same(pair_result, outputs=False):
    (js, jb), (ts, tb) = pair_result
    assert ts == js, (ts, tb, js, jb)
    if outputs:
        np.testing.assert_allclose(np.asarray(tb.pop("output")),
                                   np.asarray(jb.pop("output")), atol=1e-6)
    assert tb == jb
    return ts, tb


# ---------------------------------------------------------- forward serving
@pytest.fixture(scope="module")
def forward_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fwd")
    jnet = _jmlp(40)
    _, tnet = _across(jnet, tmp, "a")
    kw = dict(feature_shape=(4,), buckets=(1, 8), batch_window_ms=0.5)
    pair = _Pair(dict(engine=JEngine(jnet, **kw)),
                 dict(engine=TEngine(tnet, **kw)))
    yield pair
    pair.stop()


X = R.normal(size=(3, 4)).astype(np.float32)
FORWARD_CASES = {
    "predict": ("/predict", {"features": X.tolist()}, None, 200),
    "predict_named": ("/predict/default", {"features": X.tolist(),
                                           "timeout_ms": 5000}, None, 200),
    "malformed_body": ("/predict", None, b"{not json", 400),
    "bad_features": ("/predict", {"features": [["a", "b"]]}, None, 400),
    "missing_features": ("/predict", {"rows": [[1.0]]}, None, 400),
    "wrong_shape": ("/predict", {"features": [[1.0, 2.0]]}, None, 400),
    "unknown_model": ("/predict/ghost", {"features": X.tolist()}, None, 404),
    "unknown_route": ("/nope", {"features": X.tolist()}, None, 404),
    "generate_without_engine": ("/generate", {"prompt": [1]}, None, 404),
    "reload_unknown_model": ("/reload", {"model": "ghost", "path": "x.zip"},
                             None, 404),
    "reload_bad_request": ("/reload", {"model": "default", "path": 7}, None,
                           400),
    "reload_missing_path": ("/reload", {"model": "default",
                                        "path": "/no/such/model.zip"},
                            None, 400),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_requests_answer_as_the_jax_server(forward_pair, case):
    path, payload, raw, code = FORWARD_CASES[case]
    status, _ = _same(forward_pair.post(path, payload, raw=raw),
                      outputs=code == 200)
    assert status == code


@pytest.mark.parametrize("route", ["/health", "/models", "/metrics"])
def test_get_routes_answer_as_the_jax_server(forward_pair, route):
    (js, jb), (ts, tb) = _get(forward_pair.jb, route), \
        _get(forward_pair.tb, route)
    assert ts == js == 200
    if route != "/metrics":
        assert tb == jb
    else:
        assert set(tb) == set(jb)
        assert set(tb) - {"slo", "perf"} == {"default"}
        assert set(tb["default"]) == set(jb["default"])


def test_a_full_queue_answers_429_on_both(tmp_path):
    jnet = _jmlp(41)
    _, tnet = _across(jnet, tmp_path, "q")
    kw = dict(feature_shape=(4,), buckets=(1,), queue_limit=2,
              batch_window_ms=0.1)
    jeng, teng = JEngine(jnet, **kw), TEngine(tnet, **kw)
    gate, held = threading.Event(), []
    for eng in (jeng, teng):
        entry = eng.registry.get()
        real = entry.batcher._runner
        held.append(threading.Event())
        entry.batcher._runner = (lambda r, h: lambda p: (
            h.set(), gate.wait(10.0), r(p))[2])(real, held[-1])
    pair = _Pair(dict(engine=jeng), dict(engine=teng))
    x = X[:1].tolist()
    threads = [threading.Thread(target=_post, args=(b, "/predict",
                                                    {"features": x}))
               for b in (pair.jb, pair.tb) for _ in range(3)]
    try:
        # each engine's first request is in its held runner before the
        # other two come: a third that came while the first still queued
        # would be refused early, and the depth would stay at 1
        for t in threads[::3]:
            t.start()
        for h in held:
            assert h.wait(10.0)
        for t in threads[1:3] + threads[4:]:
            t.start()
        deadline = time.monotonic() + 10.0
        while not (jeng.registry.get().batcher.queue_depth == 2
                   and teng.registry.get().batcher.queue_depth == 2):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        status, body = _same(pair.post("/predict", {"features": x}))
        assert status == 429 and body["kind"] == "QueueFullError"
    finally:
        gate.set()
        for t in threads:
            if t.ident is not None:
                t.join(timeout=20)
        pair.stop()


def test_draining_answers_503_on_both(tmp_path):
    jnet = _jmlp(42)
    _, tnet = _across(jnet, tmp_path, "d")
    kw = dict(feature_shape=(4,), buckets=(1,), batch_window_ms=0.5)
    jeng, teng = JEngine(jnet, **kw), TEngine(tnet, **kw)
    pair = _Pair(dict(engine=jeng), dict(engine=teng))
    try:
        jeng.stop(drain=True)
        teng.stop(drain=True)
        status, _ = _same(pair.post("/predict", {"features": [[0, 0, 0, 0]]}))
        assert status == 503
        (js, jb), (ts, tb) = _get(pair.jb, "/health"), _get(pair.tb,
                                                            "/health")
        assert ts == js == 503 and tb == jb and tb["status"] == "draining"
    finally:
        pair.stop()


def test_reload_from_a_zip_and_a_checkpoint_directory(tmp_path):
    jnet, j2, j3 = _jmlp(43), _jmlp(44), _jmlp(45)
    _, tnet = _across(jnet, tmp_path, "a")
    zip2 = str(tmp_path / "v2.zip")
    jwrite(j2, zip2)
    ck = tmp_path / "ck"
    ck.mkdir()
    jwrite(j3, str(ck / "checkpoint_epoch1.zip"))
    jwrite(j2, str(ck / "checkpoint_epoch2.zip"))
    with open(ck / "checkpoint_epoch2.zip", "r+b") as f:
        f.truncate(40)
    kw = dict(feature_shape=(4,), buckets=(1, 8), batch_window_ms=0.5)
    pair = _Pair(dict(engine=JEngine(jnet, **kw)),
                 dict(engine=TEngine(tnet, **kw)))
    try:
        status, body = _same(pair.post("/reload", {"model": "default",
                                                   "path": zip2}))
        assert status == 200 and body["version"] == 2
        _, body = _same(pair.post("/predict", {"features": X.tolist()}),
                        outputs=True)
        (_, tb) = _post(pair.tb, "/predict", {"features": X.tolist()})
        np.testing.assert_allclose(np.asarray(tb["output"]),
                                   np.asarray(j2.output(X)), atol=1e-5)
        status, body = _same(pair.post("/reload", {"model": "default",
                                                   "path": str(ck)}))
        assert status == 200 and body["version"] == 3
        (_, tb) = _post(pair.tb, "/predict", {"features": X.tolist()})
        np.testing.assert_allclose(np.asarray(tb["output"]),
                                   np.asarray(j3.output(X)), atol=1e-5)
    finally:
        pair.stop()


def _raw(base, method, path, body=None, trace_id=None):
    """(status, headers, body bytes) of one request."""
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["X-Trace-Id"] = trace_id
    req = urllib.request.Request(base + path, body, headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.mark.parametrize("method, path", [
    ("GET", "/debug/trace"), ("GET", "/debug/trace?since_seq=3"),
    ("GET", "/debug/trace?since_seq=x"), ("GET", "/debug/metrics"),
    ("GET", "/metrics/prometheus"), ("POST", "/debug/flightrec"),
    ("POST", "/debug/memprof")])
def test_the_telemetry_routes_answer_as_the_jax_server(forward_pair, method,
                                                      path, tmp_path,
                                                      monkeypatch):
    """Each telemetry route: the same status and content type as the JAX
    server's, the caller's ``X-Trace-Id`` echoed (normalized), and a JSON
    body with the same keys."""
    monkeypatch.setenv("DL4J_TPU_FLIGHTREC_DIR", str(tmp_path))
    from deeplearning4j_tpu.telemetry import flightrec as jfr
    from deeplearning4j_tpu_torch.telemetry import flightrec as tfr
    jprev = jfr.set_flight_recorder(jfr.FlightRecorder(str(tmp_path / "j")))
    tprev = tfr.set_flight_recorder(tfr.FlightRecorder(str(tmp_path / "t")))
    body = json.dumps({"top_k": 3}).encode() if method == "POST" else None
    tid = "ABCDEF0123456789-abcdef0123456789"
    try:
        js, jh, jb = _raw(forward_pair.jb, method, path, body, tid)
        ts, th, tb = _raw(forward_pair.tb, method, path, body, tid)
    finally:
        jfr.set_flight_recorder(jprev)
        tfr.set_flight_recorder(tprev)
    assert ts == js, (ts, tb, js, jb)
    assert th["Content-Type"] == jh["Content-Type"]
    assert th["X-Trace-Id"] == jh["X-Trace-Id"] == \
        "abcdef0123456789abcdef0123456789"
    if th["Content-Type"] == "application/json":
        assert set(json.loads(tb)) == set(json.loads(jb))
    elif path.startswith("/debug/trace"):
        assert "X-Trace-Seq" in th and "X-Trace-Dropped" in th


def test_status_for_is_the_references():
    from deeplearning4j_tpu.serving import http as jhttp
    from deeplearning4j_tpu_torch.serving import errors as te
    from deeplearning4j_tpu.serving import errors as je
    for name in ("ShapeMismatchError", "UnknownModelError", "QueueFullError",
                 "DrainingError", "DeadlineExceededError",
                 "BlockPoolExhaustedError", "GenerationClosedError",
                 "ServingError"):
        assert status_for(getattr(te, name)("x")) == \
            jhttp.status_for(getattr(je, name)("x")), name
    assert status_for(RuntimeError("x")) == 500


# -------------------------------------------------------------- generation
GEN = dict(model_name="lm", block_len=8, max_seq_len=32, decode_slots=2,
           prefill_batches=(1,), prompt_rungs=(32,))


@pytest.fixture(scope="module")
def gen_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen")
    jnet = _jlm(7)
    _, tnet = _across(jnet, tmp, "lm")
    kw = dict(GEN, num_blocks=3)
    pair = _Pair(dict(generation=JGen(jnet, **kw)),
                 dict(generation=TGen(tnet, device="cpu", **kw)))
    pair.jnet = jnet
    yield pair
    pair.stop()


def test_generate_streamed_equals_the_jax_stream(gen_pair):
    prompt = [3, 5, 7]
    want = naive_generate(gen_pair.jnet, prompt, 6, pad_to=32,
                          spec=TransformerDecodeSpec(gen_pair.jnet))
    jl_, tl_ = (_stream(b, {"prompt": prompt, "max_tokens": 6})
                for b in (gen_pair.jb, gen_pair.tb))
    assert tl_ == jl_
    assert [l["token"] for l in tl_ if "token" in l] == want
    assert tl_[-1] == {"done": True, "reason": "length", "tokens": 6}


GEN_CASES = {
    "blocking": ("/generate", {"prompt": [3, 5, 7], "max_tokens": 6,
                               "stream": False}, 200),
    "blocking_named_stop": ("/generate/lm", {"prompt": [2, 4],
                                             "max_tokens": 5, "stop": [0],
                                             "stream": False}, 200),
    "prompt_not_ids": ("/generate", {"prompt": "not-token-ids"}, 400),
    "empty_body": ("/generate", {}, 400),
    "unknown_model": ("/generate/ghost", {"prompt": [1]}, 404),
    "over_capacity": ("/generate", {"prompt": [1, 2], "max_tokens": 99,
                                    "stream": False}, 400),
    "pool_exhausted": ("/generate", {"prompt": [1, 2], "max_tokens": 28,
                                     "stream": False}, 429),
    "deadline_before_output": ("/generate", {"prompt": [1, 2, 3],
                                             "max_tokens": 4,
                                             "timeout_ms": 0,
                                             "stream": False}, 504),
    "predict_without_engine": ("/predict", {"features": [[1.0]]}, 404),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generation_requests_answer_as_the_jax_server(gen_pair, case):
    path, payload, code = GEN_CASES[case]
    status, body = _same(gen_pair.post(path, payload))
    assert status == code
    if case == "pool_exhausted":
        assert body["kind"] == "BlockPoolExhaustedError"
        assert "retry_after_ms" not in body


def test_keepalive_is_not_desynced_by_early_errors(gen_pair):
    conn = http.client.HTTPConnection("127.0.0.1", gen_pair.t.port,
                                      timeout=10)
    body = json.dumps({"features": [[1.0, 2.0]]})
    for method, path, payload, code in (
            ("POST", "/predict", body, 404), ("GET", "/health", None, 200),
            ("POST", "/nope", body, 404), ("POST", "/debug/memprof", body,
                                           200),
            ("GET", "/models", None, 200)):
        conn.request(method, path, payload,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == code, path
        r.read()
    conn.close()


def test_a_midstream_deadline_ends_with_a_done_line(tmp_path):
    jnet = _jlm(11, max_length=64)
    _, tnet = _across(jnet, tmp_path, "lm")
    kw = dict(GEN, max_seq_len=64, decode_slots=1, prompt_rungs=(64,))
    pair = _Pair(dict(generation=JGen(jnet, **kw)),
                 dict(generation=TGen(tnet, device="cpu", **kw)))
    try:
        for base in (pair.jb, pair.tb):
            t0 = time.monotonic()
            lines = _stream(base, {"prompt": [1, 2, 3], "max_tokens": 60,
                                   "timeout_ms": 5}, timeout=15)
            assert time.monotonic() - t0 < 10.0
            assert lines[-1]["done"] is True
            assert lines[-1]["reason"] == "deadline"
            ntok = len([l for l in lines if "token" in l])
            assert ntok < 60 and lines[-1]["tokens"] == ntok
    finally:
        pair.stop()


def test_generation_draining_answers_503(tmp_path):
    jnet = _jlm(13)
    _, tnet = _across(jnet, tmp_path, "lm")
    pair = _Pair(dict(generation=JGen(jnet, **GEN)),
                 dict(generation=TGen(tnet, device="cpu", **GEN)))
    try:
        pair.j.generation.stop(drain=True, timeout=5.0)
        pair.t.generation.stop(drain=True, timeout=5.0)
        status, _ = _same(pair.post("/generate", {"prompt": [1],
                                                  "max_tokens": 2,
                                                  "stream": False}))
        assert status == 503
        (js, jb), (ts, tb) = _get(pair.jb, "/health"), _get(pair.tb,
                                                            "/health")
        assert ts == js == 503 and tb["draining"] is jb["draining"] is True
    finally:
        pair.stop()


def test_generation_reload_from_a_zip_and_a_checkpoint_directory(tmp_path):
    ja, jb_, jc = _jlm(7, 64), _jlm(8, 64), _jlm(9, 64)
    _, tnet = _across(ja, tmp_path, "a")
    zb = str(tmp_path / "b.zip")
    jwrite(jb_, zb)
    ck = tmp_path / "ck"
    ck.mkdir()
    jwrite(jc, str(ck / "checkpoint_epoch1.zip"))
    jwrite(jb_, str(ck / "checkpoint_epoch2.zip"))
    with open(ck / "checkpoint_epoch2.zip", "r+b") as f:
        f.truncate(40)
    prompt = [3, 5, 7, 9]
    want = {k: naive_generate(n, prompt, 12, pad_to=64,
                              spec=TransformerDecodeSpec(n))
            for k, n in (("b", jb_), ("c", jc))}
    kw = dict(GEN, max_seq_len=64, prompt_rungs=(64,))
    pair = _Pair(dict(generation=JGen(ja, **kw)),
                 dict(generation=TGen(tnet, device="cpu", **kw)))
    req = {"prompt": prompt, "max_tokens": 12, "stream": False}
    try:
        status, body = _same(pair.post("/reload", {"model": "lm",
                                                   "path": zb}))
        assert status == 200 and body["version"] == 2
        _, body = _same(pair.post("/generate", req))
        assert body["tokens"] == want["b"]
        status, body = _same(pair.post("/reload", {"model": "lm",
                                                   "path": str(ck)}))
        assert status == 200 and body["version"] == 3
        _, body = _same(pair.post("/generate", req))
        assert body["tokens"] == want["c"]
        status, _ = _same(pair.post("/reload", {"model": "ghost",
                                                "path": zb}))
        assert status == 404
    finally:
        pair.stop()


def test_one_reload_swaps_both_engines_of_a_name(tmp_path):
    """A name served by both engines is loaded once and swapped in each;
    the generation engine's device is the one restored onto."""
    from deeplearning4j_tpu_torch.serving import load_net
    ja, jb_ = _jlm(21), _jlm(22)
    za, zb = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    jwrite(ja, za)
    jwrite(jb_, zb)
    gen = TGen(load_net(za, device="cpu"), device="cpu", **GEN)
    fwd = TEngine(load_net(za, device="cpu"), model_name="lm",
                  feature_shape=(5,), buckets=(1,),
                  forward_fn=lambda n, x: n._output_pure(x.long())[0][:, -1])
    srv = TServer(fwd, generation=gen)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        status, body = _post(base, "/reload", {"model": "lm", "path": zb})
        assert status == 200
        assert body["versions"] == {"serving": 2, "generation": 2}
        assert os.path.exists(zb)
    finally:
        srv.stop()
