"""Telemetry on the served path: the port's ``ServingHTTPServer`` over a
``GenerationEngine`` against the JAX package's, with the registry on.

A 2-block d_model 64 ``transformer_lm`` (the port's weights carried from
the JAX network by ``interop/jax_params.py``) serves the same 3 greedy
requests on both servers, one at a time, each under its own
``X-Trace-Id``, into a fresh registry a package. Compared, exactly:

- the tokens;
- the metric names (counters, gauges, histograms) after
  ``torchsignals.NAME_MAP``, the wall-clock-throttled
  ``generation.<model>.tokens_per_sec`` gauge aside;
- per request, the sequence of its trace events' names (the id echoed on
  every response), and the names and paths of the loop's spans;
- each of the five telemetry routes: status, content type and headers,
  and the body's keys, names and shapes (the ``/metrics/prometheus``
  sample names after the mapping: the port folds no ``mfu`` on the CPU,
  where it has no peak, so its ``perf_*`` names are a subset); and
  ``/metrics``' keys with an SLO watchdog set.

Also ``InferenceEngine``'s batcher events, bucket costs and dispatch
histograms, and the forward server's ``X-Trace-Id`` echo."""
import _torch_threads  # noqa: F401
import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.models.zoo_extra import \
    transformer_lm as jtransformer_lm
from deeplearning4j_tpu.serving import ServingHTTPServer as JServer
from deeplearning4j_tpu.serving.generation import GenerationEngine as JGen
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.serving import ServingHTTPServer as TServer
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


J = importlib.import_module("deeplearning4j_tpu.telemetry")
P = importlib.import_module("deeplearning4j_tpu_torch.telemetry")
CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_blocks=2, max_length=64,
           token_input=True)
ENG = dict(model_name="lm", block_len=8, max_seq_len=64, decode_slots=2,
           prefill_batches=(1,), prompt_rungs=(32, 64))
PROMPTS = [np.random.default_rng(s).integers(1, 64, size=n).tolist()
           for s, n in ((1, 9), (2, 20), (3, 33))]
IDS = [f"{i + 1:02d}" * 16 for i in range(3)]
THROTTLED = {"generation.lm.tokens_per_sec"}


def _http(base, method, path, body=None, trace_id=None):
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["X-Trace-Id"] = trace_id
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _mapped(names):
    """Reference names in the port's spelling (``NAME_MAP``)."""
    out = set()
    for n in names:
        for j, t in P.NAME_MAP.items():
            if n.startswith(j):
                n = None if t is None else t + n[len(j):]
                break
        if n is not None:
            out.add(n)
    return out


def _names(snap):
    return {kind: set(snap[kind]) - THROTTLED
            for kind in ("counters", "gauges", "histograms")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both servers after the 3 traced requests: (side, ...) per package,
    each side {"base", "reg", "tokens", "echo", "rec"}."""
    tmp = tmp_path_factory.mktemp("tel")
    jnet = jtransformer_lm(**CFG, seed=5).init()
    pnet = transformer_lm(**CFG, device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v, np.float32)
                            for k, v in p.items()} for p in jnet.params])
    sides = {"j": dict(T=J, srv=JServer(generation=JGen(jnet, **ENG))),
             "p": dict(T=P, srv=TServer(generation=GenerationEngine(
                 pnet, device="cpu", **ENG)))}
    prev = []
    for name, side in sides.items():
        T = side["T"]
        side["reg"] = T.MetricsRegistry(enabled=True)
        side["rec"] = T.FlightRecorder(directory=str(tmp / name),
                                       min_interval_s=0.0)
        prev.append((T, T.set_registry(side["reg"]),
                     T.set_flight_recorder(side["rec"]),
                     T.set_slo_watchdog(T.SLOWatchdog([T.LatencySLO(
                         "ttft", "generation.lm.ttft_ms", 1000.0)]))))
        side["base"] = f"http://127.0.0.1:{side['srv'].start()}"
    try:
        for side in sides.values():
            side["tokens"], side["echo"] = [], []
            for p, tid in zip(PROMPTS, IDS):
                st, hd, body = _http(side["base"], "POST", "/generate",
                                     {"prompt": p, "max_tokens": 6,
                                      "stream": False}, tid)
                assert st == 200, body
                side["tokens"].append(json.loads(body)["tokens"])
                side["echo"].append(hd["X-Trace-Id"])
            if side["T"] is P:                 # the port's loop, idle
                assert side["srv"].generation.runtime("lm").wait_idle(30)
            side["snap"] = side["reg"].snapshot()
            side["events"] = side["reg"].trace_events()
        yield sides
    finally:
        for side in sides.values():
            side["srv"].stop()
        for T, reg, rec, wd in prev:
            T.set_registry(reg)
            T.set_flight_recorder(rec)
            T.set_slo_watchdog(wd)


def test_tokens_and_echoed_ids_equal(served):
    assert served["p"]["tokens"] == served["j"]["tokens"]
    assert all(len(t) == 6 for t in served["p"]["tokens"])
    assert served["p"]["echo"] == served["j"]["echo"] == IDS


def test_metric_names_equal_after_the_mapping(served):
    ref, got = _names(served["j"]["snap"]), _names(served["p"]["snap"])
    for kind in ref:
        assert got[kind] == _mapped(ref[kind]), kind
    assert "generation.lm.ttft_ms" in got["histograms"]
    assert "span.generation.decode_step_ms" in got["histograms"]
    assert served["p"]["snap"]["histograms"]["generation.lm.ttft_ms"][
        "count"] == 3


def test_span_names_and_request_events_equal(served):
    def per_request(events):
        out = {}
        for e in events:
            tid = e.get("args", {}).get("trace_id")
            if tid in IDS:
                out.setdefault(tid, []).append((e["name"], e["ph"]))
        return out

    def spans(events):
        return sorted({(e["name"], e["args"]["path"]) for e in events
                       if e.get("cat") == "span"})
    ref, got = served["j"]["events"], served["p"]["events"]
    assert per_request(got) == per_request(ref)
    seq = [n for n, _ in per_request(got)[IDS[0]]]
    assert seq[:4] == ["http.request", "generation.submit",
                       "generation.admit", "generation.prefill"]
    assert seq[-1] == "generation.finish"
    assert spans(got) == spans(ref) == [
        ("generation.decode_step", "generation.decode_step"),
        ("generation.prefill", "generation.prefill")]


def test_debug_trace_route_as_the_reference(served):
    got, ref = [_http(served[s]["base"], "GET", "/debug/trace")
                for s in ("p", "j")]
    assert got[0] == ref[0] == 200
    assert got[1]["Content-Type"] == ref[1]["Content-Type"] == \
        "application/x-ndjson"
    lines = [json.loads(x) for x in got[2].splitlines()]
    assert int(got[1]["X-Trace-Seq"]) == max(e["seq"] for e in lines)
    assert got[1]["X-Trace-Dropped"] == "0"
    rnames = {json.loads(x)["name"] for x in ref[2].splitlines()}
    assert {e["name"] for e in lines} - {"http.request"} <= rnames
    for s in ("p", "j"):
        cursor = _http(served[s]["base"], "GET", "/debug/trace")[1][
            "X-Trace-Seq"]
        st, _, body = _http(served[s]["base"], "GET",
                            f"/debug/trace?since_seq={cursor}")
        assert st == 200 and body == b""


def test_debug_metrics_route_as_the_reference(served):
    got, ref = [json.loads(_http(served[s]["base"], "GET",
                                 "/debug/metrics")[2]) for s in ("p", "j")]
    assert set(got) == set(ref) == {"counters", "gauges", "histograms"}
    h_got = got["histograms"]["generation.lm.ttft_ms"]
    h_ref = ref["histograms"]["generation.lm.ttft_ms"]
    assert h_got["bounds"] == h_ref["bounds"]
    assert h_got["count"] == h_ref["count"] == 3
    assert set(got["histograms"]) == _mapped(ref["histograms"])


def test_prometheus_route_as_the_reference(served):
    got, ref = [_http(served[s]["base"], "GET", "/metrics/prometheus")
                for s in ("p", "j")]
    assert got[0] == ref[0] == 200
    assert got[1]["Content-Type"] == ref[1]["Content-Type"]

    def samples(text):
        out = set()
        for line in text.decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                float(value)
                out.add(name.split("{")[0])
        return out
    pg, pr = samples(got[2]), samples(ref[2])
    tp = "dl4j_tpu_generation_lm_tokens_per_sec"
    pr_mapped = {n.replace("dl4j_tpu_jax_", "dl4j_tpu_torch_")
                 for n in pr} - {tp}
    plain = lambda s: {n for n in s if not n.startswith("dl4j_tpu_perf_")}
    assert plain(pg) - {tp} == plain(pr_mapped)
    assert pg - plain(pg) <= pr - plain(pr)
    assert "dl4j_tpu_generation_lm_ttft_ms_count" in pg


def test_metrics_route_has_the_reference_keys(served):
    got, ref = [json.loads(_http(served[s]["base"], "GET", "/metrics")[2])
                for s in ("p", "j")]
    assert set(got) == set(ref) == {"generation", "slo", "perf"}
    assert set(got["slo"]) == set(ref["slo"])
    assert set(got["perf"]) == set(ref["perf"])     # ``kernels`` included
    assert got["perf"]["peak_tflops"] is None        # no peak on the CPU
    paths = {r["path"] for r in got["perf"]["programs"]}
    assert {"generation.lm.decode_step", "generation.lm.prefill.b1xp32",
            "generation.lm.prefill.b1xp64"} <= paths


def test_flightrec_route_as_the_reference(served):
    got, ref = [_http(served[s]["base"], "POST", "/debug/flightrec",
                      {"note": "x", "trigger": "t"}) for s in ("p", "j")]
    assert got[0] == ref[0] == 200
    dg, dr = [json.load(open(json.loads(r[2])["dumped"]))
              for r in (got, ref)]
    assert dg["trigger"] == dr["trigger"] == "http_debug"
    assert dg["info"] == dr["info"] == {"note": "x", "body_trigger": "t"}
    assert set(dg) == set(dr)
    names = {e["name"] for e in dg["events"]}
    assert {"generation.decode_step", "http.request"} <= names


def test_memprof_route_as_the_reference(served):
    got, ref = [_http(served[s]["base"], "POST", "/debug/memprof",
                      {"top_k": 50}) for s in ("p", "j")]
    assert got[0] == ref[0] == 200
    bg, br = json.loads(got[2]), json.loads(ref[2])
    assert set(bg) == set(br)
    owner = "generation.lm.kvcache"
    assert any(r["owner"] == owner for r in br["top"])
    mine = sum(r["total_bytes"] for r in bg["top"] if r["owner"] == owner)
    ps = served["p"]["srv"].generation.runtime("lm").active_ps
    assert mine == ps.kv_pool_chip_bytes


def test_generation_costs_and_recompile_detector(served):
    idx = P.get_cost_index()
    dec = idx.get("generation.lm.decode_step")
    assert dec.timing_metric == "generation.lm.decode_step_ms"
    assert dec.flops_per_step > 0 and dec.items_per_step == 2.0
    assert idx.get("generation.lm.prefill.b1xp64").flops_per_step > \
        idx.get("generation.lm.prefill.b1xp32").flops_per_step
    rt = served["p"]["srv"].generation.runtime("lm")
    assert rt._det.count == 0
    assert rt.metrics.snapshot()["decode_recompiles"] == 0


def test_decode_recompiles_count_only_the_loops_own_warm_runs(served):
    # the reference's detector sees every compile in the process; the
    # port's loop counts only the warm runs its own thread makes
    rt = served["p"]["srv"].generation.runtime("lm")
    assert rt._det._armed and rt._det.thread_only
    assert rt._det._tid == rt._thread.ident
    n0 = rt._det.count
    P.note_warm_run(0.001)                 # another thread's warm run
    P.note_capture(0.001)
    assert rt._det.count == n0


def test_forward_serving_events_costs_and_echo(tmp_path):
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    conf = NeuralNetConfiguration(seed=3).list(
        DenseLayer(n_in=4, n_out=16, activation="tanh"),
        OutputLayer(n_out=3, activation="softmax")).build()
    net = MultiLayerNetwork(conf, device="cpu").init()
    n0 = P.warm_run_count()
    eng = InferenceEngine(net, feature_shape=(4,), buckets=(1, 4),
                          model_name="fwd")
    assert P.warm_run_count() == n0 + 2
    reg = P.MetricsRegistry(enabled=True)
    prev = P.set_registry(reg)
    srv = TServer(eng)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        st, hd, body = _http(base, "POST", "/predict/fwd",
                             {"features": [[0.1, 0.2, 0.3, 0.4]] * 3},
                             "ab" * 16)
        assert st == 200 and hd["X-Trace-Id"] == "ab" * 16
        st, hd, _ = _http(base, "GET", "/health")
        assert len(hd["X-Trace-Id"]) == 32 and hd["X-Trace-Id"] != "ab" * 16
    finally:
        srv.stop()
        P.set_registry(prev)
    names = [(e["name"], e["args"].get("bucket")) for e in
             reg.trace_events() if e["args"].get("trace_id") == "ab" * 16]
    assert names == [("http.request", None), ("serving.admit", None),
                     ("serving.batch", 4)]
    snap = reg.snapshot()
    assert snap["histograms"]["serving.fwd.bucket4.dispatch_ms"]["count"] == 1
    assert snap["counters"]["serving.fwd.requests"] == 1
    entry = P.get_cost_index().get("serving.fwd.bucket4")
    assert entry.flops_per_step == 2 * 4 * (4 * 16 + 16 * 3)
    assert entry.items_per_step == 4.0 and entry.dtype == "float32"


@pytest.fixture
def recorder(tmp_path):
    reg = P.MetricsRegistry(enabled=True)
    rec = P.FlightRecorder(directory=str(tmp_path / "fr"), min_interval_s=0.0)
    prev_reg, prev_rec = P.set_registry(reg), P.set_flight_recorder(rec)
    try:
        yield rec
    finally:
        P.set_registry(prev_reg)
        P.set_flight_recorder(prev_rec)


def test_generation_dispatch_failure_leaves_black_box(recorder):
    """Reference ``test_flightrec.py``: a failing prefill fails its caller,
    then the loop dumps ``generation_error``."""
    import time
    net = transformer_lm(vocab_size=23, d_model=16, n_heads=2, n_blocks=1,
                         max_length=32, token_input=True,
                         device="cpu").init()
    eng = GenerationEngine(net, device="cpu", model_name="lm", block_len=8,
                           max_seq_len=32, decode_slots=2,
                           prefill_batches=(1,), prompt_rungs=(32,))
    try:
        def exploding(*a, **k):
            raise RuntimeError("device meltdown")
        eng.runtime("lm").active_ps.run_prefill = exploding
        ts = eng.generate([1, 2, 3], max_tokens=4, stream=True)
        assert ts.result(raise_on_error=False)[1] == "error"
    finally:
        eng.stop(drain=False, timeout=2.0)
    deadline = time.monotonic() + 5.0
    while recorder.last_dump_path is None and time.monotonic() < deadline:
        time.sleep(0.01)
    dump = json.load(open(recorder.last_dump_path))
    assert dump["trigger"] == "generation_error"
    assert dump["info"]["error_type"] == "RuntimeError"
    assert dump["info"]["model"] == "lm" and dump["info"]["in_flight"] == 1


def test_serving_dispatch_failure_leaves_black_box(recorder):
    from deeplearning4j_tpu_torch.serving.batcher import ShapeBucketedBatcher
    from deeplearning4j_tpu_torch.serving.buckets import BucketLadder

    def bad_runner(padded):
        raise RuntimeError("kernel imploded")

    b = ShapeBucketedBatcher(bad_runner, BucketLadder((4,)), (4,),
                             batch_window_ms=0.5, name="doomed")
    try:
        with pytest.raises(RuntimeError, match="kernel imploded"):
            b.submit(np.zeros((2, 4), np.float32), timeout=5.0)
    finally:
        b.stop(drain=False)
    dump = json.load(open(recorder.last_dump_path))
    assert dump["trigger"] == "serving_dispatch_error"
    assert dump["info"]["model"] == "doomed" and dump["info"]["bucket"] == 4
