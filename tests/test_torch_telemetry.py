"""The port's telemetry package (``deeplearning4j_tpu_torch/telemetry``)
against the JAX package's (``deeplearning4j_tpu/telemetry``).

Each scenario runs once on each package, on a fresh registry, from the
same seeded numpy observations, and the two results are compared:
quantiles, bucket counts, snapshots and raw metrics equal; the Prometheus
text equal line for line; Chrome-trace events equal in name, phase,
category, nesting (span path) and args, timestamps, durations, thread and
sequence stamps excluded; trace-context ids, spool files and flight
recorder dumps of the same shape; SLO decisions, burn rates and gauges
equal; ``implied_mfu`` and ``classify_roofline`` equal at explicit peaks;
the cost fold equal at an explicit peak (``BENCH_PEAK_TFLOPS`` /
``BENCH_HBM_GBPS``); ``training_health_vec`` at rel 1e-6 of the
reference's on the same loss and gradients. Everything else is exact.

Also the cases of the reference's ``test_telemetry.py``,
``test_flightrec.py``, ``test_slo.py``, ``test_perf.py`` and
``test_tracing.py`` that need neither the parallel layer nor a model (the
fitted and served paths are ``test_torch_telemetry_fit.py`` and
``test_torch_telemetry_serving.py``), with the port's differences: the
compile detector counts warm runs and captures (``note_warm_run`` /
``note_capture``, names through ``torchsignals.NAME_MAP``), the host-read
detector wraps ``torch.Tensor``'s read methods (CPU tensors flagged only
with ``include_cpu``), and no peak exists on the CPU (``mfu`` None). The
reference's cached-read case has no counterpart (torch keeps no host copy
of a device value) and is not ported."""
import _torch_threads  # noqa: F401
import importlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_flightrec import _port_flightrec_dir  # noqa: F401


J = importlib.import_module("deeplearning4j_tpu.telemetry")
P = importlib.import_module("deeplearning4j_tpu_torch.telemetry")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = np.random.default_rng(2020)
OBS = np.concatenate([R.exponential(20.0, 300), R.uniform(0, 3, 50),
                      R.uniform(5e3, 7e4, 20)]).tolist()
_SKIP = {"ts", "dur", "tid", "seq", "pid"}


@pytest.fixture
def regs():
    """A fresh, enabled registry in each package; both restored after."""
    jr, pr = J.MetricsRegistry(enabled=True), P.MetricsRegistry(enabled=True)
    jp, pp = J.set_registry(jr), P.set_registry(pr)
    try:
        yield jr, pr
    finally:
        J.set_registry(jp)
        P.set_registry(pp)


@pytest.fixture
def recorders(regs, tmp_path):
    """A flight recorder a package (no rate limit) in its own directory."""
    jrec = J.FlightRecorder(directory=str(tmp_path / "j"), min_interval_s=0.0)
    prec = P.FlightRecorder(directory=str(tmp_path / "p"), min_interval_s=0.0)
    jp, pp = J.set_flight_recorder(jrec), P.set_flight_recorder(prec)
    try:
        yield jrec, prec
    finally:
        J.set_flight_recorder(jp)
        P.set_flight_recorder(pp)


def _events(reg):
    """Trace events without their clock, thread and sequence stamps."""
    return [{k: v for k, v in e.items() if k not in _SKIP}
            for e in reg.trace_events()]


def _both(scenario, regs):
    """``scenario(T, reg)`` on each package; returns (reference, port)."""
    return scenario(J, regs[0]), scenario(P, regs[1])


# ---------------------------------------------------------------- registry
def _observe(T, reg):
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.0)
    reg.gauge("g").set(1.0)
    for v in OBS:
        reg.histogram("h_ms").observe(v)
        reg.histogram("serving.default.latency_ms").observe(v / 7.0)
    h = reg.histogram("h_ms")
    return {"snapshot": reg.snapshot(), "raw": reg.raw_metrics(),
            "cum": h.cumulative_buckets(), "le": [h.count_le(b) for b in
                                                  (0.5, 2.5, 30.0, 1e5)],
            "count_sum": h.count_and_sum(), "same": reg.counter("c") is
            reg.counter("c")}


def test_histogram_quantiles_buckets_and_snapshots_equal(regs):
    ref, got = _both(_observe, regs)
    assert got == ref
    assert got["snapshot"]["counters"]["c"] == 5
    assert got["snapshot"]["gauges"]["g"] == {"value": 1.0, "max": 2.0}
    assert got["cum"][-1] == len(OBS) and got["same"]


def test_registry_reference_percentiles():
    reg = P.MetricsRegistry()
    for v in range(100):
        reg.histogram("h_ms").observe(float(v))
    h = reg.snapshot()["histograms"]["h_ms"]
    assert h["count"] == 100 and h["p50"] == 50.0
    assert h["p95"] == 94.0 and h["p99"] == 98.0


@pytest.mark.parametrize("compat", [False, True])
def test_prometheus_text_equal_line_for_line(regs, compat):
    def dump(T, reg):
        _observe(T, reg)
        reg.counter("train.iterations").inc(7)
        reg.gauge("prefetch.queue_depth").set(3)
        return reg.to_prometheus_text(compat_quantiles=compat).splitlines()
    ref, got = _both(dump, regs)
    assert got == ref
    if not compat:
        assert 'dl4j_tpu_h_ms_bucket{le="+Inf"} ' + str(len(OBS)) in got
    else:
        assert not any("_bucket" in line for line in got)


def test_bucket_quantile_and_merge_are_the_references():
    bounds = P.registry.DEFAULT_BUCKET_BOUNDS
    assert bounds == J.registry.DEFAULT_BUCKET_BOUNDS
    hs = []
    for part in (OBS[:100], OBS[100:250], OBS[250:]):
        h = P.Histogram("x")
        for v in part:
            h.observe(v)
        hs.append(h.cumulative_buckets())
    merged = P.merge_cumulative_buckets(bounds, hs)
    assert merged == J.merge_cumulative_buckets(bounds, hs)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert P.bucket_quantile(bounds, merged, q) == \
            J.bucket_quantile(bounds, merged, q)
    with pytest.raises(P.HistogramLadderMismatch):
        P.merge_cumulative_buckets(bounds, [[1, 2]])
    assert P.registry.sanitize_metric_name("a.b-c") == "a_b_c"
    assert P.registry.escape_label_value('a"b\\c\nd') == \
        J.registry.escape_label_value('a"b\\c\nd')


def test_trace_seq_cursoring(regs):
    def run(T, reg):
        assert reg.last_seq == 0
        with T.span("a"):
            pass
        with T.span("b"):
            pass
        seqs = [e["seq"] for e in reg.trace_events()]
        return (seqs, [e["seq"] for e in reg.trace_events_since(seqs[0])],
                reg.trace_events_since(reg.last_seq),
                len(reg.trace_events_since(-1)))
    ref, got = _both(run, regs)
    assert got == ref == ([1, 2], [2], [], 2)


def test_spool_round_trip_and_skip(regs, tmp_path):
    def run(T, reg):
        path = str(tmp_path / f"{T.__name__}.spool.json")
        spool = T.TraceSpool(path, replica_id="r7", registry=reg, capacity=4)
        with T.span("work"):
            reg.counter("done").inc()
        first = spool.flush()
        spill = T.read_spool(path)
        again = spool.flush()
        for i in range(8):
            with T.span(f"s{i}"):
                pass
        spool.flush()
        tail = T.read_spool(path)
        (tmp_path / "junk.json").write_text("{not json")
        return (first, again, spool.skipped, spill["replica"],
                spill["seq"] == reg.last_seq - 8, spill["metrics"],
                [e["name"] for e in spill["events"]],
                [e["name"] for e in tail["events"]],
                T.read_spool(str(tmp_path / "nope.json")),
                T.read_spool(str(tmp_path / "junk.json")))
    ref, got = _both(run, regs)
    for r in (ref, got):            # the span histogram's sum is a clock
        r[5]["histograms"]["span.work_ms"]["sum"] = None
    assert got == ref
    assert got[:5] == (True, False, 1, "r7", True)
    assert got[7] == ["s4", "s5", "s6", "s7"]


class _Storage:
    def __init__(self):
        self.updates = []

    def put_update(self, session_id, worker_id, snap):
        self.updates.append((session_id, worker_id, snap))


def test_publish_to_a_stats_storage(regs):
    def run(T, reg):
        reg.counter("x").inc(2)
        st = _Storage()
        snap = reg.publish(st, session_id="telemetry", worker_id="runtime")
        return (st.updates[0][:2], snap["counters"], "timestamp" in snap)
    ref, got = _both(run, regs)
    assert got == ref == (("telemetry", "runtime"), {"x": 2}, True)


def test_disabled_registry_is_near_noop(regs):
    def run(T, reg):
        reg.enabled = False
        reg.counter("c").inc()
        reg.gauge("g").set(1.0)
        reg.histogram("h").observe(1.0)
        with T.span("nothing", k=1):
            pass
        T.event("e")
        same = T.span("a") is T.span("b")
        reg.enabled = True
        snap = reg.snapshot()
        return (snap["counters"], snap["gauges"], snap["histograms"],
                reg.trace_events(), same)
    ref, got = _both(run, regs)
    assert got == ref == ({}, {}, {}, [], True)


# ------------------------------------------------------------------- spans
def _span_tree(T, reg):
    ctx = T.new_trace_context("ab" * 16)
    with T.use_trace_context(ctx):
        with T.span("fit", epochs=2):
            for i in range(2):
                with T.span("epoch", index=i):
                    with T.span("window", k=4):
                        with T.span("dispatch", k=4):
                            T.event("marker", i=i)
                    T.record_external_span("collective", 1.5,
                                           cat="collective", bucket=i)
    return _events(reg), reg.histogram("span.fit_ms").count


def test_span_chrome_events_equal_apart_from_time(regs):
    ref, got = _both(_span_tree, regs)
    assert got == ref
    paths = [e["args"]["path"] for e in got[0] if e["ph"] == "X"]
    assert paths[:3] == ["fit/epoch/window/dispatch", "fit/epoch/window",
                         "fit/epoch"]
    assert all(e["args"]["trace_id"] == "ab" * 16 for e in got[0])


def test_span_nesting_and_manual_interleaving(regs):
    def run(T, reg):
        paths = []
        with T.span("outer", a=1):
            paths.append(T.current_span_path())
            with T.span("inner"):
                paths.append(T.current_span_path())
            paths.append(T.current_span_path())
        paths.append(T.current_span_path())
        s = T.span("capture").start()
        with T.span("step"):
            pass
        s.end()
        return paths, _events(reg)
    ref, got = _both(run, regs)
    assert got == ref
    assert got[0] == ["outer", "outer/inner", "outer", ""]


def test_exception_unwinding_restores_parent_span(regs):
    def run(T, reg):
        with T.span("outer"):
            try:
                with T.span("inner"):
                    raise ValueError("x")
            except ValueError:
                pass
            inside = T.current_span_path()
        return inside, T.current_span_path(), _events(reg)
    ref, got = _both(run, regs)
    assert got == ref and got[:2] == ("outer", "")


def test_chrome_trace_and_jsonl_files(regs, tmp_path):
    def run(T, reg):
        with T.use_trace_context(T.new_trace_context("cd" * 16)):
            with T.span("a"):
                with T.span("b"):
                    pass
        with T.span("untraced"):
            pass
        base = str(tmp_path / T.__name__)
        text = open(reg.write_chrome_trace(base + ".json")).read()
        body = [ln for ln in text.splitlines() if ln not in ("[", "]")]
        one = open(reg.write_trace_jsonl(base + ".jsonl",
                                         trace_id="CD" * 16)).read()
        return ([e["name"] for e in json.loads(text)], len(body),
                [json.loads(ln)["name"] for ln in one.splitlines()])
    ref, got = _both(run, regs)
    assert got == ref == (["b", "a", "untraced"], 3, ["b", "a"])


# ----------------------------------------------------------- trace context
@pytest.mark.parametrize("raw", [
    None, "", "ABCDEF0123456789ABCDEF0123456789", "abcd-ef01-2345-6789",
    "  DEADBEEF  ", "xyz", "1234567", "a" * 64, "a" * 65, 12345678,
    "g" * 32])
def test_trace_ids_normalize_as_the_reference(raw):
    assert P.normalize_trace_id(raw) == J.normalize_trace_id(raw)
    want = J.normalize_trace_id(raw)
    got = P.new_trace_context(raw)
    if want is not None:
        assert got.trace_id == want
    else:
        assert len(got.trace_id) == 32 and \
            P.normalize_trace_id(got.trace_id) == got.trace_id
    assert len(got.span_id) == 16 and got.child().trace_id == got.trace_id


def test_use_trace_context_scopes_events_and_overrides(regs):
    def run(T, reg):
        seen = [T.current_trace_id()]
        with T.use_trace_context(T.new_trace_context("11" * 16)):
            seen.append(T.current_trace_id())
            with T.use_trace_context(None):
                seen.append(T.current_trace_id())
                T.event("untraced")
            T.event("stamped", k=1)
            T.event("other", trace_id="22" * 16)
        seen.append(T.current_trace_id())
        reg.enabled = False
        T.event("dropped")
        reg.enabled = True
        return seen, _events(reg)
    ref, got = _both(run, regs)
    assert got == ref
    assert got[0] == [None, "11" * 16, None, None]
    assert [e["args"].get("trace_id") for e in got[1]] == \
        [None, "11" * 16, "22" * 16]


def test_handoff_adopt_isolates_the_consumer_stack(regs):
    def run(T, reg):
        out = {}
        with T.use_trace_context(T.new_trace_context("33" * 16)):
            with T.span("producer"):
                token = T.handoff()

        def consumer():
            with T.span("consumer_own"):
                with T.adopt(token):
                    out["path_in"] = T.current_span_path()
                    with T.span("work"):
                        out["work"] = T.current_span_path()
                        out["tid"] = T.current_trace_id()
                out["after"] = T.current_span_path()
        t = threading.Thread(target=consumer)
        t.start()
        t.join()
        return out, token.trace_id, _events(reg)
    ref, got = _both(run, regs)
    assert got == ref
    assert got[0] == {"path_in": "", "work": "producer/work",
                      "tid": "33" * 16, "after": "consumer_own"}


def test_threaded_handoff_never_misattributes(regs):
    """Many producers hand work to a pool of consumers: every span lands
    under its own producer's path with its own trace id."""
    reg = regs[1]
    import queue
    q = queue.Queue()

    def producer(i):
        with P.use_trace_context(P.new_trace_context(f"{i + 1:032x}")):
            with P.span(f"p{i}"):
                for _ in range(5):
                    q.put((i, P.handoff()))

    def consumer():
        while True:
            item = q.get()
            if item is None:
                return
            i, token = item
            with P.adopt(token):
                with P.span("job", who=i):
                    time.sleep(0.0005)
    cons = [threading.Thread(target=consumer) for _ in range(4)]
    for c in cons:
        c.start()
    prods = [threading.Thread(target=producer, args=(i,)) for i in range(8)]
    for p in prods:
        p.start()
    for p in prods:
        p.join()
    for _ in cons:
        q.put(None)
    for c in cons:
        c.join()
    jobs = [e for e in reg.trace_events() if e["name"] == "job"]
    assert len(jobs) == 40
    for e in jobs:
        i = e["args"]["who"]
        assert e["args"]["path"] == f"p{i}/job"
        assert e["args"]["trace_id"] == f"{i + 1:032x}"


# ---------------------------------------------------------- flight recorder
def _dumped(T, reg, rec):
    reg.counter("a").inc(3)
    with T.use_trace_context(T.new_trace_context("44" * 16)):
        with T.span("before"):
            rec.note("drain started", why="test")
    first = rec.dump("manual", reason="x", obj=object())
    reg.counter("a").inc(2)
    second = rec.dump("manual")
    d1, d2 = json.load(open(first)), json.load(open(second))
    keys = set(d1) - {"perf"}
    return (sorted(keys), d1["trigger"], sorted(d1["info"]),
            [(e["name"], e.get("cat")) for e in d1["events"]],
            d1["metrics"]["counters"], d1["counter_deltas_since_last_dump"],
            d2["counter_deltas_since_last_dump"],
            sorted(d1["perf"]), os.path.basename(first).split("_")[-1])


def test_flight_recorder_dumps_as_the_reference(regs, recorders):
    ref, got = _dumped(J, regs[0], recorders[0]), \
        _dumped(P, regs[1], recorders[1])
    assert got[:7] == ref[:7]
    # the perf block, the kernel registry's ``kernels`` key included
    assert set(got[7]) == set(ref[7])
    assert got[8] == ref[8] == "manual.json"
    assert got[6] == {"a": 2, "flightrec.dumps": 1}


def test_flight_recorder_capacity_rate_limit_and_pruning(regs, tmp_path):
    reg = regs[1]
    rec = P.FlightRecorder(directory=str(tmp_path / "c"), capacity=3,
                           min_interval_s=60.0, keep_last=2)
    for i in range(10):
        with P.span(f"s{i}"):
            pass
    path = rec.dump("first", force=False)
    assert [e["name"] for e in json.load(open(path))["events"]] == \
        ["s7", "s8", "s9"]
    assert rec.dump("first", force=False) is None and rec.suppressed == 1
    assert rec.dump("other", force=False) is not None   # per trigger
    rec.dump("first")                                    # force bypasses
    assert len(rec.dumps) == 2 and not os.path.exists(path)
    reg.enabled = False
    assert rec.dump("off") is None
    reg.enabled = True


def test_flight_recorder_never_raises_and_tools_read_it(regs, tmp_path,
                                                        monkeypatch):
    rec = P.FlightRecorder(directory=str(tmp_path / "t"))
    with P.use_trace_context(P.new_trace_context("55" * 16)):
        with P.span("fit"):
            with P.span("step"):
                pass
    path = rec.dump("tools")
    out = subprocess.run([sys.executable, "tools/trace2summary.py", path,
                          "--json", "--trace-id", "55" * 16], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "fit/step" in out.stdout
    out = subprocess.run([sys.executable, "tools/trace2timeline.py", path,
                          "--trace-id", "55" * 16], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    monkeypatch.setattr(rec, "_write", lambda *a: 1 / 0)
    assert rec.dump("broken") is None


# -------------------------------------------------------------------- SLOs
def _error_rate(T, reg, rec):
    obj = T.ErrorRateSLO("admission", good="srv.ok", bad="srv.err",
                         target=0.99)
    wd = T.SLOWatchdog([obj], windows=(10.0, 60.0), burn_limits=(10.0, 2.0),
                       registry=reg, flight_recorder=rec)
    rows = []
    reg.counter("srv.ok").inc(1000)
    rows.append(wd.check(now=0.0))
    rows.append(wd.check(now=5.0))
    reg.counter("srv.ok").inc(70)
    reg.counter("srv.err").inc(30)
    rows.append(wd.check(now=8.0))
    reg.counter("srv.ok").inc(5000)
    rows.append(wd.check(now=30.0))
    rows.append(wd.check(now=40.0))
    snap = reg.snapshot()
    return (rows, snap["gauges"], snap["counters"], len(rec.dumps),
            wd.snapshot())


def test_error_rate_slo_decides_as_the_reference(regs, recorders):
    ref = _error_rate(J, regs[0], recorders[0])
    got = _error_rate(P, regs[1], recorders[1])
    assert got[:2] == ref[:2] and got[3:] == ref[3:]
    assert got[2]["slo.breaches"] == ref[2]["slo.breaches"] == 1
    assert got[0][2]["breached"] == ["admission"]
    assert got[0][2]["objectives"]["admission"]["burn_rates"]["10s"] == \
        pytest.approx(30.0, rel=0.01)
    assert not got[0][4]["objectives"]["admission"]["breached"]
    assert got[3] == 1


def _latency(T, reg, rec):
    h = reg.histogram("serving.m.latency_ms")
    wd = T.SLOWatchdog([T.LatencySLO("p99", "serving.m.latency_ms",
                                     threshold_ms=50.0, target=0.9)],
                       windows=(10.0,), burn_limits=(3.0,), registry=reg,
                       flight_recorder=rec)
    out = []
    for v in OBS[:100]:
        h.observe(v)
    out.append(wd.check(now=0.0))
    out.append(wd.check(now=5.0))
    for v in OBS[100:]:
        h.observe(v * 10)
    out.append(wd.check(now=8.0))
    single = T.SLOWatchdog([T.LatencySLO("one", "serving.m.latency_ms",
                                         50.0)], registry=reg,
                           flight_recorder=rec, dump_on_breach=False)
    out.append(single.check(now=0.0))
    return out


def test_latency_slo_and_single_sample_as_the_reference(regs, recorders):
    ref = _latency(J, regs[0], recorders[0])
    got = _latency(P, regs[1], recorders[1])
    assert got == ref
    assert got[2]["objectives"]["p99"]["breached"]
    assert got[3]["breached"] == []


def _throughput(T, reg, rec):
    obj = T.ThroughputSLO("tput", metric="train.windowed_steps_per_sec",
                          baseline=100.0, ratio_floor=0.5, target=0.9,
                          best_of=2)
    wd = T.SLOWatchdog([obj], windows=(10.0,), burn_limits=(2.0,),
                       registry=reg, flight_recorder=rec)
    out = [wd.check(now=0.0)]                          # cold: no sample
    g = reg.gauge("train.windowed_steps_per_sec")
    for t, v in enumerate((95.0, 96.0, 10.0, 9.0, 8.0, 7.0, 97.0, 98.0)):
        g.set(v)
        out.append(wd.check(now=1.0 + t))
    unknown = T.SLOWatchdog([T.ThroughputSLO("u", "train.x", 0.0)],
                            registry=reg, flight_recorder=rec)
    reg.gauge("train.x").set(3.0)
    out.append(unknown.check(now=0.0))
    return out, reg.snapshot()["gauges"]


def test_throughput_slo_as_the_reference(regs, recorders):
    ref = _throughput(J, regs[0], recorders[0])
    got = _throughput(P, regs[1], recorders[1])
    assert got == ref
    assert any(r["breached"] for r in got[0])


def test_watchdog_thread_and_duplicate_names(regs):
    with pytest.raises(ValueError):
        P.SLOWatchdog([P.ErrorRateSLO("a", "g", "b"),
                       P.ErrorRateSLO("a", "g", "b")])
    wd = P.SLOWatchdog([P.ErrorRateSLO("a", "g", "b")]).start(0.01)
    time.sleep(0.1)
    wd.stop()
    assert wd.snapshot()["objectives"]["a"]["good"] == 0.0
    assert P.set_slo_watchdog(wd) is None
    assert P.get_slo_watchdog() is wd
    P.set_slo_watchdog(None)


def _health(loss, gsq, nonfin):
    return np.array([loss, gsq, nonfin], np.float32)


def _watch_rules(T, reg, rec):
    w = T.TrainingWatch(window=1, grad_norm_limit=10.0,
                        loss_spike_factor=5.0, registry=reg,
                        flight_recorder=rec)
    for it in range(6):
        w.on_health(it, _health(1.0, 4.0, 0))
    healthy = w.drain() and w.healthy
    w.on_health(6, _health(1.0, 400.0, 0))
    w.on_health(7, _health(50.0, 4.0, 0))
    w.on_health(8, _health(float("nan"), 4.0, 2))
    w.drain()
    w.close()
    recs = [{k: v for k, v in u.items() if k != "loss"}
            for u in w.unhealthy]
    snap = reg.snapshot()
    return healthy, recs, snap["counters"], snap["gauges"], \
        len(rec.dumps)


def test_training_watch_rules_as_the_reference(regs, recorders):
    ref = _watch_rules(J, regs[0], recorders[0])
    got = _watch_rules(P, regs[1], recorders[1])
    assert got == ref
    assert [u["reason"] for u in got[1]] == ["grad_norm", "loss_spike",
                                            "nonfinite"]


def test_training_watch_window_flush_and_tensor_rows(regs):
    w = P.TrainingWatch(window=8, loss_spike_factor=None,
                        dump_on_unhealthy=False)
    for it in range(7):
        w.on_health(it, torch.tensor([1.0, 1.0, 0.0]))
    assert w._buffered == 7
    w.on_health(7, torch.tensor([1.0, 1.0, 0.0]))
    assert w._buffered == 0
    rows = torch.ones((8, 3))
    rows[:, 2] = 0.0
    rows[3, 2] = 1.0
    rows[3, 0] = float("inf")
    w.on_health(8, rows, k=8)
    assert w.drain() and w.steps_seen == 16
    assert [(u["iteration"], u["reason"]) for u in w.unhealthy] == \
        [(11, "nonfinite")]
    w.close()


@pytest.mark.parametrize("case", ["finite", "inf", "nan_loss", "mixed"])
def test_training_health_vec_matches_the_reference(case):
    import jax.numpy as jnp
    from deeplearning4j_tpu.telemetry.slo import training_health_vec as jvec
    g = np.random.default_rng(7)
    grads = {"w": g.normal(size=(5, 4)).astype(np.float32),
             "b": [g.normal(size=(4,)).astype(np.float32)]}
    loss = np.float32(2.5)
    if case == "inf":
        grads["b"][0][1] = np.inf
    if case == "nan_loss":
        loss = np.float32(np.nan)
    if case == "mixed":
        grads["w"] = grads["w"].astype(np.float64)
    want = np.asarray(jvec(jnp.asarray(loss),
                           {"w": jnp.asarray(grads["w"]),
                            "b": [jnp.asarray(grads["b"][0])]}))
    got = P.training_health_vec(
        torch.tensor(loss), {"w": torch.as_tensor(grads["w"]),
                             "b": [torch.as_tensor(grads["b"][0]), None]})
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# --------------------------------------------------------------------- perf
@pytest.mark.parametrize("flops, nbytes, peak, gbps", [
    (1e12, 1e9, 989.0, 3350.0), (1e9, 1e9, 67.0, 3350.0),
    (0, 1e9, 197.0, 819.0), (5e11, 0, 197.0, 819.0),
    (2.4e12, 3.1e10, 1979.0, 3350.0)])
def test_implied_mfu_and_roofline_at_explicit_peaks(flops, nbytes, peak,
                                                    gbps):
    for dt in (0.0, 1e-3, 0.05):
        assert P.implied_mfu(flops, dt, peak=peak) == \
            J.implied_mfu(flops, dt, peak=peak)
    assert P.classify_roofline(flops, nbytes, peak=peak, gbps=gbps) == \
        J.classify_roofline(flops, nbytes, peak=peak, gbps=gbps)
    if flops:
        assert P.perf.roofline_dt(flops, peak=peak, mfu_ceiling=0.5) == \
            J.perf.roofline_dt(flops, peak=peak, mfu_ceiling=0.5)


def test_no_peak_on_the_cpu_and_no_tpu_default(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_HBM_GBPS", raising=False)
    assert P.perf.peak_tflops() is None and P.perf.hbm_gbps() is None
    assert P.perf.peak_tflops(device="cpu", dtype="float32") is None
    assert P.implied_mfu(1e12, 1.0) is None
    assert P.classify_roofline(1e12, 1e9)["bound"] == "unknown"
    h100 = P.perf.CHIP_PEAKS["NVIDIA H100 80GB HBM3"]
    assert h100["tflops"] == {"bfloat16": 989.0, "float16": 989.0,
                              "float32": 67.0, "int8": 1979.0}
    assert h100["hbm_gbps"] == 3350.0
    assert all(p["tflops"]["bfloat16"] != 197.0
               for p in P.perf.CHIP_PEAKS.values())
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "100")
    assert P.perf.peak_tflops() == 100.0


def _fold(T, reg, idx):
    h = reg.histogram("perf.fit.dispatch_ms")
    idx.register("fit/epoch/window", flops_per_step=2e12,
                 bytes_per_step=4e9, steps_per_call=8,
                 timing_metric="perf.fit.dispatch_ms")
    idx.register("serving.m.bucket8", flops_per_step=1e9,
                 bytes_per_step=1e9, items_per_step=8.0)
    idx.register("tp", flops_per_step=8e12, model_axis_size=4,
                 timing_metric="tp_ms")
    none = idx.register("nothing")
    first = idx.fold(reg)
    for v in (80.0, 120.0):
        h.observe(v)
    reg.histogram("tp_ms").observe(10.0)
    second = idx.fold(reg)
    third = idx.fold(reg)                 # no new timing: last rows
    acct = T.StepAccounting(reg, flush_every=4)
    for i in range(6):
        acct.on_step(input_wait_ms=1.0, compute_ms=8.0 * (i + 1),
                     host_ms=0.5, steps=2)
    acct.flush()
    keep = ("path", "flops_per_step", "bytes_per_step", "steps_per_call",
            "items_per_step", "model_axis_size", "roofline", "intensity",
            "attainable_tflops", "step_ms", "achieved_tflops", "mfu",
            "implausible")
    rows = [[{k: r[k] for k in keep} for r in f]
            for f in (first, second, third)]
    gauges = {n: g for n, g in reg.snapshot()["gauges"].items()
              if n.startswith("perf.")}
    return (none, rows, gauges, T.perf.decomposition_summary(reg),
            idx.train_cost().path, idx.paths())


def test_cost_fold_and_step_accounting_as_the_reference(regs, monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "989")
    monkeypatch.setenv("BENCH_HBM_GBPS", "3350")
    ref = _fold(J, regs[0], J.ProgramCostIndex())
    got = _fold(P, regs[1], P.ProgramCostIndex())
    assert got == ref
    row = got[1][1][0]
    assert row["step_ms"] == pytest.approx(12.5)
    assert row["mfu"] == pytest.approx(2e12 / 12.5e-3 / 1e12 / 989)


def test_count_cost_counts_ops_and_kernels():
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 16)
    with P.count_cost() as c:
        y = (x @ w).relu().sum()
        y.backward()
        P.note_kernel(100.0, torch.zeros(10))
    assert c.flops == 2 * (2 * 4 * 8 * 16)      # forward and dx
    assert c.kernel_flops == 100.0 and c.kernel_bytes == 40.0
    assert c.bytes > 0
    P.note_kernel(5.0, torch.zeros(1))           # no scope: nothing
    assert c.kernel_flops == 100.0
    idx = P.ProgramCostIndex()
    out = idx.count("fit/epoch/step", ("s",), lambda: (x @ w).sum(),
                    timing_metric="perf.step.compute_ms", dtype="float32",
                    device="cpu")
    assert out.shape == ()
    e = idx.get("fit/epoch/step")
    assert e.flops_per_step == 2 * 4 * 8 * 16 and e.source == "counted"
    assert idx.train_cost() is e
    idx.count("fit/epoch/step", ("s",), lambda: (x @ w @ w.T).sum())
    assert idx.get("fit/epoch/step").flops_per_step == 2 * 4 * 8 * 16


def test_perf_baseline_reads_the_trajectory_as_the_reference(tmp_path):
    assert P.PerfBaseline.load_trajectory(ROOT).per_file == \
        J.PerfBaseline.load_trajectory(ROOT).per_file
    art = {"tail": '{"serving_throughput": {"bucketed_req_per_sec": 12.5}, '
                   '"dispatch_bound_steps_per_sec": {"k8_steps_per_sec": 3'}
    (tmp_path / "BENCH_r09.json").write_text(json.dumps(art))
    got = P.PerfBaseline.load_trajectory(str(tmp_path))
    assert got.per_file == J.PerfBaseline.load_trajectory(
        str(tmp_path)).per_file
    assert got.best("serving_throughput") == 12.5
    assert got.best("dispatch_bound_steps_per_sec") is None


def test_perf_dump_rendered_by_the_report_tool(regs, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "989")
    idx = P.ProgramCostIndex()
    idx.register("fit/epoch/window", flops_per_step=2e12,
                 bytes_per_step=4e9, timing_metric="w_ms")
    regs[1].histogram("w_ms").observe(50.0)
    path = P.write_perf_dump(str(tmp_path / "perf.json"), index=idx)
    rec = json.load(open(path))
    assert rec["perf_dump"] == 1 and rec["perf"]["programs"][0]["mfu"]
    out = subprocess.run([sys.executable, "tools/perf_report.py", path],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "fit/epoch/window" in out.stdout


# ------------------------------------------------------------ torchsignals
def test_name_map_covers_the_jax_only_names():
    assert set(P.NAME_MAP) == {"jax.compiles", "jax.compile_ms",
                               "jax.compile_cache_hits",
                               "jax.recompiles_flagged",
                               "jax.host_syncs_flagged", "backend_compile"}
    assert P.NAME_MAP["jax.compile_cache_hits"] is None
    assert not any(n.startswith("jax") for n in P.__all__)
    assert set(J.__all__) - set(P.__all__) == {
        "normalize_cost_analysis", "xla_compile_count",
        "xla_cache_hit_count", "ensure_monitoring_hook"}


def test_recompile_detector_counts_warm_runs_with_span_path(regs, caplog):
    reg = regs[1]
    n0 = P.warm_run_count()
    with P.RecompileDetector(allowed=1) as det:
        with P.span("serve", model="m"):
            P.note_warm_run(0.002)
            P.note_capture(0.003)
    P.note_warm_run(0.001)                    # not armed: not seen
    assert det.count == 2 and det.recompiles == 1
    assert det.events[1]["span_path"] == "serve"
    assert det.events[1]["span_attrs"] == {"model": "m"}
    assert det.events[1]["source"].endswith("in "
                                            "test_recompile_detector_counts_"
                                            "warm_runs_with_span_path")
    assert P.warm_run_count() == n0 + 3
    snap = reg.snapshot()
    assert snap["counters"]["torch.warm_runs"] == 3
    assert snap["counters"]["torch.recompiles_flagged"] == 2
    assert snap["histograms"]["torch.warm_run_ms"]["count"] == 3
    names = [(e["name"], e["cat"], e["args"]["path"])
             for e in reg.trace_events() if e["cat"] == "compile"]
    assert names[:2] == [("warm_run", "compile", "serve"),
                         ("graph_capture", "compile", "serve")]
    assert any("RecompileDetector" in r.getMessage() for r in caplog.records)


def test_host_sync_detector_flags_reads_with_span_path(regs):
    t = torch.arange(6.0)
    with P.HostSyncDetector(action="count") as quiet:
        t[0].item()                              # a CPU read: not a sync
    assert quiet.count == 0
    with P.HostSyncDetector(action="count", include_cpu=True) as det:
        with P.span("step"):
            t[0].item()
            float(t.sum())
            t.tolist()
            bool(t[1])
            int(t[2])
            t.numpy()
            t.to("cpu")                          # CPU onto the CPU: no read
            t.cpu()
    assert det.count == 6
    assert det.events[0]["span_path"] == "step"
    assert regs[1].snapshot()["counters"]["torch.host_syncs_flagged"] == 6
    with pytest.raises(P.HostSyncError):
        with P.HostSyncDetector(action="raise", include_cpu=True):
            t[0].item()


def test_host_sync_detector_is_thread_scoped(regs):
    t = torch.ones(3)
    box = {}
    with P.HostSyncDetector(action="count", include_cpu=True) as det:
        th = threading.Thread(target=lambda: box.update(v=t.sum().item()))
        th.start()
        th.join()
    assert det.count == 0 and box["v"] == 3.0
    with P.HostSyncDetector(action="count", include_cpu=True,
                            thread=th.ident) as other:
        t.sum().item()
    assert other.count == 0


def test_recompile_detector_thread_only_counts_its_own_thread(regs):
    with P.RecompileDetector(allowed=0, warn=False,
                             thread_only=True) as det, \
            P.RecompileDetector(allowed=0, warn=False) as every:
        th = threading.Thread(target=P.note_capture, args=(0.001,))
        th.start()
        th.join()
        P.note_warm_run(0.001)
    assert det.count == 1 and every.count == 2


# the warning torch.cuda.set_sync_debug_mode("warn") raises at a sync
_SYNC_MSG = ("called a synchronizing CUDA operation (Triggered internally "
             "at c10/cuda/CUDAFunctions.cpp)")


def test_host_sync_detector_counts_sync_debug_warnings_of_its_thread(regs):
    import warnings
    with P.HostSyncDetector(action="count", sync_debug=True) as det:
        with P.span("step"):
            warnings.warn(_SYNC_MSG, UserWarning)
            warnings.warn(_SYNC_MSG, UserWarning)    # every one, not once
        th = threading.Thread(
            target=lambda: warnings.warn(_SYNC_MSG, UserWarning))
        th.start()
        th.join()                                    # not the watched one
        with pytest.warns(UserWarning, match="unrelated"):
            warnings.warn("unrelated", UserWarning)  # passed on
    assert det.count == 2
    assert [e["span_path"] for e in det.events] == ["step", "step"]
    assert det.events[0]["shape"] is None
    assert det.events[0]["source"].endswith(
        "in test_host_sync_detector_counts_sync_debug_warnings_of_its_"
        "thread")
    assert regs[1].snapshot()["counters"]["torch.host_syncs_flagged"] == 2
    with pytest.warns(UserWarning, match="synchronizing"):
        warnings.warn(_SYNC_MSG, UserWarning)        # disarmed: shown
    assert det.count == 2
    with pytest.raises(P.HostSyncError, match="synchronising call"):
        with P.HostSyncDetector(action="raise", sync_debug=True):
            warnings.warn(_SYNC_MSG, UserWarning)


def test_host_sync_detector_reads_count_once_and_blocking_copies_only(regs):
    import warnings
    S = importlib.import_module(
        "deeplearning4j_tpu_torch.telemetry.torchsignals")
    assert S._onto_cpu(("cpu",), {})
    assert S._onto_cpu((), {"device": torch.device("cpu")})
    assert not S._onto_cpu(("cpu",), {"non_blocking": True})
    assert not S._onto_cpu(("cpu", torch.float32, True), {})
    assert not S._onto_cpu((torch.float32,), {})
    # a flagged read's own sync warning is not counted a second time
    t = torch.ones(2)
    orig = t.sum
    with P.HostSyncDetector(action="count", include_cpu=True,
                            sync_debug=True) as det:
        S._read(lambda self: (warnings.warn(_SYNC_MSG, UserWarning),
                              orig())[1], t, (), {})
    assert det.count == 1 and det.events[0]["shape"] == (2,)


def test_device_memory_gauges_absent_on_the_cpu(regs):
    assert P.device_memory_gauges() == {}
    assert not any(n.startswith("device")
                   for n in regs[1].snapshot()["gauges"])


# ----------------------------------------------------------------- memprof
def test_memprof_groups_tagged_tensors_by_owner(regs):
    memprof = importlib.import_module(
        "deeplearning4j_tpu_torch.telemetry.memprof")
    memprof.clear_tags()
    params = {"W": torch.zeros(64, 32), "b": torch.zeros(32)}
    pool = torch.zeros(4, 16, 8)
    view = pool[1]
    assert memprof.tag(params, "params") == 2
    with P.span("gen"):
        assert memprof.tag([pool, view]) == 2       # owner: the span path
    snap = memprof.snapshot(top_k=10)
    rows = {(tuple(r["shape"]), r["owner"]): r for r in snap["top"]}
    assert rows[((64, 32), "params")]["total_bytes"] == 64 * 32 * 4
    assert rows[((4, 16, 8), "gen")]["total_bytes"] == 4 * 16 * 8 * 4
    assert rows[((16, 8), "gen")]["total_bytes"] == 0     # a view: once
    assert snap["total_live_bytes"] == (64 * 32 + 32 + 4 * 16 * 8) * 4
    assert snap["live_bytes_by_device"] == {"cpu": snap["total_live_bytes"]}
    assert snap["device_stats"] == {} and snap["live_arrays"] == 4
    gauges = memprof.publish_gauges()
    assert gauges["memprof.live_arrays"] == 4.0
    del params, pool, view
    import gc
    gc.collect()
    assert memprof.snapshot()["live_arrays"] == 0      # weak references
    assert set(memprof.snapshot()) == set(
        ["total_live_bytes", "live_arrays", "live_bytes_by_device",
         "device_stats", "top"])
