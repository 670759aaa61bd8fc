"""The port's fleet observability (``serving/fleet/collector.py``): merge
math, collector, fleet SLOs. The reference's
``tests/test_fleet_collector.py`` case by case, on the port's telemetry
and its ``GenerationEngine`` on the CPU, plus ``merge_raw_metrics`` and
the bucket merge beside the JAX package's on the same samples. The
reference's ``test_fleet_collector_overhead_bench_smoke`` is a wall-clock
guard that drives the JAX package's ``bench.py``; it is not ported.

The merge-correctness contract is pinned here against the one honest
baseline there is: a single registry that observed every sample. Fleet
p99 computed off elementwise-summed cumulative ``le`` buckets must EQUAL
the single-registry bucket computation (same nearest-rank convention,
same ladder) — an averaged-percentile shortcut would fail this test.
Also covered: bucket-ladder mismatch refusal, the collector's
cursor/attribution/spool-recovery mechanics over synthetic spools, the
registry-shaped aggregate view driving an unmodified SLOWatchdog (and
through it the autoscaler's ``slo_breached`` input), Prometheus
exposition with ``replica=`` labels + ``fleet_`` aggregates, an
in-process end-to-end pull through real HTTP replicas, and the
trace2timeline/fleet_report tool surfaces. True multi-PROCESS stitching
(separate registries per OS process, SIGKILL spool recovery) lives in
tests/test_fleet_process.py.
"""
import _torch_threads  # noqa: F401
import json
import os
import sys
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.telemetry import (HistogramLadderMismatch,
                                                LatencySLO, MetricsRegistry,
                                                TraceSpool, bucket_quantile,
                                                merge_cumulative_buckets)
from _torch_flightrec import _port_flightrec_dir  # noqa: F401
from deeplearning4j_tpu_torch.serving.fleet import (FleetCollector,
                                                    FleetRouter,
                                                    merge_raw_metrics)
from deeplearning4j_tpu_torch.serving.fleet.collector import FRONT_DOOR
from deeplearning4j_tpu_torch.util.httpjson import HTTPClient

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TID = "deadbeef0123"            # valid wire-format trace id (hex, 8-64)


@pytest.fixture
def fresh_registry():
    reg = MetricsRegistry(enabled=True)
    prev = telemetry.set_registry(reg)
    try:
        yield reg
    finally:
        telemetry.set_registry(prev)


class StubRouter:
    """Just enough router for the collector: a membership table + a
    pooled client."""

    def __init__(self, rows=()):
        self.rows = [dict(r) for r in rows]
        self.client = HTTPClient(max_per_host=2, timeout=5.0)

    def replicas(self):
        return [dict(r) for r in self.rows]

    def metrics(self):
        return {"replicas": {
            r["id"]: dict(r, steering=r.get("steering", {}))
            for r in self.rows}}


def _observing(samples, extra_counters=()):
    reg = MetricsRegistry(enabled=True)
    h = reg.histogram("generation.lm.ttft_ms")
    for v in samples:
        h.observe(float(v))
    for name, n in extra_counters:
        reg.counter(name).inc(n)
    return reg


def _event(seq_hint, name, ts, trace_id=TID, **args):
    return {"name": name, "ph": "i", "ts": ts, "cat": "event",
            "args": {"trace_id": trace_id, **args}}


# ------------------------------------------------------------- merge math
def test_fleet_quantile_equals_single_registry_pin():
    """THE regression pin: p50/p95/p99 off merged cumulative buckets ==
    the same computation on one registry that saw every sample."""
    a = [1.0, 3.0, 9.0, 40.0] * 25             # 100 samples
    b = [220.0, 800.0, 4000.0] * 40             # 120 samples, other tail
    ra, rb = _observing(a), _observing(b)
    rall = _observing(a + b)
    merged = merge_raw_metrics(
        {"r0": ra.raw_metrics(), "r1": rb.raw_metrics()}
    )["histograms"]["generation.lm.ttft_ms"]
    single = rall.raw_metrics()["histograms"]["generation.lm.ttft_ms"]
    assert merged["bounds"] == single["bounds"]
    assert merged["cumulative"] == single["cumulative"]
    assert merged["count"] == single["count"] == 220
    assert merged["sum"] == pytest.approx(single["sum"])
    for q in (0.5, 0.95, 0.99):
        assert bucket_quantile(merged["bounds"], merged["cumulative"], q) \
            == bucket_quantile(single["bounds"], single["cumulative"], q)


def test_merge_sums_counters_and_keeps_gauges_out():
    raws = {"r0": _observing([1.0], [("fleet.ok", 3)]).raw_metrics(),
            "r1": _observing([2.0], [("fleet.ok", 4)]).raw_metrics()}
    agg = merge_raw_metrics(raws)
    assert agg["counters"]["fleet.ok"] == 7
    assert agg["replicas"] == ["r0", "r1"]
    assert "gauges" not in agg      # no honest fleet-wide gauge sum


def test_merge_refuses_ladder_mismatch_loudly():
    good = _observing([5.0]).raw_metrics()
    bad = _observing([5.0]).raw_metrics()
    h = bad["histograms"]["generation.lm.ttft_ms"]
    h["bounds"] = h["bounds"][:-1] + [99999.0]      # different ladder
    with pytest.raises(HistogramLadderMismatch) as ei:
        merge_raw_metrics({"r0": good, "r1": bad})
    assert "r1" in str(ei.value)                    # names the offender
    with pytest.raises(HistogramLadderMismatch):
        merge_cumulative_buckets([1.0, 2.0], [[1, 2, 3], [1, 2]])


# -------------------------------------------------- collector mechanics
def test_collector_ingests_spool_with_cursor_and_attribution(tmp_path):
    vic = MetricsRegistry(enabled=True)
    for i in range(3):
        vic.record_event(_event(i, f"gen.step{i}", 1000 + i))
    vic.histogram("generation.lm.ttft_ms").observe(7.0)
    vic.gauge("generation.lm.queue_depth").set(2.0)
    vic.gauge("generation.lm.prefix_hit_rate").set(0.75)
    path = str(tmp_path / "replica-r0.spool.json")
    TraceSpool(path, replica_id="r0", registry=vic).flush(force=True)

    router = StubRouter([{"id": "r0", "state": "dead", "url": None,
                          "spool_path": path}])
    local = MetricsRegistry(enabled=True)
    col = FleetCollector(router, registry=local)
    try:
        assert col.pull_once() == 3
        assert col.spools_recovered == 1
        # exactly-once by seq watermark: the same spill adds nothing
        assert col.pull_once() == 0
        assert col.spools_recovered == 1
        events = col.events_for_trace(TID)
        assert [e["name"] for e in events] == ["gen.step0", "gen.step1",
                                               "gen.step2"]
        assert all(e["args"]["replica"] == "r0" for e in events)
        # the victim's metrics joined the aggregate
        agg = col.aggregate()
        assert agg["histograms"]["generation.lm.ttft_ms"]["count"] == 1
        # per-replica steering gauges published into the LOCAL registry
        assert local.gauge_if_exists(
            "fleet.replica.r0.prefix_hit_rate").value == 0.75
        assert local.gauge_if_exists(
            "fleet.replica.r0.queue_depth").value == 2.0
        snap = col.snapshot()
        assert snap["spools_recovered"] == 1
        assert snap["per_replica"]["r0"]["events"] == 3
        assert snap["traces"] == 1
    finally:
        col.stop()
        router.client.close()


def test_stitching_merges_local_front_door_events(tmp_path):
    vic = MetricsRegistry(enabled=True)
    vic.record_event(_event(0, "generation.admit", 2000))
    path = str(tmp_path / "replica-r1.spool.json")
    TraceSpool(path, replica_id="r1", registry=vic).flush(force=True)
    router = StubRouter([{"id": "r1", "state": "dead", "url": None,
                          "spool_path": path}])
    local = MetricsRegistry(enabled=True)
    local.record_event(_event(0, "fleet.request", 1000))   # earlier ts
    col = FleetCollector(router, registry=local)
    try:
        col.pull_once()
        events = col.events_for_trace(TID)
        assert [e["name"] for e in events] == ["fleet.request",
                                               "generation.admit"]
        assert events[0]["args"]["replica"] == FRONT_DOOR
        assert events[1]["args"]["replica"] == "r1"
        # the local ring itself was NOT mutated by the stamping
        assert "replica" not in local.trace_events()[0]["args"]
    finally:
        col.stop()
        router.client.close()


# -------------------------------------------- aggregate registry + SLOs
def test_fleet_watchdog_and_autoscaler_wiring(tmp_path):
    """An unmodified SLOWatchdog over the aggregate view breaches on
    fleet-wide bad latency, writes its gauges into the LOCAL registry,
    and feeds the autoscaler's ``slo_breached`` observation."""
    from deeplearning4j_tpu_torch.serving.fleet import Autoscaler

    rows = []
    for rid, lat in (("r0", 900.0), ("r1", 950.0)):
        reg = MetricsRegistry(enabled=True)
        for _ in range(50):
            reg.histogram("generation.lm.ttft_ms").observe(lat)
        path = str(tmp_path / f"replica-{rid}.spool.json")
        TraceSpool(path, replica_id=rid, registry=reg).flush(force=True)
        rows.append({"id": rid, "state": "dead", "url": None,
                     "spool_path": path})
    router = StubRouter(rows)
    local = MetricsRegistry(enabled=True)
    col = FleetCollector(router, registry=local)
    try:
        col.pull_once()
        areg = col.aggregate_registry()
        h = areg.histogram("generation.lm.ttft_ms")
        good, total = h.count_le_and_total(50.0)
        assert (good, total) == (0, 100)        # every sample is bad
        wd = col.make_watchdog(
            [LatencySLO("fleet_ttft", "generation.lm.ttft_ms",
                        threshold_ms=50.0, target=0.99)],
            dump_on_breach=False)
        # anchor sample times to the monotonic clock: Autoscaler.observe()
        # re-runs check() at real time.monotonic(), so synthetic epochs
        # would fall outside the burn windows
        t0 = time.monotonic()
        wd.check(now=t0 - 45.0)                 # seed the baseline
        for _ in range(100):
            col.local_registry.histogram("generation.lm.ttft_ms") \
               .observe(900.0)                  # front door sees it too
        out = wd.check(now=t0)                  # 60s window 75% covered
        assert "fleet_ttft" in out["breached"]
        # watchdog side effects landed in the local registry
        assert local.gauge_if_exists("slo.fleet_ttft.breached").value == 1
        assert local.counter("slo.breaches").value >= 1
        scaler = Autoscaler(router, spec_factory=lambda i: None,
                            watchdog=wd)
        obs = scaler.observe()
        assert obs["slo_breached"] is True
        assert "fleet_ttft" in obs["breached"]
    finally:
        col.stop()
        router.client.close()


def test_prometheus_text_labels_and_fleet_aggregates(tmp_path):
    regs = {"r0": _observing([1.0, 40.0], [("requests", 2)]),
            "r1": _observing([800.0], [("requests", 1)])}
    rows = []
    for rid, reg in regs.items():
        path = str(tmp_path / f"replica-{rid}.spool.json")
        TraceSpool(path, replica_id=rid, registry=reg).flush(force=True)
        rows.append({"id": rid, "state": "dead", "url": None,
                     "spool_path": path})
    router = StubRouter(rows)
    local = MetricsRegistry(enabled=True)
    col = FleetCollector(router, registry=local)
    try:
        col.pull_once()
        text = col.to_prometheus_text()
        # per-replica samples carry replica= labels
        assert 'dl4j_tpu_requests{replica="r0"} 2' in text
        assert 'dl4j_tpu_requests{replica="r1"} 1' in text
        assert 'dl4j_tpu_generation_lm_ttft_ms_bucket{replica="r0",' \
            in text
        # fleet aggregates: summed counter + merged bucket series
        assert "dl4j_tpu_fleet_requests 3" in text
        assert "# TYPE dl4j_tpu_fleet_generation_lm_ttft_ms histogram" \
            in text
        assert 'dl4j_tpu_fleet_generation_lm_ttft_ms_bucket{le="+Inf"} 3' \
            in text
        assert "dl4j_tpu_fleet_generation_lm_ttft_ms_count 3" in text
        # the merged bucket series reproduces the honest fleet quantile
        merged = col.merged_histogram("generation.lm.ttft_ms")
        single = _observing([1.0, 40.0, 800.0]).histogram(
            "generation.lm.ttft_ms").raw()
        assert merged["cumulative"] == single["cumulative"]
    finally:
        col.stop()
        router.client.close()


# --------------------------------------------------- in-process end to end
@pytest.fixture(scope="module")
def live_replica():
    """One real single-process replica (GenerationEngine behind
    ServingHTTPServer) — the /debug/trace + /debug/metrics surface under
    a real HTTP client."""
    from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
    from deeplearning4j_tpu_torch.serving import ServingHTTPServer
    from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
    net = transformer_lm(vocab_size=29, d_model=16, n_heads=2, n_blocks=1,
                         max_length=32, seed=7, dtype="float32",
                         token_input=True, device="cpu").init()
    eng = GenerationEngine(net, model_name="lm", block_len=8,
                           max_seq_len=32, decode_slots=2,
                           prefill_batches=(1,), prompt_rungs=(32,),
                           device="cpu")
    srv = ServingHTTPServer(generation=eng)
    url = f"http://127.0.0.1:{srv.start()}"
    yield url
    srv.stop()
    eng.stop(drain=False, timeout=5.0)


def test_debug_trace_route_serves_ndjson_deltas(live_replica,
                                                fresh_registry):
    client = HTTPClient(max_per_host=1, timeout=10.0)
    try:
        status, body = client.request_json(
            "POST", live_replica + "/generate",
            payload={"prompt": [1, 2, 3], "max_tokens": 3,
                     "stream": False},
            headers={"X-Trace-Id": TID})
        assert status == 200
        status, headers, events = client.request_ndjson(
            "GET", live_replica + "/debug/trace?since_seq=0")
        assert status == 200
        assert headers.get("Content-Type") == "application/x-ndjson"
        watermark = int(headers["X-Trace-Seq"])
        assert watermark == fresh_registry.last_seq > 0
        assert any(e.get("args", {}).get("trace_id") == TID
                   for e in events)
        seqs = [e["seq"] for e in events]
        assert seqs == sorted(seqs)
        # cursoring: pulling past the watermark returns nothing
        status, _, rest = client.request_ndjson(
            "GET",
            f"{live_replica}/debug/trace?since_seq={watermark}")
        assert status == 200 and rest == []
        status, _, _ = client.request_ndjson(
            "GET", live_replica + "/debug/trace?since_seq=bogus")
        assert status == 400
        status, raw = client.request_json(
            "GET", live_replica + "/debug/metrics")
        assert status == 200
        assert "generation.lm.ttft_ms" in raw["histograms"]
    finally:
        client.close()


def test_collector_pulls_live_replica_and_front_door_routes(
        live_replica, fresh_registry, tmp_path):
    """Real HTTP pull path + the fleet front door's collector routes
    (/debug/trace/<id> stitched JSON, /metrics/prometheus, /metrics slo
    + collector keys). The collector gets its OWN local registry so the
    shared-process registry does not double as both sides."""
    from deeplearning4j_tpu_torch.serving.fleet.http import FleetHTTPServer
    router = FleetRouter(policy="round_robin", health_period_s=3600.0)
    local = MetricsRegistry(enabled=True)
    col = FleetCollector(router, registry=local)
    front = FleetHTTPServer(router, collector=col)
    port = front.start()
    client = HTTPClient(max_per_host=2, timeout=10.0)
    try:
        router.add_url(live_replica, "f0")
        status, body = client.request_json(
            "POST", f"http://127.0.0.1:{port}/generate",
            payload={"prompt": [2, 3, 4], "max_tokens": 3,
                     "stream": False},
            headers={"X-Trace-Id": TID})
        assert status == 200 and body["replica"] == "f0"
        got = col.pull_once()
        assert got > 0 and col.pull_errors == 0
        cursor = col.snapshot()["per_replica"]["f0"]["cursor"]
        assert col.pull_once() == 0     # cursor: no re-pull of old spans
        assert col.snapshot()["per_replica"]["f0"]["cursor"] >= cursor
        # stitched download through the front door
        status, stitched = client.request_json(
            "GET", f"http://127.0.0.1:{port}/debug/trace/{TID}")
        assert status == 200 and stitched["trace_id"] == TID
        names = [e["name"] for e in stitched["events"]]
        assert any(n.startswith("generation.") for n in names)
        assert all(e["args"]["replica"] == "f0"
                   for e in stitched["events"])
        status, listing = client.request_json(
            "GET", f"http://127.0.0.1:{port}/debug/trace")
        assert status == 200 and TID in listing["traces"]
        status, _, data = client.request(
            "GET", f"http://127.0.0.1:{port}/metrics/prometheus")
        text = data.decode()
        assert status == 200
        assert 'replica="f0"' in text and "dl4j_tpu_fleet_" in text
        col.make_watchdog([LatencySLO(
            "fleet_ttft", "generation.lm.ttft_ms",
            threshold_ms=60000.0, target=0.5)], dump_on_breach=False)
        status, m = client.request_json(
            "GET", f"http://127.0.0.1:{port}/metrics")
        assert status == 200
        assert m["collector"]["pulls"] >= 2
        assert "fleet_ttft" in m["slo"]["objectives"]
        # 404 for an unknown trace id
        status, _ = client.request_json(
            "GET", f"http://127.0.0.1:{port}/debug/trace/{'ab' * 8}")
        assert status == 404
    finally:
        client.close()
        front.stop()
        col.stop()
        router.stop()
        # replicas are externally managed here: close only the client
        router.client.close()


# ------------------------------------------------------------ tool surface
def test_trace2timeline_merges_spools_with_replica_column(tmp_path,
                                                          capsys):
    from tools.trace2timeline import (format_timeline, list_traces,
                                      load_merged, main, timeline)
    front = {"replica": "", "events": [
        _event(0, "fleet.request", 1000),
        _event(0, "fleet.route", 1500, target="f0")]}
    spool = {"spool": 1, "replica": "f0", "seq": 2, "events": [
        _event(0, "generation.admit", 2000),
        _event(0, "generation.prefill", 3000)]}
    fp = tmp_path / "front.json"
    sp = tmp_path / "replica-f0.spool.json"
    fp.write_text(json.dumps(front))
    sp.write_text(json.dumps(spool))

    events = load_merged([str(fp), str(sp)])
    rows = timeline(events, TID)
    assert [r["name"] for r in rows] == ["fleet.request", "fleet.route",
                                         "generation.admit",
                                         "generation.prefill"]
    assert [r["replica"] for r in rows] == ["", "", "f0", "f0"]
    text = format_timeline(rows)
    assert "replica" in text.splitlines()[0]
    listing = list_traces(events)
    assert listing[0]["replicas"] == ["f0"]
    # CLI accepts multiple files
    assert main([str(fp), str(sp), "--trace-id", TID]) == 0
    out = capsys.readouterr().out
    assert "generation.prefill" in out and "f0" in out


def test_fleet_report_renders_slo_and_collector_sections(tmp_path):
    """The port collector's snapshot and its watchdog's check render in
    ``tools/fleet_report.py``'s SLO and collector sections."""
    from tools.fleet_report import fold, render
    reg = _observing([900.0] * 50)
    path = str(tmp_path / "replica-f0.spool.json")
    TraceSpool(path, replica_id="f0", registry=reg).flush(force=True)
    router = StubRouter([{"id": "f0", "state": "dead", "url": None,
                          "spool_path": path}])
    col = FleetCollector(router, registry=MetricsRegistry(enabled=True))
    try:
        col.pull_once()
        wd = col.make_watchdog([LatencySLO(
            "fleet_ttft", "generation.lm.ttft_ms", threshold_ms=50.0,
            target=0.99)], dump_on_breach=False)
        t0 = time.monotonic()
        wd.check(now=t0 - 45.0)
        col.local_registry.histogram("generation.lm.ttft_ms").observe(900.0)
        slo = wd.check(now=t0)
        text = render(fold({"policy": "affinity", "block_len": 8,
                            "replicas": {"f0": {"state": "dead",
                                                "steering": {}}},
                            "replica_metrics": {}, "slo": slo,
                            "collector": col.snapshot()}))
    finally:
        col.stop()
        router.client.close()
    assert "fleet SLOs:" in text and "fleet_ttft: target=0.99" in text
    assert "BREACHED" in text
    assert "collector: pulls=1" in text and "spools_recovered=1" in text


# ------------------------------------------------ beside the JAX package
def _jax_observing(samples, extra_counters=()):
    from deeplearning4j_tpu.telemetry import MetricsRegistry as JReg
    reg = JReg(enabled=True)
    h = reg.histogram("generation.lm.ttft_ms")
    for v in samples:
        h.observe(float(v))
    for name, n in extra_counters:
        reg.counter(name).inc(n)
    return reg


def test_merge_raw_metrics_equals_the_references():
    """The same samples observed by each package's registries merge into
    the same fleet counters, buckets, count and quantiles."""
    from deeplearning4j_tpu.serving.fleet import merge_raw_metrics as jmerge
    from deeplearning4j_tpu.telemetry import bucket_quantile as jquantile
    rng = np.random.default_rng(67)
    samples = {rid: rng.lognormal(3.0, 1.5, size=n).tolist()
               for rid, n in (("r0", 40), ("r1", 75), ("r2", 9))}
    counters = {rid: [("fleet.ok", i + 2)] for i, rid in
                enumerate(samples)}
    mine = merge_raw_metrics({rid: _observing(v, counters[rid])
                              .raw_metrics()
                              for rid, v in samples.items()})
    theirs = jmerge({rid: _jax_observing(v, counters[rid]).raw_metrics()
                     for rid, v in samples.items()})
    assert mine["counters"] == theirs["counters"]
    assert mine["replicas"] == theirs["replicas"]
    h, jh = (m["histograms"]["generation.lm.ttft_ms"]
             for m in (mine, theirs))
    assert h["bounds"] == jh["bounds"]
    assert h["cumulative"] == jh["cumulative"]
    assert h["count"] == jh["count"] == 124
    assert h["sum"] == pytest.approx(jh["sum"])
    for q in (0.5, 0.9, 0.99):
        assert bucket_quantile(h["bounds"], h["cumulative"], q) == \
            jquantile(jh["bounds"], jh["cumulative"], q)


def test_bucket_merge_equals_the_references():
    from deeplearning4j_tpu.telemetry import \
        merge_cumulative_buckets as jmerge_buckets
    bounds = [1.0, 5.0, 25.0, 125.0]
    rows = [[0, 2, 3, 3, 4], [1, 1, 5, 9, 9], [0, 0, 0, 2, 7]]
    assert merge_cumulative_buckets(bounds, rows) == \
        jmerge_buckets(bounds, rows)
    for bad in ([[1, 2, 3], [1, 2]], [[1, 2, 3, 4, 5, 6]]):
        with pytest.raises(HistogramLadderMismatch):
            merge_cumulative_buckets(bounds, bad)
