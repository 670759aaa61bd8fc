"""FleetCollector: cross-process trace stitching + metrics aggregation.

Counterpart of ``deeplearning4j_tpu/serving/fleet/collector.py``, the same
code over the port's ``telemetry/`` package.

A replica's observability is per-process; the fleet fragments it across N
replica OS processes. The collector is the supervisor-side half that
puts it back together:

- **Trace stitching** — incremental pulls of every replica's trace ring
  over the pooled :class:`~...util.httpjson.HTTPClient`
  (``GET /debug/trace?since_seq=<cursor>``: each replica ships only the
  delta past the collector's watermark), every event stamped with
  ``args.replica`` for attribution. Span timestamps are epoch-anchored
  (telemetry/spans.py ``_EPOCH_NS``), so merging by ``ts`` across
  processes yields a true end-to-end timeline: front-door ingress,
  ``fleet.route`` events, replica ``generation.*`` spans — one request,
  one trace id, one chronology.
- **Black-box recovery** — a DEAD replica cannot answer a pull; its
  last :class:`~..telemetry.spool.TraceSpool` spill is ingested instead
  (events past the cursor only), so a SIGKILLed replica's final spans
  still appear in stitched timelines.
- **Honest aggregation** — per-replica ``/debug/metrics`` raws carry
  cumulative ``le`` buckets, merged by elementwise sum on ONE canonical
  bucket ladder (mismatched ladders raise
  :class:`~..telemetry.registry.HistogramLadderMismatch` — loudly, per
  the merge-correctness pin). Fleet p99 is read off the merged buckets
  (:func:`~..telemetry.registry.bucket_quantile`), never an average of
  per-replica percentiles.
- **Fleet SLOs** — :meth:`FleetCollector.aggregate_registry` is a
  registry-shaped view over the merged data (reads aggregate, writes
  land in the front door's local registry), so the existing
  ``SLOWatchdog`` burn-rate/breach-edge/flight-dump machinery runs
  unmodified at fleet level; :meth:`make_watchdog` wires it, and the
  autoscaler's ``slo_breached`` input reads it.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional

from ...telemetry import get_registry
from ...telemetry.registry import (MetricsRegistry, bucket_quantile,
                                   escape_label_value,
                                   merge_cumulative_buckets,
                                   sanitize_metric_name)
from ...telemetry.slo import SLOWatchdog
from ...telemetry.spool import read_spool
from ...telemetry.tracecontext import normalize_trace_id
from ...util.httpjson import HTTPClient

__all__ = ["FleetCollector", "AggregateRegistry",
           "merge_raw_metrics"]

# the replica label the collector stamps on the supervisor process's own
# events (front-door admission spans, fleet.route markers)
FRONT_DOOR = "front"


def merge_raw_metrics(raws: Dict[str, dict]) -> dict:
    """Fold per-replica ``raw_metrics()`` dicts into fleet aggregates:
    counters summed, histograms merged by elementwise-summed cumulative
    ``le`` buckets (one canonical ladder enforced — mismatches raise),
    gauges kept per-replica (a last-write-wins value has no honest
    fleet-wide sum; consumers read them labelled)."""
    counters: Dict[str, float] = {}
    hists: Dict[str, dict] = {}
    for rid in sorted(raws):
        raw = raws[rid] or {}
        for n, v in (raw.get("counters") or {}).items():
            counters[n] = counters.get(n, 0) + v
        for n, h in (raw.get("histograms") or {}).items():
            bounds = list(h.get("bounds") or ())
            agg = hists.get(n)
            if agg is None:
                hists[n] = {"bounds": bounds,
                            "cumulative": merge_cumulative_buckets(
                                bounds, [h.get("cumulative") or []]),
                            "count": int(h.get("count", 0)),
                            "sum": float(h.get("sum", 0.0))}
                continue
            if bounds != agg["bounds"]:
                from ...telemetry.registry import HistogramLadderMismatch
                raise HistogramLadderMismatch(
                    f"histogram {n!r}: replica {rid!r} observes on ladder "
                    f"{bounds} but the fleet ladder is {agg['bounds']} — "
                    "pin one canonical bucket ladder fleet-wide")
            agg["cumulative"] = merge_cumulative_buckets(
                agg["bounds"], [agg["cumulative"],
                                h.get("cumulative") or []])
            agg["count"] += int(h.get("count", 0))
            agg["sum"] += float(h.get("sum", 0.0))
    return {"counters": counters, "histograms": hists,
            "replicas": sorted(raws)}


# --------------------------------------------------- registry-shaped view
class _AggregateHistogram:
    """Read side of one merged histogram; the SLOWatchdog's LatencySLO
    reads ``count_le_and_total`` exactly like a local Histogram."""

    def __init__(self, collector: "FleetCollector", name: str):
        self._collector = collector
        self.name = name

    def _merged(self) -> dict:
        return self._collector.merged_histogram(self.name)

    @property
    def bounds(self) -> tuple:
        return tuple(self._merged()["bounds"])

    @property
    def count(self) -> int:
        return self._merged()["count"]

    @property
    def sum(self) -> float:
        return self._merged()["sum"]

    def cumulative_buckets(self) -> List[int]:
        return list(self._merged()["cumulative"])

    def count_le_and_total(self, threshold: float):
        m = self._merged()
        bounds, cum = m["bounds"], m["cumulative"]
        if not bounds:
            return 0, 0
        idx = bisect_left(bounds, float(threshold))
        total = cum[-1] if cum else 0
        return (cum[idx] if idx < len(cum) else total), total

    def count_le(self, threshold: float) -> int:
        return self.count_le_and_total(threshold)[0]

    def count_and_sum(self):
        m = self._merged()
        return m["count"], m["sum"]

    def percentiles(self) -> Dict[str, float]:
        m = self._merged()
        return {k: bucket_quantile(m["bounds"], m["cumulative"], q)
                for k, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))}

    def observe(self, v: float) -> None:
        # writes land locally: the front door's own latency samples merge
        # back in through merged_histogram's local fold
        self._collector.local_registry.histogram(self.name).observe(v)

    def stats(self) -> Dict[str, float]:
        m = self._merged()
        p = self.percentiles()
        p["count"] = m["count"]
        p["sum"] = round(m["sum"], 6)
        p["mean"] = m["sum"] / m["count"] if m["count"] else 0.0
        return p


class _AggregateCounter:
    __slots__ = ("_collector", "name")

    def __init__(self, collector: "FleetCollector", name: str):
        self._collector = collector
        self.name = name

    @property
    def value(self):
        agg = self._collector.aggregate()["counters"].get(self.name, 0)
        local = self._collector.local_registry._counters.get(self.name)
        return agg + (local.value if local is not None else 0)

    def inc(self, n: int = 1) -> None:
        self._collector.local_registry.counter(self.name).inc(n)


class AggregateRegistry:
    """Registry-shaped facade over the collector's merged metrics.

    Reads (histogram buckets, counter values) come from the fleet
    aggregate — every replica plus the front door's local registry;
    writes (the watchdog's ``slo.*`` gauges, breach counters) go to the
    local registry, so they surface on the front door's own scrape and
    dashboard. This is the seam that lets ``SLOWatchdog`` run at fleet
    level without a single changed line in slo.py."""

    def __init__(self, collector: "FleetCollector"):
        self._collector = collector

    @property
    def enabled(self) -> bool:
        return self._collector.local_registry.enabled

    def histogram(self, name: str) -> _AggregateHistogram:
        return _AggregateHistogram(self._collector, name)

    def histogram_if_exists(self, name: str):
        if name in self._collector.aggregate()["histograms"] or \
                self._collector.local_registry.histogram_if_exists(name) \
                is not None:
            return _AggregateHistogram(self._collector, name)
        return None

    def counter(self, name: str) -> _AggregateCounter:
        return _AggregateCounter(self._collector, name)

    def gauge(self, name: str):
        return self._collector.local_registry.gauge(name)

    def gauge_if_exists(self, name: str):
        return self._collector.local_registry.gauge_if_exists(name)

    def gauges_matching(self, prefix: str, suffix: str = ""):
        return self._collector.local_registry.gauges_matching(prefix,
                                                              suffix)


# --------------------------------------------------------------- collector
class FleetCollector:
    """Incremental puller + merger for one FleetRouter's replicas.

        collector = FleetCollector(router).start()
        events = collector.events_for_trace(trace_id)
        wd = collector.make_watchdog([LatencySLO(...)])

    ``capacity_per_replica`` bounds the stitched-event memory per
    replica (a deque — old spans age out, the bound is the contract).
    The collector reuses the router's pooled HTTP client by default, so
    pulls ride the same keep-alive sockets as forwards."""

    def __init__(self, router, *, period_s: float = 0.5,
                 capacity_per_replica: int = 16384,
                 client: Optional[HTTPClient] = None,
                 registry: Optional[MetricsRegistry] = None,
                 timeout_s: float = 5.0):
        self.router = router
        self.client = client or router.client
        self.period_s = float(period_s)
        self.capacity_per_replica = int(capacity_per_replica)
        self.timeout_s = float(timeout_s)
        self._local = registry
        self.watchdog: Optional[SLOWatchdog] = None
        self._lock = threading.Lock()
        self._events: Dict[str, deque] = {}
        self._cursors: Dict[str, int] = {}
        self._metrics: Dict[str, dict] = {}     # rid -> raw_metrics
        self._spool_seqs: Dict[str, int] = {}   # rid -> last ingested seq
        self.pulls = 0
        self.events_pulled = 0
        self.pull_errors = 0
        self.spools_recovered = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def local_registry(self) -> MetricsRegistry:
        """The supervisor process's own registry (front-door spans and
        fleet.* metrics live here; watchdog writes land here too)."""
        return self._local if self._local is not None else get_registry()

    # ------------------------------------------------------------- pulling
    def pull_once(self) -> int:
        """One incremental sweep over the membership table. Live
        replicas answer ``/debug/trace`` + ``/debug/metrics``; dead ones
        are recovered from their spool spill. Returns events ingested."""
        self.pulls += 1
        got = 0
        for row in self.router.replicas():
            rid = row["id"]
            if row["state"] == "ready" and row.get("url"):
                got += self._pull_replica(rid, row["url"])
            elif row["state"] == "dead" and row.get("spool_path"):
                got += self.ingest_spool(rid, row["spool_path"])
        self._publish_gauges()
        reg = self.local_registry
        if reg.enabled:
            reg.counter("fleet.collector.pulls").inc()
            if got:
                reg.counter("fleet.collector.events").inc(got)
        return got

    def _pull_replica(self, rid: str, url: str) -> int:
        cursor = self._cursors.get(rid, 0)
        try:
            status, headers, events = self.client.request_ndjson(
                "GET", f"{url}/debug/trace?since_seq={cursor}",
                timeout=self.timeout_s)
            if status != 200:
                raise ConnectionError(f"/debug/trace answered {status}")
            mstatus, metrics = self.client.request_json(
                "GET", f"{url}/debug/metrics", timeout=self.timeout_s)
        except Exception:
            # transport flake: the router's health machinery owns
            # membership — the collector just tries again next period
            self.pull_errors += 1
            return 0
        watermark = int(headers.get("X-Trace-Seq", 0) or 0)
        got = self._ingest(rid, events, watermark)
        if mstatus == 200 and isinstance(metrics, dict):
            with self._lock:
                self._metrics[rid] = metrics
        return got

    def ingest_spool(self, rid: str, path: str) -> int:
        """Black-box recovery: ingest a dead replica's last spill. Only
        events past the HTTP cursor count — a spool that the live pulls
        already covered adds nothing (exactly-once by seq watermark)."""
        spill = read_spool(path)
        if spill is None:
            return 0
        seq = int(spill.get("seq", 0))
        if self._spool_seqs.get(rid) == seq:
            return 0                    # this spill is already ingested
        got = self._ingest(rid, spill.get("events") or [], seq)
        self._spool_seqs[rid] = seq
        if isinstance(spill.get("metrics"), dict):
            with self._lock:
                self._metrics[rid] = spill["metrics"]
        self.spools_recovered += 1
        reg = self.local_registry
        if reg.enabled:
            reg.counter("fleet.collector.spools_recovered").inc()
        return got

    def _ingest(self, rid: str, events: List[dict], watermark: int) -> int:
        cursor = self._cursors.get(rid, 0)
        fresh = []
        for e in events:
            if not isinstance(e, dict) or e.get("seq", 0) <= cursor:
                continue
            e.setdefault("args", {})["replica"] = rid
            fresh.append(e)
        with self._lock:
            dq = self._events.get(rid)
            if dq is None:
                dq = self._events[rid] = deque(
                    maxlen=self.capacity_per_replica)
            dq.extend(fresh)
        top = max([e["seq"] for e in fresh], default=cursor)
        self._cursors[rid] = max(cursor, top, watermark)
        self.events_pulled += len(fresh)
        return len(fresh)

    def _publish_gauges(self) -> None:
        """Per-replica steering summary gauges into the LOCAL registry —
        the dashboard's fleet card and the front-door Prometheus dump
        read these without touching the collector object."""
        reg = self.local_registry
        if not reg.enabled:
            return
        with self._lock:
            raws = dict(self._metrics)
        for rid, raw in raws.items():
            gauges = (raw or {}).get("gauges") or {}
            hit, queue, occ = [], 0.0, []
            for n, g in gauges.items():
                v = (g or {}).get("value", 0.0)
                if n.endswith(".prefix_hit_rate"):
                    hit.append(v)
                elif n.endswith(".queue_depth"):
                    queue += v
                elif n.endswith(".slot_occupancy"):
                    occ.append(v)
            base = f"fleet.replica.{rid}"
            if hit:
                reg.gauge(f"{base}.prefix_hit_rate").set(
                    round(max(hit), 4))
            reg.gauge(f"{base}.queue_depth").set(queue)
            if occ:
                reg.gauge(f"{base}.slot_occupancy").set(
                    round(max(occ), 4))

    # ----------------------------------------------------------- stitching
    def events_for_trace(self, trace_id: str) -> List[dict]:
        """One request's events across every process, chronological.
        Replica events carry their pulled ``args.replica``; the
        supervisor's own events (front-door ingress span, fleet.route)
        are stamped ``front`` on the way out (copies — the local ring is
        never mutated). Epoch-anchored ``ts`` makes the cross-process
        sort meaningful."""
        want = normalize_trace_id(trace_id)
        if want is None:
            return []
        out: List[dict] = []
        with self._lock:
            pools = [list(dq) for dq in self._events.values()]
        for pool in pools:
            out.extend(e for e in pool
                       if e.get("args", {}).get("trace_id") == want)
        for e in self.local_registry.trace_events():
            args = e.get("args", {})
            if args.get("trace_id") == want:
                e = dict(e)
                e["args"] = {**args}
                e["args"].setdefault("replica", FRONT_DOOR)
                out.append(e)
        out.sort(key=lambda e: (e.get("ts", 0), e.get("seq", 0)))
        return out

    def trace_ids(self) -> List[str]:
        """Distinct trace ids currently held (replica pools + local)."""
        ids = set()
        with self._lock:
            pools = [list(dq) for dq in self._events.values()]
        for pool in pools:
            for e in pool:
                tid = e.get("args", {}).get("trace_id")
                if tid:
                    ids.add(tid)
        for e in self.local_registry.trace_events():
            tid = e.get("args", {}).get("trace_id")
            if tid:
                ids.add(tid)
        return sorted(ids)

    # --------------------------------------------------------- aggregation
    def aggregate(self) -> dict:
        """Fleet-merged counters + histograms over the latest per-replica
        raws (see :func:`merge_raw_metrics`; ladder mismatches raise)."""
        with self._lock:
            raws = dict(self._metrics)
        return merge_raw_metrics(raws)

    def merged_histogram(self, name: str) -> dict:
        """One histogram merged across replicas AND the local registry
        (the front door's own ``fleet.latency_ms`` folds in), in raw
        wire format."""
        agg = self.aggregate()["histograms"].get(name)
        local = self.local_registry.histogram_if_exists(name)
        if local is not None:
            raws = {"_local": {"histograms": {name: local.raw()}}}
            if agg is not None:
                raws["_agg"] = {"histograms": {name: agg}}
            agg = merge_raw_metrics(raws)["histograms"][name]
        if agg is None:
            return {"bounds": [], "cumulative": [], "count": 0,
                    "sum": 0.0}
        return agg

    def aggregate_registry(self) -> AggregateRegistry:
        return AggregateRegistry(self)

    def make_watchdog(self, objectives, **kwargs) -> SLOWatchdog:
        """Fleet-level SLOs: the standard watchdog over the aggregate
        view. Burn-rate gauges and breach dumps land in the local
        (front-door) registry/flight recorder; the autoscaler's
        ``watchdog=`` parameter takes the return value directly."""
        self.watchdog = SLOWatchdog(
            objectives, registry=self.aggregate_registry(), **kwargs)
        return self.watchdog

    # ----------------------------------------------------------- exposition
    def to_prometheus_text(self, prefix: str = "dl4j_tpu") -> str:
        """Front-door registry text + per-replica samples with
        ``replica=`` labels + ``fleet_``-prefixed aggregates whose
        histogram buckets are the merged cumulative counts (fleet p99
        quantile queries over these are honest by construction)."""
        san = sanitize_metric_name
        lines = [self.local_registry.to_prometheus_text(prefix).rstrip()]
        with self._lock:
            raws = {rid: self._metrics[rid] for rid in sorted(self._metrics)}
        for rid, raw in raws.items():
            lab = f'replica="{escape_label_value(rid)}"'
            for n, v in sorted((raw.get("counters") or {}).items()):
                lines.append(f"{prefix}_{san(n)}{{{lab}}} {v}")
            for n, g in sorted((raw.get("gauges") or {}).items()):
                lines.append(
                    f"{prefix}_{san(n)}{{{lab}}} {(g or {}).get('value', 0)}")
            for n, h in sorted((raw.get("histograms") or {}).items()):
                full = f"{prefix}_{san(n)}"
                cum = h.get("cumulative") or []
                total = cum[-1] if cum else h.get("count", 0)
                for bound, cnt in zip(h.get("bounds") or (), cum):
                    le = escape_label_value(f"{float(bound):g}")
                    lines.append(
                        f'{full}_bucket{{{lab},le="{le}"}} {cnt}')
                lines.append(f'{full}_bucket{{{lab},le="+Inf"}} {total}')
                lines.append(f"{full}_sum{{{lab}}} {h.get('sum', 0.0)}")
                lines.append(f"{full}_count{{{lab}}} {total}")
        agg = merge_raw_metrics(raws)
        for n, v in sorted(agg["counters"].items()):
            full = f"{prefix}_fleet_{san(n)}"
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {v}")
        for n, h in sorted(agg["histograms"].items()):
            full = f"{prefix}_fleet_{san(n)}"
            lines.append(f"# TYPE {full} histogram")
            cum = h["cumulative"]
            total = cum[-1] if cum else 0
            for bound, cnt in zip(h["bounds"], cum):
                le = escape_label_value(f"{float(bound):g}")
                lines.append(f'{full}_bucket{{le="{le}"}} {cnt}')
            lines.append(f'{full}_bucket{{le="+Inf"}} {total}')
            lines.append(f"{full}_sum {h['sum']}")
            lines.append(f"{full}_count {total}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Collector health for ``GET /metrics``'s ``collector`` key and
        the fleet_report tool."""
        with self._lock:
            per = {rid: {"events": len(dq),
                         "cursor": self._cursors.get(rid, 0)}
                   for rid, dq in self._events.items()}
        return {"pulls": self.pulls,
                "events_pulled": self.events_pulled,
                "pull_errors": self.pull_errors,
                "spools_recovered": self.spools_recovered,
                "period_s": self.period_s,
                "traces": len(self.trace_ids()),
                "per_replica": per}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetCollector":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="fleet-collector")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.pull_once()
            except Exception:           # pragma: no cover - keep pulling
                self.pull_errors += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
