"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``deeplearning4j_tpu/telemetry/registry.py`` (pure host
code, copied whole, not imported): ``Counter``, ``Gauge`` with its
high-watermark, ``Histogram`` with the ``le`` bucket ladder
(``DEFAULT_BUCKET_BOUNDS``), ``bucket_quantile``,
``merge_cumulative_buckets`` and ``HistogramLadderMismatch``, and
``MetricsRegistry`` (``raw_metrics``, ``to_prometheus_text``,
``record_event`` with the bounded, sequence-stamped trace buffer,
``write_chrome_trace``, ``write_trace_jsonl``, ``publish`` to a
StatsStorage backend), ``get_registry`` / ``set_registry``. The
process-wide registry is on by default, as the reference's is.

Recording is lock-light and never touches a device value: a counter or
gauge takes one small lock, a histogram appends to a bounded ring and
sorts only at snapshot time. ``enabled=False`` turns every accessor into
a shared null object, so a disabled registry is a near no-op. No
deliberate differences.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "HistogramLadderMismatch", "bucket_quantile",
           "merge_cumulative_buckets", "get_registry", "set_registry"]


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


# Prometheus-conformant histogram buckets (``le`` upper bounds, ms-scaled:
# most histograms here are latencies in milliseconds). Cumulative counts
# are maintained in observe() — unlike the percentile ring these are
# LIFETIME totals, the semantics scrapers expect.
DEFAULT_BUCKET_BOUNDS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                         250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
                         30000.0, 60000.0)


class HistogramLadderMismatch(ValueError):
    """Two histograms with different ``le`` bucket ladders cannot be
    merged: summing misaligned cumulative buckets would silently produce
    a wrong fleet p99. The fleet collector refuses loudly instead —
    every replica must observe on the one canonical ladder
    (:data:`DEFAULT_BUCKET_BOUNDS`) or declare its own fleet-wide."""


def merge_cumulative_buckets(bounds, cumulative_lists) -> List[int]:
    """Elementwise sum of cumulative ``le`` bucket counts from N
    histograms that all share ``bounds`` (each list is ``len(bounds)+1``
    long, last entry == +Inf == lifetime count). Mismatched lengths
    raise :class:`HistogramLadderMismatch` — merge math is only honest
    on one ladder."""
    want = len(bounds) + 1
    out = [0] * want
    for cum in cumulative_lists:
        if len(cum) != want:
            raise HistogramLadderMismatch(
                f"cumulative bucket list of length {len(cum)} does not "
                f"fit a {len(bounds)}-bound ladder (want {want})")
        for i, c in enumerate(cum):
            out[i] += int(c)
    return out


def bucket_quantile(bounds, cumulative, q: float) -> float:
    """Quantile estimate from cumulative ``le`` buckets: the smallest
    bound whose cumulative count covers ``q`` of the total (observations
    past the last bound report that bound — the ladder's honest ceiling).
    This is THE fleet p99: computed on merged buckets it equals the
    single-registry computation on the same observations exactly,
    because both reduce to the same integer rank lookup."""
    if not bounds or not cumulative:
        return 0.0
    total = cumulative[-1]
    if total <= 0:
        return 0.0
    # nearest-rank on the cumulative counts: rank in [1, total]
    rank = max(1, min(total, int(round(q * (total - 1))) + 1))
    for bound, cnt in zip(bounds, cumulative):
        if cnt >= rank:
            return float(bound)
    return float(bounds[-1])


def escape_label_value(v) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double-quote and newline must be escaped inside the quotes."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def sanitize_metric_name(name: str) -> str:
    """Dots/dashes -> underscores: one sanitizer for every exposition
    surface (the registry's own dump AND the fleet collector's merged
    dump must agree on names or dashboards see two series)."""
    return "".join(ch if (ch.isalnum() or ch == "_") else "_"
                   for ch in name)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins value, with a monotone high-watermark (the lock
    keeps ``max`` from regressing under concurrent writers)."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        """High watermark since creation (device-memory gauges report this)."""
        return self._max


class Histogram:
    """Bounded ring of recent observations; percentiles computed lazily at
    snapshot time (p50/p95/p99), plus lifetime count/sum and cumulative
    ``le``-bucket counts (Prometheus histogram semantics; also what the
    SLO watchdog's latency objectives read via :meth:`count_le`)."""

    __slots__ = ("name", "_ring", "_count", "_sum", "_lock", "_bounds",
                 "_bucket_counts")

    def __init__(self, name: str, window: int = 4096,
                 bounds: tuple = DEFAULT_BUCKET_BOUNDS):
        self.name = name
        self._ring: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._bounds = tuple(float(b) for b in bounds)
        # non-cumulative per-bucket tallies (+1 slot for > last bound);
        # cumulated lazily at read time so observe() stays one index + add
        self._bucket_counts = [0] * (len(self._bounds) + 1)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._ring.append(v)
            self._count += 1
            self._sum += v
            self._bucket_counts[bisect_left(self._bounds, v)] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def count_and_sum(self) -> tuple:
        """(lifetime count, lifetime sum) under ONE lock — delta-based
        consumers (the perf fold) must not tear the pair against a
        concurrent observe()."""
        with self._lock:
            return self._count, self._sum

    @property
    def bounds(self) -> tuple:
        return self._bounds

    def cumulative_buckets(self) -> List[int]:
        """Cumulative count per ``le`` bound (last entry == +Inf == count)."""
        with self._lock:
            out, acc = [], 0
            for c in self._bucket_counts:
                acc += c
                out.append(acc)
        return out

    def count_le(self, threshold: float) -> int:
        """Lifetime observations <= the smallest bucket bound covering
        ``threshold`` (exact when the threshold IS a bound — pick SLO
        thresholds from the bucket grid for exact accounting)."""
        return self.count_le_and_total(threshold)[0]

    def count_le_and_total(self, threshold: float) -> tuple:
        """(count_le, lifetime_count) read under ONE lock — the SLO
        watchdog's good/bad split must come from a consistent snapshot
        (two separate reads racing observe() would mint phantom bad
        observations and poison the window baselines)."""
        idx = bisect_left(self._bounds, float(threshold))
        with self._lock:
            return sum(self._bucket_counts[:idx + 1]), self._count

    def raw(self) -> dict:
        """Wire-format export for cross-process aggregation (the fleet
        collector's ``/debug/metrics`` pull): bounds + cumulative ``le``
        buckets + lifetime count/sum, all under ONE lock so the merge
        math never sees a torn (buckets, count) pair."""
        with self._lock:
            cum, acc = [], 0
            for c in self._bucket_counts:
                acc += c
                cum.append(acc)
            return {"bounds": list(self._bounds), "cumulative": cum,
                    "count": self._count, "sum": self._sum}

    def percentiles(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._ring)
        return {"p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99)}

    def stats(self) -> Dict[str, float]:
        p = self.percentiles()
        p["count"] = self._count
        p["sum"] = round(self._sum, 6)
        p["mean"] = self._sum / self._count if self._count else 0.0
        return p


class _NullCounter:
    __slots__ = ()
    name = "<disabled>"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = "<disabled>"
    value = 0.0
    max = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = "<disabled>"
    count = 0
    sum = 0.0
    bounds = ()

    def observe(self, v: float) -> None:
        pass

    def cumulative_buckets(self) -> List[int]:
        return []

    def count_le(self, threshold: float) -> int:
        return 0

    def count_le_and_total(self, threshold: float) -> tuple:
        return (0, 0)

    def count_and_sum(self) -> tuple:
        return (0, 0.0)

    def percentiles(self) -> Dict[str, float]:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}

    def stats(self) -> Dict[str, float]:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "count": 0,
                "sum": 0.0, "mean": 0.0}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Thread-safe registry of named counters/gauges/histograms plus the
    structured-span trace buffer (spans.py appends; export helpers here).

    ``enabled=False`` turns every accessor into a shared null object and
    every recording call into an empty method — the near-no-op contract
    the disabled-registry tier-1 test pins.
    """

    def __init__(self, enabled: bool = True, *, trace_capacity: int = 65536,
                 histogram_window: int = 4096):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._histogram_window = histogram_window
        # trace events: Chrome-trace dicts (spans, compile/sync instants).
        # deque(maxlen=) keeps memory bounded on long runs; append is
        # GIL-atomic so the recording path takes no extra lock.
        self.trace_capacity = trace_capacity
        self._trace: deque = deque(maxlen=trace_capacity)
        self._trace_dropped = 0
        # monotonic per-event sequence stamp: itertools.count().__next__
        # is GIL-atomic, so the recording path stays lock-free while
        # incremental consumers (the fleet collector's since_seq cursor,
        # the crash spool) get an exactly-once watermark
        self._trace_seq = itertools.count(1)
        self._last_seq = 0

    # ------------------------------------------------------------- accessors
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, self._histogram_window))
        return h

    # read-only lookups that must not CREATE metrics (the perf fold and
    # report layers probe for histograms the hot loop may never have
    # observed — materializing empties would pollute every snapshot)
    def histogram_if_exists(self, name: str) -> Optional[Histogram]:
        return self._histograms.get(name)

    def gauge_if_exists(self, name: str) -> Optional[Gauge]:
        return self._gauges.get(name)

    def gauges_matching(self, prefix: str, suffix: str = ""):
        """[(name, gauge)] with the given name prefix/suffix (snapshot —
        safe to iterate while writers register new gauges)."""
        with self._lock:
            items = list(self._gauges.items())
        return [(n, g) for n, g in items
                if n.startswith(prefix) and n.endswith(suffix)]

    # ----------------------------------------------------------- trace events
    def record_event(self, event: dict) -> None:
        """Append one Chrome-trace event dict (spans.py and the torch signal
        hooks call this; callers check ``enabled`` first)."""
        if len(self._trace) == self._trace.maxlen:
            self._trace_dropped += 1
        seq = next(self._trace_seq)
        event["seq"] = seq          # extra key; Chrome trace ignores it
        self._last_seq = seq
        self._trace.append(event)

    def trace_events(self) -> List[dict]:
        return list(self._trace)

    @property
    def last_seq(self) -> int:
        """Sequence stamp of the most recently recorded event (0 before
        the first) — the cursor an incremental reader resumes from."""
        return self._last_seq

    def trace_events_since(self, seq: int) -> List[dict]:
        """Events with ``seq`` strictly greater than the cursor — the
        incremental pull the replica's ``GET /debug/trace?since_seq=``
        route serves. A cursor older than the ring's tail simply returns
        the whole ring (the evicted gap is visible as non-contiguous seq
        numbers plus ``trace_dropped``; no silent pretense of
        completeness)."""
        seq = int(seq)
        return [e for e in self._trace if e.get("seq", 0) > seq]

    @property
    def trace_dropped(self) -> int:
        """Events evicted by the bounded buffer — nonzero means the trace
        export is a truncated window, not the full run (no silent caps)."""
        return self._trace_dropped

    def write_chrome_trace(self, path: str) -> str:
        """Write the span/compile trace as Chrome-trace-format JSON with one
        event per line (JSONL-style body inside a valid JSON array — both
        ``json.load`` and Perfetto's trace processor accept it)."""
        events = self.trace_events()
        with open(path, "w") as f:
            f.write("[\n")
            for i, ev in enumerate(events):
                f.write(json.dumps(ev))
                f.write(",\n" if i < len(events) - 1 else "\n")
            f.write("]\n")
        return path

    def write_trace_jsonl(self, path: str,
                          trace_id: Optional[str] = None) -> str:
        """Write the trace buffer as bare JSONL (one event object per
        line — what ``tools/trace2summary.py``/``trace2timeline.py``
        read), optionally filtered to one request's ``trace_id`` (the
        wire-format id is accepted: normalized like the HTTP ingress and
        the CLI filters normalize it)."""
        events = self.trace_events()
        if trace_id is not None:
            from .tracecontext import normalize_trace_id
            want = normalize_trace_id(trace_id)
            events = [] if want is None else \
                [e for e in events
                 if e.get("args", {}).get("trace_id") == want]
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev))
                f.write("\n")
        return path

    # -------------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        """JSON-ready dump of every metric (histograms as p50/p95/p99 +
        count/mean)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: {"value": g.value, "max": g.max}
                      for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
        return {"counters": counters,
                "gauges": gauges,
                "histograms": {n: h.stats() for n, h in hists},
                "spans_recorded": len(self._trace),
                "spans_dropped": self._trace_dropped}

    def raw_metrics(self) -> dict:
        """Mergeable export: counter values, gauge value/max, histograms
        in :meth:`Histogram.raw` wire format (bounds + cumulative ``le``
        buckets + count/sum). This is what ``GET /debug/metrics`` serves
        and what the fleet collector sums — unlike :meth:`snapshot` it
        carries the raw buckets, so fleet percentiles are computed from
        merged counts instead of averaging per-replica percentiles."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: {"value": g.value, "max": g.max}
                      for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
        return {"counters": counters, "gauges": gauges,
                "histograms": {n: h.raw() for n, h in hists}}

    def to_prometheus_text(self, prefix: str = "dl4j_tpu", *,
                           compat_quantiles: bool = False) -> str:
        """Prometheus text exposition format. Metric names are sanitized
        (dots/dashes -> underscores), label values escaped per the
        exposition spec. Histograms export conformant
        ``_bucket{le="..."}`` cumulative counts (``le="+Inf"`` == the
        lifetime count) plus ``_sum``/``_count``. ``compat_quantiles``
        restores the older summary-style dump (ad-hoc
        ``quantile=`` gauges from the bounded ring) for scrapers that
        grew to depend on those keys."""
        san = sanitize_metric_name
        lines: List[str] = []
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        for n, c in counters:
            full = f"{prefix}_{san(n)}"
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {c.value}")
        for n, g in gauges:
            full = f"{prefix}_{san(n)}"
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {g.value}")
        for n, h in hists:
            full = f"{prefix}_{san(n)}"
            total = h.count
            if compat_quantiles:
                lines.append(f"# TYPE {full} summary")
                for q, v in h.percentiles().items():
                    quant = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}[q]
                    lines.append(
                        f'{full}{{quantile="{escape_label_value(quant)}"}}'
                        f" {v}")
            else:
                lines.append(f"# TYPE {full} histogram")
                cum = h.cumulative_buckets()
                total = cum[-1] if cum else h.count   # one consistent read
                for bound, cnt in zip(h.bounds, cum):
                    le = escape_label_value(f"{bound:g}")
                    lines.append(f'{full}_bucket{{le="{le}"}} {cnt}')
                lines.append(f'{full}_bucket{{le="+Inf"}} {total}')
            lines.append(f"{full}_sum {h.sum}")
            lines.append(f"{full}_count {total}")
        return "\n".join(lines) + "\n"

    def publish(self, storage, session_id: str = "telemetry",
                worker_id: str = "runtime") -> dict:
        """Push a snapshot into a StatsStorage backend (ui/storage.py) —
        the same SPI StatsListener and the serving engine publish through,
        so one dashboard/router sees training, serving AND runtime
        telemetry."""
        snap = self.snapshot()
        snap["timestamp"] = time.time()
        storage.put_update(session_id, worker_id, snap)
        return snap

    def reset(self) -> None:
        """Drop every metric and trace event (tests; not thread-safe with
        respect to in-flight recording)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._trace.clear()
            self._trace_dropped = 0


_global_registry = MetricsRegistry(enabled=True)
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """THE process-wide registry every built-in instrumentation point
    reports to. Swap it with ``set_registry`` (tests) or flip
    ``get_registry().enabled`` to gate all built-in telemetry."""
    return _global_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, registry
    return prev
