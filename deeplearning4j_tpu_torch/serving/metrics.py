"""Serving observability: per-model latency, queue, occupancy and rejection
counters, and a process-wide count of warm runs.

Counterpart of ``deeplearning4j_tpu/serving/metrics.py``. ``ServingMetrics``
keeps the reference's local ``snapshot()`` (the ``GET /metrics`` payload);
mirroring each recording into the telemetry registry and ``publish`` to a
StatsStorage backend wait for telemetry (ROADMAP A8; the engine's
``publish_metrics`` raises until then). There is no XLA
compile in the port: the process-wide ``warm_count`` of bucket warm runs
stands in for ``xla_compile_count`` (``:29``), so the guarantee that
traffic after warm-up warms nothing stays checkable.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

from .generation.metrics import _percentile

_warm_lock = threading.Lock()
_warm_runs = 0          # bucket warm runs in this process (ProgramSet.warm)


def warm_count() -> int:
    """Bucket warm runs in this process so far. Take a snapshot after
    warm-up; any later increase means traffic waited on a warm run."""
    return _warm_runs


def _record_warm_run() -> None:
    global _warm_runs
    with _warm_lock:
        _warm_runs += 1


class ServingMetrics:
    """Per-model counters. Latency percentiles come from a bounded ring of
    the most recent ``window`` observations."""

    def __init__(self, window: int = 4096, name: str = "default"):
        self._lock = threading.Lock()
        self._lat_ms = deque(maxlen=window)
        self._qwait_ms = deque(maxlen=window)
        self.name = name
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.batch_rows = 0
        self.padded_rows = 0
        self.per_bucket: Dict[int, int] = {}
        self.rejected: Dict[str, int] = {"full": 0, "draining": 0,
                                         "deadline": 0, "error": 0}
        self.swaps = 0
        self._t0 = time.monotonic()

    # ------------------------------------------------------------- recording
    def record_request(self, latency_ms: float, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += rows
            self._lat_ms.append(latency_ms)

    def record_queue_wait(self, queue_wait_ms: float) -> None:
        with self._lock:
            self._qwait_ms.append(queue_wait_ms)

    def record_batch(self, bucket: int, rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += rows
            self.padded_rows += bucket - rows
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1

    def record_rejection(self, kind: str) -> None:
        with self._lock:
            self.rejected[kind] = self.rejected.get(kind, 0) + 1

    def record_swap(self) -> None:
        with self._lock:
            self.swaps += 1

    # ------------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            qw = sorted(self._qwait_ms)
            dispatched = self.batch_rows + self.padded_rows
            occupancy = self.batch_rows / dispatched if dispatched else 0.0
            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "latency_ms": {"p50": round(_percentile(lat, 0.50), 3),
                               "p99": round(_percentile(lat, 0.99), 3)},
                "queue_wait_ms": {"p50": round(_percentile(qw, 0.50), 3),
                                  "p99": round(_percentile(qw, 0.99), 3)},
                "batch_occupancy": round(occupancy, 4),
                "padding_waste": round(1.0 - occupancy, 4) if dispatched
                else 0.0,
                "per_bucket": dict(self.per_bucket),
                "rejected": dict(self.rejected),
                "hot_swaps": self.swaps,
                "uptime_s": round(time.monotonic() - self._t0, 1),
            }
