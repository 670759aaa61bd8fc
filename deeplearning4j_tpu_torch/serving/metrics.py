"""Serving observability: per-model latency, queue, occupancy and rejection
counters, and a process-wide count of warm runs.

Counterpart of ``deeplearning4j_tpu/serving/metrics.py``. ``ServingMetrics``
keeps the reference's local ``snapshot()`` (the ``GET /metrics`` payload),
mirrors every recording into the telemetry registry under
``serving.<name>.*`` with the reference's names, and ``publish`` pushes
the snapshot into a StatsStorage backend. There is no XLA compile in the
port: ``warm_count`` (``telemetry.warm_run_count``: every warm run and
CUDA graph capture in the process) stands in for ``xla_compile_count``
(``:29``), so the guarantee that traffic after warm-up warms nothing
stays checkable.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

from ..telemetry import get_registry
from ..telemetry.torchsignals import warm_run_count as warm_count
from .generation.metrics import _percentile

__all__ = ["ServingMetrics", "warm_count"]


class ServingMetrics:
    """Per-model counters. Latency percentiles come from a bounded ring of
    the most recent ``window`` observations. Every recording is mirrored
    into the telemetry registry under ``serving.<name>.*``."""

    def __init__(self, window: int = 4096, name: str = "default",
                 registry=None):
        self._lock = threading.Lock()
        self._lat_ms = deque(maxlen=window)
        self._qwait_ms = deque(maxlen=window)
        self.name = name
        self._registry = registry
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

    @property
    def registry(self):
        # resolved per recording so a test-swapped global registry applies
        return self._registry if self._registry is not None else get_registry()

    # ------------------------------------------------------------- recording
    def record_request(self, latency_ms: float, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += rows
            self._lat_ms.append(latency_ms)
        reg = self.registry
        if reg.enabled:
            reg.counter(f"serving.{self.name}.requests").inc()
            reg.counter(f"serving.{self.name}.rows").inc(rows)
            reg.histogram(f"serving.{self.name}.latency_ms").observe(latency_ms)

    def record_queue_wait(self, queue_wait_ms: float) -> None:
        with self._lock:
            self._qwait_ms.append(queue_wait_ms)
        reg = self.registry
        if reg.enabled:
            reg.histogram(
                f"serving.{self.name}.queue_wait_ms").observe(queue_wait_ms)

    def record_batch(self, bucket: int, rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += rows
            self.padded_rows += bucket - rows
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1
            dispatched = self.batch_rows + self.padded_rows
            occupancy = self.batch_rows / dispatched if dispatched else 0.0
        reg = self.registry
        if reg.enabled:
            reg.counter(f"serving.{self.name}.batches").inc()
            reg.gauge(f"serving.{self.name}.batch_occupancy").set(occupancy)

    def record_rejection(self, kind: str) -> None:
        with self._lock:
            self.rejected[kind] = self.rejected.get(kind, 0) + 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"serving.{self.name}.rejected.{kind}").inc()

    def record_swap(self) -> None:
        with self._lock:
            self.swaps += 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"serving.{self.name}.hot_swaps").inc()

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

    def publish(self, storage, session_id: str = "serving",
                worker_id: str = "default") -> dict:
        """Push a snapshot into a StatsStorage backend (``put_update``)."""
        snap = self.snapshot()
        storage.put_update(session_id, worker_id, snap)
        return snap
