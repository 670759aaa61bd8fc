"""TraceSpool: the crash-durable black box a process leaves behind.

Counterpart of ``deeplearning4j_tpu/telemetry/spool.py`` (copied, not
imported): a background thread re-writes ONE file, atomically (tmp +
fsync + ``os.replace``), with the tail of the registry's trace ring and
its raw (mergeable) metrics, so a SIGKILLed process leaves a complete
last flush on disk. File format::

    {"spool": 1, "replica": "r0", "pid": 4711, "seq": 1234,
     "wall_time": 1754550000.0, "events": [...last <=capacity events...],
     "metrics": {"counters": ..., "gauges": ..., "histograms": ...}}

``seq`` is the registry's event watermark at flush time; a flush with no
new events is skipped. ``tools/trace2summary.py`` and
``trace2timeline.py`` read the file (they unwrap ``events``). No
deliberate differences.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .registry import MetricsRegistry, get_registry

__all__ = ["TraceSpool", "read_spool"]


def read_spool(path: str) -> Optional[dict]:
    """Parse a spool file; None if absent or (mid-crash window) empty.
    Atomic replace means a file that exists is always complete — a
    parse failure is reported as None rather than raised because every
    caller (router dump embed, collector recovery) treats a missing
    black box as degraded evidence, not an error."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) and data.get("spool") else None


class TraceSpool:
    """Periodic atomic spill of trace-ring tail + raw metrics.

        spool = TraceSpool(path, replica_id="r0").start()
        ...
        spool.stop()        # final flush, thread joined

    ``capacity`` bounds the number of ring events per flush (the tail —
    the most recent events are the ones a post-mortem wants).
    ``period_s`` is the crash-durability window: a SIGKILL loses at most
    one period of spans. A flush with no new events since the last one
    is skipped (no seq advance -> no disk write), so an idle replica
    costs zero steady-state I/O.
    """

    def __init__(self, path: str, *, replica_id: str = "",
                 period_s: float = 0.25, capacity: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.path = str(path)
        self.replica_id = str(replica_id)
        self.period_s = float(period_s)
        self.capacity = int(capacity)
        self._registry = registry
        self._flushed_seq = -1          # force the first flush
        self.flushes = 0
        self.skipped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    # -------------------------------------------------------------- flush
    def flush(self, force: bool = False) -> bool:
        """Write one spill if the ring advanced (or ``force``). Returns
        True when a file was written."""
        reg = self.registry
        seq = reg.last_seq
        if seq == self._flushed_seq and not force:
            self.skipped += 1
            return False
        events = reg.trace_events()
        if len(events) > self.capacity:
            events = events[-self.capacity:]
        record = {"spool": 1,
                  "replica": self.replica_id,
                  "pid": os.getpid(),
                  "seq": seq,
                  "wall_time": time.time(),
                  "events": events,
                  "metrics": reg.raw_metrics()}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(record, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)      # atomic: never a half-read spool
        self._flushed_seq = seq
        self.flushes += 1
        if reg.enabled:
            reg.counter("spool.flushes").inc()
        return True

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "TraceSpool":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="trace-spool")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.flush()
            except OSError:             # disk pressure must not kill serving
                pass

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_flush:
            try:
                self.flush(force=True)
            except OSError:             # pragma: no cover - defensive
                pass
