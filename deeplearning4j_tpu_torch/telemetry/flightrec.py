"""Incident flight recorder: a black box for the seconds before a failure.

Counterpart of ``deeplearning4j_tpu/telemetry/flightrec.py`` (copied,
not imported). On a trigger (a scheduler or batcher exception, an SLO
breach, a training-health failure, an explicit ``POST /debug/flightrec``)
``FlightRecorder.dump`` writes the tail of the registry's trace ring,
the full metrics snapshot, the counter deltas since the previous dump
and the ``perf`` block (``perf.perf_snapshot``: cost table, step
decomposition and ``memprof``'s memory section) ATOMICALLY (tmp +
``os.replace``) to a timestamped JSON file. ``tools/trace2summary.py``
and ``trace2timeline.py`` read a dump directly. Auto triggers
(``force=False``) are rate-limited per trigger; a dump never raises into
the path that tripped it. Dumps land in ``$DL4J_TPU_FLIGHTREC_DIR`` or
``./flightrec_dumps``, the reference's variable and default.

The one difference is the memory section, which is the port's
``memprof.snapshot`` (tagged tensors plus the CUDA allocator's
remainder, see ``memprof.py``), not a walk of every live array.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import List, Optional

from .registry import MetricsRegistry, get_registry

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder",
           "configure_flight_recorder"]

_ENV_DIR = "DL4J_TPU_FLIGHTREC_DIR"


class FlightRecorder:
    """Dump-on-trigger view over the telemetry trace ring.

    ``directory``: where dumps land (created on first dump; defaults to
    ``$DL4J_TPU_FLIGHTREC_DIR`` or ``./flightrec_dumps``).
    ``capacity``: max trace events captured per dump (the tail of the
    ring — the most recent history).
    ``min_interval_s``: auto-triggers (``force=False`` — SLO breaches,
    training-health watchdogs) are rate-limited to one dump per
    interval PER TRIGGER (a NaN storm can't starve a concurrent SLO
    breach of its evidence, and vice versa); explicit triggers (faults,
    recovery, HTTP) bypass the limit entirely.
    ``keep_last``: oldest dumps beyond this are pruned (only files this
    recorder wrote — a shared directory is never swept blindly).
    """

    def __init__(self, directory: Optional[str] = None, *,
                 capacity: int = 2048, min_interval_s: float = 1.0,
                 keep_last: int = 16,
                 registry: Optional[MetricsRegistry] = None):
        self.directory = directory or os.environ.get(
            _ENV_DIR, "flightrec_dumps")
        self.capacity = capacity
        self.min_interval_s = min_interval_s
        self.keep_last = keep_last
        self._registry = registry
        self._lock = threading.Lock()
        self._seq = 0
        self._last_dump_t: dict = {}       # trigger -> monotonic time
        self._last_counters: dict = {}
        self.dumps: List[str] = []
        self.suppressed = 0            # rate-limited trigger count

    @property
    def registry(self) -> MetricsRegistry:
        # resolved per use so a test-swapped global registry applies
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def last_dump_path(self) -> Optional[str]:
        return self.dumps[-1] if self.dumps else None

    def note(self, name: str, **attrs) -> None:
        """Drop a breadcrumb into the ring (an instant event with
        ``cat="note"``) — context a later dump should contain that no
        span captures, e.g. 'drain started', 'config reloaded'."""
        from .tracecontext import event
        event(name, cat="note", **attrs)

    # ------------------------------------------------------------------ dump
    def dump(self, trigger: str, *, force: bool = True, **info
             ) -> Optional[str]:
        """Write one black-box file; returns its path, or None when
        rate-limited / the registry is disabled / the write failed (a
        flight recorder must never add a second failure to the incident
        that tripped it — errors are logged, not raised)."""
        reg = self.registry
        if not reg.enabled:
            return None
        try:
            return self._dump(reg, trigger, force, info)
        except Exception as e:            # never fail the failing path
            log.warning("flight recorder: dump for trigger %r failed: %s",
                        trigger, e)
            return None

    def _dump(self, reg: MetricsRegistry, trigger: str, force: bool,
              info: dict) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_t.get(trigger, -1e18)
            if not force and now - last < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_dump_t[trigger] = now
            self._seq += 1
            seq = self._seq
        try:
            return self._write(reg, trigger, seq, info)
        except BaseException:
            # a FAILED write must not count against the rate limit — the
            # next trigger should try again, or the incident loses its
            # only chance at a black box
            with self._lock:
                if self._last_dump_t.get(trigger) == now:
                    self._last_dump_t[trigger] = last
            raise

    def _write(self, reg: MetricsRegistry, trigger: str, seq: int,
               info: dict) -> str:
        events = reg.trace_events()[-self.capacity:]
        snap = reg.snapshot()
        with self._lock:
            prev = self._last_counters
            counters = snap.get("counters", {})
            delta = {k: v - prev.get(k, 0) for k, v in counters.items()
                     if v != prev.get(k, 0)}
            self._last_counters = dict(counters)
        record = {
            "flightrec": 1,
            "trigger": trigger,
            "info": {k: _jsonable(v) for k, v in info.items()},
            "wall_time": time.time(),
            "wall_time_iso": time.strftime("%Y-%m-%dT%H:%M:%S",
                                           time.gmtime()) + "Z",
            "pid": os.getpid(),
            "seq": seq,
            "events": events,
            "metrics": snap,
            "counter_deltas_since_last_dump": delta,
        }
        # performance black box (telemetry/perf.py + memprof.py): the
        # per-program cost/MFU table, step decomposition and the live
        # memory top-K — an OOM-adjacent incident ships its memory state
        # with the spans. perf_snapshot never raises; a dump must not
        # add a second failure to the path that tripped it.
        from .perf import perf_snapshot
        record["perf"] = perf_snapshot(reg, top_k=8)
        os.makedirs(self.directory, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime())
        safe_trigger = "".join(ch if (ch.isalnum() or ch in "-_") else "_"
                               for ch in trigger)[:48]
        name = f"flightrec_{stamp}_{seq:04d}_{safe_trigger}.json"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            # default=repr: ONE numpy scalar in some span's attrs must
            # not cost every future incident its black box
            json.dump(record, f, default=repr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)             # atomic: never a torn black box
        with self._lock:
            self.dumps.append(path)
            doomed = self.dumps[:-self.keep_last] if self.keep_last else []
            self.dumps = self.dumps[-self.keep_last:] if self.keep_last \
                else self.dumps
        for old in doomed:
            try:
                os.remove(old)
            except OSError:
                pass
        reg.counter("flightrec.dumps").inc()
        log.warning("flight recorder: dumped %d events to %s (trigger=%s)",
                    len(events), path, trigger)
        return path


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


_global: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """THE process-wide recorder every built-in trigger fires (lazily
    created with defaults; reconfigure with
    :func:`configure_flight_recorder` or swap with
    :func:`set_flight_recorder`)."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = FlightRecorder()
    return _global


def set_flight_recorder(rec: Optional[FlightRecorder]
                        ) -> Optional[FlightRecorder]:
    global _global
    with _global_lock:
        prev, _global = _global, rec
    return prev


def configure_flight_recorder(**kwargs) -> FlightRecorder:
    """Replace the global recorder with one built from ``kwargs``
    (``directory=``, ``capacity=``, ...). Returns the new recorder."""
    rec = FlightRecorder(**kwargs)
    set_flight_recorder(rec)
    return rec
