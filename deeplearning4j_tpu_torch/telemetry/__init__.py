"""Unified telemetry: structured spans, runtime counters, request tracing,
the flight recorder, the memory profiler, cost accounting and SLOs.

Counterpart of ``deeplearning4j_tpu/telemetry/__init__.py``: one
process-wide, thread-safe :class:`MetricsRegistry` (on by default) plus
:func:`span`, exported as Chrome-trace JSON (``write_chrome_trace``), the
Prometheus text format (``to_prometheus_text``) and a StatsStorage bridge
(``publish``). ``Solver.fit`` (fit/epoch/window|step/dispatch spans, step
accounting, the training watch), ``DevicePrefetchIterator``,
``PerformanceListener``, the serving engines and their HTTP server report
here; ``get_registry().enabled = False`` turns it all into near no-ops.

``__all__`` is the reference's minus its JAX-only names
(``normalize_cost_analysis``, ``xla_compile_count``,
``xla_cache_hit_count``, ``ensure_monitoring_hook``), plus their
counterparts: ``count_cost`` and ``note_kernel`` (``perf.py``),
``warm_run_count``, ``note_warm_run``, ``note_capture`` and ``NAME_MAP``
(``torchsignals.py``, the counterpart of ``jaxsignals.py``), and
``training_health_vec``.
"""
from .flightrec import (FlightRecorder, configure_flight_recorder,
                        get_flight_recorder, set_flight_recorder)
from .perf import (PerfBaseline, ProgramCostIndex, StepAccounting,
                   classify_roofline, count_cost, get_cost_index,
                   implied_mfu, note_kernel, perf_snapshot, set_cost_index,
                   write_perf_dump)
from .registry import (Counter, Gauge, Histogram, HistogramLadderMismatch,
                       MetricsRegistry, bucket_quantile, get_registry,
                       merge_cumulative_buckets, set_registry)
from .slo import (ErrorRateSLO, LatencySLO, SLOWatchdog, ThroughputSLO,
                  TrainingWatch, get_slo_watchdog, get_training_watch,
                  set_slo_watchdog, set_training_watch, training_health_vec)
from .spans import (Span, current_span, current_span_path,
                    record_external_span, span)
from .spool import TraceSpool, read_spool
from .torchsignals import (NAME_MAP, HostSyncDetector, HostSyncError,
                           RecompileDetector, device_memory_gauges,
                           note_capture, note_warm_run, warm_run_count)
from .tracecontext import (TraceContext, adopt, current_trace_context,
                           current_trace_id, event, handoff,
                           new_trace_context, normalize_trace_id,
                           use_trace_context)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "HistogramLadderMismatch", "bucket_quantile",
    "merge_cumulative_buckets",
    "get_registry", "set_registry",
    "TraceSpool", "read_spool",
    "Span", "span", "current_span", "current_span_path",
    "record_external_span",
    "TraceContext", "new_trace_context", "normalize_trace_id",
    "current_trace_context", "current_trace_id", "use_trace_context",
    "handoff", "adopt", "event",
    "FlightRecorder", "get_flight_recorder", "set_flight_recorder",
    "configure_flight_recorder",
    "SLOWatchdog", "LatencySLO", "ErrorRateSLO", "ThroughputSLO",
    "get_slo_watchdog", "set_slo_watchdog",
    "ProgramCostIndex", "StepAccounting", "PerfBaseline",
    "get_cost_index", "set_cost_index", "perf_snapshot", "write_perf_dump",
    "implied_mfu", "classify_roofline", "count_cost", "note_kernel",
    "TrainingWatch", "get_training_watch", "set_training_watch",
    "training_health_vec",
    "RecompileDetector", "HostSyncDetector", "HostSyncError",
    "device_memory_gauges", "warm_run_count", "note_warm_run",
    "note_capture", "NAME_MAP",
    "reset",
]


def reset() -> None:
    """Clear the global registry's metrics and trace buffer (tests /
    between runs). The enabled flag is preserved."""
    get_registry().reset()
