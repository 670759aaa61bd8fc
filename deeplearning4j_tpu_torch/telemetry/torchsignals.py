"""Runtime signals on the card: warm runs and captures, host syncs, device
memory.

Counterpart of ``deeplearning4j_tpu/telemetry/jaxsignals.py``. The three
signals are the reference's; how each is caught differs, because torch
has no compiler events to listen to and no host cache of a device value:

- **Warm runs and captures** (the reference's backend compiles,
  ``:58-107``). The port's "compile" is a program's warm run (a serving
  bucket's, ``serving/programs.py``; a generation program's,
  ``serving/generation/programs.py``) or a CUDA graph capture (the decode
  step's, ``serving/generation/graphs.py``; the training step's,
  ``optimize/step_graph.py``). Those sites call :func:`note_warm_run` /
  :func:`note_capture`, which count it, land a ``warm_run`` /
  ``graph_capture`` trace event attributed to the calling thread's span
  path, and feed every armed :class:`RecompileDetector`.
- **Host syncs** (``:241-376``). The reference wraps
  ``ArrayImpl._value``; torch has no such funnel, so
  :class:`HostSyncDetector` wraps the ``torch.Tensor`` methods that read a
  device value to the host: ``item``, ``tolist``, ``numpy``,
  ``__float__``, ``__int__``, ``__index__``, ``__bool__``, and ``cpu`` /
  ``to`` onto the CPU from another device. It flags one only for a CUDA
  tensor, or for any tensor when armed with ``include_cpu=True`` (the
  tests' flag: the reference's funnel fires on the CPU backend too,
  ``:14-20``); a move of a CPU tensor onto the CPU, and a
  ``to(..., non_blocking=True)`` (which does not wait), are no reads and
  are never flagged. ``sync_debug=True`` additionally turns on
  ``torch.cuda.set_sync_debug_mode("warn")`` for the scope and counts the
  warnings it raises on the watched thread, which catches the syncs the
  wrapped methods cannot see (a blocking copy or a size read inside a
  C++ op); a read the funnel flagged is not counted twice. The mode is
  process-wide, not per thread (only the watched thread's warnings are
  counted), and it sees only the waits torch routes through its check:
  a wait on a ``torch.cuda.Event`` or an explicit
  ``torch.cuda.synchronize()`` is not flagged. ``thread=`` (an addition)
  watches a given thread, such as a scheduler's loop, from outside it.
- **Device memory** (``:378-432``). :func:`device_memory_gauges` reads
  ``torch.cuda.memory_stats(i)`` into ``device<i>.bytes_in_use`` /
  ``peak_bytes_in_use`` (the allocator's current and peak allocated
  bytes, the numbers ``torch.cuda.memory_allocated`` and
  ``max_memory_allocated`` give) and ``bytes_limit`` (the card's total
  memory). It reads host-side allocator counters only: no sync.

Deliberate differences:

- names: the reference's ``jax.*`` metrics and ``backend_compile`` event
  have no meaning on the card; :data:`NAME_MAP` is the one table of their
  counterparts (the parity tests read it). ``xla_compile_count`` is
  :func:`warm_run_count` (warm runs and captures together).
  ``xla_cache_hit_count`` and ``jax.compile_cache_hits`` are not ported:
  the port has no persistent compile cache, so nothing is ever a hit.
- torch keeps no host copy of a device value, so every read is a sync and
  the reference's "a cached re-read is free" case (``:253-258``) has no
  counterpart.
- on the CPU ``device_memory_gauges`` sets nothing (the reference falls
  back to a walk of its live arrays there, ``:411-430``); ``memprof.py``
  holds the port's tagged-tensor accounting instead.
- ``ensure_monitoring_hook`` (it installs the ``jax.monitoring``
  listener) has nothing to install here and is not ported.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch

from .registry import MetricsRegistry, get_registry
from .spans import _EPOCH_NS, current_span, current_span_path

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["warm_run_count", "note_warm_run", "note_capture",
           "timed_warm_run", "RecompileDetector", "HostSyncDetector",
           "HostSyncError", "device_memory_gauges", "NAME_MAP"]

# the reference's metric and event names with no meaning on the card ->
# the port's (None: not ported)
NAME_MAP: Dict[str, Optional[str]] = {
    "jax.compiles": "torch.warm_runs",
    "jax.compile_ms": "torch.warm_run_ms",
    "jax.compile_cache_hits": None,
    "jax.recompiles_flagged": "torch.recompiles_flagged",
    "jax.host_syncs_flagged": "torch.host_syncs_flagged",
    "backend_compile": "warm_run",
}

_lock = threading.Lock()
_warm_runs = 0              # warm runs and captures in the process
_subscribers: List[Callable[[str, float], None]] = []


def warm_run_count() -> int:
    """Warm runs and graph captures in this process so far (the
    counterpart of ``xla_compile_count``): take a snapshot after warm-up;
    any later increase means traffic waited on one."""
    return _warm_runs


def _note(kind: str, secs: float) -> None:
    global _warm_runs
    with _lock:
        _warm_runs += 1
    path = current_span_path()
    reg = get_registry()
    if reg.enabled:
        reg.counter("torch.warm_runs").inc()
        reg.histogram("torch.warm_run_ms").observe(secs * 1e3)
        now_ns = time.perf_counter_ns()
        reg.record_event({
            "name": "graph_capture" if kind == "capture" else "warm_run",
            "ph": "X", "cat": "compile",
            "ts": (now_ns + _EPOCH_NS) // 1000 - int(secs * 1e6),
            "dur": int(secs * 1e6), "pid": 1,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "args": {"path": path, "duration_s": round(secs, 6)}})
    for cb in list(_subscribers):
        cb(path, secs)


def note_warm_run(secs: float = 0.0) -> None:
    """One program's warm run just finished, ``secs`` of host time."""
    _note("warm", secs)


def note_capture(secs: float = 0.0) -> None:
    """One CUDA graph capture just finished, ``secs`` of host time."""
    _note("capture", secs)


@contextlib.contextmanager
def timed_warm_run():
    """``with timed_warm_run(): run_once()`` notes one warm run with the
    scope's host time (nothing is noted when the body raises)."""
    t0 = time.perf_counter()
    yield
    note_warm_run(time.perf_counter() - t0)


_STDLIB_DIR = None
_THIS_PKG_DIR = None


def _source_hint() -> str:
    """Best-effort 'file.py:line in func' of the user code driving the
    warm run: the innermost frame that is neither torch, the stdlib nor
    this telemetry package. Computed only when a flagged warning is
    emitted."""
    import os as _os
    import traceback
    global _STDLIB_DIR, _THIS_PKG_DIR
    if _STDLIB_DIR is None:
        import sysconfig
        _STDLIB_DIR = sysconfig.get_paths()["stdlib"].replace("\\", "/")
        _THIS_PKG_DIR = _os.path.dirname(
            _os.path.abspath(__file__)).replace("\\", "/")
    try:
        for frame in reversed(traceback.extract_stack()):
            fn = frame.filename.replace("\\", "/")
            if "/site-packages/torch" in fn or "/dist-packages/torch" in fn:
                continue
            if fn.startswith(_THIS_PKG_DIR):
                continue
            if fn.startswith(_STDLIB_DIR) and "-packages" not in fn:
                continue
            return f"{fn}:{frame.lineno} in {frame.name}"
    except Exception:
        pass
    return ""


class RecompileDetector:
    """Scoped warm-run watchdog: counts warm runs and captures while armed
    and attributes each to the span path of the thread that made it.

        with RecompileDetector(allowed=0) as det:
            serve_steady_state_traffic()
        det.count            # warm runs and captures in scope
        det.events           # [{"span_path", "span_attrs", "source",
                             #   "duration_s", "wall_time"}]

    ``allowed`` of them pass silently; every one past it logs a WARNING
    naming the span path, its attrs and a source hint. The reference's
    detector sees every compile in the process; ``thread_only=True`` (an
    addition) counts only the warm runs made on the thread that armed it,
    such as a scheduler's loop, so another engine's warm-up or capture in
    the same process is not counted.
    """

    def __init__(self, *, allowed: int = 0, warn: bool = True,
                 thread_only: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        self.allowed = allowed
        self.warn = warn
        self.thread_only = thread_only
        self.registry = registry or get_registry()
        self.count = 0
        self.events: List[dict] = []
        self._armed = False
        self._tid: Optional[int] = None

    def _on_compile(self, span_path: str, secs: float) -> None:
        if self.thread_only and threading.get_ident() != self._tid:
            return
        self.count += 1
        sp = current_span()
        attrs = {k: v for k, v in (sp.attrs if sp is not None else {}).items()
                 if k != "path"}
        flagged = self.warn and self.count > self.allowed
        source = _source_hint() if flagged else ""
        self.events.append({"span_path": span_path,
                            "span_attrs": attrs,
                            "source": source,
                            "duration_s": round(secs, 6),
                            "wall_time": time.time()})
        if self.registry.enabled:
            self.registry.counter("torch.recompiles_flagged").inc()
        if flagged:
            log.warning(
                "RecompileDetector: warm run or capture #%d (%.1f ms) "
                "during span '%s'%s%s — a steady-state loop should not "
                "warm; check for a shape outside the warmed rungs",
                self.count, secs * 1e3, span_path or "<no span>",
                f" (span attrs: {attrs})" if attrs else "",
                f" (driven from {source})" if source else "")

    def __enter__(self) -> "RecompileDetector":
        if not self._armed:
            self._tid = threading.get_ident()
            with _lock:
                _subscribers.append(self._on_compile)
            self._armed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._armed:
            with _lock:
                try:
                    _subscribers.remove(self._on_compile)
                except ValueError:
                    pass
            self._armed = False
        return False

    @property
    def recompiles(self) -> int:
        """Warm runs and captures beyond the allowed budget."""
        return max(0, self.count - self.allowed)


class HostSyncError(RuntimeError):
    """Raised by HostSyncDetector(action="raise") at the sync site."""


_sync_lock = threading.Lock()
_sync_installed = False
_sync_detectors: List["HostSyncDetector"] = []
# per thread: inside a wrapped read (its own sync warning is not counted
# again by a sync_debug detector)
_in_read = threading.local()

# the torch.Tensor methods that read a value to the host
_READS = ("item", "tolist", "numpy", "__float__", "__int__", "__index__",
          "__bool__")
# the warning torch.cuda.set_sync_debug_mode("warn") raises at each sync
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _onto_cpu(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call's arguments name the CPU (a device, a
    string or another tensor's device; a dtype alone names none) and ask
    for a blocking copy."""
    dev = kwargs.get("device", args[0] if args else None)
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    blocking = not kwargs.get("non_blocking",
                              next((a for a in args if isinstance(a, bool)),
                                   False))
    return blocking and isinstance(dev, (str, torch.device)) and \
        torch.device(dev).type == "cpu"


def _read(orig, t, a, k):
    """``orig(t, ...)`` after flagging it to the armed detectors."""
    for det in list(_sync_detectors):
        det._on_sync(t, threading.get_ident())
    _in_read.depth = getattr(_in_read, "depth", 0) + 1
    try:
        return orig(t, *a, **k)
    finally:
        _in_read.depth -= 1


def _install_sync_tripwire() -> None:
    """Wrap the ``torch.Tensor`` host-read methods (once a process). A
    wrapper costs one list check when no detector is armed."""
    global _sync_installed
    if _sync_installed:
        return
    with _sync_lock:
        if _sync_installed:
            return

        def wrap_read(orig):
            def traced(self, *a, **k):
                if _sync_detectors:
                    return _read(orig, self, a, k)
                return orig(self, *a, **k)
            traced.__name__ = orig.__name__
            traced.__doc__ = orig.__doc__
            return traced

        for name in _READS:
            setattr(torch.Tensor, name, wrap_read(getattr(torch.Tensor,
                                                          name)))
        orig_cpu, orig_to = torch.Tensor.cpu, torch.Tensor.to

        def cpu(self, *a, **k):
            if _sync_detectors and self.device.type != "cpu":
                return _read(orig_cpu, self, a, k)
            return orig_cpu(self, *a, **k)

        def to(self, *a, **k):
            if _sync_detectors and self.device.type != "cpu" \
                    and _onto_cpu(a, k):
                return _read(orig_to, self, a, k)
            return orig_to(self, *a, **k)

        cpu.__doc__, to.__doc__ = orig_cpu.__doc__, orig_to.__doc__
        torch.Tensor.cpu, torch.Tensor.to = cpu, to
        _sync_installed = True


class HostSyncDetector:
    """Scoped device-to-host read tripwire.

        with HostSyncDetector() as det:          # action="warn"
            fit_window()
        assert det.count == 0

    ``action``: "count" (silent), "warn" (log a WARNING with the span path
    and shape) or "raise" (``HostSyncError`` at the sync site).
    ``thread_only=True`` (default) scopes detection to the arming thread,
    or to ``thread`` (a ``threading.get_ident()`` value: a loop thread
    watched from outside it) when given. ``include_cpu=True`` flags reads
    of CPU tensors too (the CPU tests' flag). ``sync_debug=True`` also
    counts the synchronising calls ``torch.cuda.set_sync_debug_mode("warn")``
    reports on the watched thread (the mode is set for the scope where
    CUDA is available, process-wide, and restored after); such an event
    has ``shape`` None and ``source``, the call site. Under "raise" such
    a call raises ``HostSyncError`` from the op that synchronised.
    """

    def __init__(self, *, action: str = "warn", thread_only: bool = True,
                 include_cpu: bool = False, thread: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 sync_debug: bool = False):
        if action not in ("count", "warn", "raise"):
            raise ValueError(f"unknown action {action!r}")
        self.action = action
        self.thread_only = thread_only
        self.include_cpu = include_cpu
        self.registry = registry or get_registry()
        self.sync_debug = sync_debug
        self.count = 0
        self.events: List[dict] = []
        self._thread = thread
        self._tid = None
        self._prev_mode = None
        self._caught = None

    # called from the wrapped methods, possibly on any thread
    def _on_sync(self, t, tid: int) -> None:
        if self.thread_only and tid != self._tid:
            return
        if not self.include_cpu and t.device.type != "cuda":
            return
        self._flag(tid, tuple(t.shape), None)

    def _flag(self, tid: int, shape, source: Optional[str]) -> None:
        path = current_span_path()
        self.count += 1
        ev = {"span_path": path, "shape": shape, "wall_time": time.time()}
        if shape is None:
            ev["source"] = source
        self.events.append(ev)
        reg = self.registry
        if reg.enabled:
            reg.counter("torch.host_syncs_flagged").inc()
            reg.record_event({
                "name": "host_sync", "ph": "i", "cat": "sync", "s": "t",
                "ts": (time.perf_counter_ns() + _EPOCH_NS) // 1000,
                "pid": 1, "tid": tid & 0xFFFFFFFF,
                "args": {"path": path, "shape": str(shape)}})
        what = f"device-to-host read of shape {shape}" if shape is not None \
            else f"synchronising call at {source or '<unknown>'}"
        if self.action == "warn":
            log.warning(
                "HostSyncDetector: %s during span '%s' — this blocks the "
                "host until the card catches up; defer the read or move it "
                "off the hot path", what, path or "<no span>")
        elif self.action == "raise":
            raise HostSyncError(
                f"unexpected {what} during span '{path or '<no span>'}'")

    def _show(self, prev):
        """A ``warnings.showwarning`` that counts the sync-debug warnings
        of the watched thread (outside a flagged read), drops the other
        threads' (the mode is process-wide) and passes the rest on."""
        def show(message, category, filename, lineno, file=None,
                 line=None):
            if _SYNC_WARNING not in str(message):
                return prev(message, category, filename, lineno, file, line)
            tid = threading.get_ident()
            if (self.thread_only and tid != self._tid) or \
                    getattr(_in_read, "depth", 0):
                return None
            self._flag(tid, None, _source_hint())
            return None
        return show

    def __enter__(self) -> "HostSyncDetector":
        _install_sync_tripwire()
        self._tid = self._thread if self._thread is not None \
            else threading.get_ident()
        with _sync_lock:
            _sync_detectors.append(self)
        if self.sync_debug:
            if torch.cuda.is_available():
                self._prev_mode = torch.cuda.get_sync_debug_mode()
                # the switch itself warns once (a prototype feature)
                torch.cuda.set_sync_debug_mode("warn")
            self._caught = warnings.catch_warnings()
            self._caught.__enter__()
            # every occurrence, not once per call site
            warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
            warnings.showwarning = self._show(warnings.showwarning)
        return self

    def __exit__(self, *exc) -> bool:
        with _sync_lock:
            try:
                _sync_detectors.remove(self)
            except ValueError:
                pass
        if self._prev_mode is not None:
            torch.cuda.set_sync_debug_mode(self._prev_mode)
            self._prev_mode = None
        if self._caught is not None:
            self._caught.__exit__(*exc)
            self._caught = None
        return False


def device_memory_gauges(registry: Optional[MetricsRegistry] = None
                         ) -> Dict[str, float]:
    """Read each card's allocator counters into ``device<i>.bytes_in_use``
    / ``device<i>.peak_bytes_in_use`` / ``device<i>.bytes_limit`` gauges.
    Returns the values read; sets nothing where CUDA is not in use."""
    reg = registry or get_registry()
    out: Dict[str, float] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            limit = float(torch.cuda.get_device_properties(i).total_memory)
        except Exception:
            continue
        vals = {"bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": limit}
        for key, v in vals.items():
            if v is None:
                continue
            name = f"device{i}.{key}"
            reg.gauge(name).set(float(v))
            out[name] = float(v)
    return out
