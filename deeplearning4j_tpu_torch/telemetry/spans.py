"""Structured spans: nested wall-clock attribution for the hot paths.

Counterpart of ``deeplearning4j_tpu/telemetry/spans.py`` (copied, not
imported): ``span(name, **attrs)`` opens a span on a thread-local stack;
on close it lands ONE Chrome-trace complete event (``"ph": "X"``) in the
registry's trace buffer and one observation in the ``span.<name>_ms``
histogram. A span opened inside another carries the parent's path
(``fit/epoch/window/dispatch``), and ``torchsignals.py`` attributes warm
runs and graph captures to ``current_span_path()`` of the thread that
made them. ``record_external_span`` lands a duration measured outside the
stack.

A span reads the host clock twice and writes a dict: it never touches a
device value. On the card a span around a kernel launch or a CUDA graph
replay times the host's enqueue, as the reference's times an async
dispatch. A disabled registry makes ``span()`` return a shared no-op.

Difference: the reference's first span installs the ``jax.monitoring``
compile hook (``:157``); the port has no compile events to hook, and its
counterpart (``torchsignals.note_warm_run`` / ``note_capture``) is
called by the sites that warm or capture, so ``span`` installs
nothing.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from .registry import MetricsRegistry, get_registry
from .tracecontext import current_trace_id

__all__ = ["Span", "span", "current_span", "current_span_path",
           "record_external_span"]

# Chrome-trace timestamps are microseconds; anchor perf_counter_ns to the
# unix epoch once so every event in a process shares one clock domain.
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()

_tls = threading.local()


def _stack() -> List["Span"]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class _NoopSpan:
    """Shared do-nothing span for a disabled registry."""

    __slots__ = ()
    name = path = "<disabled>"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        return self

    def end(self):
        return self

    def set_attr(self, key, value):
        pass


_NOOP = _NoopSpan()


class Span:
    """One timed, attributed region. Context-manager use is the norm;
    ``start()``/``end()`` exist for regions that do not nest lexically
    (e.g. ProfilerListener's capture window opens in one listener callback
    and closes in a later one)."""

    __slots__ = ("name", "attrs", "path", "registry", "_t0", "_tid",
                 "_ended", "_trace_id")

    def __init__(self, name: str, registry: MetricsRegistry, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.registry = registry
        self.path = name          # parent path resolved at start()
        self._t0 = 0
        self._tid = 0
        self._ended = False
        self._trace_id = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Span":
        stack = _stack()
        if stack:
            self.path = stack[-1].path + "/" + self.name
        else:
            # a handed-off scope (tracecontext.adopt) installs the
            # producer's span path as a virtual root: the first span a
            # consumer thread opens parents under the producer's path
            root = getattr(_tls, "virtual_root", "")
            if root:
                self.path = root + "/" + self.name
        stack.append(self)
        # request tracing: stamp the ACTIVE trace context (if any) so the
        # closed event is keyed by trace id alongside its span path
        self._trace_id = current_trace_id()
        self._tid = threading.get_ident() & 0xFFFFFFFF
        self._t0 = time.perf_counter_ns()
        return self

    def end(self) -> "Span":
        t1 = time.perf_counter_ns()
        if self._ended:
            return self
        self._ended = True
        stack = _stack()
        # the common case is LIFO exit; tolerate out-of-order manual end()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            while stack and stack.pop() is not self:
                pass
        dur_ns = t1 - self._t0
        reg = self.registry
        if reg.enabled:
            args = self.attrs
            args["path"] = self.path
            if self._trace_id is not None:
                args["trace_id"] = self._trace_id
            reg.record_event({"name": self.name, "ph": "X", "cat": "span",
                              "ts": (self._t0 + _EPOCH_NS) // 1000,
                              "dur": dur_ns // 1000,
                              "pid": 1, "tid": self._tid, "args": args})
            reg.histogram("span." + self.name + "_ms").observe(dur_ns / 1e6)
        return self

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


def span(name: str, **attrs):
    """Open a structured span (context manager). ``attrs`` must be
    host-side values (ints/strs) — passing a device tensor would force the
    readback this layer exists to avoid."""
    reg = get_registry()
    if not reg.enabled:
        return _NOOP
    return Span(name, reg, attrs)


def record_external_span(name: str, dur_ms: float, cat: str = "external",
                         **attrs) -> None:
    """Land a Chrome-trace complete event for a duration measured OUTSIDE
    the span stack (a profiled collective, a subprocess stage, an
    externally-timed region), attributed under the innermost open span's
    path like the torchsignals warm-run events. ``cat`` distinguishes it from
    lexical spans — tools/trace2summary.py folds non-span categories into
    their own ``[name]`` buckets (per-bucket for cat="collective" events
    carrying a ``bucket`` attr) instead of inflating the enclosing span."""
    reg = get_registry()
    if not reg.enabled:
        return
    # args.path carries the ENCLOSING span path (same contract as the
    # warm_run events): trace2summary appends "[name]" itself
    args = dict(attrs)
    args["path"] = current_span_path()
    tid_trace = current_trace_id()
    if tid_trace is not None:
        args["trace_id"] = tid_trace
    now_ns = time.perf_counter_ns()
    dur_us = max(0, int(dur_ms * 1000))
    reg.record_event({"name": name, "ph": "X", "cat": cat,
                      "ts": (now_ns + _EPOCH_NS) // 1000 - dur_us,
                      "dur": dur_us, "pid": 1,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "args": args})


def current_span() -> Optional[Span]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_span_path() -> str:
    """'fit/epoch/window/dispatch'-style path of the innermost open span on
    THIS thread ('' outside any span) — the attribution key the recompile
    and host-sync detectors report."""
    stack = getattr(_tls, "stack", None)
    return stack[-1].path if stack else ""
