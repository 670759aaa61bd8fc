"""Distributed request tracing: ``TraceContext`` and the ``event()`` API.

Counterpart of ``deeplearning4j_tpu/telemetry/tracecontext.py`` (copied,
not imported): a (128-bit trace id, 64-bit span id) pair held
thread-locally; while one is active every span closed by ``spans.py``
and every ``event`` stamps ``trace_id`` into its record, so one request's
journey (HTTP ingress, admission, batch, prefill, each decode step) can
be read back from the trace by id, though the work hops threads.
``normalize_trace_id`` is the wire-format rule the HTTP ingress and the
JSONL filter share. Cross-thread handoff is explicit: ``handoff()``
captures the producer's context and span path, ``adopt(token)`` runs the
consumer's scope under it with an isolated span stack.

Everything here is host bookkeeping; a disabled registry makes ``event``
one attribute check. No deliberate differences.
"""
from __future__ import annotations

import os
import random as _random
import re
import threading
import time
from typing import Optional

from .registry import get_registry

# id mint: a process-seeded Mersenne generator, NOT os.urandom per id —
# urandom is a ~8 us syscall on older kernels and a context is minted per
# request on the serving hot path; getrandbits is a single C call (~1 us,
# GIL-atomic, so the shared instance is thread-safe). Ids need
# uniqueness, not cryptographic strength.
_idgen = _random.Random(int.from_bytes(os.urandom(16), "big"))

__all__ = ["TraceContext", "new_trace_context", "normalize_trace_id",
           "current_trace_context", "current_trace_id",
           "use_trace_context", "handoff", "adopt", "event"]

_tls = threading.local()

# inbound X-Trace-Id values: hex (dashes tolerated, stripped), 8..64 chars
# after stripping — anything else is replaced with a fresh id rather than
# letting a caller inject arbitrary bytes into the trace files
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,64}$")


class TraceContext:
    """One request's identity: ``trace_id`` (32 hex chars / 128 bits)
    plus a per-hop ``span_id`` (16 hex chars). Immutable value object —
    activate it with :func:`use_trace_context`."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id or f"{_idgen.getrandbits(64):016x}"

    def child(self) -> "TraceContext":
        """Same trace, fresh span id (one per handoff hop)."""
        return TraceContext(self.trace_id)

    def __repr__(self):
        return f"TraceContext({self.trace_id}/{self.span_id})"


def normalize_trace_id(trace_id) -> Optional[str]:
    """THE wire-format normalization (lowercase, dashes stripped,
    validated hex): one rule shared by the HTTP ingress, the JSONL
    export filter and context minting. Returns None for invalid input.
    (tools/trace2summary.py keeps a deliberate stdlib-only copy.)"""
    if not trace_id:
        return None
    tid = str(trace_id).strip().lower().replace("-", "")
    return tid if _TRACE_ID_RE.match(tid) else None


def new_trace_context(trace_id: Optional[str] = None) -> TraceContext:
    """A fresh context. ``trace_id`` (e.g. an inbound ``X-Trace-Id``
    header) is normalized (lowercase, dashes stripped) and validated;
    invalid or absent values get a generated 128-bit id."""
    tid = normalize_trace_id(trace_id)
    if tid is not None:
        return TraceContext(tid)
    return TraceContext(f"{_idgen.getrandbits(128):032x}")


def current_trace_context() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def current_trace_id() -> Optional[str]:
    ctx = getattr(_tls, "ctx", None)
    return ctx.trace_id if ctx is not None else None


class _CtxScope:
    """Context manager installing ``ctx`` on this thread for the scope."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self._prev = None

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc) -> bool:
        _tls.ctx = self._prev
        return False


def use_trace_context(ctx: Optional[TraceContext]) -> _CtxScope:
    """``with use_trace_context(ctx): ...`` — spans/events in the scope
    stamp ``ctx.trace_id``. ``None`` deactivates tracing for the scope."""
    return _CtxScope(ctx)


class Handoff:
    """Captured (trace context, span path) to carry across a queue or
    executor boundary. Produce where the work is enqueued; consume with
    :func:`adopt` on the thread that executes it."""

    __slots__ = ("ctx", "span_path")

    def __init__(self, ctx: Optional[TraceContext], span_path: str):
        self.ctx = ctx
        self.span_path = span_path

    @property
    def trace_id(self) -> Optional[str]:
        return self.ctx.trace_id if self.ctx is not None else None


def handoff() -> Handoff:
    """Capture the calling thread's trace context + innermost span path
    (cheap: two thread-local reads; safe to call with no context/span)."""
    from .spans import current_span_path
    return Handoff(current_trace_context(), current_span_path())


class _AdoptScope:
    """Run a scope under a handed-off context with an ISOLATED span
    stack: spans opened inside parent under ``token.span_path`` (as a
    virtual root), not under whatever the consumer thread has open —
    and on exit the consumer thread's own stack is restored untouched."""

    __slots__ = ("token", "_prev_ctx", "_saved_stack", "_saved_root")

    def __init__(self, token: Handoff):
        self.token = token

    def __enter__(self) -> Handoff:
        from . import spans
        self._prev_ctx = getattr(_tls, "ctx", None)
        _tls.ctx = self.token.ctx
        self._saved_stack = getattr(spans._tls, "stack", None)
        self._saved_root = getattr(spans._tls, "virtual_root", "")
        spans._tls.stack = []
        spans._tls.virtual_root = self.token.span_path
        return self.token

    def __exit__(self, *exc) -> bool:
        from . import spans
        _tls.ctx = self._prev_ctx
        spans._tls.stack = self._saved_stack if self._saved_stack is not None \
            else []
        spans._tls.virtual_root = self._saved_root
        return False


def adopt(token: Handoff) -> _AdoptScope:
    """``with adopt(token): ...`` on the consuming thread/executor."""
    return _AdoptScope(token)


def event(name: str, *, trace_id: Optional[str] = None, cat: str = "event",
          **attrs) -> None:
    """Land one instant trace event (Chrome-trace ``"ph": "i"``) stamped
    with the active span path and trace id. ``trace_id=`` overrides the
    thread's active context — the pattern for loops that advance MANY
    requests at once (the decode step emits one event per participating
    slot, each with that request's id). ``attrs`` must be host values;
    a disabled registry makes this a single attribute check."""
    reg = get_registry()
    if not reg.enabled:
        return
    global _spans
    if _spans is None:                       # one-time module resolve —
        from . import spans as _s            # the per-call import costs
        _spans = _s                          # microseconds on a hot loop
    attrs["path"] = _spans.current_span_path()   # kwargs dict is fresh
    tid = trace_id
    if tid is None:
        ctx = getattr(_tls, "ctx", None)
        if ctx is not None:
            tid = ctx.trace_id
    if tid is not None:
        attrs["trace_id"] = tid
    reg.record_event({"name": name, "ph": "i", "cat": cat, "s": "t",
                      "ts": (time.perf_counter_ns() + _spans._EPOCH_NS)
                      // 1000,
                      "pid": 1,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "args": attrs})


_spans = None
