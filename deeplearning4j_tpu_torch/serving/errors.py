"""Serving error taxonomy.

A copy of ``deeplearning4j_tpu/serving/errors.py`` (framework-free, kept
here so the port imports nothing of the JAX package). Each class maps to
one HTTP status code once the HTTP front end is ported, so admission
decisions made deep in the scheduler surface as the right wire response."""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class; http.py maps subclasses to status codes."""


class QueueFullError(ServingError):
    """Admission refused: the model's bounded queue is at capacity (429)."""


class DrainingError(ServingError):
    """Admission refused: the engine/model is draining or stopped (503)."""


class DeadlineExceededError(ServingError):
    """The caller's deadline expired before a result was ready (504)."""


class UnknownModelError(ServingError):
    """No model registered under the requested name (404)."""


class ShapeMismatchError(ServingError):
    """Request feature shape/dtype doesn't match the model's warmed
    programs (400) — the ladder is compiled for one trailing shape."""


class BlockPoolExhaustedError(QueueFullError):
    """Generation admission refused: the paged KV-cache block pool cannot
    supply the blocks the request needs (429, like its parent).
    ``retryable=False`` marks the PERMANENT flavor — the request needs more
    blocks than the pool has at all, so retrying can never help and
    http.py omits the ``retry_after_ms`` hint."""

    def __init__(self, *args, retryable: bool = True):
        super().__init__(*args)
        self.retryable = retryable


class GenerationClosedError(ServingError):
    """The generation was terminated before completing (shutdown or
    internal failure); streaming callers see the stream close with this
    as the error, blocking callers get it raised (500/503)."""
