"""Capped exponential backoff with an optional deterministic mode.

A copy of ``deeplearning4j_tpu/util/retry.py`` (stdlib only, kept here
so the port imports nothing of the JAX package). Serving's ``/reload``
retries its checkpoint loads through it; one policy object keeps the
backoff math, the give-up contract and the deterministic test mode in
one place.

Design:
  - delays are ``base * multiplier**attempt`` capped at ``max_delay_s``;
    with ``jitter > 0`` each delay is scaled by a seeded uniform draw in
    ``[1-jitter, 1]`` (full determinism comes from ``jitter=0.0`` — the
    test mode — or a fixed ``seed``).
  - ``timeout_s`` is an overall wall budget across attempts: a retry
    whose *sleep* would cross the budget gives up immediately (no
    pointless terminal sleep).
  - give-up raises :class:`RetryError` carrying the attempt count and
    the last exception (``__cause__``-chained, so tracebacks compose).
  - ``sleep``/``clock`` are injectable so unit tests exercise timeout
    and give-up paths without real waiting.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional

__all__ = ["RetryError", "RetryPolicy", "retry_call"]


class RetryError(RuntimeError):
    """All attempts exhausted (count or time budget). ``last`` is the
    final underlying exception (also chained as ``__cause__``)."""

    def __init__(self, message: str, *, attempts: int, elapsed_s: float,
                 last: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last = last


class RetryPolicy:
    """Capped exponential backoff.

        policy = RetryPolicy(max_attempts=5, base_delay_s=0.1,
                             max_delay_s=2.0)
        result = policy.call(load_checkpoint, path)

    ``retryable`` filters which exceptions are worth retrying (default:
    every ``Exception``); a non-retryable exception propagates untouched
    on the first throw. ``jitter=0.0`` (the default) is the
    deterministic mode — delays are a pure function of the attempt
    index, which is what the elastic-coordinator tests pin."""

    def __init__(self, *, max_attempts: int = 5, base_delay_s: float = 0.1,
                 max_delay_s: float = 2.0, multiplier: float = 2.0,
                 timeout_s: Optional[float] = None, jitter: float = 0.0,
                 seed: Optional[int] = None,
                 retryable: Optional[Callable[[BaseException], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.multiplier = multiplier
        self.timeout_s = timeout_s
        self.jitter = jitter
        self.seed = seed
        self.retryable = retryable
        self._sleep = sleep
        self._clock = clock

    def delays(self) -> Iterator[float]:
        """The (max_attempts - 1) sleep durations between attempts."""
        rng = random.Random(self.seed) if self.jitter else None
        for attempt in range(self.max_attempts - 1):
            d = min(self.base_delay_s * (self.multiplier ** attempt),
                    self.max_delay_s)
            if rng is not None:
                d *= 1.0 - self.jitter * rng.random()
            yield d

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy. ``on_retry`` is
        invoked as ``on_retry(attempt_index, exc)`` before each sleep."""
        t0 = self._clock()
        delays = self.delays()
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - filtered below
                if self.retryable is not None and not self.retryable(e):
                    raise
                last = e
            elapsed = self._clock() - t0
            delay = next(delays, None)
            if delay is None:        # count budget exhausted
                raise RetryError(
                    f"gave up after {attempt + 1} attempts "
                    f"({elapsed:.3f}s): {last}",
                    attempts=attempt + 1, elapsed_s=elapsed,
                    last=last) from last
            if self.timeout_s is not None and elapsed + delay > self.timeout_s:
                raise RetryError(
                    f"time budget {self.timeout_s}s exhausted after "
                    f"{attempt + 1} attempts ({elapsed:.3f}s): {last}",
                    attempts=attempt + 1, elapsed_s=elapsed,
                    last=last) from last
            if on_retry is not None:
                on_retry(attempt, last)
            self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               **kwargs):
    """Convenience wrapper: ``retry_call(fn, a, b, policy=p, kw=1)``."""
    return (policy or RetryPolicy()).call(fn, *args, **kwargs)
