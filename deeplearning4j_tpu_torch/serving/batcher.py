"""Shape-bucketed dynamic batcher: bounded queue, deadlines, drain.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py``: the same
admission, coalescing, deferral and resolution rules, and the same
telemetry: a request carries its submitter's trace id to the dispatch
thread (``serving.admit`` and ``serving.batch`` events), each batch's
dispatch time lands in ``serving.<model>.bucket<b>.dispatch_ms`` (the
timing half of the bucket's cost entry; the runner returns a host array,
so this is device-complete time) and a dispatch error fires the flight
recorder (``serving_dispatch_error``, rate-limited). The runner is
called on the batcher's own thread; the port's runner launches its kernels
on that thread's current stream and returns a numpy array, so the result
is on the host before a caller's event is set. One addition: ``on_start``
runs on that thread before it takes any request, and the constructor waits
for it and raises its error. CUDA libraries keep per-thread state (cuBLAS
and cuDNN handles, their workspaces), so the engine warms its buckets
there, on the thread that serves them, and not on the caller's.

Fixes the legacy ParallelInference contract holes by construction:
  - a candidate that would overshoot the largest bucket is DEFERRED to the
    next batch, never merged (the legacy loop appended whatever it popped);
  - every admitted request is resolved exactly once — served, failed with
    the model error, failed at shutdown, or skipped as expired — so callers
    with ``event.wait(timeout)`` can never hang;
  - admission is fast-fail: a full queue or a draining batcher raises
    immediately (HTTP 429/503) instead of blocking the caller.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

from .buckets import BucketLadder
from .errors import (DeadlineExceededError, DrainingError, QueueFullError,
                     ShapeMismatchError)
from ..telemetry.flightrec import get_flight_recorder
from ..telemetry.registry import get_registry
from ..telemetry.tracecontext import current_trace_id, event
from .metrics import ServingMetrics


class _Request:
    __slots__ = ("x", "n", "event", "result", "error", "enqueue_t",
                 "deadline", "abandoned", "trace_id")

    def __init__(self, x: np.ndarray, deadline: float):
        self.x = x
        self.n = x.shape[0]
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueue_t = time.monotonic()
        self.deadline = deadline
        self.abandoned = False        # caller gave up (deadline expired)
        # the submitter's trace id rides the request to the dispatch
        # thread, which stamps it on the request's batch event (None: an
        # untraced caller costs nothing)
        self.trace_id = current_trace_id()


class ShapeBucketedBatcher:
    """Coalesces concurrent ``submit()`` callers into padded ladder-bucket
    batches and runs them through ``runner`` (an np.ndarray -> np.ndarray
    callable over warmed programs; the engine resolves the active model
    version per batch, which is what makes hot-swap seamless)."""

    def __init__(self, runner: Callable[[np.ndarray], np.ndarray],
                 ladder: BucketLadder, feature_shape: Tuple[int, ...],
                 dtype=np.float32, *, queue_limit: int = 256,
                 batch_window_ms: float = 2.0,
                 default_timeout_s: float = 30.0,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "default",
                 on_start: Optional[Callable[[], object]] = None):
        self._runner = runner
        self.ladder = ladder
        self.feature_shape = tuple(int(d) for d in feature_shape)
        self.dtype = np.dtype(dtype)
        self.queue_limit = queue_limit
        self.window_s = batch_window_ms / 1000.0
        self.default_timeout_s = default_timeout_s
        self.metrics = metrics or ServingMetrics()
        self.name = name
        self._dq: "deque[_Request]" = deque()
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._on_start = on_start
        self._start_error: Optional[Exception] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"serving-batcher-{name}")
        self._thread.start()
        self._started.wait()
        if self._start_error is not None:
            self._thread.join()
            raise self._start_error

    # ------------------------------------------------------------- admission
    @property
    def queue_depth(self) -> int:
        return len(self._dq)

    @property
    def draining(self) -> bool:
        return self._draining

    def submit(self, x, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking predict with a hard deadline. Oversized requests are
        chunked across max-bucket sub-requests and reassembled, so callers
        see the legacy accept-any-size contract with bounded programs."""
        t_start = time.monotonic()
        timeout = self.default_timeout_s if timeout is None else timeout
        deadline = t_start + timeout
        x = np.asarray(x)
        if x.ndim == len(self.feature_shape):      # single row convenience
            x = x[None]
        if x.shape[0] == 0:
            raise ShapeMismatchError("empty request (0 rows)")
        if tuple(x.shape[1:]) != self.feature_shape:
            raise ShapeMismatchError(
                f"model '{self.name}' serves feature shape "
                f"{self.feature_shape}, got {tuple(x.shape[1:])}")
        x = np.ascontiguousarray(x, self.dtype)
        mx = self.ladder.max
        if x.shape[0] <= mx:
            out = self._submit_one(x, deadline)
        else:
            reqs = []
            try:
                for off in range(0, x.shape[0], mx):
                    reqs.append(self._enqueue(x[off:off + mx], deadline))
                parts = [self._await(r, deadline) for r in reqs]
            except BaseException:
                # partial failure (queue full / deadline / model error):
                # abandon the sibling chunks so the dispatcher skips them
                # instead of running padded batches nobody is waiting on
                for r in reqs:
                    r.abandoned = True
                raise
            out = np.concatenate(parts, axis=0)
        self.metrics.record_request(
            (time.monotonic() - t_start) * 1000.0, x.shape[0])
        return out

    def _submit_one(self, x: np.ndarray, deadline: float) -> np.ndarray:
        req = self._enqueue(x, deadline)
        return self._await(req, deadline)

    def _enqueue(self, x: np.ndarray, deadline: float) -> _Request:
        req = _Request(x, deadline)
        with self._cond:
            if self._draining or self._stopped:
                self.metrics.record_rejection("draining")
                raise DrainingError(
                    f"model '{self.name}' is draining/stopped")
            if len(self._dq) >= self.queue_limit:
                self.metrics.record_rejection("full")
                raise QueueFullError(
                    f"model '{self.name}' queue full "
                    f"({self.queue_limit} requests)")
            self._dq.append(req)
            self._cond.notify_all()
        if req.trace_id is not None:
            event("serving.admit", model=self.name, rows=req.n,
                  queue_depth=len(self._dq))
        return req

    def _await(self, req: _Request, deadline: float) -> np.ndarray:
        remaining = deadline - time.monotonic()
        if not req.event.wait(max(0.0, remaining)):
            req.abandoned = True
        if req.event.is_set():     # dispatcher resolved it (maybe in the race)
            if req.error is not None:
                if isinstance(req.error, DeadlineExceededError):
                    self.metrics.record_rejection("deadline")
                raise req.error
            return req.result
        self.metrics.record_rejection("deadline")
        raise DeadlineExceededError(
            f"deadline expired after "
            f"{round(deadline - req.enqueue_t, 3)}s "
            f"(queue depth {self.queue_depth})")

    # -------------------------------------------------------------- dispatch
    def _loop(self):
        try:
            if self._on_start is not None:
                self._on_start()
        except Exception as e:                 # raised by the constructor
            self._start_error = e
            self._stopped = self._draining = True
            return
        finally:
            self._started.set()
        while True:
            first = self._take_first()
            if first is None:
                return                         # stopped and queue empty
            batch, total = [first], first.n
            window_end = time.monotonic() + self.window_s
            mx = self.ladder.max
            while total < mx:
                now = time.monotonic()
                if now >= window_end and not self._dq:
                    break
                with self._cond:
                    r = self._dq[0] if self._dq else None
                    if r is not None:
                        if r.abandoned or (now > r.deadline):
                            self._dq.popleft()
                            self._expire(r)
                            continue
                        if total + r.n > mx:
                            break              # DEFER: next batch, no overshoot
                        self._dq.popleft()
                    elif now < window_end and not self._stopped:
                        if all(b.abandoned or now > b.deadline
                               for b in batch):
                            break     # nobody left waiting: free the window
                        self._cond.wait(min(window_end - now, 0.0005))
                        continue
                    else:
                        break
                batch.append(r)
                total += r.n
            self._dispatch(batch, total)

    def _take_first(self) -> Optional[_Request]:
        while True:
            with self._cond:
                while not self._dq and not self._stopped:
                    self._cond.wait(0.05)
                if not self._dq:
                    return None                # stopped + drained
                req = self._dq.popleft()
            if req.abandoned or time.monotonic() > req.deadline:
                self._expire(req)
                continue
            return req

    def _expire(self, req: _Request) -> None:
        req.error = DeadlineExceededError("deadline expired while queued")
        req.event.set()

    def _dispatch(self, batch, total: int) -> None:
        t_disp = time.monotonic()
        # drop requests whose caller already gave up (their 504 is raised);
        # running them would spend a padded device batch on nobody
        live = []
        for r in batch:
            if r.abandoned or t_disp > r.deadline:
                self._expire(r)
            else:
                live.append(r)
        if not live:
            return
        batch = live
        total = sum(r.n for r in batch)
        bucket = self.ladder.bucket_for(total)
        padded = np.zeros((bucket,) + self.feature_shape, self.dtype)
        off = 0
        for r in batch:
            padded[off:off + r.n] = r.x
            off += r.n
        try:
            t_run = time.perf_counter()
            out = self._runner(padded)
            reg = get_registry()
            if reg.enabled:
                reg.histogram(
                    f"serving.{self.name}.bucket{bucket}.dispatch_ms"
                ).observe((time.perf_counter() - t_run) * 1e3)
        except Exception as e:                 # model/device-side failure
            # the loop keeps serving: every caller of this batch gets the
            # error, and the next batch runs
            self.metrics.record_rejection("error")
            for r in batch:
                r.error = e
                r.event.set()
            # the black box after the callers are resolved; rate-limited,
            # since a failing runner fails every batch
            get_flight_recorder().dump(
                "serving_dispatch_error", force=False, model=self.name,
                bucket=bucket, rows=total, error=str(e),
                error_type=type(e).__name__)
            return
        self.metrics.record_batch(bucket, total)
        for r in batch:
            self.metrics.record_queue_wait((t_disp - r.enqueue_t) * 1000.0)
            if r.trace_id is not None:
                # the dispatch thread has no trace context of its own:
                # each request's id is stamped on its batch event
                event("serving.batch", trace_id=r.trace_id,
                      model=self.name, bucket=bucket, rows=r.n,
                      queue_ms=round((t_disp - r.enqueue_t) * 1e3, 3))
        off = 0
        for r in batch:
            r.result = out[off:off + r.n]
            off += r.n
            r.event.set()

    # -------------------------------------------------------------- lifecycle
    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """drain=True: refuse new work (503) but flush everything queued;
        drain=False: refuse new work AND fail everything queued now."""
        with self._cond:
            self._draining = True
            if not drain:
                while self._dq:
                    r = self._dq.popleft()
                    r.error = DrainingError(
                        f"model '{self.name}' shut down before dispatch")
                    r.event.set()
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout)
        # belt-and-braces: if the worker died or timed out, nothing may hang
        with self._cond:
            while self._dq:
                r = self._dq.popleft()
                r.error = DrainingError(f"model '{self.name}' stopped")
                r.event.set()
