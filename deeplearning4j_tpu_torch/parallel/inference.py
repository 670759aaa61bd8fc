"""ParallelInference: multi-request inference serving (the legacy path).

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``
(``ParallelInference`` ``:37-145``), host code over the network's
``output``. ``inference_mode="batched"`` (the default) merges concurrent
``output()`` callers into one batch of at most ``batch_limit`` rows; a
request that would overshoot it is carried to the next batch, never split
and never dropped (``:99-112``). A failure reaches every request of its
batch; ``shutdown`` fails every queued request instead of leaving its
caller waiting (``:130-145``). ``"sequential"`` runs each call alone. The
merged batch goes through ``net.output`` on the network's device and the
results are split back as numpy arrays.

This is the simple dynamic batcher: every distinct merged size is a new
shape. For production serving use ``deeplearning4j_tpu_torch.serving``'s
``InferenceEngine`` (shape buckets, warmed programs, admission control,
deadlines, hot swap).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch


def _host(out) -> np.ndarray:
    """A network's output (a tensor on its device) as a numpy array."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class _Request:
    __slots__ = ("x", "event", "result", "error")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None


class ParallelInference:
    def __init__(self, net, *, inference_mode: str = "batched",
                 batch_limit: int = 32, queue_limit: int = 64,
                 max_wait_ms: float = 2.0):
        self.net = net
        self.mode = inference_mode.lower()
        self.batch_limit = batch_limit
        self.max_wait_ms = max_wait_ms
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._shutdown = False
        self._worker: Optional[threading.Thread] = None
        if self.mode == "batched":
            self._worker = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._worker.start()

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def output(self, x):
        x = np.asarray(x)
        if self.mode != "batched":
            if self._shutdown:
                raise RuntimeError("ParallelInference is shut down")
            with self._lock:
                return _host(self.net.output(x))
        req = _Request(x)
        # submit under the lock shutdown() takes, so a request can never
        # slip into the queue after the shutdown drain (it would hang its
        # caller forever — no worker is left to serve it)
        while True:
            with self._submit_lock:
                if self._shutdown:
                    raise RuntimeError("ParallelInference is shut down")
                try:
                    self._queue.put_nowait(req)
                    break
                except queue.Full:
                    pass
            time.sleep(0.0005)        # queue full: wait outside the lock
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _dispatch_loop(self):
        carry: Optional[_Request] = None   # deferred overflow request
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    if self._shutdown:
                        return             # drained: shutdown() failed the rest
                    continue
            batch: List[_Request] = [first]
            total = first.x.shape[0]
            # scoop up whatever else is queued, but NEVER overshoot
            # batch_limit: an overflow request is carried to the next batch
            deadline = self.max_wait_ms / 1000.0
            t0 = time.monotonic()
            while total < self.batch_limit and (time.monotonic() - t0) < deadline:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    if self._shutdown:
                        break              # drain fast, don't wait the window
                    time.sleep(0.0005)
                    continue
                if total + r.x.shape[0] > self.batch_limit:
                    carry = r              # defer: next batch starts with it
                    break
                batch.append(r)
                total += r.x.shape[0]
            try:
                merged = np.concatenate([r.x for r in batch], axis=0)
                out = _host(self.net.output(merged))
                off = 0
                for r in batch:
                    n = r.x.shape[0]
                    r.result = out[off:off + n]
                    off += n
            except Exception as e:  # propagate per-request
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()

    def shutdown(self):
        """Stop the worker and FAIL every request still queued — callers
        blocked in output() get a RuntimeError instead of hanging, and
        later output() calls raise instead of enqueueing to nobody."""
        with self._submit_lock:
            self._shutdown = True
        if self._worker is not None:
            self._worker.join(timeout=2.0)
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            r.error = RuntimeError("ParallelInference shut down before "
                                   "this request was dispatched")
            r.event.set()
