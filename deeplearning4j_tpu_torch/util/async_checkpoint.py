"""Background checkpoint writes and the preemption guard.

Counterpart of ``deeplearning4j_tpu/util/async_checkpoint.py``:
``AsyncCheckpointWriter`` (``:62-200``) and ``PreemptionGuard``
(``:203-240``).

- **``submit(step, tree)``** runs on the training thread and never waits
  for the device or the disk: it enqueues a copy of every tensor leaf on
  the current stream (new memory, so later in-place steps cannot change
  what the writer reads), records a CUDA event after the copies and hands
  the snapshot to the writer thread. On the CPU the copy is made at once.
  A captured window never runs a snapshot: the wrapper calls its
  ``step_callback`` (where a loop submits) after a window's replays.
- **The writer thread** waits for the event, marks each snapshot tensor
  as used on its own stream (``record_stream``, so the caching allocator
  does not hand the memory out before the copy to the host has run),
  copies to the host and writes through
  ``distributed_checkpoint.save_sharded_checkpoint`` (the manifest last,
  by atomic rename), then prunes to ``keep_last`` complete saves.
- **Latest wins.** One snapshot waits at most: a submit while the writer
  is busy replaces the waiting one (``submit`` returns False), so a slow
  disk lowers the checkpoint rate, never the step rate.
- **``save_sync``** writes on the calling thread (the preemption path),
  after the queue is drained, and skips a step already written.

``PreemptionGuard`` installs handlers for SIGTERM (the preemption notice)
that only set ``triggered`` and call ``on_preempt``; the training loop
polls it and calls ``save_sync`` at its next step boundary, where the
state is consistent.

Telemetry (reference ``:108-193``), into ``registry`` (the process-wide
one by default): the ``elastic.checkpoint.submitted`` and ``.dropped``
counters on the training thread, a ``checkpoint_write`` span around each
write, then ``elastic.checkpoint.errors`` or ``.written`` and the
``elastic.checkpoint.write_ms`` histogram. ``write_ms`` keeps each write's
time too.
"""
from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..telemetry import get_registry, span
from .distributed_checkpoint import (DistributedCheckpointer,
                                     save_sharded_checkpoint, tree_flatten,
                                     tree_unflatten)

_log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["AsyncCheckpointWriter", "PreemptionGuard"]


class _Snapshot:
    """A tree's leaves copied on the device (on the stream current at
    ``submit``) and the event recorded after the copies (None on the
    CPU)."""

    def __init__(self, tree: Any, specs: Any = None):
        self.specs = specs
        leaves, self.spec = tree_flatten(tree)
        self.leaves = [t.detach().clone() for t in leaves]
        self.event = None
        dev = next((t.device for t in self.leaves if t.is_cuda), None)
        if dev is not None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def to_host(self) -> Any:
        """The snapshot on the host, after its copies (writer thread)."""
        if self.event is not None:
            self.event.synchronize()
            out = []
            for t in self.leaves:
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
                out.append(t.cpu())
        else:
            out = self.leaves
        return tree_unflatten(self.spec, out)


class AsyncCheckpointWriter:
    """Sharded checkpoints written by a background thread with a
    latest-wins queue (see the module docstring):

        w = AsyncCheckpointWriter(directory, keep_last=3)
        w.submit(step, {"params": ..., "state": ..., "opt": ...})
        ...
        w.flush(); w.close()
    """

    def __init__(self, directory: str, *, keep_last: int = 3,
                 registry=None):
        self.directory = directory
        self.keep_last = keep_last
        self._reg = registry if registry is not None else get_registry()
        self._ckpt = DistributedCheckpointer(directory, every_n_steps=1,
                                             keep_last=keep_last)
        self._lock = threading.Condition()
        self._pending: Optional[tuple] = None  # (step, snap, extra, sharding)
        self._writing: Optional[int] = None
        self._stop = False
        self.last_completed_step: Optional[int] = None
        self.last_error: Optional[BaseException] = None
        self.write_ms: List[float] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="async-ckpt-writer")
        self._thread.start()

    # ----------------------------------------------------- training side
    def submit(self, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None,
               sharding: Optional[Dict[str, Any]] = None,
               specs: Any = None) -> bool:
        """Snapshot ``tree`` and queue it as ``step``; False if it replaced
        an older waiting snapshot. ``sharding`` is the manifest's layout
        block (the ZeRO engine's ``sharding_meta()``), ``specs`` the tree's
        model-axis layout (``save_sharded_checkpoint``'s)."""
        snap = _Snapshot(tree, specs)
        fresh = True
        with self._lock:
            if self._stop:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            if self._pending is not None:
                fresh = False
                if self._reg.enabled:
                    self._reg.counter("elastic.checkpoint.dropped").inc()
            self._pending = (step, snap, dict(extra or {}), sharding)
            self._lock.notify_all()
        if self._reg.enabled:
            self._reg.counter("elastic.checkpoint.submitted").inc()
        return fresh

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until nothing waits or is being written; True if drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._pending is not None or self._writing is not None:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if remaining == 0.0:
                    return False
                self._lock.wait(remaining if remaining is not None else 0.5)
        return True

    def save_sync(self, step: int, tree: Any,
                  extra: Optional[Dict[str, Any]] = None,
                  sharding: Optional[Dict[str, Any]] = None,
                  specs: Any = None) -> None:
        """Write now on the calling thread, after draining the queue (the
        steps on disk stay in order); a step already written is
        skipped."""
        self.flush()
        if self.last_completed_step is not None \
                and step <= self.last_completed_step:
            return
        self._write(step, _Snapshot(tree, specs), dict(extra or {}),
                    sharding)

    def close(self, flush: bool = True) -> None:
        if flush:
            self.flush()
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=30.0)

    @property
    def pending(self) -> bool:
        with self._lock:
            return self._pending is not None or self._writing is not None

    # ------------------------------------------------------- writer side
    def _run(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._lock.wait()
                if self._pending is None and self._stop:
                    return
                step, snap, extra, sharding = self._pending
                self._pending = None
                self._writing = step
            try:
                self._write(step, snap, extra, sharding)
            finally:
                with self._lock:
                    self._writing = None
                    self._lock.notify_all()

    def _write(self, step: int, snap: _Snapshot, extra: Dict[str, Any],
               sharding: Optional[Dict[str, Any]] = None) -> None:
        t0 = time.perf_counter()
        try:
            with span("checkpoint_write", step=step):
                save_sharded_checkpoint(self.directory, step,
                                        snap.to_host(), extra=extra,
                                        sharding=sharding, specs=snap.specs)
                self._ckpt._prune()
        except BaseException as e:  # a sick disk must not kill training
            self.last_error = e
            if self._reg.enabled:
                self._reg.counter("elastic.checkpoint.errors").inc()
            _log.warning("async checkpoint write for step %d failed: %s",
                         step, e)
            return
        self.last_completed_step = step
        ms = (time.perf_counter() - t0) * 1e3
        self.write_ms.append(ms)
        if self._reg.enabled:
            self._reg.counter("elastic.checkpoint.written").inc()
            self._reg.histogram("elastic.checkpoint.write_ms").observe(ms)


class PreemptionGuard:
    """Signal handlers that set ``triggered`` and call ``on_preempt``
    (nothing that takes a lock: a handler runs on the interrupted main
    thread). The loop polls ``triggered`` and writes its final checkpoint
    (``AsyncCheckpointWriter.save_sync``) at the next step boundary. Also a
    context manager; ``uninstall`` puts the previous handlers back."""

    def __init__(self, on_preempt: Optional[Callable[[], None]] = None,
                 signals: Iterable[int] = (signal.SIGTERM,)):
        self.on_preempt = on_preempt
        self.signals = tuple(signals)
        self.triggered = False
        self._old: Dict[int, Any] = {}

    def _handler(self, signum, frame):  # noqa: ARG002
        self.triggered = True
        if self.on_preempt is not None:
            self.on_preempt()

    def install(self) -> "PreemptionGuard":
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
