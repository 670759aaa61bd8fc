"""Deterministic fault injection for elastic training.

Counterpart of ``deeplearning4j_tpu/parallel/faults.py``: the errors
(``:53-64``), the faults and ``FaultPlan`` (``:68-117``), the file-damage
helpers (``:121-167``) and ``FaultInjector`` (``:171-262``), host code
ported whole. A :class:`FaultPlan` is an explicit list of faults keyed to
the supervised step counter, so a test says "worker 2 dies at step 12, the
newest checkpoint is truncated, coordination flakes twice during
recovery" and gets the same run every time.

Fault kinds:
  - :class:`KillWorker` raises :class:`WorkerLostError` out of the step
    loop at step N. ``rejoin=True`` is a preempted worker that comes back
    before recovery completes (the mesh re-forms at full size, and the
    recovered run is bitwise an uninterrupted one); ``rejoin=False`` is a
    worker lost for good (the mesh re-forms smaller).
  - :class:`SlowCollective` reports a synthetic per-collective latency to
    the supervisor over a step range (the degraded-mode trigger);
    optionally sleeps for wall-clock realism.
  - :class:`CorruptCheckpoint` truncates (or bit-flips) the newest
    on-disk checkpoint's shard files at step N, after draining the
    asynchronous writer so the damage is deterministic.
  - :class:`PreemptAt` fires the trainer's preemption flag at step N (the
    in-process stand-in for SIGTERM).
  - :class:`CoordinationFlake`: the next ``n`` coordination attempts
    during recovery raise :class:`CoordinationError` (the retry and
    give-up paths).

Order within a step: disk damage, then preemption, then the kill. Workers
are indices into the trainer's worker list (``surviving``). The file
helpers (:func:`truncate_newest_sharded`, :func:`corrupt_newest_sharded`,
:func:`truncate_newest_zip`) work on the port's
``util/distributed_checkpoint.py`` and ``util/checkpointing.py`` files.
Each injected kill and each checkpoint damage first dumps the flight
recorder (``fault_killworker``, ``fault_corruptcheckpoint``; reference
``_blackbox``, ``:218-222``), so every chaos run leaves a readable black
box of the spans and events before the injected loss.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set

from ..telemetry.flightrec import get_flight_recorder
from ..util import distributed_checkpoint as _dck  # a module: no cycle

__all__ = [
    "WorkerLostError", "CoordinationError", "Fault", "KillWorker",
    "SlowCollective", "CorruptCheckpoint", "PreemptAt", "CoordinationFlake",
    "FaultPlan", "FaultInjector", "truncate_newest_sharded",
    "corrupt_newest_sharded", "truncate_newest_zip",
]


class WorkerLostError(RuntimeError):
    """A mesh worker stopped responding (injected or real)."""

    def __init__(self, worker: int, step: int):
        super().__init__(f"worker {worker} lost at step {step}")
        self.worker = worker
        self.step = step


class CoordinationError(RuntimeError):
    """Transient coordination failure during mesh re-form (retryable)."""


# ------------------------------------------------------------------ faults
@dataclass
class Fault:
    step: int
    fired: bool = field(default=False, init=False)


@dataclass
class KillWorker(Fault):
    worker: int = 0
    rejoin: bool = False


@dataclass
class SlowCollective(Fault):
    """Per-collective extra latency over ``[step, until_step)``."""
    until_step: int = 0
    delay_ms: float = 0.0
    sleep: bool = False        # also burn real wall time (soak realism)


@dataclass
class CorruptCheckpoint(Fault):
    mode: str = "truncate"     # "truncate" | "flip"


@dataclass
class PreemptAt(Fault):
    pass


@dataclass
class CoordinationFlake(Fault):
    """Arms ``failures`` transient coordination errors (consumed by the
    recovery path's retry loop, regardless of which step recovery starts
    at — ``step`` only orders the plan)."""
    failures: int = 1


class FaultPlan:
    """An ordered list of faults. ``FaultPlan(KillWorker(step=10), ...)``."""

    def __init__(self, *faults: Fault):
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.step)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)


# ------------------------------------------------------- file-damage helpers
def truncate_newest_sharded(directory: str, keep_bytes: int = 64) -> Optional[int]:
    """Truncate every shard file of the newest sharded checkpoint (manifest
    left intact — the dangerous shape: a save that LOOKS complete). Returns
    the damaged step, or None if the directory has no checkpoints."""
    ckpts = _dck.list_sharded_checkpoints(directory)
    if not ckpts:
        return None
    step = ckpts[-1][0]
    for path in _dck._shard_files(directory, step):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(min(keep_bytes, size))
    return step


def corrupt_newest_sharded(directory: str) -> Optional[int]:
    """Flip bytes mid-file in every shard of the newest checkpoint: the
    zip central directory survives (``is_zipfile`` passes) but the member
    CRC fails on read — the corruption only the actual restore catches."""
    ckpts = _dck.list_sharded_checkpoints(directory)
    if not ckpts:
        return None
    step = ckpts[-1][0]
    for path in _dck._shard_files(directory, step):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(16)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
    return step


def truncate_newest_zip(directory: str, keep_bytes: int = 64) -> Optional[str]:
    """Truncate the newest ``checkpoint_epoch*.zip`` (util/checkpointing
    format). Returns the damaged path."""
    from ..util.checkpointing import _scan_checkpoints
    entries = _scan_checkpoints(directory)
    if not entries:
        return None
    path = entries[-1][0]
    with open(path, "r+b") as f:
        f.truncate(min(keep_bytes, os.path.getsize(path)))
    return path


# ---------------------------------------------------------------- injector
class FaultInjector:
    """Executes a :class:`FaultPlan` against a supervised step loop.

    The elastic trainer calls :meth:`on_step` once per completed dispatch
    (with the post-increment step counter), :meth:`collective_delay_ms`
    when estimating sync latency, :meth:`on_coordinate` inside each
    recovery attempt, and :meth:`on_recovery` once a recovery succeeds.
    All methods are also callable directly from tests."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.failed_workers: Set[int] = set()
        self._flakes_armed = 0
        self.coordination_attempts = 0

    # ------------------------------------------------------------ step hook
    def on_step(self, step: int, trainer=None) -> None:
        """Apply every not-yet-fired fault with ``fault.step <= step``.
        Order within a step: disk damage first, then preemption, then the
        kill (so a kill+corrupt plan at the same step damages the disk the
        recovery will read)."""
        due = [f for f in self.plan if not f.fired and f.step <= step
               and not isinstance(f, (SlowCollective, CoordinationFlake))]
        kill: Optional[KillWorker] = None
        for f in due:
            if isinstance(f, CorruptCheckpoint):
                f.fired = True
                self._apply_corrupt(f, trainer)
                self._blackbox(f, step)
            elif isinstance(f, PreemptAt):
                f.fired = True
                if trainer is not None:
                    trainer._on_preempt()
            elif isinstance(f, KillWorker):
                kill = f
        for f in self.plan:
            if isinstance(f, CoordinationFlake) and not f.fired \
                    and f.step <= step:
                f.fired = True
                self._flakes_armed += f.failures
        if kill is not None:
            kill.fired = True
            self.failed_workers.add(kill.worker)
            # the dump before the raise: the black box holds what preceded
            # the injected loss
            self._blackbox(kill, step, worker=kill.worker)
            raise WorkerLostError(kill.worker, step)
        for f in self.plan:
            if isinstance(f, SlowCollective) and f.sleep \
                    and f.step <= step < f.until_step:
                time.sleep(f.delay_ms / 1e3)

    @staticmethod
    def _blackbox(fault: Fault, step: int, **info) -> None:
        get_flight_recorder().dump(
            f"fault_{type(fault).__name__.lower()}", step=step,
            planned_step=fault.step, **info)

    def _apply_corrupt(self, f: CorruptCheckpoint, trainer) -> None:
        directory = getattr(trainer, "checkpoint_dir", None)
        if directory is None:
            return
        writer = getattr(trainer, "_writer", None)
        if writer is not None:
            writer.flush()      # damage the *landed* newest, deterministically
        if f.mode == "flip":
            corrupt_newest_sharded(directory)
        else:
            truncate_newest_sharded(directory)

    # ------------------------------------------------------- latency signal
    def collective_delay_ms(self, step: int) -> float:
        """Synthetic per-collective latency active at ``step`` (sum of
        overlapping SlowCollective windows)."""
        return sum(f.delay_ms for f in self.plan
                   if isinstance(f, SlowCollective)
                   and f.step <= step < f.until_step)

    # ----------------------------------------------------- recovery hooks
    def on_coordinate(self) -> None:
        """Called inside each mesh re-form attempt. Rejoin-flagged killed
        workers answer the coordination call (a preempted VM that came
        back — the mesh re-forms at full size), then armed coordination
        flakes raise (exercising the retry/backoff path)."""
        for f in self.plan:
            if isinstance(f, KillWorker) and f.fired and f.rejoin:
                self.failed_workers.discard(f.worker)
        self.coordination_attempts += 1
        if self._flakes_armed > 0:
            self._flakes_armed -= 1
            raise CoordinationError(
                f"injected coordination flake "
                f"({self._flakes_armed} more armed)")

    def surviving(self, devices: Sequence) -> List:
        return [d for i, d in enumerate(devices)
                if i not in self.failed_workers]
