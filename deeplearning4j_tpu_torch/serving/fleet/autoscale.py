"""SLO-driven autoscaling: burn rate and queue depth in, replicas out.

Counterpart of ``deeplearning4j_tpu/serving/fleet/autoscale.py``, the
same code.

The decision function is pure (state in, ``(delta, reason)`` out) so the
policy is unit-testable without processes or clocks; the
:class:`Autoscaler` thread is a thin actuator around it. Scale-out is
driven by the signals the serving stack already publishes — the SLO
watchdog's burn-rate breach list (telemetry/slo.py) and the fleet-wide
queue depth from ``/health`` steering — and is only as useful as cold
start is fast, which is why replicas share one directory of built
kernel libraries (coldstart.py): the replica the autoscaler adds
mid-spike loads its kernel libraries instead of building them.
Scale-in is deliberately timid (deeper cooldown, requires an idle fleet)
and always drains:
``router.drain_replica`` stops admissions first and SIGTERMs only after
the replica's queue and slots are empty, so scale-in is invisible to
in-flight requests.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ...telemetry.tracecontext import event


@dataclass(frozen=True)
class AutoscalePolicy:
    min_replicas: int = 1
    max_replicas: int = 4
    # scale OUT when fleet queue depth exceeds queue_hi * ready replicas
    # (i.e. everyone's admission queue is backing up), or the SLO
    # watchdog reports a burn-rate breach
    queue_hi: int = 4
    # scale IN only when the fleet is idle: no queue and mean decode-slot
    # occupancy under this floor
    occupancy_lo: float = 0.25
    scale_out_cooldown_s: float = 5.0
    scale_in_cooldown_s: float = 30.0


def decide(policy: AutoscalePolicy, *, ready: int, starting: int,
           queue_depth: int, slot_occupancy: float, slo_breached: bool,
           now_s: float, last_out_s: float = float("-inf"),
           last_in_s: float = float("-inf")) -> Tuple[int, str]:
    """Pure scaling decision: ``(delta, reason)`` with delta in
    {-1, 0, +1}. One step per tick — the cooldowns make convergence a
    sequence of small observable moves, never a thundering herd."""
    total = ready + starting
    if total < policy.min_replicas:
        return 1, "below_min"
    out_cool = now_s - last_out_s < policy.scale_out_cooldown_s
    in_cool = now_s - last_in_s < policy.scale_in_cooldown_s
    if total < policy.max_replicas and not out_cool and starting == 0:
        if slo_breached:
            return 1, "slo_burn"
        if ready and queue_depth > policy.queue_hi * ready:
            return 1, "queue_depth"
    if (ready > policy.min_replicas and starting == 0 and not in_cool
            and not slo_breached and queue_depth == 0
            and slot_occupancy < policy.occupancy_lo):
        return -1, "idle"
    return 0, "steady"


class Autoscaler:
    """Actuator loop: scrape router state, decide, add or drain replicas.

        scaler = Autoscaler(router, spec_factory=make_replica,
                            watchdog=watchdog).start()

    ``spec_factory(index)`` returns an UNSTARTED
    :class:`~.replica.ReplicaProcess` for the index-th replica ever
    launched; the scaler starts it without blocking the loop (the
    router's health poller flips it READY when its ready file + /health
    land). ``watchdog`` is a telemetry/slo.py ``SLOWatchdog`` (or any
    object with ``check() -> {"breached": [...]}``); None means
    queue-depth-only scaling. For FLEET-level objectives — burn rate over
    every replica's latency buckets merged honestly, not one process's
    view — pass ``FleetCollector.make_watchdog(objectives)`` (see
    collector.py): same check() contract, fleet-wide data."""

    def __init__(self, router, spec_factory: Callable[[int], object], *,
                 policy: Optional[AutoscalePolicy] = None,
                 watchdog=None, period_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.router = router
        self.spec_factory = spec_factory
        self.policy = policy or AutoscalePolicy()
        self.watchdog = watchdog
        self.period_s = float(period_s)
        self.clock = clock
        self.launched = 0           # monotonic index for spec_factory
        self.history: List[dict] = []
        self._last_out_s = float("-inf")
        self._last_in_s = float("-inf")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- loop
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="fleet-autoscale")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception as e:      # pragma: no cover - keep looping
                event("fleet.autoscale_error", error=str(e))

    # ------------------------------------------------------------- tick
    def observe(self) -> dict:
        """Fleet-wide signals for one decision, from router state."""
        rows = list(self.router.metrics()["replicas"].values())
        ready = [r for r in rows if r["state"] == "ready"]
        starting = [r for r in rows if r["state"] == "starting"]
        queue = sum(r["steering"].get("queue_depth", 0) for r in ready)
        occ = ([r["steering"].get("slot_occupancy", 0.0) for r in ready]
               or [0.0])
        breached: list = []
        if self.watchdog is not None:
            try:
                breached = self.watchdog.check().get("breached", [])
            except Exception:           # watchdog flake must not stall scaling
                breached = []
        return {"ready": len(ready), "starting": len(starting),
                "queue_depth": queue,
                "slot_occupancy": sum(occ) / len(occ),
                "slo_breached": bool(breached), "breached": breached,
                "ready_rows": ready}

    def tick(self) -> Tuple[int, str]:
        obs = self.observe()
        now = self.clock()
        delta, reason = decide(
            self.policy, ready=obs["ready"], starting=obs["starting"],
            queue_depth=obs["queue_depth"],
            slot_occupancy=obs["slot_occupancy"],
            slo_breached=obs["slo_breached"], now_s=now,
            last_out_s=self._last_out_s, last_in_s=self._last_in_s)
        if delta > 0:
            self._scale_out(now, reason, obs)
        elif delta < 0:
            self._scale_in(now, reason, obs)
        if delta:
            self.history.append({"delta": delta, "reason": reason,
                                 "ready": obs["ready"],
                                 "queue_depth": obs["queue_depth"],
                                 "breached": obs["breached"]})
        return delta, reason

    def _scale_out(self, now: float, reason: str, obs: dict) -> None:
        proc = self.spec_factory(self.launched)
        self.launched += 1
        self._last_out_s = now
        event("fleet.scale_out", reason=reason, replica=proc.id,
              queue_depth=obs["queue_depth"], breached=obs["breached"])
        # non-blocking: the router's poller flips it READY when warm
        self.router.add_process(proc, wait_ready=False)

    def _scale_in(self, now: float, reason: str, obs: dict) -> None:
        # drain the least-loaded ready replica; never the last min_replicas
        rows = sorted(obs["ready_rows"],
                      key=lambda r: (r["steering"].get("in_flight", 0)
                                     + r["steering"].get("queue_depth", 0),
                                     r["forwarded"]))
        if not rows:
            return
        rid = rows[0]["id"]
        self._last_in_s = now
        event("fleet.scale_in", reason=reason, replica=rid)
        threading.Thread(target=self.router.drain_replica, args=(rid,),
                         daemon=True,
                         name=f"fleet-drain-{rid}").start()
