"""The port's ``serving/fleet/autoscale.py``: the pure decision function
and the actuator. The reference's ``tests/test_fleet_autoscale.py`` case
by case, and ``decide`` beside the JAX package's over a grid of fleet
states.

decide() is a pure function of fleet state and the clock, so the whole
policy truth table runs without processes; the Autoscaler tests drive
tick() by hand against a duck-typed fake router and a manual clock.
"""
import _torch_threads  # noqa: F401
import itertools
import threading
import time
from types import SimpleNamespace

from deeplearning4j_tpu.serving.fleet import autoscale as jauto
from deeplearning4j_tpu_torch.serving.fleet.autoscale import (
    Autoscaler, AutoscalePolicy, decide)

P = AutoscalePolicy(min_replicas=1, max_replicas=4, queue_hi=4,
                    occupancy_lo=0.25, scale_out_cooldown_s=5.0,
                    scale_in_cooldown_s=30.0)


def _decide(**kw):
    base = dict(ready=2, starting=0, queue_depth=0, slot_occupancy=0.5,
                slo_breached=False, now_s=1000.0)
    base.update(kw)
    return decide(P, **base)


# ------------------------------------------------------------ truth table
def test_below_min_always_scales_out():
    assert _decide(ready=0, starting=0) == (1, "below_min")
    # even inside the cooldown window — a fleet below min is an outage
    assert _decide(ready=0, last_out_s=999.0) == (1, "below_min")


def test_slo_burn_scales_out():
    assert _decide(slo_breached=True) == (1, "slo_burn")


def test_queue_depth_scales_out_per_ready_replica():
    # threshold is queue_hi * ready: 2 ready -> backlog must exceed 8
    assert _decide(queue_depth=8) == (0, "steady")
    assert _decide(queue_depth=9) == (1, "queue_depth")


def test_scale_out_respects_cooldown_max_and_starting():
    assert _decide(slo_breached=True, last_out_s=996.0) == (0, "steady")
    assert _decide(slo_breached=True, ready=4) == (0, "steady")
    # a replica already starting absorbs the signal — one step per tick
    assert _decide(slo_breached=True, starting=1) == (0, "steady")


def test_idle_scale_in_requires_everything():
    idle = dict(queue_depth=0, slot_occupancy=0.1)
    assert _decide(**idle) == (-1, "idle")
    assert _decide(**idle, ready=1) == (0, "steady")        # at min
    assert _decide(**idle, last_in_s=990.0) == (0, "steady")  # cooldown
    assert _decide(queue_depth=1, slot_occupancy=0.1) == (0, "steady")
    assert _decide(queue_depth=0, slot_occupancy=0.5) == (0, "steady")
    assert _decide(**idle, slo_breached=True) == (1, "slo_burn")
    assert _decide(**idle, starting=1) == (0, "steady")


# --------------------------------------------------------------- actuator
class _FakeRouter:
    def __init__(self, rows):
        self.rows = {r["id"]: r for r in rows}
        self.added = []
        self.drained = []
        self.drain_event = threading.Event()

    def metrics(self):
        return {"replicas": dict(self.rows)}

    def add_process(self, proc, wait_ready=True):
        self.added.append(proc)

    def drain_replica(self, rid):
        self.drained.append(rid)
        self.drain_event.set()
        return True


def _row(rid, state="ready", queue=0, occ=0.5, in_flight=0, forwarded=0):
    return {"id": rid, "state": state, "forwarded": forwarded,
            "steering": {"queue_depth": queue, "slot_occupancy": occ,
                         "in_flight": in_flight}}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_tick_scales_out_on_queue_and_respects_cooldown():
    router = _FakeRouter([_row("a", queue=6, occ=0.9),
                          _row("b", queue=6, occ=0.9),
                          _row("x", state="dead", queue=99)])
    clock = _Clock()
    scaler = Autoscaler(router,
                        lambda i: SimpleNamespace(id=f"auto{i}"),
                        policy=P, clock=clock)
    clock.t = 100.0
    assert scaler.tick() == (1, "queue_depth")      # 12 > 4*2
    assert [p.id for p in router.added] == ["auto0"]
    assert scaler.launched == 1
    clock.t = 101.0                                 # inside cooldown
    assert scaler.tick() == (0, "steady")
    clock.t = 106.0
    assert scaler.tick() == (1, "queue_depth")
    assert [p.id for p in router.added] == ["auto0", "auto1"]
    assert [h["reason"] for h in scaler.history] == ["queue_depth",
                                                     "queue_depth"]


def test_tick_scales_out_on_watchdog_breach():
    router = _FakeRouter([_row("a", queue=0, occ=0.3)])
    watchdog = SimpleNamespace(
        check=lambda: {"breached": [{"slo": "ttft_p99"}]})
    scaler = Autoscaler(router, lambda i: SimpleNamespace(id=f"a{i}"),
                        policy=P, watchdog=watchdog, clock=_Clock())
    delta, reason = scaler.tick()
    assert (delta, reason) == (1, "slo_burn")
    assert scaler.history[0]["breached"] == [{"slo": "ttft_p99"}]


def test_watchdog_failure_never_stalls_scaling():
    router = _FakeRouter([_row("a", queue=20, occ=0.9)])
    watchdog = SimpleNamespace(
        check=lambda: (_ for _ in ()).throw(RuntimeError("flake")))
    scaler = Autoscaler(router, lambda i: SimpleNamespace(id=f"a{i}"),
                        policy=P, watchdog=watchdog, clock=_Clock())
    assert scaler.tick() == (1, "queue_depth")


def test_tick_drains_least_loaded_on_idle():
    router = _FakeRouter([_row("busy", occ=0.1, in_flight=2, forwarded=9),
                          _row("lazy", occ=0.1, in_flight=0, forwarded=1)])
    scaler = Autoscaler(router, lambda i: SimpleNamespace(id=f"a{i}"),
                        policy=P, clock=_Clock())
    assert scaler.tick() == (-1, "idle")
    assert router.drain_event.wait(timeout=5.0)     # background drain
    assert router.drained == ["lazy"]
    # immediately after: the scale-in cooldown holds the next move
    assert scaler.tick() == (0, "steady")


def test_observe_folds_ready_rows_only():
    router = _FakeRouter([_row("a", queue=3, occ=0.2),
                          _row("b", queue=5, occ=0.6),
                          _row("s", state="starting", queue=99, occ=1.0),
                          _row("d", state="dead", queue=99)])
    scaler = Autoscaler(router, lambda i: None, policy=P, clock=_Clock())
    obs = scaler.observe()
    assert obs["ready"] == 2 and obs["starting"] == 1
    assert obs["queue_depth"] == 8
    assert abs(obs["slot_occupancy"] - 0.4) < 1e-9
    assert obs["slo_breached"] is False


def test_actuator_thread_start_stop():
    router = _FakeRouter([_row("a")])
    scaler = Autoscaler(router, lambda i: None, policy=P, period_s=0.01,
                        clock=time.monotonic)
    scaler.start()
    try:
        deadline = time.monotonic() + 5.0
        while not scaler._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert scaler._thread.is_alive()
    finally:
        scaler.stop()
    assert scaler._thread is None


# ------------------------------------------------ beside the JAX package
def test_decide_equals_the_references_over_a_grid():
    jp = jauto.AutoscalePolicy(min_replicas=1, max_replicas=4, queue_hi=4,
                               occupancy_lo=0.25, scale_out_cooldown_s=5.0,
                               scale_in_cooldown_s=30.0)
    n = 0
    for ready, starting, queue, occ, slo, last_out, last_in in \
            itertools.product((0, 1, 2, 4), (0, 1), (0, 3, 9, 17),
                              (0.0, 0.2, 0.9), (False, True),
                              (float("-inf"), 998.0), (float("-inf"), 990.0)):
        kw = dict(ready=ready, starting=starting, queue_depth=queue,
                  slot_occupancy=occ, slo_breached=slo, now_s=1000.0,
                  last_out_s=last_out, last_in_s=last_in)
        assert decide(P, **kw) == jauto.decide(jp, **kw), kw
        n += 1
    assert n == 4 * 2 * 4 * 3 * 2 * 2 * 2
