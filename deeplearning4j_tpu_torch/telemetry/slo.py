"""SLO watchdogs and the in-step training-health watch.

Counterpart of ``deeplearning4j_tpu/telemetry/slo.py`` (copied, not
imported, apart from ``training_health_vec``): ``LatencySLO``,
``ErrorRateSLO`` and ``ThroughputSLO`` objectives over the registry's
histograms, counters and gauges; ``SLOWatchdog``'s multi-window
error-budget burn rates (``slo.<name>.burn_rate_<w>s`` gauges, a breach
edge fires the flight recorder); and ``TrainingWatch``, the deferred-flush
training-health watchdog, with ``get_`` / ``set_`` for both.

``training_health_vec`` (reference ``:360-381``) is a torch function:
``[loss, sum(grad**2), nonfinite]`` in float32 on the loss's device,
computed inside the training step (``optimize/solver.py``) from the
gradients it already holds, so on the card it rides the step's CUDA
graph. ``TrainingWatch`` keeps the reference's discipline: the loop
thread only appends device vectors (a window's ``[K, 3]`` rows, cloned
out of the graph's output before the next replay); its worker thread
reads them to the host at window boundaries and evaluates them. The
worker reads with ``Tensor.cpu`` (torch tensors have no ``__array__`` on
the card); nothing else differs.
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .flightrec import FlightRecorder, get_flight_recorder
from .registry import MetricsRegistry, get_registry

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["LatencySLO", "ErrorRateSLO", "ThroughputSLO", "SLOWatchdog",
           "get_slo_watchdog", "set_slo_watchdog",
           "TrainingWatch", "get_training_watch", "set_training_watch",
           "training_health_vec", "HEALTH_LEN"]


# --------------------------------------------------------------- objectives
@dataclass(frozen=True)
class LatencySLO:
    """``target`` fraction of observations in ``histogram`` must be
    <= ``threshold_ms``. Good/bad counts come from the histogram's
    cumulative bucket counts (registry.Histogram.count_le)."""
    name: str
    histogram: str
    threshold_ms: float
    target: float = 0.99


@dataclass(frozen=True)
class ErrorRateSLO:
    """``target`` fraction of events must be good. ``good``/``bad`` are
    registry counter names (or tuples of names, summed)."""
    name: str
    good: Union[str, Tuple[str, ...]]
    bad: Union[str, Tuple[str, ...]]
    target: float = 0.999


@dataclass(frozen=True)
class ThroughputSLO:
    """Perf-regression objective: a live throughput/efficiency gauge
    must not fall below ``ratio_floor`` of the best recorded baseline.

    ``metric`` names a registry GAUGE carrying the live steady-state
    rate — ``train.windowed_steps_per_sec`` (PerformanceListener),
    ``generation.<model>.tokens_per_sec``, a ``perf.<path>.mfu`` gauge
    from the cost index (telemetry/perf.py), or any operator-published
    rate. ``baseline`` is the best recorded value for the SAME workload
    — typically ``PerfBaseline.load_trajectory(...).best(row)`` over the
    checked-in ``BENCH_r*.json`` files, or an operator-pinned number.

    Each watchdog ``check()`` turns the gauge into one good/bad sample
    using the paired best-of discipline the bench guards use on this
    noisy rig: the BEST of the last ``best_of`` readings is compared
    against ``ratio_floor * baseline`` — a co-tenant load burst dents
    some readings but not the window's best, while a real regression
    lifts every reading. The good/bad stream then rides the standard
    multi-window burn-rate machinery (``target`` = the fraction of
    checks that must pass), so a sustained regression pages through the
    same breach-edge -> flight-dump path as a latency SLO. A gauge that
    has never been set (0) contributes NO sample — cold start cannot
    breach. ``baseline`` <= 0 (row missing from the trajectory) makes
    the objective report-only: the ratio gauge is published, nothing can
    breach."""
    name: str
    metric: str
    baseline: float
    ratio_floor: float = 0.5
    target: float = 0.9
    best_of: int = 8


def _names(v) -> Tuple[str, ...]:
    return (v,) if isinstance(v, str) else tuple(v)


# ---------------------------------------------------------------- watchdog
class SLOWatchdog:
    """Multi-window error-budget burn-rate watchdog.

    ``windows``: lookback horizons in seconds, ascending.
    ``burn_limits``: per-window burn-rate alert thresholds (aligned with
    ``windows``; default ``(14.4, 6.0, 1.0)``-style — Google SRE fast/
    slow-burn pages: a short window needs a much faster burn to page).
    A breach = ANY window with >= 2 samples AND at least
    ``min_coverage`` of its horizon actually observed (a 1 h window must
    not page off 10 s of cold-start evidence — its lenient limit assumes
    an hour of history) burning past its limit; the not-breached ->
    breached edge increments ``slo.breaches`` and fires the flight
    recorder (rate-limited, ``force=False``). Burn rates are still
    REPORTED for under-covered windows, they just cannot page.

    ``check()`` is explicit (call it from a scrape handler, a step
    callback, or the optional ``start(period_s)`` background thread) and
    accepts an injected ``now`` for deterministic tests.
    """

    _DEFAULT_LIMITS = (14.4, 6.0, 1.0)

    def __init__(self, objectives: Sequence, *,
                 windows: Sequence[float] = (60.0, 300.0, 3600.0),
                 burn_limits: Optional[Sequence[float]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 dump_on_breach: bool = True,
                 min_coverage: float = 0.5,
                 max_samples: int = 4096):
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.windows = tuple(float(w) for w in sorted(windows))
        if burn_limits is None:
            base = self._DEFAULT_LIMITS
            burn_limits = [base[i] if i < len(base) else base[-1]
                           for i in range(len(self.windows))]
        if len(burn_limits) != len(self.windows):
            raise ValueError("burn_limits must align with windows")
        self.burn_limits = tuple(float(b) for b in burn_limits)
        self.min_coverage = float(min_coverage)
        self._registry = registry
        self._flightrec = flight_recorder
        self.dump_on_breach = dump_on_breach
        self._samples: Dict[str, deque] = {
            o.name: deque(maxlen=max_samples) for o in self.objectives}
        # ThroughputSLO state: recent gauge readings (paired best-of
        # window) + cumulative good/bad totals the burn-rate math reads
        self._throughput: Dict[str, dict] = {
            o.name: {"recent": deque(maxlen=o.best_of),
                     "good": 0, "bad": 0}
            for o in self.objectives if isinstance(o, ThroughputSLO)}
        self._breached: Dict[str, bool] = {o.name: False
                                           for o in self.objectives}
        self._last: dict = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def flight_recorder(self) -> FlightRecorder:
        return self._flightrec if self._flightrec is not None \
            else get_flight_recorder()

    # ---------------------------------------------------------------- counts
    def _totals(self, obj) -> Tuple[float, float]:
        """Lifetime (good, bad) totals for one objective."""
        reg = self.registry
        if isinstance(obj, LatencySLO):
            h = reg.histogram(obj.histogram)
            good, total = h.count_le_and_total(obj.threshold_ms)
            return float(good), float(total - good)
        if isinstance(obj, ThroughputSLO):
            return self._throughput_totals(obj)
        good = sum(reg.counter(n).value for n in _names(obj.good))
        bad = sum(reg.counter(n).value for n in _names(obj.bad))
        return float(good), float(bad)

    def _throughput_totals(self, obj: ThroughputSLO) -> Tuple[float, float]:
        """One good/bad sample per check from the live gauge: best of the
        recent readings vs ``ratio_floor * baseline`` (paired best-of —
        the bench-guard discipline for a rig with co-tenant load bursts).
        An unset gauge adds no sample; an unknown baseline never bads."""
        reg = self.registry
        st = self._throughput[obj.name]
        g = reg.gauge_if_exists(obj.metric)
        v = float(g.value) if g is not None else 0.0
        if v > 0:
            st["recent"].append(v)
            best = max(st["recent"])
            if obj.baseline > 0:
                ratio = best / obj.baseline
                if reg.enabled:
                    reg.gauge(f"slo.{obj.name}.throughput_ratio").set(
                        round(ratio, 4))
                if ratio >= obj.ratio_floor:
                    st["good"] += 1
                else:
                    st["bad"] += 1
            else:                      # report-only: no baseline to breach
                st["good"] += 1
        return float(st["good"]), float(st["bad"])

    # ----------------------------------------------------------------- check
    def check(self, now: Optional[float] = None) -> dict:
        """Sample every objective, recompute burn rates, update gauges,
        fire the flight recorder on a fresh breach. Returns the full
        evaluation (also served on ``GET /metrics`` as ``"slo"``)."""
        now = time.monotonic() if now is None else now
        reg = self.registry
        out: dict = {"objectives": {}, "breached": []}
        fresh_breaches: List[tuple] = []
        with self._lock:
            for obj in self.objectives:
                good, bad = self._totals(obj)
                samples = self._samples[obj.name]
                samples.append((now, good, bad))
                budget = max(1e-9, 1.0 - obj.target)
                row: dict = {"target": obj.target,
                             "good": good, "bad": bad,
                             "burn_rates": {}, "breached_windows": [],
                             "truncated_windows": []}
                breached = False
                # retention check: a FULL deque whose oldest sample is
                # younger than a window means frequent check() calls
                # evicted that window's true baseline — the burn rate is
                # over a shorter horizon than its label claims (no
                # silent caps: surface it)
                full = len(samples) == samples.maxlen
                oldest_age = now - samples[0][0]
                for w, limit in zip(self.windows, self.burn_limits):
                    if full and oldest_age < w:
                        row["truncated_windows"].append(f"{int(w)}s")
                    # the just-appended sample (t == now) is always in
                    # window, so a base always exists
                    base = None
                    n_in_window = 0
                    for t, g, b in samples:       # oldest-first scan
                        if t >= now - w:
                            if base is None:
                                base = (t, g, b)
                            n_in_window += 1
                    dg = good - base[1]
                    db = bad - base[2]
                    total = dg + db
                    bad_frac = (db / total) if total > 0 else 0.0
                    burn = bad_frac / budget
                    key = f"{int(w)}s"
                    row["burn_rates"][key] = round(burn, 4)
                    if reg.enabled:
                        reg.gauge(f"slo.{obj.name}.burn_rate_{key}").set(
                            round(burn, 4))
                    # a window may only BREACH once min_coverage of its
                    # horizon has been observed: the 1 h limit is lenient
                    # because it assumes an hour of evidence — 10 s of
                    # cold-start blips must not page through it
                    if n_in_window >= 2 and burn > limit \
                            and oldest_age >= w * self.min_coverage:
                        breached = True
                        row["breached_windows"].append(key)
                row["breached"] = breached
                if reg.enabled:
                    reg.gauge(f"slo.{obj.name}.breached").set(
                        1.0 if breached else 0.0)
                was = self._breached[obj.name]
                self._breached[obj.name] = breached
                if breached:
                    out["breached"].append(obj.name)
                out["objectives"][obj.name] = row
                if breached and not was:
                    if reg.enabled:
                        reg.counter("slo.breaches").inc()
                    log.warning(
                        "SLO '%s' breached: burn rates %s (target %s)",
                        obj.name, row["burn_rates"], obj.target)
                    fresh_breaches.append((obj, row["burn_rates"]))
            self._last = out
        # flight-recorder file I/O OUTSIDE the lock: a breach edge during
        # a /metrics scrape must not serialize concurrent scrapers (or
        # the background checker) behind a json dump + fsync
        if self.dump_on_breach:
            for obj, burns in fresh_breaches:
                self.flight_recorder.dump(
                    f"slo_breach_{obj.name}", force=False,
                    objective=obj.name, target=obj.target,
                    burn_rates=burns)
        return out

    def snapshot(self) -> dict:
        """Most recent evaluation (empty before the first check)."""
        with self._lock:
            return dict(self._last)

    # ------------------------------------------------------------ background
    def start(self, period_s: float = 5.0) -> "SLOWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.check()
                except Exception as e:    # a watchdog must not die silently
                    log.warning("SLO watchdog check failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


_watchdog: Optional[SLOWatchdog] = None
_watchdog_lock = threading.Lock()


def get_slo_watchdog() -> Optional[SLOWatchdog]:
    """The registered process-wide watchdog (None until one is set) —
    the serving HTTP ``/metrics`` route surfaces it when present."""
    return _watchdog


def set_slo_watchdog(wd: Optional[SLOWatchdog]) -> Optional[SLOWatchdog]:
    global _watchdog
    with _watchdog_lock:
        prev, _watchdog = _watchdog, wd
    return prev


# ----------------------------------------------------------- training watch
HEALTH_LEN = 3          # [loss, grad_norm_sq, nonfinite_count] (f32)


def training_health_vec(loss, grads):
    """The in-step health summary: ONE [3] float32 tensor a step,
    ``[loss, sum(grad**2), nonfinite_indicator]``, on the loss's device.
    ``grads``: a tensor or nested dicts, lists and tuples of them (None
    entries skipped). No host read.

    Non-finite detection is free given the norm: any inf/nan gradient
    element makes ``sum(grad**2)`` inf/nan, so the indicator counts the
    non-finite AGGREGATES (grad-norm², loss), not elements."""
    import torch
    gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
    for g in _grad_leaves(grads):
        gsq = gsq + g.detach().float().square().sum()
    lf = loss.detach().float().reshape(())
    nonfin = ((~torch.isfinite(gsq)).float()
              + (~torch.isfinite(lf)).float())
    return torch.stack([lf, gsq, nonfin])


def _grad_leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _grad_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _grad_leaves(v)
    else:
        yield tree


class TrainingWatch:
    """Deferred-flush training-health watchdog.

    The fit loop calls :meth:`on_health` with the step's health vector —
    a device tensor that is only ever appended to a host list (zero syncs
    on the loop thread). Once ``window`` steps are buffered
    the batch is queued to a background worker that materializes the
    values and evaluates:

      - ``nonfinite``: any non-finite grad/loss value,
      - ``grad_norm``: sqrt(grad_norm_sq) above ``grad_norm_limit``,
      - ``loss_spike``: loss above ``loss_spike_factor`` x the rolling
        median of recent finite losses (after ``spike_history`` >= 4
        steps of history).

    Any of them marks the run unhealthy: ``training_watch.unhealthy``
    counter, ``training_watch.healthy`` gauge -> 0, a WARNING naming
    step + reason, and a flight-recorder dump carrying the preceding
    spans/events. Arm it globally with :func:`set_training_watch`; the
    Solver picks it up at the next ``fit`` (the SGD paths, per step and in
    windows; tbptt/second-order keep their own structure and are not
    watched).
    """

    def __init__(self, *, window: int = 32,
                 grad_norm_limit: Optional[float] = None,
                 loss_spike_factor: Optional[float] = 10.0,
                 spike_history: int = 16,
                 dump_on_unhealthy: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 flight_recorder: Optional[FlightRecorder] = None):
        self.window = max(1, int(window))
        self.grad_norm_limit = grad_norm_limit
        self.loss_spike_factor = loss_spike_factor
        self.spike_history = max(4, int(spike_history))
        self.dump_on_unhealthy = dump_on_unhealthy
        self._registry = registry
        self._flightrec = flight_recorder
        self._buf: List[tuple] = []        # (it0, device [3] or [K,3], k)
        self._buffered = 0
        self._loss_hist: deque = deque(maxlen=self.spike_history)
        self._q: "_queue.Queue" = _queue.Queue()
        self._submitted = 0
        self._processed = 0
        self._lock = threading.Lock()
        # bounded: a diverged run that keeps training must not grow an
        # unbounded record list (the counter keeps the true total)
        self.unhealthy: deque = deque(maxlen=256)
        self.unhealthy_total = 0
        self.steps_seen = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="training-watch")
        self._thread.start()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    @property
    def flight_recorder(self) -> FlightRecorder:
        return self._flightrec if self._flightrec is not None \
            else get_flight_recorder()

    @property
    def healthy(self) -> bool:
        return not self.unhealthy

    # -------------------------------------------------- loop-thread surface
    def on_health(self, it0: int, health, k: int = 1) -> None:
        """Record one dispatch's health output: ``health`` is the device
        [3] vector (k=1) or stacked [K, 3] (fused window). Append-only on
        this thread; flushes to the worker at window boundaries."""
        self._buf.append((int(it0), health, int(k)))
        self._buffered += int(k)
        self.steps_seen += int(k)
        if self._buffered >= self.window:
            self.flush()

    def flush(self) -> None:
        """Hand the buffered window to the worker (no device reads on
        the calling thread — materialization happens on the worker)."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        self._buffered = 0
        with self._lock:
            self._submitted += 1
        self._q.put(buf)

    def drain(self, timeout: float = 10.0) -> bool:
        """Flush and wait for the worker to evaluate everything queued
        (tests / end-of-fit). Returns False on timeout."""
        self.flush()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._processed >= self._submitted:
                    return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        self.drain(timeout=5.0)
        self._q.put(None)
        self._thread.join(timeout=5.0)

    # ----------------------------------------------------- worker evaluation
    def _worker(self) -> None:
        import numpy as np
        while True:
            batch = self._q.get()
            if batch is None:
                return
            try:
                for it0, health, k in batch:
                    if hasattr(health, "detach"):   # a (device) tensor
                        health = health.detach().float().cpu().numpy()
                    vals = np.asarray(health, np.float32)
                    if vals.ndim == 1:
                        vals = vals[None]
                    for i in range(vals.shape[0]):
                        self._evaluate(it0 + i, float(vals[i, 0]),
                                       float(vals[i, 1]), float(vals[i, 2]))
            except Exception as e:        # never kill the watch thread
                log.warning("training watch: evaluation failed: %s", e)
            finally:
                with self._lock:
                    self._processed += 1

    def _evaluate(self, it: int, loss: float, gsq: float,
                  nonfin: float) -> None:
        import math
        reason = None
        detail: dict = {}
        grad_norm = math.sqrt(gsq) if gsq >= 0 and math.isfinite(gsq) \
            else float("inf")
        if nonfin > 0:
            reason = "nonfinite"
            detail["nonfinite_count"] = int(nonfin)
        elif self.grad_norm_limit is not None \
                and grad_norm > self.grad_norm_limit:
            reason = "grad_norm"
            detail["grad_norm"] = round(grad_norm, 6)
            detail["limit"] = self.grad_norm_limit
        elif self.loss_spike_factor is not None and math.isfinite(loss) \
                and len(self._loss_hist) >= 4:
            hist = sorted(self._loss_hist)
            baseline = hist[len(hist) // 2]
            if baseline > 0 and loss > baseline * self.loss_spike_factor:
                reason = "loss_spike"
                detail["loss"] = round(loss, 6)
                detail["baseline_median"] = round(baseline, 6)
        if math.isfinite(loss):
            self._loss_hist.append(loss)
        reg = self.registry
        if reg.enabled:
            reg.gauge("training_watch.loss").set(
                loss if math.isfinite(loss) else -1.0)
            reg.gauge("training_watch.grad_norm").set(
                grad_norm if math.isfinite(grad_norm) else -1.0)
        if reason is None:
            return
        rec = {"iteration": it, "reason": reason, "loss": loss,
               "grad_norm": grad_norm, **detail}
        self.unhealthy.append(rec)
        self.unhealthy_total += 1
        if reg.enabled:
            reg.counter("training_watch.unhealthy").inc()
            reg.counter(f"training_watch.unhealthy.{reason}").inc()
            reg.gauge("training_watch.healthy").set(0.0)
        # throttle past the first few: a run that stays diverged would
        # otherwise emit one WARNING per step for the rest of training
        if self.unhealthy_total <= 5 or self.unhealthy_total % 100 == 0:
            log.warning("training watch: UNHEALTHY at step %d (%s): %s "
                        "(%d unhealthy steps total)",
                        it, reason, detail or f"loss={loss}",
                        self.unhealthy_total)
        if self.dump_on_unhealthy:
            self.flight_recorder.dump(f"training_{reason}", force=False,
                                      **rec)


_watch: Optional[TrainingWatch] = None
_watch_lock = threading.Lock()


def get_training_watch() -> Optional[TrainingWatch]:
    """The armed process-wide training watch (None = health compute off:
    the step computes no health vector)."""
    return _watch


def set_training_watch(w: Optional[TrainingWatch]
                       ) -> Optional[TrainingWatch]:
    global _watch
    with _watch_lock:
        prev, _watch = _watch, w
    return prev
