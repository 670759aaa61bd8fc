"""Training listeners: the listener protocol and the stock listeners.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``:
``score_to_float`` and ``_LazyScoreStr`` (``:18-40``), ``IterationListener``
and ``TrainingListener`` (``:43-66``), ``ScoreIterationListener``
(``:69-84``), ``CollectScoresIterationListener`` with its deferred scores
(``:87-123``), ``PerformanceListener`` (``:126-263``),
``TimeIterationListener``, ``EvaluativeListener`` and
``SleepyTrainingListener`` (``:266-306``).

The score a listener is handed is the step's loss as a device tensor (a
0-dim tensor, or one element of a window's ``[K]`` losses): the training
loop never reads it back. A listener that needs a number calls
``score_to_float`` when it logs or reports, so a step is not serialized
behind a readback.

``PerformanceListener`` counts samples, batches, host dispatches and the
input pipeline's wait (``note_batch``, from ``optimize/solver.py`` and
``parallel/data_parallel.py``, which take the wait from the
``DevicePrefetchIterator``). A report that falls due inside a window of
K steps (``note_window``) waits for the window's last step, whose time
stamp covers all K. Each report lands in the telemetry registry
(``train.*`` gauges and histograms), and once the cost index holds the
train step's cost (``telemetry/perf.py``) the record also holds
``achieved_tflops`` and ``mfu`` against the peak of the step's compute
dtype on its card; ``mfu`` is None where there is no peak (the CPU, a
card not in ``perf.CHIP_PEAKS``), never a TPU figure.
"""
from __future__ import annotations

import logging
import time
from typing import Any, List, Optional, Tuple

import torch

log = logging.getLogger("deeplearning4j_tpu_torch")


def score_to_float(score) -> float:
    """The score as a host float: the one place a listener reads a device
    loss back (the training loop itself never does)."""
    if isinstance(score, torch.Tensor):
        return float(score.detach().float().cpu())
    return float(score)


class _LazyScoreStr:
    """Defers the device-to-host read past the logging gate: the score is
    read only if a handler formats the record."""

    __slots__ = ("score",)

    def __init__(self, score):
        self.score = score

    def __str__(self):
        return str(score_to_float(self.score))


class IterationListener:
    def iteration_done(self, model, iteration: int, score) -> None:
        """``score`` is the loss of ``iteration``, possibly still a device
        tensor; ``score_to_float`` reads it when a number is needed."""
        pass


class TrainingListener(IterationListener):
    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass

    def on_backward_pass(self, model) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Logs the score every ``print_iterations`` iterations; the score is
    read only when a handler emits the line."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration,
                     _LazyScoreStr(score))


class CollectScoresIterationListener(TrainingListener):
    """Collects (iteration, score) pairs every ``frequency`` iterations.
    The scores are kept as handed in and read back together the first time
    ``scores`` is read, or every ``flush_every`` collected entries, so a run
    that never reads them does not hold one device tensor per iteration."""

    def __init__(self, frequency: int = 1, flush_every: int = 1024):
        self.frequency = max(1, frequency)
        self.flush_every = max(1, flush_every)
        self._raw: List[Tuple[int, Any]] = []
        self._scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self._raw.append((iteration, score))
            if len(self._raw) >= self.flush_every:
                self._flush()

    def _flush(self):
        self._scores.extend((i, score_to_float(s)) for i, s in self._raw)
        self._raw.clear()

    @property
    def scores(self) -> List[Tuple[int, float]]:
        """The collected (iteration, score) pairs; reads any pending device
        scores."""
        if self._raw:
            self._flush()
        return self._scores

    @scores.setter
    def scores(self, value):
        # ``listener.scores = []`` resets, as before the deferred protocol
        self._raw = []
        self._scores = list(value)


class PerformanceListener(TrainingListener):
    """Throughput every ``frequency`` iterations: samples and batches a
    second, the time the loop blocked waiting for its next batch
    (``etl_wait_ms_per_iteration``, the reference's lastEtlTime; zero when
    the prefetcher kept up) and the rest of an iteration's wall time
    (``device_ms_per_iteration``). ``etl_ms_per_iteration`` is an alias of
    the wait.

    The score is read at report time only; at ``frequency=1`` that is one
    read a step.

    Windows (``steps_per_dispatch=K``): the loop calls ``note_window(k)``
    before a window's K-step fan-out, and a report that falls due inside
    the window waits for its last step, so every step of the window is
    counted against the wall time that ran it. The record then also holds
    ``windowed_steps_per_sec`` and ``steps_per_dispatch``, the mean steps a
    host dispatch over the report's interval. The log line is the
    reference's.

    Each report also sets the ``train.samples_per_sec`` /
    ``train.batches_per_sec`` / ``train.windowed_steps_per_sec`` /
    ``train.steps_per_dispatch`` gauges and observes the
    ``train.etl_wait_ms`` / ``train.device_ms`` histograms. Once the cost
    index holds the train step's cost, a record also carries
    ``achieved_tflops`` and ``mfu`` (None without a peak), implied by the
    report's per-step device time; before that it holds neither key, as
    the reference's does before its cost capture."""

    def __init__(self, frequency: int = 10, report_samples: bool = True):
        self.frequency = max(1, frequency)
        self.report_samples = report_samples
        self._last_time = None
        self._samples = 0
        self._batches = 0
        self._etl_ms = 0.0
        self._device_ms = 0.0
        self._window_left = 0     # fan-out calls left in the current window
        self._dispatches = 0      # host dispatches (a window counts once)
        self._report_due = False
        self.history: List[dict] = []

    def note_window(self, k: int):
        """Loop hook: the next ``k`` note_batch / iteration_done calls
        belong to one dispatch."""
        self._window_left = k
        self._dispatches += 1

    def note_batch(self, n_samples: int, etl_ms: float = 0.0,
                   etl_wait_ms: Optional[float] = None,
                   device_ms: float = 0.0):
        self._samples += n_samples
        self._batches += 1
        if self._window_left == 0:   # a window's steps counted in note_window
            self._dispatches += 1
        self._etl_ms += etl_ms if etl_wait_ms is None else etl_wait_ms
        self._device_ms += device_ms

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        mid_window = False
        if self._window_left:
            self._window_left -= 1
            mid_window = self._window_left > 0
        if self._last_time is None:
            self._last_time = now
            return
        if iteration % self.frequency == 0:
            self._report_due = True
        if self._report_due and not mid_window and self._batches:
            self._report_due = False
            dt = max(now - self._last_time, 1e-9)
            etl_per_it = self._etl_ms / self._batches
            steps_per_dispatch = self._batches / max(1, self._dispatches)
            value = score_to_float(score)
            rec = {"iteration": iteration,
                   "samples_per_sec": self._samples / dt,
                   "batches_per_sec": self._batches / dt,
                   "etl_ms_per_iteration": etl_per_it,
                   "etl_wait_ms_per_iteration": etl_per_it,
                   "device_ms_per_iteration": self._device_ms / self._batches,
                   "windowed_steps_per_sec": self._batches / dt,
                   "steps_per_dispatch": steps_per_dispatch,
                   "score": value}
            # cost-model keys (telemetry/perf.py): host floats read at the
            # report point, as the reference's
            from ..telemetry.perf import get_cost_index, implied_mfu
            cost = get_cost_index().train_cost()
            if cost is not None and cost.flops_per_step and \
                    rec["device_ms_per_iteration"] > 0:
                dt_step_s = rec["device_ms_per_iteration"] / 1e3
                rec["mfu"] = implied_mfu(cost.flops_per_step, dt_step_s,
                                         dtype=cost.dtype,
                                         device=cost.device)
                rec["achieved_tflops"] = \
                    cost.flops_per_step / dt_step_s / 1e12
            self.history.append(rec)
            from ..telemetry import get_registry
            reg = get_registry()
            if reg.enabled:
                reg.gauge("train.samples_per_sec").set(rec["samples_per_sec"])
                reg.gauge("train.batches_per_sec").set(rec["batches_per_sec"])
                reg.gauge("train.windowed_steps_per_sec").set(
                    rec["windowed_steps_per_sec"])
                reg.gauge("train.steps_per_dispatch").set(steps_per_dispatch)
                reg.histogram("train.etl_wait_ms").observe(etl_per_it)
                reg.histogram("train.device_ms").observe(
                    rec["device_ms_per_iteration"])
            log.info("iteration %d: %.1f samples/sec, %.2f batches/sec, "
                     "etl wait %.2f ms/it, device %.2f ms/it, score=%.5f",
                     iteration, rec["samples_per_sec"],
                     rec["batches_per_sec"],
                     rec["etl_wait_ms_per_iteration"],
                     rec["device_ms_per_iteration"], value)
            self._last_time = now
            self._samples = 0
            self._batches = 0
            self._dispatches = 0
            self._etl_ms = 0.0
            self._device_ms = 0.0


class TimeIterationListener(TrainingListener):
    """Logs the time left every ``frequency`` iterations."""

    def __init__(self, total_iterations: int, frequency: int = 100):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, score):
        if iteration and iteration % self.frequency == 0:
            elapsed = time.perf_counter() - self.start
            remaining = elapsed / iteration * max(self.total - iteration, 0)
            log.info("iteration %d/%d, ETA %.0fs", iteration, self.total,
                     remaining)


class EvaluativeListener(TrainingListener):
    """Evaluates the model on a held-out iterator every ``frequency``
    iterations; the evaluations are kept in ``evaluations``."""

    def __init__(self, iterator, frequency: int = 100):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.evaluations: List[Any] = []

    def iteration_done(self, model, iteration, score):
        if iteration and iteration % self.frequency == 0:
            e = model.evaluate(self.iterator)
            self.evaluations.append(e)
            log.info("iteration %d eval: accuracy=%.4f", iteration,
                     e.accuracy())


class SleepyTrainingListener(TrainingListener):
    """Sleeps ``sleep_ms`` every iteration (for testing the fan-out)."""

    def __init__(self, sleep_ms: float = 0.0):
        self.sleep_ms = sleep_ms

    def iteration_done(self, model, iteration, score):
        if self.sleep_ms:
            time.sleep(self.sleep_ms / 1000.0)
