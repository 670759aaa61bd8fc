"""Early stopping: config, termination conditions, model savers, trainer.

Counterpart of ``deeplearning4j_tpu/earlystopping/early_stopping.py``, the
same classes with the same arguments and the same loop. The port's
differences: ``LocalFileModelSaver`` writes and reads the port's model
zips (``util/serialization.py``, byte-compatible with the JAX package's;
a restored model lives on the saver's ``device``, the CUDA card unless the
caller names another); the iteration guard is a plain score callback
(the port's ``set_listeners`` takes those); and ``EarlyStoppingTrainer``
fits an epoch through ``_fit_epoch``, which ``EarlyStoppingParallelTrainer``
routes through its ``ParallelWrapper``.

Reference: earlystopping/* — EarlyStoppingConfiguration,
termination/{MaxEpochsTerminationCondition, MaxTimeIterationTerminationCondition,
MaxScoreIterationTerminationCondition, InvalidScoreIterationTerminationCondition,
ScoreImprovementEpochTerminationCondition, BestScoreEpochTerminationCondition},
saver/{InMemoryModelSaver, LocalFileModelSaver},
trainer/BaseEarlyStoppingTrainer.java:76 (fit() loop).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..device import DeviceLike


# ----------------------------------------------------------------- score calc
class DataSetLossCalculator:
    """Average loss over a held-out iterator (reference
    earlystopping/scorecalc/DataSetLossCalculator)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            total += net.score(dataset=ds) * ds.num_examples()
            n += ds.num_examples()
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return total / n if (self.average and n) else total


# ------------------------------------------------------- epoch-level condits
class MaxEpochsTerminationCondition:
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float, improved: bool) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after N epochs without (min-delta) improvement."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._since = 0

    def terminate(self, epoch: int, score: float, improved: bool) -> bool:
        if improved:
            self._since = 0
        else:
            self._since += 1
        return self._since > self.patience


class BestScoreEpochTerminationCondition:
    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def terminate(self, epoch: int, score: float, improved: bool) -> bool:
        return score <= self.best_expected_score


# --------------------------------------------------- iteration-level condits
class MaxTimeIterationTerminationCondition:
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start: Optional[float] = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score: float) -> bool:
        return (time.monotonic() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition:
    """Stop immediately if the score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        return score > self.max_score


class InvalidScoreIterationTerminationCondition:
    """Stop on NaN/Inf score — the reference's closest thing to failure
    detection (SURVEY.md §5.3)."""

    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        return math.isnan(score) or math.isinf(score)


# ---------------------------------------------------------------- savers
class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, net, score):
        self.best = net.clone()

    def save_latest_model(self, net, score):
        self.latest = net.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver:
    """Save best/latest model zips in a directory (reference
    saver/LocalFileModelSaver); restored models live on ``device``."""

    def __init__(self, directory: str, *, device: DeviceLike = None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, kind):
        return os.path.join(self.directory, f"{kind}Model.bin")

    def save_best_model(self, net, score):
        from ..util.serialization import write_model
        write_model(net, self._path("best"))

    def save_latest_model(self, net, score):
        from ..util.serialization import write_model
        write_model(net, self._path("latest"))

    def get_best_model(self):
        from ..util.serialization import restore_model
        return restore_model(self._path("best"), device=self.device)

    def get_latest_model(self):
        from ..util.serialization import restore_model
        return restore_model(self._path("latest"), device=self.device)


# ---------------------------------------------------------------- config
@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    model_saver: Any = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[Any] = field(default_factory=list)
    iteration_termination_conditions: List[Any] = field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingTrainer:
    """Reference trainer/BaseEarlyStoppingTrainer.java:76 fit() loop."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator

    def _fit_epoch(self) -> None:
        self.net.fit(iterator=self.train_iterator, epochs=1)

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        best_score, best_epoch = float("inf"), -1
        scores = {}
        epoch = 0
        reason, details = "EpochTerminationCondition", ""

        class _IterGuard:
            def __init__(self):
                self.tripped = None

            def iteration_done(self, model, iteration, score):
                if not cfg.iteration_termination_conditions:
                    return
                # one host read of the loss an iteration, shared by the
                # conditions; under K-step windows the listeners run after
                # the window, so termination is window-granular
                s = float(score)
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(s):
                        self.tripped = c
                        raise _StopTraining()

        guard = _IterGuard()
        saved_listeners = list(self.net.listeners)
        self.net.set_listeners(*(saved_listeners + [guard]))
        try:
            while True:
                try:
                    self._fit_epoch()
                except _StopTraining:
                    reason = "IterationTerminationCondition"
                    details = type(guard.tripped).__name__
                    break
                if epoch % cfg.evaluate_every_n_epochs == 0:
                    score = (cfg.score_calculator.calculate_score(self.net)
                             if cfg.score_calculator else self.net.score)
                    scores[epoch] = float(score)
                    improved = score < best_score
                    if improved:
                        best_score, best_epoch = float(score), epoch
                        cfg.model_saver.save_best_model(self.net, score)
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest_model(self.net, score)
                    stop = False
                    for c in cfg.epoch_termination_conditions:
                        if c.terminate(epoch, float(score), improved):
                            details = type(c).__name__
                            stop = True
                            break
                    if stop:
                        break
                epoch += 1
        finally:
            self.net.set_listeners(*saved_listeners)
        best_model = cfg.model_saver.get_best_model()
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch + 1,
            best_model=best_model or self.net)


class _StopTraining(Exception):
    pass
