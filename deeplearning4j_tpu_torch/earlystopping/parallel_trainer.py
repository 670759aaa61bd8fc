"""EarlyStoppingParallelTrainer: early stopping over data-parallel fitting.

Counterpart of ``deeplearning4j_tpu/earlystopping/parallel_trainer.py``
(reference parallelism/EarlyStoppingParallelTrainer.java): the
``EarlyStoppingTrainer`` loop with each epoch's fit run by the port's
``ParallelWrapper`` over its logical mesh; the termination, saver and score
machinery are the same.
"""
from __future__ import annotations

from typing import Optional

from ..parallel.data_parallel import ParallelWrapper
from .early_stopping import EarlyStoppingConfiguration, EarlyStoppingTrainer


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, *, mesh=None, workers: Optional[int] = None,
                 averaging_frequency: int = 1,
                 training_mode: str = "shared_gradients",
                 average_updaters: bool = True,
                 gradient_accumulator=None):
        super().__init__(config, net, train_iterator)
        self.wrapper = ParallelWrapper(
            net, mesh=mesh, workers=workers,
            averaging_frequency=averaging_frequency,
            training_mode=training_mode, average_updaters=average_updaters,
            gradient_accumulator=gradient_accumulator)

    def _fit_epoch(self) -> None:
        self.wrapper.fit(self.train_iterator, epochs=1)
