"""Early stopping (counterpart of ``deeplearning4j_tpu/earlystopping``)."""
from .early_stopping import (BestScoreEpochTerminationCondition,
                             DataSetLossCalculator, EarlyStoppingConfiguration,
                             EarlyStoppingResult, EarlyStoppingTrainer,
                             InMemoryModelSaver,
                             InvalidScoreIterationTerminationCondition,
                             LocalFileModelSaver,
                             MaxEpochsTerminationCondition,
                             MaxScoreIterationTerminationCondition,
                             MaxTimeIterationTerminationCondition,
                             ScoreImprovementEpochTerminationCondition)
from .parallel_trainer import EarlyStoppingParallelTrainer

__all__ = [n for n in dir() if not n.startswith("_")]
