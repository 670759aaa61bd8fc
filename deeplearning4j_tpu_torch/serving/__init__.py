"""Counterpart of ``deeplearning4j_tpu/serving``: the forward
``InferenceEngine`` here, paged generation in ``serving.generation``."""
from .batcher import ShapeBucketedBatcher
from .buckets import BucketLadder
from .engine import InferenceEngine
from .errors import (DeadlineExceededError, DrainingError, QueueFullError,
                     ServingError, ShapeMismatchError, UnknownModelError)
from .metrics import ServingMetrics, warm_count
from .programs import ProgramSet, default_forward

__all__ = ["InferenceEngine", "ShapeBucketedBatcher", "BucketLadder",
           "ProgramSet", "default_forward", "ServingMetrics", "warm_count",
           "ServingError", "QueueFullError", "DrainingError",
           "DeadlineExceededError", "UnknownModelError",
           "ShapeMismatchError"]
