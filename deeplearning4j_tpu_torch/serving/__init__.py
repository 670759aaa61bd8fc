"""Counterpart of ``deeplearning4j_tpu/serving``: the forward
``InferenceEngine`` and its HTTP front end (``ServingHTTPServer``) here,
paged generation in ``serving.generation``."""
from .batcher import ShapeBucketedBatcher
from .buckets import BucketLadder
from .engine import InferenceEngine
from .errors import (DeadlineExceededError, DrainingError, QueueFullError,
                     ServingError, ShapeMismatchError, UnknownModelError)
from .http import ServingHTTPServer, status_for
from .metrics import ServingMetrics, warm_count
from .programs import ProgramSet, default_forward
from .registry import load_net

__all__ = ["InferenceEngine", "ServingHTTPServer", "status_for",
           "load_net", "ShapeBucketedBatcher", "BucketLadder", "ProgramSet",
           "default_forward", "ServingMetrics", "warm_count",
           "ServingError", "QueueFullError", "DrainingError",
           "DeadlineExceededError", "UnknownModelError",
           "ShapeMismatchError"]
