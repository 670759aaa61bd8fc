"""Paged autoregressive generation (counterpart of
``deeplearning4j_tpu/serving/generation``)."""
from .engine import GenerationEngine
from .kvcache import BlockAllocator
from .programs import GenerationConfig
from .scheduler import TokenStream

__all__ = ["GenerationEngine", "GenerationConfig", "BlockAllocator",
           "TokenStream"]
