"""Paged autoregressive generation (counterpart of
``deeplearning4j_tpu/serving/generation``): the block pool and its stores
(``kvcache``), the prefix cache (``prefix``), speculative decoding
(``speculative``), the programs (``programs``), the decode step's CUDA
graph (``graphs``), sampling, the continuous-batching scheduler, its
metrics and the engine."""
from .engine import GenerationEngine
from .kvcache import (BlockAllocator, PagedStore, PagedWindowStore,
                      QuantizedPool, cow_copy, kv_dequantize, kv_quantize,
                      make_pools)
from .metrics import GenerationMetrics
from .prefix import PrefixCache
from .programs import GenerationConfig, GenerationProgramSet
from .sampling import sample_tokens
from .scheduler import ModelRuntime, TokenStream
from .speculative import DenseDraftStore, accept_greedy

__all__ = [
    "GenerationEngine", "GenerationConfig", "GenerationProgramSet",
    "GenerationMetrics", "ModelRuntime", "TokenStream", "BlockAllocator",
    "PagedStore", "PagedWindowStore", "PrefixCache", "DenseDraftStore",
    "QuantizedPool", "accept_greedy", "cow_copy", "kv_quantize",
    "kv_dequantize", "make_pools", "sample_tokens",
]
