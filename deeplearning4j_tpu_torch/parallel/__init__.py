"""Counterpart of ``deeplearning4j_tpu/parallel``: the logical mesh, the
data-parallel wrapper with its gradient accumulators, bucketed overlap
sync, the ZeRO sharded update and K-step averaging, and ring attention.
The rest of the reference's parallel layer (tensor parallelism,
resharding, pipeline and expert parallelism, elastic, faults, inference)
is ROADMAP A7b-2."""
from .mesh import data_sharding, make_mesh
from .data_parallel import MODEL_AXIS, ParallelWrapper
from .zero import ZeroUpdateEngine, is_zero_state, make_zero_resharder

__all__ = ["data_sharding", "make_mesh", "MODEL_AXIS", "ParallelWrapper",
           "ZeroUpdateEngine", "is_zero_state", "make_zero_resharder"]
