"""Counterpart of ``deeplearning4j_tpu/parallel``: the logical mesh, the
data-parallel wrapper with its gradient accumulators, and ring attention.
The rest of the reference's parallel layer (overlap, ZeRO, tensor
parallelism, resharding, elastic, faults, inference) is ROADMAP A7b."""
from .mesh import data_sharding, make_mesh
from .data_parallel import MODEL_AXIS, ParallelWrapper

__all__ = ["data_sharding", "make_mesh", "MODEL_AXIS", "ParallelWrapper"]
