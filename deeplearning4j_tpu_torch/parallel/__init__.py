"""Counterpart of ``deeplearning4j_tpu/parallel``: the mesh (logical, or
spread over a process group by ``distributed``), the data-parallel
wrapper with its gradient accumulators, bucketed overlap sync, the ZeRO
sharded update and K-step averaging, the model axis (Megatron tensor
parallelism, head-sharded decode and serving), resharding, pipeline and
expert parallelism, ring attention, ``ElasticTrainer`` with its fault
injectors, ``ParallelInference`` and the legacy serving and streaming
routes (``model_server``, ``streaming``). The export list is the
reference's."""
from .mesh import data_sharding, make_mesh, replicated, window_sharding
from .data_parallel import ParallelWrapper
from .inference import ParallelInference
from .overlap import (BucketSchedule, GradBucket, build_bucket_schedule,
                      bucketed_pmean, fused_pmean, profile_schedule)
from .zero import ZeroUpdateEngine, is_zero_state, make_zero_resharder
from .tensor_parallel import (MODEL_AXIS, build_param_specs,
                              build_param_shardings, host_gather,
                              model_axis_size, per_replica_bytes,
                              shard_params, sharded_leaf_count)
from .resharding import make_any_resharder, redistribute
from .elastic import ElasticTrainer, RecoveryFailedError
from .faults import (CoordinationError, CoordinationFlake, CorruptCheckpoint,
                     FaultInjector, FaultPlan, KillWorker, PreemptAt,
                     SlowCollective, WorkerLostError)

__all__ = ["data_sharding", "make_mesh", "replicated", "window_sharding",
           "ParallelWrapper", "ParallelInference",
           "BucketSchedule", "GradBucket", "build_bucket_schedule",
           "bucketed_pmean", "fused_pmean", "profile_schedule",
           "ZeroUpdateEngine", "is_zero_state", "make_zero_resharder",
           "MODEL_AXIS", "build_param_specs", "build_param_shardings",
           "host_gather", "model_axis_size", "per_replica_bytes",
           "shard_params", "sharded_leaf_count",
           "make_any_resharder", "redistribute",
           "ElasticTrainer", "RecoveryFailedError",
           "FaultInjector", "FaultPlan", "KillWorker", "SlowCollective",
           "CorruptCheckpoint", "PreemptAt", "CoordinationFlake",
           "WorkerLostError", "CoordinationError"]
