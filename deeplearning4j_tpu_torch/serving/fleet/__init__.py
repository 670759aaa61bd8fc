"""serving/fleet/ — elastic multi-process replica pool.

Counterpart of ``deeplearning4j_tpu/serving/fleet/`` (its eight modules,
path for path). A replica runs on the card unless its spec says
``"device": "cpu"``; the kernel-library directory stands in for the
compilation cache (``coldstart.py``).

One replica = one OS process running the single-process serving stack
(GenerationEngine + ServingHTTPServer); the fleet layer adds what a
single process cannot give you — fault isolation (a replica SIGKILL
loses only its in-flight streams, each closed with an explicit reason),
horizontal decode throughput, and elasticity:

  - replica.py    process supervisor + replica child entrypoint
                  (spawn, ready-file + /health readiness gate, drain-
                  then-stop SIGTERM, chaos SIGKILL, restart)
  - affinity.py   prefix-cache-affinity routing: learned longest-prefix
                  map + rendezvous hashing over the SAME rolling chain
                  hash the prefix cache keys blocks by
  - router.py     health-gated admission, capped-backoff failover
                  (retry ONLY before the first token), DEAD_AFTER=3
                  mark-dead discipline, drain-then-stop scale-in
  - autoscale.py  pure decide() on SLO burn rate + queue depth, one-step
                  moves under cooldowns; actuator thread
  - collector.py  supervisor-side observability: incremental trace-ring
                  pulls with replica attribution, cross-process timeline
                  stitching, dead-replica spool recovery, merged-bucket
                  fleet metrics + fleet-level SLO watchdog
  - coldstart.py  load-not-build cold start via the shared kernel-
                  library directory (DL4J_TPU_COMPILE_CACHE)
  - http.py       the front door: single-replica wire protocol, fleet
                  semantics
"""
from .affinity import AffinityMap, AffinityPolicy, prompt_chain, \
    rendezvous_order
from .autoscale import Autoscaler, AutoscalePolicy, decide
from .coldstart import (configure_compile_cache, configured_cache_dir,
                        fresh_compile_count)
from .collector import AggregateRegistry, FleetCollector, merge_raw_metrics
from .http import FleetHTTPServer
from .replica import ReplicaProcess
from .router import (DEAD_AFTER, FleetError, FleetHTTPError, FleetRouter,
                     NoReadyReplicaError)

__all__ = [
    "AffinityMap", "AffinityPolicy", "prompt_chain", "rendezvous_order",
    "Autoscaler", "AutoscalePolicy", "decide",
    "AggregateRegistry", "FleetCollector", "merge_raw_metrics",
    "configure_compile_cache", "configured_cache_dir",
    "fresh_compile_count",
    "FleetHTTPServer", "ReplicaProcess",
    "DEAD_AFTER", "FleetError", "FleetHTTPError", "FleetRouter",
    "NoReadyReplicaError",
]
