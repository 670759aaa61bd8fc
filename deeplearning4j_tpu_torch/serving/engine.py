"""InferenceEngine: the forward-serving facade.

Counterpart of ``deeplearning4j_tpu/serving/engine.py`` (``:27-186``):
routing, warm-up, hot-swap and lifecycle over the other serving modules.
The dispatch path is: caller -> ``engine.predict`` -> the model's
``ShapeBucketedBatcher`` (coalesce, pad to a ladder bucket) -> the model's
active ``ProgramSet`` (the forward on the network's device, the CUDA card
unless the network lives elsewhere). The active set is read per
dispatched batch, so a hot swap is one reference assignment: a batch in
flight finishes on the old set, the next batch runs the new one.

Left for later, each raising ``NotImplementedError`` that names its
ROADMAP item: a hot swap from a path and ``reload_from_checkpoint`` (model
zips, A2), ``publish_metrics`` (A8), a ``mesh`` (A7b). The HTTP front end
comes with A2.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .batcher import ShapeBucketedBatcher
from .buckets import BucketLadder
from .errors import DrainingError
from .metrics import ServingMetrics, warm_count
from .programs import ProgramSet
from .registry import ModelRegistry, _Entry, load_net


class InferenceEngine:
    def __init__(self, net=None, *, model_name: str = "default",
                 feature_shape: Optional[Tuple[int, ...]] = None,
                 buckets: Sequence[int] = (1, 8, 32, 128),
                 dtype="float32", mesh=None, data_axis: str = "data",
                 batch_window_ms: float = 2.0, queue_limit: int = 256,
                 default_timeout_s: float = 30.0, warm: bool = True,
                 forward_fn: Optional[Callable] = None):
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported "
                                      "yet (ROADMAP A7b)")
        self.registry = ModelRegistry()
        self.buckets = tuple(buckets)
        self.dtype = dtype
        self.mesh = None
        self.data_axis = data_axis     # the mesh's batch axis, with A7b
        self.batch_window_ms = batch_window_ms
        self.queue_limit = queue_limit
        self.default_timeout_s = default_timeout_s
        self._trace_count = 0          # warm runs of this engine's programs
        self._draining = False
        self._lock = threading.Lock()
        if net is not None:
            if feature_shape is None:
                raise ValueError("feature_shape is required to warm the "
                                 "bucket programs ahead of traffic")
            self.add_model(model_name, net, feature_shape=feature_shape,
                           warm=warm, forward_fn=forward_fn)

    # ----------------------------------------------------------------- models
    def add_model(self, name: str, net, *, feature_shape: Tuple[int, ...],
                  buckets: Optional[Sequence[int]] = None, dtype=None,
                  warm: bool = True, default: bool = False,
                  forward_fn: Optional[Callable] = None) -> "_Entry":
        if name in self.registry.names():   # fail before warming/threading
            raise ValueError(f"model '{name}' already registered "
                             "(use hot_swap to replace)")
        ladder = BucketLadder(buckets or self.buckets)
        metrics = ServingMetrics(name=name)
        ps = ProgramSet(net, feature_shape=feature_shape, ladder=ladder,
                        dtype=dtype or self.dtype, forward_fn=forward_fn,
                        trace_hook=self._on_trace)
        entry_box = {}

        def runner(padded: np.ndarray) -> np.ndarray:
            # resolve the ACTIVE set per batch: the hot-swap seam
            return entry_box["entry"].active.run(padded)

        batcher = ShapeBucketedBatcher(
            runner, ladder, feature_shape, dtype=np.dtype(dtype or self.dtype),
            queue_limit=self.queue_limit,
            batch_window_ms=self.batch_window_ms,
            default_timeout_s=self.default_timeout_s,
            metrics=metrics, name=name,
            on_start=ps.warm if warm else None)   # warm on the serving thread
        entry = _Entry(name, ps, batcher, metrics)
        entry_box["entry"] = entry
        try:
            self.registry.add(entry, default=default)
        except ValueError:          # registration race: don't leak the thread
            batcher.stop(drain=False)
            raise
        return entry

    def remove_model(self, name: str) -> None:
        entry = self.registry.remove(name)
        entry.batcher.stop(drain=True)

    # ---------------------------------------------------------------- serving
    def predict(self, x, *, model: Optional[str] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        if self._draining:
            raise DrainingError("engine is draining")
        entry = self.registry.get(model)
        return entry.batcher.submit(x, timeout=timeout)

    def warm_up(self, model: Optional[str] = None) -> None:
        entry = self.registry.get(model)
        if not entry.active.warmed:
            entry.active.warm()

    # --------------------------------------------------------------- hot-swap
    def hot_swap(self, name: str, net_or_path) -> int:
        """Replace model ``name`` with zero downtime. A network of the same
        architecture and parameter shapes shares the warmed buckets (a
        reference assignment); any other warms a full new set before the
        cutover, so no request waits on a warm run or fails. Returns the
        new version number."""
        entry = self.registry.get(name)       # unknown name fails fast
        net = load_net(net_or_path) if isinstance(net_or_path, str) \
            else net_or_path
        with entry.swap_lock:
            old = entry.active
            try:
                new_set = old.with_params_from(net)       # same shapes: free
            except ValueError:
                new_set = ProgramSet(
                    net, feature_shape=old.feature_shape, ladder=old.ladder,
                    dtype=old.dtype, forward_fn=old._custom_fwd,
                    trace_hook=self._on_trace).warm()     # warm BEFORE swap
            entry.active = new_set                        # atomic cutover
            entry.version += 1
            entry.metrics.record_swap()
            return entry.version

    def reload_from_checkpoint(self, name: str, path: str) -> int:
        return self.hot_swap(name, load_net(path))

    # ------------------------------------------------------------ observability
    def models(self) -> Dict[str, dict]:
        return {e.name: e.info() for e in self.registry.entries()}

    def metrics(self) -> Dict[str, dict]:
        return {e.name: e.metrics.snapshot()
                for e in self.registry.entries()}

    def publish_metrics(self, storage, session_id: str = "serving") -> None:
        raise NotImplementedError("publishing serving metrics to a "
                                  "StatsStorage backend is not ported yet "
                                  "(ROADMAP A8)")

    @property
    def trace_count(self) -> int:
        """Warm runs of this engine's programs (one per bucket per warmed
        set); traffic must not move it."""
        return self._trace_count

    def _on_trace(self):
        self._trace_count += 1

    @staticmethod
    def compile_count() -> int:
        """Process-wide warm runs (``metrics.warm_count``), the port's
        stand-in for the reference's process-wide XLA compile count."""
        return warm_count()

    @property
    def draining(self) -> bool:
        return self._draining

    def queue_depths(self) -> Dict[str, int]:
        return {e.name: e.batcher.queue_depth
                for e in self.registry.entries()}

    # ---------------------------------------------------------------- lifecycle
    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """drain=True: reject new work (503), flush every queued request,
        then stop; drain=False: reject new work and fail queued requests
        immediately. Either way no caller is left hanging."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout
        for e in self.registry.entries():
            e.batcher.stop(drain=drain,
                           timeout=max(0.1, deadline - time.monotonic()))
