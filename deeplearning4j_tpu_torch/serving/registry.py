"""Multi-model registry: named, versioned serving entries.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``. The reference
loads a served model from a model zip or a checkpoint directory; model
zips and checkpointing are not ported yet, so ``load_net`` raises
``NotImplementedError`` naming ROADMAP A2b.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .errors import UnknownModelError


def load_net(path: str):
    """Restore a network from a model zip or a checkpoint directory."""
    raise NotImplementedError(f"loading {path!r}: model zips and checkpoint "
                              f"directories are not ported yet (ROADMAP A2b); "
                              f"pass a network")


class _Entry:
    """One served model: its batcher + atomically-swappable program set.
    ``active`` is replaced by reference assignment (atomic in CPython);
    in-flight batches keep the set they snapshotted at dispatch."""

    def __init__(self, name: str, program_set, batcher, metrics):
        self.name = name
        self.active = program_set
        self.batcher = batcher
        self.metrics = metrics
        self.version = 1
        self.swap_lock = threading.Lock()   # serializes swaps, not serving

    def info(self) -> dict:
        ps = self.active
        return {"name": self.name, "version": self.version,
                "buckets": list(ps.ladder.rungs),
                "feature_shape": list(ps.feature_shape),
                "dtype": str(ps.dtype), "warmed": ps.warmed,
                "sharded": ps.mesh is not None,
                "queue_depth": self.batcher.queue_depth,
                "draining": self.batcher.draining}


class ModelRegistry:
    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self.default_name: Optional[str] = None

    def add(self, entry: _Entry, default: bool = False) -> None:
        with self._lock:
            if entry.name in self._entries:
                raise ValueError(f"model '{entry.name}' already registered "
                                 "(use hot_swap to replace)")
            self._entries[entry.name] = entry
            if default or self.default_name is None:
                self.default_name = entry.name

    def get(self, name: Optional[str] = None) -> _Entry:
        with self._lock:
            name = name or self.default_name
            if name is None or name not in self._entries:
                raise UnknownModelError(f"unknown model '{name}'; "
                                        f"registered: {sorted(self._entries)}")
            return self._entries[name]

    def remove(self, name: str) -> _Entry:
        with self._lock:
            if name not in self._entries:
                raise UnknownModelError(f"unknown model '{name}'")
            entry = self._entries.pop(name)
            if self.default_name == name:
                self.default_name = next(iter(sorted(self._entries)), None)
            return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def entries(self) -> List[_Entry]:
        with self._lock:
            return list(self._entries.values())
