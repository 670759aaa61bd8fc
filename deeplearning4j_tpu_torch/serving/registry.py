"""Multi-model registry: named, versioned serving entries.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``. Models load from
the training side's own persistence formats: a model zip
(``util.serialization.restore_model``) or a checkpoint directory, whose
newest valid ``checkpoint_epoch*.zip`` wins (``util.checkpointing``). The
port's ``load_net`` also takes the ``device`` to restore onto (the CUDA
card unless the caller names another): an engine passes its own.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ..device import DeviceLike
from .errors import UnknownModelError


def load_net(path: str, *, device: DeviceLike = None):
    """Restore a network from a model zip OR a checkpoint directory."""
    if os.path.isdir(path):
        from ..util.checkpointing import latest_checkpoint
        ckpt = latest_checkpoint(path)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint_epoch*.zip in {path}")
        path = ckpt
    from ..util.serialization import restore_model
    return restore_model(path, device=device)


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
