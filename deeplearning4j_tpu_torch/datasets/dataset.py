"""DataSet container, the in-memory iterator and the host prefetch wrapper.

A copy of ``DataSet``, ``DataSetIterator``, ``ListDataSetIterator`` and
``AsyncDataSetIterator`` from ``deeplearning4j_tpu/datasets/dataset.py``,
which is numpy-only; the port keeps its own copy instead of importing the
JAX package. ``DataSetIterator.prefetch`` (reference ``:42-50``) wraps an
iterator in the port's ``datasets/prefetch.py`` ``DevicePrefetchIterator``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None
    # optional per-example record metadata; length = N
    metadata: Optional[List] = None

    def num_examples(self) -> int:
        f = self.features[0] if isinstance(self.features, (list, tuple)) \
            else self.features
        return int(f.shape[0])


class DataSetIterator:
    """Minimal protocol: iterable of DataSet with reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    def prefetch(self, depth: int = 2, *, device=None, dtype=None,
                 sharding=None):
        """Wrap this iterator in a ``DevicePrefetchIterator``: a background
        thread stages each batch and copies it to ``device`` (default: the
        CUDA card) so the copy overlaps the previous step's compute;
        floating arrays take ``dtype`` when given. ``sharding`` (a
        ``parallel.mesh.data_sharding``) lands batches on its mesh's
        device for a ``ParallelWrapper``'s feed. See
        ``datasets/prefetch.py``."""
        from .prefetch import DevicePrefetchIterator
        return DevicePrefetchIterator(self, depth, device=device,
                                      dtype=dtype, sharding=sharding)


class ListDataSetIterator(DataSetIterator):
    """Batches an in-memory dataset (reference ListDataSetIterator)."""

    def __init__(self, data: Sequence[DataSet] = None, *, features=None,
                 labels=None, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0):
        if data is None:
            n = features.shape[0]
            data = []
            for s in range(0, n, batch_size):
                data.append(DataSet(features[s:s + batch_size],
                                    labels[s:s + batch_size]))
        self.data = list(data)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        order = list(range(len(self.data)))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in order:
            yield self.data[i]


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper (reference AsyncDataSetIterator):
    overlaps host-side batch preparation (decoding, augmentation) with the
    consumer; ``DevicePrefetchIterator`` also overlaps the copy to the
    device."""

    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        self.base = base
        self.queue_size = queue_size

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        _SENTINEL = object()
        err: List[BaseException] = []

        def producer():
            try:
                for ds in self.base:
                    q.put(ds)
            except BaseException as e:   # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item

    def reset(self):
        self.base.reset()
