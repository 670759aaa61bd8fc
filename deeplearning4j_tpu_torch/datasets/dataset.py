"""DataSet container and the in-memory iterator.

A copy of ``DataSet``, ``DataSetIterator`` and ``ListDataSetIterator``
from ``deeplearning4j_tpu/datasets/dataset.py``, which is numpy-only; the
port keeps its own copy instead of importing the JAX package. Device
prefetch (``DataSetIterator.prefetch``) and ``AsyncDataSetIterator`` come
with a later slice.
"""
from __future__ import annotations

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
