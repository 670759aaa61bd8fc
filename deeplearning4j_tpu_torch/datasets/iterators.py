"""Dataset iterator adapter family.

A copy of ``deeplearning4j_tpu/datasets/iterators.py`` (numpy-only, kept
here so the port imports nothing of the JAX package): ``MultiDataSet``,
which multi-input and multi-output ``ComputationGraph`` feeds take, and the
iterator wrappers. Reference: datasets/iterator/ — ExistingDataSetIterator,
MultipleEpochsIterator, EarlyTerminationDataSetIterator,
SamplingDataSetIterator, IteratorDataSetIterator, and the MultiDataSet
iterator family (AsyncMultiDataSetIterator etc.) used by multi-input
ComputationGraphs. The TPU build's iterator protocol is "iterable of
DataSet + reset()" (datasets/dataset.py); these adapters compose it the same
way the reference's 20+ wrappers compose DataSetIterator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .dataset import DataSet, DataSetIterator


@dataclass
class MultiDataSet:
    """Multi-input/multi-output sample batch (reference ND4J MultiDataSet):
    features/labels are LISTS of arrays, one per network input/output.
    Shares the DataSet attribute surface so solvers/iterators are agnostic."""
    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_mask: Optional[List[Optional[np.ndarray]]] = None
    labels_mask: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


class ExistingDataSetIterator(DataSetIterator):
    """Wraps any re-iterable of DataSet/MultiDataSet (reference
    ExistingDataSetIterator)."""

    def __init__(self, iterable: Iterable):
        self.iterable = iterable

    def __iter__(self):
        return iter(self.iterable)

    def reset(self):
        if hasattr(self.iterable, "reset"):
            self.iterable.reset()


class MultipleEpochsIterator(DataSetIterator):
    """Repeats the base iterator n times as ONE epoch (reference
    MultipleEpochsIterator — used to stretch small datasets)."""

    def __init__(self, n_epochs: int, base: DataSetIterator):
        self.n = n_epochs
        self.base = base

    def __iter__(self):
        for i in range(self.n):
            yield from self.base
            if hasattr(self.base, "reset"):
                self.base.reset()

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches per epoch (reference
    EarlyTerminationDataSetIterator)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        if max_batches <= 0:
            raise ValueError("max_batches must be positive")
        self.base = base
        self.max_batches = max_batches

    def __iter__(self):
        for i, ds in enumerate(self.base):
            if i >= self.max_batches:
                break
            yield ds

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()


class SamplingDataSetIterator(DataSetIterator):
    """Draws ``n_batches`` random with-replacement minibatches from an
    in-memory dataset (reference SamplingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch_size: int, n_batches: int,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.seed = seed
        self._epoch = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        n = self.dataset.num_examples()
        for _ in range(self.n_batches):
            idx = rng.integers(0, n, self.batch_size)
            yield DataSet(
                self.dataset.features[idx], self.dataset.labels[idx],
                None if self.dataset.features_mask is None
                else self.dataset.features_mask[idx],
                None if self.dataset.labels_mask is None
                else self.dataset.labels_mask[idx])


class IteratorDataSetIterator(DataSetIterator):
    """Re-batches a stream of single examples (or small DataSets) into
    minibatches of ``batch_size`` (reference IteratorDataSetIterator)."""

    def __init__(self, make_iterator, batch_size: int):
        """``make_iterator``: zero-arg callable returning a fresh iterator of
        DataSet (so reset() can re-create it)."""
        self.make_iterator = make_iterator
        self.batch_size = batch_size

    def __iter__(self):
        buf: List[DataSet] = []
        count = 0
        for ds in self.make_iterator():
            buf.append(ds)
            count += ds.num_examples()
            if count >= self.batch_size:
                yield _concat(buf)
                buf, count = [], 0
        if buf:
            yield _concat(buf)


class ListMultiDataSetIterator(DataSetIterator):
    """Batches an in-memory MultiDataSet (the multi-input analogue of
    ListDataSetIterator; reference iterator/impl MultiDataSet iterators)."""

    def __init__(self, mds: MultiDataSet, batch_size: int):
        self.mds = mds
        self.batch_size = batch_size

    def __iter__(self):
        n = self.mds.num_examples()
        for s in range(0, n, self.batch_size):
            sl = slice(s, s + self.batch_size)

            def cut(arrs):
                if arrs is None:
                    return None
                return [None if a is None else a[sl] for a in arrs]

            yield MultiDataSet(cut(self.mds.features), cut(self.mds.labels),
                               cut(self.mds.features_mask),
                               cut(self.mds.labels_mask))


def _concat(batch: Sequence[DataSet]) -> DataSet:
    def cat(get):
        vals = [get(d) for d in batch]
        if any(v is None for v in vals):
            return None
        return np.concatenate(vals, axis=0)

    return DataSet(cat(lambda d: d.features), cat(lambda d: d.labels),
                   cat(lambda d: d.features_mask), cat(lambda d: d.labels_mask))
