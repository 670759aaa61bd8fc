"""Datasets: the DataSet container, iterators, the device prefetcher, the
shard export path and the fetchers (MNIST, Iris, CIFAR-10, Curves, LFW).

Counterpart of ``deeplearning4j_tpu/datasets/__init__.py``: the same
exports, name for name.
"""
from .dataset import (AsyncDataSetIterator, DataSet, DataSetIterator,
                      ListDataSetIterator)
from .export import (ShardedFileDataSetIterator,
                     export_dataset_iterator)
from .fetchers import (Cifar10DataSetIterator, CurvesDataSetIterator,
                       IrisDataSetIterator, LFWDataSetIterator,
                       load_cifar10, load_curves, load_iris, load_lfw)
from .prefetch import DevicePrefetchIterator
from .iterators import (EarlyTerminationDataSetIterator,
                        ExistingDataSetIterator, IteratorDataSetIterator,
                        ListMultiDataSetIterator, MultiDataSet,
                        MultipleEpochsIterator, SamplingDataSetIterator)
from .mnist import MnistDataSetIterator, load_mnist

__all__ = [
    "AsyncDataSetIterator", "Cifar10DataSetIterator", "CurvesDataSetIterator",
    "DataSet", "DataSetIterator", "DevicePrefetchIterator",
    "EarlyTerminationDataSetIterator",
    "ExistingDataSetIterator", "IrisDataSetIterator",
    "IteratorDataSetIterator", "LFWDataSetIterator",
    "ListDataSetIterator",
    "ListMultiDataSetIterator", "MnistDataSetIterator", "MultiDataSet",
    "MultipleEpochsIterator", "SamplingDataSetIterator",
    "ShardedFileDataSetIterator", "export_dataset_iterator", "load_cifar10",
    "load_curves", "load_iris", "load_lfw", "load_mnist",
]
