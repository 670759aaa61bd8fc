"""Export-based dataset pipeline: save minibatches as sharded files, stream
them back per worker.

Counterpart of ``deeplearning4j_tpu/datasets/export.py`` (numpy and the
port's ``native/``): the same ``.npz`` shard format and manifest, so a
shard written by either package reads back bitwise in the other, through
numpy (``ShardedFileDataSetIterator``) or the C++ reader
(``NativeShardedFileDataSetIterator``). A torch tensor in a DataSet is
written as numpy writes it (a bfloat16 tensor as the raw 2-byte void
``|V2`` the reference's bfloat16 arrays become, as
``util/distributed_checkpoint.py`` ``_to_numpy`` writes one); the C++ reader gives it back
as a ``torch.bfloat16`` tensor, numpy's reader as ``|V2``, as in the
reference. ``for_process`` partitions by ``torch.distributed``'s rank and
world size when a process group is initialised, else one worker.

Reference: the Spark parameter-averaging master's DEFAULT export path —
`ParameterAveragingTrainingMaster.executeTraining` first exports the RDD to
saved minibatch files and workers then stream those files
(`spark/impl/paramavg/ParameterAveragingTrainingMaster.java:326-335`,
`spark/util/ExportSupport`, `spark/iterator/PortableDataStreamDataSetIterator`).
The design decouples (slow, once) preprocessing from (fast, repeated)
training epochs, and lets each host read only ITS shards instead of
shipping batches through a driver.

Format: one `.npz` per shard holding `features_<i>`, `labels_<i>` (+ optional
`features_mask_<i>` / `labels_mask_<i>`) for each minibatch i, plus a
`manifest.json` with shard/batch counts — plain numpy files any tool can
read.

Multi-host: `ShardedFileDataSetIterator(dir, shard_index=k, num_shards=n)`
reads the k-th of n interleaved shard subsets.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import re
from typing import Iterator

import numpy as np
import torch

from .dataset import DataSet, DataSetIterator


def _host(value) -> np.ndarray:
    """A batch member as numpy writes it: a tensor copied to the host (a
    bfloat16 one as the raw 2-byte void of the reference's bfloat16
    arrays), anything else through ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(value)


def export_dataset_iterator(iterator, out_dir: str, *,
                            batches_per_shard: int = 16,
                            prefix: str = "shard") -> dict:
    """Write every DataSet from ``iterator`` into ``out_dir`` as .npz shards
    (reference ExportSupport.exportIfRequired). Returns the manifest dict."""
    os.makedirs(out_dir, exist_ok=True)
    shard, batch_in_shard, n_batches, n_examples = 0, 0, 0, 0
    bufs: dict = {}
    shards = []

    def flush():
        nonlocal shard, batch_in_shard, bufs
        if not bufs:
            return
        path = os.path.join(out_dir, f"{prefix}_{shard:05d}.npz")
        np.savez(path, **bufs)
        shards.append({"file": os.path.basename(path),
                       "batches": batch_in_shard})
        shard += 1
        batch_in_shard = 0
        bufs = {}

    def put(name, value):
        # multi-input/multi-output graphs carry list features/labels
        # (optimize/solver.py handles the same shape); store each part as
        # <name>_inJ — the index in the key preserves positions, and a
        # <name>_len marker keeps None holes (e.g. labels_mask [None, m])
        # reconstructible. None scalars (unlabeled DataSets) are skipped
        # entirely: np.asarray(None) would pickle an object array that
        # np.load(allow_pickle=False) later refuses.
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            bufs[f"{name}_len"] = np.asarray(len(value), np.int64)
            for j, v in enumerate(value):
                if v is not None:
                    bufs[f"{name}_in{j}"] = _host(v)
        else:
            bufs[name] = _host(value)

    for ds in iterator:
        i = batch_in_shard
        put(f"features_{i}", ds.features)
        put(f"labels_{i}", ds.labels)
        if ds.features_mask is not None:
            put(f"features_mask_{i}", ds.features_mask)
        if ds.labels_mask is not None:
            put(f"labels_mask_{i}", ds.labels_mask)
        batch_in_shard += 1
        n_batches += 1
        n_examples += ds.num_examples()
        if batch_in_shard >= batches_per_shard:
            flush()
    flush()
    manifest = {"version": 1, "prefix": prefix, "num_shards": len(shards),
                "num_batches": n_batches, "num_examples": n_examples,
                "shards": shards}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ShardedFileDataSetIterator(DataSetIterator):
    """Stream exported shards back as DataSets (reference
    PortableDataStreamDataSetIterator / the worker side of the export path).

    ``shard_index``/``num_shards`` select an interleaved subset of shard
    FILES (shard i goes to worker i % num_shards) so every worker streams a
    disjoint, load-balanced partition without a driver in the loop.

    ``reader_threads`` > 1 parallelizes the DISK side: a small thread pool
    reads shard files ahead of consumption (each worker fully materializes
    its shard's batches — numpy decompression/parse releases the GIL on
    the I/O, and the native C++ reader's memcpy is GIL-free by
    construction), while batches are yielded strictly in shard order, so
    the stream is bit-identical to the serial read. At most
    ``reader_threads`` shards are in flight plus the one being yielded —
    size against shard bytes, not batch bytes. The default (1) keeps the
    lazy footprint existing callers were sized for: one open shard, one
    batch of host memory at a time.
    """

    def __init__(self, data_dir: str, *, shard_index: int = 0,
                 num_shards: int = 1, shuffle_shards: bool = False,
                 seed: int = 0, reader_threads: int = 1):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"num_shards {num_shards}")
        if reader_threads < 1:
            raise ValueError("reader_threads must be >= 1")
        self.data_dir = data_dir
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.shuffle_shards = shuffle_shards
        self.reader_threads = reader_threads
        self._rng = np.random.default_rng(seed)
        mpath = os.path.join(data_dir, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                self.manifest = json.load(f)
            files = [s["file"] for s in self.manifest["shards"]]
        else:   # manifest-less directory of npz files still works
            self.manifest = None
            files = sorted(os.path.basename(p) for p in
                           glob.glob(os.path.join(data_dir, "*.npz")))
        if not files:
            raise FileNotFoundError(f"No exported shards in {data_dir!r}")
        self._files = [f for i, f in enumerate(files)
                       if i % num_shards == shard_index]
        if not self._files:
            # an empty partition would make this worker iterate zero batches
            # while its peers wait in collectives — fail at construction
            raise ValueError(
                f"Worker {shard_index}/{num_shards} gets no shards: only "
                f"{len(files)} shard file(s) in {data_dir!r}. Re-export with "
                f"a smaller batches_per_shard so every worker has data")

    @classmethod
    def for_process(cls, data_dir: str, **kw) -> "ShardedFileDataSetIterator":
        """Partition by process: rank k of n in an initialised
        ``torch.distributed`` process group streams its own shard subset
        (reference: each Spark executor reads its partition's export
        files); without a process group, the one worker reads them all."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            rank, world = 0, 1
        return cls(data_dir, shard_index=rank, num_shards=world, **kw)

    @staticmethod
    def _get(z, name):
        """Reassemble a possibly multi-part value: <name> (single array) or
        <name>_len + <name>_inJ (list features/labels of a multi-input
        graph, with None holes preserved at their positions)."""
        if name in z.files:
            return z[name]
        if f"{name}_len" in z.files:
            out = [None] * int(z[f"{name}_len"])
            for k in z.files:
                m = re.fullmatch(re.escape(name) + r"_in(\d+)", k)
                if m:
                    out[int(m.group(1))] = z[k]
            return out
        # legacy shards (written before the _len marker) carry only the
        # _inJ parts — place each at its parsed index (length = max index
        # + 1) so None holes below the highest index survive
        indexed = {}
        for k in z.files:
            m = re.fullmatch(re.escape(name) + r"_in(\d+)", k)
            if m:
                indexed[int(m.group(1))] = z[k]
        if indexed:
            out = [None] * (max(indexed) + 1)
            for j, v in indexed.items():
                out[j] = v
            return out
        return None

    def _open_npz(self, path: str):
        """Shard-file opener hook (np.load here; the native subclass
        serves the same protocol from the C++ mmap reader)."""
        return np.load(path)

    def _iter_shard(self, fname: str) -> Iterator[DataSet]:
        """Lazily yield one shard file's DataSets (members are read from
        the open npz at yield time — one batch of host memory at a time)."""
        with self._open_npz(os.path.join(self.data_dir, fname)) as z:
            n = 0
            while (f"features_{n}" in z.files
                   or f"features_{n}_len" in z.files
                   or any(k.startswith(f"features_{n}_in")
                          for k in z.files)):            # legacy shards
                n += 1
            for i in range(n):
                yield DataSet(self._get(z, f"features_{i}"),
                              self._get(z, f"labels_{i}"),
                              self._get(z, f"features_mask_{i}"),
                              self._get(z, f"labels_mask_{i}"))

    def _read_shard(self, fname: str) -> list:
        """Fully materialize one shard (the thread-pool worker unit)."""
        return list(self._iter_shard(fname))

    def __iter__(self) -> Iterator[DataSet]:
        order = list(self._files)
        if self.shuffle_shards:
            self._rng.shuffle(order)
        if self.reader_threads == 1 or len(order) == 1:
            for fname in order:
                yield from self._iter_shard(fname)
            return
        # lookahead pool: keep reader_threads shard reads in flight, yield
        # strictly in order (bit-identical stream to the serial path)
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=self.reader_threads,
                                  thread_name_prefix="shard-reader")
        try:
            pending = collections.deque(
                pool.submit(self._read_shard, f)
                for f in order[:self.reader_threads])
            next_submit = self.reader_threads
            while pending:
                batches = pending.popleft().result()
                if next_submit < len(order):
                    pending.append(pool.submit(self._read_shard,
                                               order[next_submit]))
                    next_submit += 1
                yield from batches
        finally:
            # early break: drop queued reads; in-flight ones finish on the
            # daemon-less pool threads and are discarded
            pool.shutdown(wait=False, cancel_futures=True)

    def reset(self):
        pass


class NativeShardedFileDataSetIterator(ShardedFileDataSetIterator):
    """ShardedFileDataSetIterator served by the C++ mmap shard reader
    (native/shard_reader.cpp): zip/npy headers parse natively and member
    payloads arrive via one GIL-free memcpy — the data-plane stays native
    like the reference's DataVec/ND4J loaders. Falls back to numpy parsing
    per file if the native parse rejects it."""

    def _open_npz(self, path: str):
        from ..native import NativeNpzFile, shard_reader_available
        if shard_reader_available():
            try:
                return NativeNpzFile(path)
            except OSError:
                pass                      # e.g. a compressed npz: numpy path
        return np.load(path)


def make_shard_iterator(data_dir: str, *, prefer_native: bool = True,
                        **kw) -> ShardedFileDataSetIterator:
    """The production entry point: native reader when the toolchain built
    it, numpy otherwise — same iterator contract either way."""
    from ..native import shard_reader_available
    if prefer_native and shard_reader_available():
        return NativeShardedFileDataSetIterator(data_dir, **kw)
    return ShardedFileDataSetIterator(data_dir, **kw)
