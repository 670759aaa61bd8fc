"""Device prefetch: overlap the host-to-device copy with device compute.

Counterpart of ``deeplearning4j_tpu/datasets/prefetch.py``:
``DevicePrefetchIterator`` (``:119-398``), its staging pool
(``_StagingPool`` and ``_definitely_copied``, ``:44-116``), ``BatchWindow``,
``_window_stackable``, ``skip_batches`` and ``iter_windows``
(``:401-486``) and ``etl_wait_ms_per_batch`` (``:362``), which the
performance listener's wait reads. The reference's ``windows`` serves its
stacked windows; the port calls ``iter_windows``.

``DevicePrefetchIterator`` wraps any ``DataSetIterator`` and keeps
``depth`` batches in flight on the device. A producer thread pulls host
batches from ``base`` (so host-side decoding overlaps too) and ships every
array:

- **On the card.** A host array is cast (floats to ``dtype``; integers,
  token ids, stay as they are) into a pinned host buffer of a pool, and
  copied to the device on a side CUDA stream. One CUDA event is recorded
  after a batch's copies. The consumer's stream waits on that event before
  the batch is handed out, and each of the batch's tensors calls
  ``record_stream`` on the consumer's stream, so the allocator does not
  hand its memory to the side stream while the consumer still reads it.
  A pinned buffer is reused only after the event of the copy that last
  read it has completed (the counterpart of the reference's
  ``_definitely_copied`` and ``block_until_ready`` on a slot): each
  (shape, dtype) rotates over ``depth + 2`` buffers, so in steady state
  that copy finished long ago and the wait is free. A batch never reuses
  a buffer it took itself (its event is recorded after all its copies):
  one with more arrays of a (shape, dtype) than that grows the pool.
- **On the CPU.** The same iterator, without pinned memory or streams:
  each array becomes a tensor of its own (a copy, never a view of the
  base's buffer), cast as above.

An array that already lies on the device passes through as it is (the
consumer's feed cast handles its dtype). The bounded queue is the
back-pressure contract: at most ``depth`` batches wait, plus one in the
producer's hands. The consumer records the time it blocked waiting for a
batch (``last_wait_ms``, ``total_wait_ms`` over the current epoch): the
honest per-iteration ETL cost, zero when the pipeline keeps up. Breaking
out of the consuming loop (or an error in it) stops the producer within
one tick; an exception raised by ``base`` reaches the consumer. The
reference's host-to-device bandwidth gauge is telemetry (ROADMAP A8).
``sharding`` (a ``parallel.mesh.Sharding``, the reference's
``data_sharding(mesh)``) ships to its mesh's device and checks that every
array's cut dimension tiles the axis, as the reference's ``device_put``
onto a sharding refuses one that does not; on the logical mesh a worker's
rows are the contiguous blocks of the batch, which the wrapper's split
takes.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List

import torch

from ..device import DeviceLike, resolve_device, torch_dtype
from .dataset import DataSet, DataSetIterator
from .iterators import MultiDataSet


class _StagingPool:
    """Pinned host buffers for the card's copies, ``slots`` of them per
    (shape, dtype), used round robin. A slot keeps the event of the copy
    that last read it; staging into it first waits for that event. A batch
    never takes a slot twice: a batch with more arrays of one (shape,
    dtype) than the pool holds grows the pool, since the slots it took
    are marked only after the whole batch is shipped. ``pin=False`` keeps
    plain host buffers (the pool's own tests on a machine without a
    card)."""

    def __init__(self, slots: int, pin: bool = True):
        self.slots = max(2, int(slots))
        self.pin = pin
        self._pools = {}      # (shape, dtype) -> [[host tensor, event]]
        self._rr = {}
        self.allocations = 0  # distinct buffers ever allocated (tests)

    def stage(self, t: torch.Tensor, dtype: torch.dtype, taken: list) -> list:
        """Cast-copy the CPU tensor ``t`` into a slot that is not in
        ``taken`` (the slots this batch took so far); returns the slot
        (slot[0] is the buffer). Call ``mark`` after the batch's copies."""
        key = (tuple(t.shape), dtype)
        pool = self._pools.setdefault(key, [])
        i = self._rr.get(key, 0) % max(1, len(pool))
        if len(pool) < self.slots or any(pool[i] is s for s in taken):
            slot = [torch.empty(t.shape, dtype=dtype, pin_memory=self.pin),
                    None]
            self.allocations += 1
            pool.insert(i, slot)
            self._rr[key] = i + 1
        else:
            self._rr[key] = i + 1
            slot = pool[i]
            if slot[1] is not None:
                slot[1].synchronize()      # the copy it fed has completed
                slot[1] = None
        slot[0].copy_(t)
        return slot

    @staticmethod
    def mark(slots: list, event) -> None:
        for slot in slots:
            slot[1] = event


class DevicePrefetchIterator(DataSetIterator):
    """Background-thread device prefetch wrapper (see the module
    docstring). ``device``: where batches go (default: the CUDA card;
    ``"cpu"`` runs the same producer without pinned memory or streams).
    ``dtype``: the floating type host arrays are cast to (a name such as
    ``"bfloat16"`` or a ``torch.dtype``; None keeps each array's)."""

    _TICK = 0.05   # stop-signal poll interval for a blocked producer

    def __init__(self, base: DataSetIterator, depth: int = 2, *,
                 device: DeviceLike = None, dtype=None, sharding=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.base = base
        self.depth = depth
        self.sharding = sharding
        if sharding is not None:
            if device is not None and resolve_device(device) != \
                    sharding.mesh.device:
                raise ValueError(f"the sharding's mesh lives on "
                                 f"{sharding.mesh.device}, not {device}")
            device = sharding.mesh.device
        self.device = resolve_device(device)
        self.dtype = (None if dtype is None else dtype
                      if isinstance(dtype, torch.dtype) else torch_dtype(dtype))
        self.last_wait_ms = 0.0     # consumer block time for the last batch
        self.total_wait_ms = 0.0    # cumulative over the current epoch
        self.batches = 0            # batches yielded in the current epoch
        # each __iter__ builds its own pool (held by its producer), so a
        # producer of an abandoned epoch can never refill a slot whose copy
        # the new epoch's consumer still waits on; this is the newest
        self._staging = _StagingPool(depth + 2)

    # ------------------------------------------------------------- shipping
    def _put_array(self, a, pool, used, out):
        if a is None:
            return None
        if isinstance(a, torch.Tensor) and a.device == self.device:
            return a                        # already there
        t = torch.as_tensor(a)
        if self.sharding is not None:
            sh = self.sharding
            n = sh.mesh.shape[sh.axis]
            if t.dim() <= sh.dim or t.shape[sh.dim] % n:
                raise ValueError(
                    f"an array of shape {tuple(t.shape)} does not tile the "
                    f"{n} workers of axis {sh.axis!r} along dimension "
                    f"{sh.dim}")
        if t.device.type != "cpu":
            t = t.cpu()
        dtype = (self.dtype if self.dtype is not None
                 and t.is_floating_point() else t.dtype)
        if self.device.type == "cpu":
            c = t.to(dtype)
            # a tensor of its own, never a view of the base's buffer
            return c.clone() if c.data_ptr() == t.data_ptr() else c
        slot = pool.stage(t, dtype, used)
        used.append(slot)
        d = torch.empty(t.shape, dtype=dtype, device=self.device)
        d.copy_(slot[0], non_blocking=True)
        out.append(d)
        return d

    def _put_any(self, v, pool, used, out):
        if isinstance(v, (list, tuple)):    # multi-input lists
            return [self._put_array(u, pool, used, out) for u in v]
        return self._put_array(v, pool, used, out)

    def _ship(self, ds, pool, used, out):
        """One host batch -> the same batch with tensors on the device."""
        put = lambda v: self._put_any(v, pool, used, out)
        if isinstance(ds, MultiDataSet):
            return MultiDataSet(
                put(ds.features), put(ds.labels),
                None if ds.features_mask is None else put(ds.features_mask),
                None if ds.labels_mask is None else put(ds.labels_mask))
        return DataSet(put(ds.features), put(ds.labels),
                       put(ds.features_mask), put(ds.labels_mask),
                       metadata=getattr(ds, "metadata", None))

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: List[BaseException] = []
        _SENTINEL = object()
        self.last_wait_ms = 0.0
        self.total_wait_ms = 0.0
        self.batches = 0
        pool = _StagingPool(self.depth + 2)
        self._staging = pool
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(device=self.device) if cuda else None

        def offer(item) -> bool:
            """put() that gives up when the consumer went away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=self._TICK)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            for ds in self.base:
                if stop.is_set():
                    return
                used, out = [], []
                if cuda:
                    with torch.cuda.stream(side):
                        shipped = self._ship(ds, pool, used, out)
                        event = torch.cuda.Event()
                        event.record(side)
                    pool.mark(used, event)
                else:
                    shipped, event = self._ship(ds, pool, used, out), None
                if not offer((shipped, event, out)):
                    return

        def producer():
            try:
                if cuda:
                    with torch.cuda.device(self.device):
                        produce()
                else:
                    produce()
            except BaseException as e:     # surfaced on the consumer side
                err.append(e)
            finally:
                offer(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True,
                             name="device-prefetch")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                wait_ms = (time.perf_counter() - t0) * 1e3
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                shipped, event, out = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for d in out:
                        d.record_stream(consumer)
                self.last_wait_ms = wait_ms
                self.total_wait_ms += wait_ms
                self.batches += 1
                yield shipped
        finally:
            # break / exception / exhaustion: stop the producer and let it
            # notice within one tick
            stop.set()
            while True:                    # unblock a producer mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=1.0)

    def etl_wait_ms_per_batch(self) -> float:
        """Mean consumer-side wait a batch over the current or last
        epoch."""
        return self.total_wait_ms / self.batches if self.batches else 0.0

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()


class BatchWindow:
    """K same-shape batches destined for one K-step window. The solver
    runs them step by step (on the card as replays of one captured step),
    so it keeps the batches as they are; the reference's stacked [K, ...]
    feed has no use here."""

    __slots__ = ("datasets",)

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return len(self.datasets)

    def num_examples(self) -> int:
        return sum(d.num_examples() for d in self.datasets)


def _window_stackable(group) -> bool:
    """Can these batches be stacked into one [K, ...] feed? Requires
    single-array features and labels (multi-input ``MultiDataSet``
    batches run per step), identical shapes, and the same mask presence
    and shape across the group."""
    if isinstance(group[0], MultiDataSet):
        return False
    for field in ("features", "labels", "labels_mask", "features_mask"):
        vals = [getattr(d, field, None) for d in group]
        if any(isinstance(v, (list, tuple)) for v in vals):
            return False           # multi-input lists: per-step path
        none = [v is None for v in vals]
        if any(none):
            if not all(none):
                return False       # mask present in some batches only
            if field in ("features", "labels"):
                return False
            continue
        if len({tuple(v.shape) for v in vals}) != 1:
            return False           # ragged (e.g. short remainder batch)
    return True


def skip_batches(iterable, n: int):
    """Consume (without yielding) the first ``n`` batches and return an
    iterator over the rest: the mid-epoch resume, shared by ``Solver`` and
    ``ParallelWrapper``. Tolerates streams shorter than ``n``."""
    src = iter(iterable)
    _miss = object()
    for _ in range(max(0, n)):
        if next(src, _miss) is _miss:
            break
    return src


def iter_windows(iterable, k: int):
    """Group a batch stream into ``BatchWindow``s of ``k``: a window for
    every run of ``k`` consecutive same-shape single-array batches, and
    bare batches for the rest (the ragged remainder, a group whose shapes
    differ, multi-input batches, windows of one), in order, so the stream
    stays order- and content-identical to the unwindowed one."""
    if k < 1:
        raise ValueError("steps_per_dispatch window size must be >= 1")
    buf = []
    for ds in iterable:
        buf.append(ds)
        if len(buf) == k:
            if k > 1 and _window_stackable(buf):
                yield BatchWindow(buf)
            else:
                yield from buf
            buf = []
    yield from buf        # ragged remainder: per-step
