"""Bucketed gradient synchronization on the logical mesh.

Counterpart of ``deeplearning4j_tpu/parallel/overlap.py``:
``DEFAULT_BUCKET_BYTES``, ``GradBucket`` and ``BucketSchedule``
(``:42-88``), ``build_bucket_schedule`` (``:91-136``), ``bucketed_pmean``
(``:147-173``) and ``fused_pmean`` (``:176-182``).

The schedule is host metadata over a list of leaves (a network's
parameters in ``data_parallel.flat_param_order``, which is
``jax.tree.leaves(net.params)``'s order): leaves are packed into buckets
of about ``bucket_bytes`` in REVERSE order (the backward produces the last
layers' gradients first), a leaf at or above the bucket size ships alone,
and leaves of different dtypes never share a bucket. The reference
schedules one collective launch per bucket so that XLA can overlap them
with the rest of the backward.

On the logical mesh (``parallel/mesh.py``) a per-worker gradient is a
tensor ``[n, *shape]`` and a collective is arithmetic on its rows:
``bucketed_pmean`` packs each multi-leaf bucket's rows into one
``[n, elements]`` buffer, takes ``mesh.pmean`` of it (the rows added in
worker order, then divided by n) and cuts the result back into the
leaves. Grouping changes no element's arithmetic, so the result is
bitwise the per-leaf sweep's on the CPU and on the card, at every bucket
size; what the buckets change here is the number of launches.
``fused_pmean`` takes the mean of a list of leaves in one buffer a dtype.

``profile_schedule`` (reference ``:195-220``) times each bucket's mean on
a mesh with :func:`time_collective`, records a ``bucket_psum`` span a
bucket and sets the ``parallel.collective_ms`` and
``parallel.bucket_count`` gauges. The mesh is logical, so these times
measure the collective's kernels and copies on the one device (the rows'
adds), not a wire.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

from ..telemetry import get_registry, record_external_span
from .mesh import Mesh, local_count, pmean

DEFAULT_BUCKET_BYTES = 4 * 2 ** 20      # ~4 MB, the reference's


@dataclass(frozen=True)
class GradBucket:
    """One collective launch: ``indices`` are leaf positions. A multi-leaf
    bucket is packed into one flat buffer; a singleton ships its leaf as
    it is."""
    indices: Tuple[int, ...]
    nbytes: int

    def __len__(self) -> int:
        return len(self.indices)


class BucketSchedule:
    """The buckets of a list of leaves, built once per (leaf shapes and
    dtypes, ``bucket_bytes``) on the host."""

    def __init__(self, buckets: List[GradBucket], leaf_shapes: List[tuple],
                 leaf_dtypes: List[torch.dtype], bucket_bytes: int):
        self.buckets = buckets
        self.leaf_shapes = leaf_shapes
        self.leaf_dtypes = leaf_dtypes
        self.bucket_bytes = bucket_bytes
        self.total_bytes = sum(b.nbytes for b in buckets)

    def __len__(self) -> int:
        return len(self.buckets)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_shapes)

    def describe(self) -> List[dict]:
        """One row a bucket: its index, leaves and bytes."""
        return [{"bucket": i, "leaves": len(b), "bytes": b.nbytes}
                for i, b in enumerate(self.buckets)]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def build_bucket_schedule(leaves: Sequence[torch.Tensor],
                          bucket_bytes: int = DEFAULT_BUCKET_BYTES
                          ) -> BucketSchedule:
    """Partition ``leaves`` into buckets of about ``bucket_bytes`` (see the
    module docstring)."""
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    leaves = list(leaves)
    if not leaves:
        raise ValueError("cannot bucket an empty pytree")
    shapes = [tuple(t.shape) for t in leaves]
    dtypes = [t.dtype for t in leaves]
    nbytes = [_numel(s) * t.element_size() for s, t in zip(shapes, leaves)]

    buckets: List[GradBucket] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None

    def close():
        nonlocal cur, cur_bytes, cur_dtype
        if cur:
            buckets.append(GradBucket(tuple(cur), cur_bytes))
        cur, cur_bytes, cur_dtype = [], 0, None

    for i in reversed(range(len(leaves))):
        if nbytes[i] >= bucket_bytes:
            close()
            buckets.append(GradBucket((i,), nbytes[i]))
            continue
        if cur_dtype is not None and dtypes[i] != cur_dtype:
            close()
        cur.append(i)
        cur_bytes += nbytes[i]
        cur_dtype = dtypes[i]
        if cur_bytes >= bucket_bytes:
            close()
    close()
    return BucketSchedule(buckets, shapes, dtypes, bucket_bytes)


def _check_rows(schedule: BucketSchedule, rows, n: int) -> None:
    if len(rows) != schedule.num_leaves or any(
            tuple(r.shape) != (n,) + s
            for r, s in zip(rows, schedule.leaf_shapes)):
        raise ValueError(
            f"tree does not match the bucket schedule it was built for "
            f"({len(rows)} leaves vs {schedule.num_leaves}) — rebuild the "
            f"schedule when the parameter structure changes")


def bucketed_pmean(rows: Sequence[torch.Tensor], schedule: BucketSchedule,
                   mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """The mean over the workers of each leaf, a bucket at a time:
    ``rows[i]`` is leaf i's per-worker value ``[n, *shape]``; the result is
    a list of ``[n, *shape]`` (every row the mean). Bitwise the per-leaf
    ``pmean`` sweep's. On a process-group mesh n is this process's rows,
    one."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.axis_names}")
    n = local_count(mesh, axis)
    _check_rows(schedule, rows, n)
    out = list(rows)
    for b in schedule.buckets:
        if len(b) == 1:
            i = b.indices[0]
            out[i] = pmean(rows[i], mesh, axis)
            continue
        flat = torch.cat([rows[i].reshape(n, -1) for i in b.indices], dim=1)
        red = pmean(flat, mesh, axis)
        off = 0
        for i in b.indices:
            k = _numel(schedule.leaf_shapes[i])
            out[i] = red[:, off:off + k].reshape(
                (n,) + schedule.leaf_shapes[i])
            off += k
    return out


def fused_pmean(rows: Sequence[torch.Tensor], mesh: Mesh,
                axis: str = "data") -> List[torch.Tensor]:
    """The mean over the workers of every ``[n, ...]`` leaf of ``rows``,
    one buffer a dtype (the reference's one variadic pmean launch):
    elementwise the per-leaf ``pmean``'s."""
    n = local_count(mesh, axis)
    out = list(rows)
    by_dtype = {}
    for i, r in enumerate(rows):
        by_dtype.setdefault(r.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([rows[i].reshape(n, -1) for i in idx], dim=1)
        red = pmean(flat, mesh, axis)
        off = 0
        for i in idx:
            k = rows[i][0].numel()
            out[i] = red[:, off:off + k].reshape(rows[i].shape)
            off += k
    return out


def time_collective(fn: Callable[[], object], device: torch.device,
                    repeats: int = 3) -> float:
    """Best-of-``repeats`` milliseconds of ``fn()`` after one warm call:
    between two CUDA events on the card (the collective's kernels on the
    current stream), by ``perf_counter`` on the CPU. Host-side tooling: it
    waits for the card, so no training loop calls it."""
    fn()
    best = float("inf")
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def profile_schedule(mesh: Mesh, schedule: BucketSchedule,
                     axis: str = "data", repeats: int = 3) -> dict:
    """Time each bucket's mean over ``axis`` of ``mesh`` (a zero buffer of
    the bucket's elements a worker, best of ``repeats``), record a
    ``bucket_psum`` span a bucket (cat "collective") under the current
    span path, and set the ``parallel.collective_ms`` gauge to the total
    and ``parallel.bucket_count``. On a logical mesh the times are the
    rows' adds on the one device, not a wire; on a process-group mesh
    (every process calls it) they include the group's exchange.
    Host-side tooling; the training step never calls it."""
    reg = get_registry()
    n = local_count(mesh, axis)
    rows, total_ms = [], 0.0
    for i, b in enumerate(schedule.buckets):
        dtype = schedule.leaf_dtypes[b.indices[0]]
        elems = b.nbytes // torch.empty((), dtype=dtype).element_size()
        buf = torch.zeros((n, max(1, elems)), dtype=dtype,
                          device=mesh.device)
        ms = time_collective(lambda: pmean(buf, mesh, axis), mesh.device,
                             repeats)
        total_ms += ms
        rows.append({"bucket": i, "leaves": len(b), "bytes": b.nbytes,
                     "ms": round(ms, 4)})
        record_external_span("bucket_psum", ms, cat="collective",
                             bucket=i, bytes=b.nbytes, leaves=len(b))
    if reg.enabled:
        reg.gauge("parallel.collective_ms").set(total_ms)
        reg.gauge("parallel.bucket_count").set(len(schedule))
    return {"buckets": rows, "collective_ms": round(total_ms, 4)}
