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

The reference's ``profile_schedule`` times each bucket's collective on a
mesh and writes trace events: that is telemetry (ROADMAP A8, part 2b) and
raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from .mesh import Mesh, pmean

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
    ``pmean`` sweep's."""
    n = mesh.shape.get(axis)
    if n is None:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.axis_names}")
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
    n = mesh.shape[axis]
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


def profile_schedule(mesh, schedule: BucketSchedule, axis: str = "data",
                     repeats: int = 3) -> dict:
    raise NotImplementedError("profile_schedule (per-bucket collective "
                              "timing and trace events) is telemetry: not "
                              "ported yet (ROADMAP A8, part 2b)")
