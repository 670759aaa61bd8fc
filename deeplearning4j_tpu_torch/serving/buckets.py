"""Bucket ladder: the fixed menu of batch shapes the engine ever runs.

A copy of ``deeplearning4j_tpu/serving/buckets.py`` (framework-free, kept
here so the port imports nothing of the JAX package). Every request lands
in the smallest ladder rung that fits the merged rows; the pad-to-rung
waste is the price of running only shapes that were warmed (kernels built,
cuDNN algorithms chosen) before traffic. The ladder is the only set of
batch shapes that exist after warm-up, which is what makes the
no-re-warm guarantee checkable. ``validate_for_mesh`` is mesh-sharded
serving's check that every rung divides over the mesh's data axis.
"""
from __future__ import annotations

from typing import Sequence, Tuple


class BucketLadder:
    """Sorted, deduplicated ladder of merged-batch sizes (e.g. 1/8/32/128)."""

    def __init__(self, buckets: Sequence[int] = (1, 8, 32, 128)):
        rungs = sorted(set(int(b) for b in buckets))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"bucket ladder must be positive ints, got {buckets}")
        self.rungs: Tuple[int, ...] = tuple(rungs)

    @property
    def max(self) -> int:
        return self.rungs[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n. Callers must pre-chunk n > max (batcher does)."""
        if n < 1:
            raise ValueError("empty batch")
        for b in self.rungs:
            if n <= b:
                return b
        raise ValueError(f"{n} rows exceed the largest bucket {self.max}")

    def padding_waste(self, n: int) -> float:
        """Wasted fraction of the padded batch: (bucket - n) / bucket."""
        b = self.bucket_for(n)
        return (b - n) / b

    def validate_for_mesh(self, mesh, axis: str = "data") -> None:
        """Mesh-sharded serving lands the merged batch on the data axis, so
        every rung must divide evenly across it."""
        size = mesh.shape[axis]
        bad = [b for b in self.rungs if b % size]
        if bad:
            raise ValueError(
                f"buckets {bad} not divisible by mesh '{axis}' axis ({size})")

    def __repr__(self):
        return f"BucketLadder{self.rungs}"

    def __iter__(self):
        return iter(self.rungs)
