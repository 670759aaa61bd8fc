"""A logical mesh: n workers in one process on one device.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py`` (``make_mesh``
``:33-45``, ``data_sharding`` ``:48-50``) and of what ``shard_map`` does with
it. The reference builds a ``jax.sharding.Mesh`` over devices and lets
``shard_map`` hand each worker its row of a sharded array; its own tests
run that on eight virtual CPU devices in one process. The port's ``Mesh``
names its axes, their sizes and ONE ``torch.device``; a per-worker value is
a tensor with the worker axis leading (``[n, ...]``), row ``i`` being what
``shard_map`` with ``P(axis)`` hands worker ``i``. The collectives the
parallel layer needs are plain functions on such tensors: ``pmean``,
``ppermute_next``, ``axis_index``, ``psum_scatter`` and ``all_gather``
(the ZeRO update's, ``parallel/zero.py``). ``Sharding.split`` / ``gather`` cut a
global array into the rows and join them again. Nothing else of
``shard_map`` is rebuilt.

This is not several cards: all workers' rows live on the one device and a
"collective" is an indexing operation there. Real ranks
(``torch.distributed`` with NCCL, one process a card) go behind these same
functions, so the code above them (``parallel/accumulation.py``,
``parallel/data_parallel.py``, ``parallel/ring_attention.py``) does not
change when a machine has several cards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes and the one device every worker lives on."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              device: DeviceLike = None) -> Mesh:
    """Build a logical mesh on ``device`` (default: the CUDA card).
    Default shape: one worker, as the reference's default is one worker a
    local device."""
    if shape is None:
        shape = (1,)
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} must be positive")
    return Mesh(axis_names, shape, resolve_device(device))


def axis_size(mesh: Mesh, axis: str) -> int:
    try:
        return mesh.shape[axis]
    except KeyError:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.axis_names}") from None


def _check_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> int:
    n = axis_size(mesh, axis)
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"a per-worker value on axis {axis!r} has the "
                         f"worker axis leading: expected [{n}, ...], got "
                         f"{tuple(x.shape)}")
    return n


def axis_index(mesh: Mesh, axis: str) -> torch.Tensor:
    """Each worker's index on ``axis``: ``[n]`` int64, row i is i."""
    return torch.arange(axis_size(mesh, axis), device=mesh.device)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The mean over the worker axis, which every worker gets: ``[n, ...]``
    in and out, every row the same (a broadcast view, not n copies). The
    rows are added in x's dtype in worker order, one after the other, and
    the sum divided by n, as ``lax.pmean``: a fixed order gives the same
    bits on the CPU and on the card."""
    n = _check_rows(x, mesh, axis)
    total = x[0]
    for i in range(1, n):
        total = total + x[i]
    return (total / n).unsqueeze(0).expand_as(x)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=False)`` on
    per-worker values ``[n, n, ...]`` (each worker's row cut into n
    parts): worker k gets the sum over the workers of part k, ``[n, ...]``
    out. The rows are added in worker order, as ``pmean`` adds them."""
    n = _check_rows(x, mesh, axis)
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(f"psum_scatter cuts each worker's row into {n} "
                         f"parts: expected [{n}, {n}, ...], got "
                         f"{tuple(x.shape)}")
    total = x[0]
    for i in range(1, n):
        total = total + x[i]
    return total


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=False)``: every worker gets
    all the rows, ``[n, ...]`` in and ``[n, n, ...]`` out (a broadcast
    view, not n copies)."""
    n = _check_rows(x, mesh, axis)
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


def ppermute_next(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Worker i's row goes to worker (i + 1) mod n: the ring's
    ``ppermute`` with ``perm = [(i, (i + 1) % n)]``."""
    _check_rows(x, mesh, axis)
    return torch.roll(x, shifts=1, dims=0)


@dataclass(frozen=True)
class Sharding:
    """How a global array is cut over one mesh axis: dimension ``dim`` is
    split into n equal parts, one a worker."""
    mesh: Mesh
    axis: str
    dim: int

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """Global array -> ``[n, ...]`` rows (a copy, worker axis leading).
        The dimension must divide evenly, as ``shard_map`` requires."""
        n = axis_size(self.mesh, self.axis)
        if x.shape[self.dim] % n:
            raise ValueError(
                f"dimension {self.dim} of size {x.shape[self.dim]} does not "
                f"divide over the {n} workers of axis {self.axis!r}")
        return torch.stack(x.chunk(n, dim=self.dim))

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` rows -> the global array."""
        _check_rows(rows, self.mesh, self.axis)
        return torch.cat(rows.unbind(0), dim=self.dim)


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Batch sharding: the leading dimension split across ``axis``."""
    axis_size(mesh, axis)
    return Sharding(mesh, axis, 0)
