"""A logical mesh: n workers in one process on one device.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py`` (``shard_map``
``:16-30``, ``make_mesh`` ``:33-45``, ``data_sharding`` ``:48-50``,
``window_sharding`` ``:53-56``, ``replicated`` ``:59-60``) and of what
``shard_map`` does with it. The reference builds a ``jax.sharding.Mesh``
over devices and lets ``shard_map`` hand each worker its row of a sharded
array; its own tests run that on eight virtual CPU devices in one
process. The port's ``Mesh`` names its axes, their sizes and ONE
``torch.device``; a per-worker value is a tensor with the worker axis
leading (``[n, ...]``), row ``i`` being what ``shard_map`` with
``P(axis)`` hands worker ``i``. The collectives the
parallel layer needs are plain functions on such tensors, on any named
axis of a 1-D or a 2-D ``(data, model)`` mesh: ``psum`` and ``pmean``,
``ppermute_next``, ``axis_index``, ``psum_scatter`` and ``all_gather``
(the ZeRO update's, ``parallel/zero.py``) and ``all_to_all`` (the expert
exchange, ``parallel/expert_parallel.py``). A sum over the rows adds them
in worker order (``sum_rows``), so the CPU and the card give the same
bits. ``Sharding.split`` / ``gather`` cut a global array into the rows and
join them again; a spec is a tuple of axis names (or None) a dimension,
``jax.sharding.PartitionSpec``'s entries (``()`` is replicated).
``shard_map`` splits its inputs by spec into worker rows, calls the body
ONCE on the rows (the body uses the collectives above) and joins the
outputs.

This is not several cards: all workers' rows live on the one device and a
"collective" is an indexing operation there. Real ranks
(``torch.distributed`` with NCCL, one process a card) go behind these same
functions, so the code above them (``parallel/accumulation.py``,
``parallel/data_parallel.py``, ``parallel/ring_attention.py``) does not
change when a machine has several cards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

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


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum of the rows of ``x`` (its leading axis) in row order, one
    after the other in x's dtype: the fixed order of every sum over
    workers here (``psum``, ``pmean``, a row-parallel product's
    partials), so the CPU and the card give the same bits."""
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis``: ``[n, ...]`` in and out, every row the
    sum of the rows in worker order (a broadcast view, not n copies)."""
    _check_rows(x, mesh, axis)
    return sum_rows(x).unsqueeze(0).expand_as(x)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The mean over the worker axis, which every worker gets: ``[n, ...]``
    in and out, every row the same (a broadcast view, not n copies). The
    rows are added in x's dtype in worker order, one after the other, and
    the sum divided by n, as ``lax.pmean``: a fixed order gives the same
    bits on the CPU and on the card."""
    n = _check_rows(x, mesh, axis)
    return (sum_rows(x) / n).unsqueeze(0).expand_as(x)


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


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` on per-worker values
    ``[n, n, ...]`` (each worker's row cut into n parts, part j bound for
    worker j): worker i gets part i of every worker's row, in worker
    order, ``out[i, j] = x[j, i]``."""
    n = _check_rows(x, mesh, axis)
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(f"all_to_all cuts each worker's row into {n} "
                         f"parts: expected [{n}, {n}, ...], got "
                         f"{tuple(x.shape)}")
    return x.transpose(0, 1)


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


def window_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """``[K, batch, ...]`` feeds of a K-step window: the batch dimension
    split across ``axis`` (the reference's ``P(None, axis)``)."""
    axis_size(mesh, axis)
    return Sharding(mesh, axis, 1)


def replicated(mesh: Mesh) -> Tuple:
    """The replicated spec ``()`` (the reference's ``NamedSharding(mesh,
    P())``): every worker holds the whole array."""
    return ()


def spec_axis(spec: Sequence) -> Tuple[Optional[str], Optional[int]]:
    """(axis, dimension) of the one dimension a spec cuts, or (None, None)
    for a replicated spec; a spec cutting two dimensions is refused."""
    cut = [(a, d) for d, a in enumerate(spec) if a is not None]
    if len(cut) > 1:
        raise ValueError(f"a spec cuts one dimension here, got {spec}")
    return cut[0] if cut else (None, None)


def shard_map(f: Callable, *, mesh: Mesh, in_specs: Sequence,
              out_specs) -> Callable:
    """``shard_map(f, mesh, in_specs, out_specs)`` on the logical mesh:
    each input cut by its spec into worker rows ``[n, ...]`` (a replicated
    input is broadcast to every row), ``f`` called once on the rows (it
    works through the collectives above), each output joined by its spec
    (a replicated output is row 0, which the body made equal on every
    row). ``out_specs`` is one spec, or a tuple of specs for a tuple of
    outputs. One mesh axis a call, as every caller here needs."""
    several = isinstance(out_specs, tuple) and bool(out_specs) and \
        all(isinstance(sp, tuple) for sp in out_specs)
    specs_out = out_specs if several else (out_specs,)
    axes = {spec_axis(sp)[0] for sp in tuple(in_specs) + specs_out} - {None}
    if len(axes) != 1:
        raise ValueError(f"shard_map here maps over one mesh axis, the "
                         f"specs name {sorted(axes)}")
    axis = axes.pop()
    n = axis_size(mesh, axis)

    def cut(sp):
        a, d = spec_axis(sp)
        if a is None:
            return lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape))
        return Sharding(mesh, a, d).split

    def join(sp):
        a, d = spec_axis(sp)
        return (lambda t: t[0]) if a is None else Sharding(mesh, a, d).gather

    def run(*args):
        out = f(*(_tree_map(cut(sp), x) for x, sp in zip(args, in_specs)))
        outs = tuple(_tree_map(join(sp), y) for y, sp in
                     zip(out if several else (out,), specs_out))
        return outs if several else outs[0]
    return run


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree
