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

On a logical mesh all workers' rows live on the one device and a
"collective" is an indexing operation there. **Real ranks** go behind the
same functions: a mesh with a process group (``parallel/distributed.py``
``global_mesh``, one process a card on NCCL, or processes on gloo, on the
CPU or sharing one card) holds one worker a process, worker ``rank`` in
the flat (row-major) order, and each process holds only its own worker's
row, ``[1, ...]`` on every axis (``local_slots`` / ``keep_local``). Where
the axis spans the whole group in rank order (every 1-D mesh), a
collective moves what it must and no more, and every sum stays local, in
rank order, so no backend's reduction order enters the result and the
bits are the logical mesh's:

- ``psum_scatter``: ``all_to_all_single`` hands rank j part j of this
  process's row (its own part stays home, so a process hands the backend
  (n-1)/n of its row); the n parts of this process's slot are then added
  in rank order, as ``sum_rows`` adds the logical rows;
- ``psum`` / ``pmean``: that reduce-scatter over the row cut into n parts
  (zero-padded), then ``all_gather_into_tensor`` of the summed part (a
  process hands (n-1)/n + 1/n of its row, where gathering every row
  handed it whole and took n rows back);
- ``all_gather`` and ``all_to_all``: the backend's own, directly;
  ``ppermute_next``: ``all_to_all_single`` with one nonzero split each
  way (gloo has no CUDA send/recv; NCCL and gloo both take this).

A line that is not the whole group (the model axis over processes, ROADMAP
A7b-4b) keeps the first design (``_across``): every row gathered in rank
order, the logical function on the line's rows, this process's row kept.
gloo takes card tensors for every collective here (torch 2.11 on an H100,
``chip_smoke.py`` phase 26's probe), so two processes sharing one card
(NCCL refuses two ranks on a device) hand it their card tensors as they
are. ``Sharding.split`` takes the global array and keeps
this process's row; ``shard_map`` takes each process's local part of an
array (the reference's ``make_array_from_process_local_data``) and gives
each process its part back. The code above these functions
(``parallel/accumulation.py``, ``parallel/data_parallel.py``,
``parallel/zero.py``, ``parallel/ring_attention.py``) reads its own rows
with ``local_slots`` and otherwise does not change.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device


WORLD = "WORLD"           # ``Mesh.group`` of the default process group


@dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes and the one device this process's workers
    live on; ``group`` (a ``torch.distributed`` process group, ``WORLD``
    for the default one, None for a logical mesh), this process's
    ``rank`` in it and its ``world`` size."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    group: Any = field(default=None, compare=False)
    rank: int = 0
    world: int = 1

    @property
    def pg(self) -> Any:
        """The group to pass ``torch.distributed`` (None: the default
        group, looked up at each call). A mesh holds no reference to the
        default group: one still held when the interpreter exits, after
        ``destroy_process_group``, aborts the process from gloo's
        destructor."""
        return None if self.group == WORLD else self.group

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

    def coords(self, flat: int) -> Tuple[int, ...]:
        """The (row-major) coordinates of flat worker index ``flat``."""
        out = []
        for s in reversed(self.axis_sizes):
            out.append(flat % s)
            flat //= s
        return tuple(reversed(out))

    def logical(self) -> "Mesh":
        """The same axes as a logical mesh (every row in this process)."""
        return Mesh(self.axis_names, self.axis_sizes, self.device)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              device: DeviceLike = None, *, group: Any = None,
              rank: int = 0, world: int = 1) -> Mesh:
    """Build a logical mesh on ``device`` (default: the CUDA card).
    Default shape: one worker, as the reference's default is one worker a
    local device. ``group``/``rank``/``world`` spread it over a process
    group, one worker a process (``distributed.global_mesh`` passes
    them)."""
    if shape is None:
        shape = (1,)
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} must be positive")
    if group is not None:
        import torch.distributed as dist
        if group is dist.group.WORLD:
            group = WORLD
    mesh = Mesh(axis_names, shape, resolve_device(device), group, int(rank),
                int(world))
    if (group is not None or mesh.world != 1) and mesh.size != mesh.world:
        raise ValueError(f"a mesh of shape {shape} does not spread over "
                         f"{world} processes (one worker a process)")
    return mesh


def axis_size(mesh: Mesh, axis: str) -> int:
    try:
        return mesh.shape[axis]
    except KeyError:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{mesh.axis_names}") from None


def local_slots(mesh: Mesh, axis: str) -> range:
    """The positions on ``axis`` whose rows this process holds: all of
    them on a logical mesh, its one worker's on a process-group mesh."""
    if mesh.group is None:
        return range(axis_size(mesh, axis))
    i = mesh.coords(mesh.rank)[mesh.axis_names.index(axis)]
    return range(i, i + 1)


def local_count(mesh: Mesh, axis: str) -> int:
    """Rows of a per-worker value on ``axis`` this process holds."""
    return len(local_slots(mesh, axis))


def keep_local(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """This process's rows of ``t``, whose dimension ``dim`` runs over
    ``axis``' positions (``t`` itself on a logical mesh)."""
    if mesh.group is None:
        return t
    s = local_slots(mesh, axis)
    return t.narrow(dim, s.start, len(s))


def _line_ranks(mesh: Mesh, axis: str) -> List[int]:
    """The ranks on this process's line along ``axis``, in the axis'
    order (rank = flat worker index, one worker a process)."""
    a = mesh.axis_names.index(axis)
    mine = list(mesh.coords(mesh.rank))
    ranks = []
    for i in range(mesh.axis_sizes[a]):
        mine[a] = i
        flat = 0
        for s, ci in zip(mesh.axis_sizes, mine):
            flat = flat * s + ci
        ranks.append(flat)
    return ranks


def _whole_line(mesh: Mesh, axis: str) -> bool:
    """True if this process's line along ``axis`` is the whole group in
    rank order (every 1-D process-group mesh)."""
    return _line_ranks(mesh, axis) == list(range(mesh.world))


def _gather_into(mesh: Mesh, out: torch.Tensor, inp: torch.Tensor) -> None:
    """Every process's ``inp`` into ``out`` ``[world, *inp.shape]``, in
    rank order."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out.view(-1), inp.contiguous().view(-1), group=mesh.pg)


def _scatter_sum(parts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The reduce-scatter: ``parts`` ``[n, ...]`` is this process's row
    cut into n parts, part j bound for rank j; returns the sum over the
    ranks of their part ``rank``, added in rank order. Part ``rank`` stays
    here: the backend is handed the other n - 1."""
    import torch.distributed as dist
    n, k = mesh.world, mesh.rank
    if n == 1:
        return parts[0]
    sends = torch.cat([parts[:k], parts[k + 1:]])
    recv = torch.empty_like(sends)
    splits = [0 if j == k else 1 for j in range(n)]
    dist.all_to_all_single(recv, sends, splits, splits, group=mesh.pg)
    rows = list(recv[:k]) + [parts[k]] + list(recv[k:])
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total


def _reduce(x: torch.Tensor, mesh: Mesh, mean: bool) -> torch.Tensor:
    """``psum`` / ``pmean`` of this process's row ``[1, ...]`` over the
    whole group: the reduce-scatter of the row cut into n zero-padded
    parts, then the summed parts all-gathered."""
    n = mesh.world
    flat = x.reshape(-1)
    size = flat.numel()
    c = -(-size // n)
    if n * c != size:
        flat = torch.cat([flat, flat.new_zeros(n * c - size)])
    mine = _scatter_sum(flat.view(n, c), mesh)
    if mean:
        mine = mine / n
    out = mine.new_empty(n * c)
    _gather_into(mesh, out, mine)
    return out[:size].view(x.shape)


def _across(x: torch.Tensor, mesh: Mesh, axis: str, fn) -> torch.Tensor:
    """A collective on a line that is not the whole group (the model axis
    over processes, ROADMAP A7b-4b): every process's rows gathered in rank
    order, ``fn`` (the logical collective) on the rows of this process's
    line along ``axis``, this process's row kept."""
    _check_rows(x, mesh, axis)
    parts = x.new_empty((mesh.world,) + tuple(x.shape))
    _gather_into(mesh, parts, x)
    out = fn(torch.cat([parts[r] for r in _line_ranks(mesh, axis)]),
             mesh.logical(), axis)
    return keep_local(out, mesh, axis)


def _check_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> int:
    n = local_count(mesh, axis)
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"a per-worker value on axis {axis!r} has the "
                         f"worker axis leading: expected [{n}, ...], got "
                         f"{tuple(x.shape)}")
    return n


def axis_index(mesh: Mesh, axis: str) -> torch.Tensor:
    """Each worker's index on ``axis``: ``[n]`` int64, row i is i (this
    process's row of it on a process-group mesh)."""
    return keep_local(torch.arange(axis_size(mesh, axis),
                                   device=mesh.device), mesh, axis)


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
    if mesh.group is not None:
        if not _whole_line(mesh, axis):
            return _across(x, mesh, axis, psum)
        _check_rows(x, mesh, axis)
        return _reduce(x, mesh, mean=False)
    _check_rows(x, mesh, axis)
    return sum_rows(x).unsqueeze(0).expand_as(x)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The mean over the worker axis, which every worker gets: ``[n, ...]``
    in and out, every row the same (a broadcast view, not n copies). The
    rows are added in x's dtype in worker order, one after the other, and
    the sum divided by n, as ``lax.pmean``: a fixed order gives the same
    bits on the CPU and on the card."""
    if mesh.group is not None:
        if not _whole_line(mesh, axis):
            return _across(x, mesh, axis, pmean)
        _check_rows(x, mesh, axis)
        return _reduce(x, mesh, mean=True)
    n = _check_rows(x, mesh, axis)
    return (sum_rows(x) / n).unsqueeze(0).expand_as(x)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=False)`` on
    per-worker values ``[n, n, ...]`` (each worker's row cut into n
    parts): worker k gets the sum over the workers of part k, ``[n, ...]``
    out. The rows are added in worker order, as ``pmean`` adds them."""
    n = axis_size(mesh, axis)
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(f"psum_scatter cuts each worker's row into {n} "
                         f"parts: expected [{local_count(mesh, axis)}, "
                         f"{n}, ...], got {tuple(x.shape)}")
    if mesh.group is not None:
        if not _whole_line(mesh, axis):
            return _across(x, mesh, axis, psum_scatter)
        _check_rows(x, mesh, axis)
        return _scatter_sum(x[0], mesh).unsqueeze(0)
    _check_rows(x, mesh, axis)
    total = x[0]
    for i in range(1, n):
        total = total + x[i]
    return total


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=False)``: every worker gets
    all the rows, ``[n, ...]`` in and ``[n, n, ...]`` out (a broadcast
    view, not n copies)."""
    if mesh.group is not None:
        if not _whole_line(mesh, axis):
            return _across(x, mesh, axis, all_gather)
        _check_rows(x, mesh, axis)
        out = x.new_empty((1, mesh.world) + tuple(x.shape[1:]))
        _gather_into(mesh, out[0], x[0])
        return out
    n = _check_rows(x, mesh, axis)
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` on per-worker values
    ``[n, n, ...]`` (each worker's row cut into n parts, part j bound for
    worker j): worker i gets part i of every worker's row, in worker
    order, ``out[i, j] = x[j, i]``."""
    n = axis_size(mesh, axis)
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(f"all_to_all cuts each worker's row into {n} "
                         f"parts: expected [{local_count(mesh, axis)}, "
                         f"{n}, ...], got {tuple(x.shape)}")
    if mesh.group is not None:
        if not _whole_line(mesh, axis):
            return _across(x, mesh, axis, all_to_all)
        import torch.distributed as dist
        _check_rows(x, mesh, axis)
        out = torch.empty_like(x)
        dist.all_to_all_single(out[0], x[0].contiguous(), group=mesh.pg)
        return out
    _check_rows(x, mesh, axis)
    return x.transpose(0, 1)


def ppermute_next(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Worker i's row goes to worker (i + 1) mod n: the ring's
    ``ppermute`` with ``perm = [(i, (i + 1) % n)]``."""
    if mesh.group is not None:
        if not _whole_line(mesh, axis):
            return _across(x, mesh, axis, ppermute_next)
        import torch.distributed as dist
        _check_rows(x, mesh, axis)
        n, k = mesh.world, mesh.rank
        if n == 1:
            return x.clone()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(),
                               [int(j == (k - 1) % n) for j in range(n)],
                               [int(j == (k + 1) % n) for j in range(n)],
                               group=mesh.pg)
        return out
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
        """Global array -> ``[n, ...]`` rows (a copy, worker axis leading;
        this process's row on a process-group mesh). The dimension must
        divide evenly, as ``shard_map`` requires."""
        n = axis_size(self.mesh, self.axis)
        if x.shape[self.dim] % n:
            raise ValueError(
                f"dimension {self.dim} of size {x.shape[self.dim]} does not "
                f"divide over the {n} workers of axis {self.axis!r}")
        return keep_local(torch.stack(x.chunk(n, dim=self.dim)), self.mesh,
                          self.axis)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` rows -> the global array (on a process-group mesh:
        this process's rows in, every process's gathered)."""
        if self.mesh.group is not None:
            rows = all_gather(rows, self.mesh, self.axis)[0]
        _check_rows(rows, self.mesh.logical(), self.axis)
        return torch.cat(rows.unbind(0), dim=self.dim)

    def split_local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's part of the global array -> its rows: its one
        worker's ``[1, ...]`` on a process-group mesh, the global split on
        a logical mesh."""
        if self.mesh.group is None:
            return self.split(x)
        return x.unsqueeze(0).clone()

    def join_local(self, rows: torch.Tensor) -> torch.Tensor:
        """``split_local``'s inverse: this process's rows -> its part."""
        if self.mesh.group is None:
            return self.gather(rows)
        _check_rows(rows, self.mesh, self.axis)
        return rows[0]


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
    outputs. One mesh axis a call, as every caller here needs. On a
    process-group mesh a cut input is this process's part of the global
    array and a cut output is its part (``Sharding.split_local``)."""
    several = isinstance(out_specs, tuple) and bool(out_specs) and \
        all(isinstance(sp, tuple) for sp in out_specs)
    specs_out = out_specs if several else (out_specs,)
    axes = {spec_axis(sp)[0] for sp in tuple(in_specs) + specs_out} - {None}
    if len(axes) != 1:
        raise ValueError(f"shard_map here maps over one mesh axis, the "
                         f"specs name {sorted(axes)}")
    axis = axes.pop()
    n = local_count(mesh, axis)

    def cut(sp):
        a, d = spec_axis(sp)
        if a is None:
            return lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape))
        return Sharding(mesh, a, d).split_local

    def join(sp):
        a, d = spec_axis(sp)
        return (lambda t: t[0]) if a is None else \
            Sharding(mesh, a, d).join_local

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
