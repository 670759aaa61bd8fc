"""The multi-process entry point: real ranks behind the mesh's collectives.

Counterpart of ``deeplearning4j_tpu/parallel/distributed.py``
(``initialize_distributed`` ``:30-56``, ``shutdown_distributed``
``:59-61``, ``global_mesh`` ``:64-76``, ``process_index`` /
``process_count`` ``:79-86``). The reference joins the JAX coordination
service, after which ``jax.devices()`` is every process's devices and a
mesh over them spans hosts. Here every process joins a
``torch.distributed`` process group (NCCL between cards, gloo between CPU
processes) and ``global_mesh`` gives a ``parallel/mesh.py`` ``Mesh`` over
one worker a process, each process holding its own worker's row. The
collectives on such a mesh move reduce-scatter and all-gather bytes and
add every sum locally in rank order, so its bits are the logical mesh's
(see ``parallel/mesh.py``).

Usage (one process a card; nothing on the machine names the cluster, so
each process is given the address, the count and its rank):

    from deeplearning4j_tpu_torch.parallel import distributed
    distributed.initialize_distributed("10.0.0.1:29500", num_processes=2,
                                       process_id=rank)
    mesh = distributed.global_mesh(("data",))
    ParallelWrapper(net, mesh=mesh, prefetch_buffer=0).fit(iterator)

Each process feeds the same global batches; each trains its workers' rows
of them, on every path of the data axis: plain sync, ZeRO stages 1 and 2,
a ``GradientsAccumulator`` and K-step averaging. Tested with CPU processes
on gloo (``tests/test_torch_distributed.py``,
``tests/test_torch_distributed_options.py``).

Several processes may share one card: NCCL refuses two ranks on one
device, so they join on gloo with the card as their device,

    distributed.initialize_distributed("127.0.0.1:29500", 2, rank,
                                       backend="gloo", device="cuda:0")

and gloo takes their card tensors (the semantics and bits of several
cards, not their speed: gloo moves them through host memory and
loopback TCP). NCCL stays the default on a card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .mesh import Mesh, make_mesh

__all__ = ["initialize_distributed", "shutdown_distributed", "global_mesh",
           "process_index", "process_count"]

_DEVICE: Optional[torch.device] = None     # this process's device


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, backend: Optional[str] = None,
                           *, device: DeviceLike = None) -> None:
    """Join (or start, as process 0) the process group at
    ``tcp://coordinator_address``. ``device`` is this process's device
    (default: the CUDA card, ``cuda:{process_id % device_count}``; pass
    ``"cpu"`` for CPU processes). ``backend`` defaults to NCCL on a card
    and gloo on the CPU (the reference's ``cpu_collectives="gloo"``);
    ``backend="gloo"`` with a card lets several processes share it."""
    global _DEVICE
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)
    _DEVICE = dev


def shutdown_distributed() -> None:
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over every process's worker (one a process, on this
    process's device). With the default shape, all of them on the first
    axis, the others of size 1. A shape that does not cover them is
    refused, as the reference's is."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs initialize_distributed first")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    n = 1
    for s in shape:
        n *= int(s)
    if n != world:
        raise ValueError(f"Mesh shape {tuple(shape)} must cover all {world} "
                         f"global devices")
    return make_mesh(tuple(shape), axis_names, _DEVICE,
                     group=dist.group.WORLD, rank=dist.get_rank(),
                     world=world)
