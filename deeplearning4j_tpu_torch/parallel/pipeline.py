"""Pipeline parallelism: a GPipe schedule of identical stages over a mesh
axis.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``
(``pipeline_apply`` ``:32-95``, ``stage_sharding`` ``:98-100``,
``stack_stage_params`` ``:103-107``). A deep stack of identical blocks
(transformer or recurrent) has its parameters stacked on a leading stage
axis, one stage a worker of the ``pipe`` axis, so each worker holds 1/n of
them; the ends that differ (embedding, head) stay outside, replicated.
Microbatches stream through the GPipe schedule: at tick t, stage s runs
microbatch t - s, and the activations hop to the next stage
(``ppermute_next``). A (stage, tick) pair with no microbatch computes
nothing here; the reference's stage computes a value there that no output
reads, so the outputs and gradients are the same. The whole schedule is
torch operations, so autograd through ``fn`` gives the GPipe backward.

On the logical mesh the stages run one after another within a tick, on
the one device; ``block_fn`` is any differentiable function of a stage's
parameters (its flash attention runs the K1-K3 kernels on the card).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .mesh import Mesh, Sharding, axis_size, ppermute_next, shard_map


def pipeline_apply(block_fn: Callable, mesh: Mesh, axis: str = "pipe"):
    """A pipelined apply ``fn(stacked_params, x_micro)``:

    - ``block_fn(params_i, x) -> y``: one stage; x and y have one shape;
    - ``stacked_params``: a dict of tensors with a leading ``n_stages``
      axis (``stack_stage_params``), one stage a worker of ``axis``;
    - ``x_micro``: ``[n_micro, micro_batch, ...]`` microbatches.

    Returns ``[n_micro, micro_batch, ...]``: every microbatch through the n
    stages in order, as applying the blocks one after another gives."""
    n = axis_size(mesh, axis)

    def worker(params: Dict[str, torch.Tensor], x_rows: torch.Tensor):
        # params: each worker's shard of the stacked axis, [n, 1, ...]
        # (a worker strips its own stage); x_rows: the microbatches on
        # every row
        x_micro = x_rows[0]
        n_micro = x_micro.shape[0]
        buf = torch.zeros((n,) + tuple(x_micro.shape[1:]),
                          dtype=x_micro.dtype, device=x_micro.device)
        outs: List = [None] * n_micro
        for t in range(n_micro + n - 1):
            ys = []
            for s in range(n):
                mb = t - s
                if not 0 <= mb < n_micro:       # this stage is idle
                    ys.append(torch.zeros_like(buf[s]))
                    continue
                x_in = x_micro[mb] if s == 0 else buf[s]
                ys.append(block_fn({k: v[s, 0] for k, v in params.items()},
                                   x_in))
            if 0 <= t - (n - 1) < n_micro:      # the last stage emits
                outs[t - (n - 1)] = ys[n - 1]
            buf = ppermute_next(torch.stack(ys), mesh, axis)
        out = torch.stack(outs)
        # the outputs live on the last stage; every row gets them
        return out.unsqueeze(0).expand((n,) + tuple(out.shape))

    inner = shard_map(worker, mesh=mesh, in_specs=((axis,), ()),
                      out_specs=())

    def fn(stacked_params: Dict[str, torch.Tensor], x_micro: torch.Tensor):
        for leaf in stacked_params.values():
            if leaf.shape[0] != n:
                raise ValueError(
                    f"stacked stage params must have leading dim == mesh "
                    f"axis size ({n}); got {leaf.shape[0]} — one stage per "
                    f"device (each worker strips its own stage)")
        return inner(stacked_params, x_micro)

    return fn


def stage_sharding(mesh: Mesh, axis: str = "pipe") -> Sharding:
    """Stacked per-stage parameters: the leading axis on ``axis``."""
    axis_size(mesh, axis)
    return Sharding(mesh, axis, 0)


def stack_stage_params(param_list) -> Dict[str, torch.Tensor]:
    """A list of per-stage parameter dicts stacked on a new leading axis."""
    return {k: torch.stack([p[k] for p in param_list])
            for k in param_list[0]}
