"""Expert parallelism: mixture-of-experts dispatch over a mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/expert_parallel.py``
(``expert_parallel_apply`` ``:24-125``, ``expert_sharding`` ``:128-129``,
``load_balancing_loss`` ``:132-141``). One expert a worker of the
``expert`` axis, its parameters stacked on a leading axis. Routing is the
reference's: top-``top_k`` of the softmax gate with a capacity of
``ceil(capacity_factor * top_k * N / n_experts)`` slots an expert; every
token's first choice claims its slot before any second choice does
(GShard), and the combine weights are the chosen probabilities
renormalized over the choices that fit (top-1 keeps the raw probability,
so the router gets a gradient), so a token whose first choice overflowed
goes to its second with full weight, and a token with no choice left
passes through as zeros.

The exchange is the canonical one, on the logical mesh's collectives:
the tokens are cut over the workers (``[n, N/n, D]``); each worker
scatters its own tokens into a dispatch buffer ``[E, cap, D]`` at their
slots; an ``all_to_all`` hands expert e's slab of every worker to worker
e, which adds them in worker order (the slots are disjoint, so this is
the reference's slab exactly) and runs its expert; a second
``all_to_all`` hands every worker each expert's outputs, and each worker
gathers its tokens' outputs with their weights; the token rows are joined.
The slot positions need every token's choices (a prefix count over the
whole batch), so the routing is computed from the whole gate, as in the
reference, where every worker computes it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from .mesh import (Mesh, Sharding, all_to_all, axis_size, data_sharding,
                   sum_rows)


def _route(gate_logits: torch.Tensor, n: int, top_k: int, cap: int):
    """(expert [N, k], slot [N, k], kept [N, k] bool, weight [N, k]): the
    reference's top-k routing with first-choice-first slots."""
    probs = torch.softmax(gate_logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)
    claimed = torch.zeros(n, dtype=torch.int64, device=gate_logits.device)
    slots, keeps = [], []
    for c in range(top_k):
        onehot = torch.nn.functional.one_hot(top_e[:, c], n)       # [N, E]
        pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1 \
            + claimed[top_e[:, c]]
        slots.append(pos)
        keeps.append(pos < cap)
        claimed = claimed + onehot.sum(0)
    slot = torch.stack(slots, 1)
    keep = torch.stack(keeps, 1)
    live = gates * keep
    weight = live if top_k == 1 else \
        live / torch.clamp(live.sum(-1, keepdim=True), min=1e-9)
    return top_e, slot, keep, weight


def expert_parallel_apply(expert_fn: Callable, mesh: Mesh,
                          axis: str = "expert", capacity_factor: float = 2.0,
                          top_k: int = 1):
    """``fn(stacked_expert_params, tokens, gate_logits)``:

    - ``expert_fn(params_e, x) -> y``: one expert, ``[T, D]`` in, ``[T,
      D']`` out;
    - ``stacked_expert_params``: a dict of tensors with a leading
      ``n_experts`` axis, one expert a worker of ``axis``;
    - ``tokens`` ``[N, D]`` (cut over the workers, padded with rows that
      route nowhere to a multiple of the axis size), ``gate_logits``
      ``[N, n_experts]``.

    Returns ``[N, D']``."""
    n = axis_size(mesh, axis)
    if not 1 <= top_k <= n:
        raise ValueError(f"top_k must be in [1, {n}], got {top_k}")

    def fn(stacked: Dict[str, torch.Tensor], tokens: torch.Tensor,
           gate_logits: torch.Tensor) -> torch.Tensor:
        if gate_logits.shape[-1] != n:
            raise ValueError(
                f"gate_logits last dim ({gate_logits.shape[-1]}) must equal "
                f"the expert mesh axis size ({n}) — routing to a nonexistent "
                f"expert would silently zero those tokens")
        for leaf in stacked.values():
            if leaf.shape[0] != n:
                raise ValueError(
                    f"stacked expert params must have leading dim == mesh "
                    f"axis size ({n}); got {leaf.shape[0]}")
        N, D = tokens.shape
        cap = int(math.ceil(capacity_factor * top_k * N / n))
        expert, slot, keep, weight = _route(gate_logits, n, top_k, cap)
        pad = -N % n        # rows that route nowhere, so N/n is whole
        if pad:
            tokens, expert, slot, keep, weight = (
                torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                for a in (tokens, expert, slot, keep, weight))
        sh = data_sharding(mesh, axis)          # the token rows
        tok_rows = sh.split(tokens)                             # [n, Nw, D]
        e_rows, s_rows, k_rows = (sh.split(a) for a in (expert, slot, keep))
        w_rows = sh.split(weight)
        Nw = tokens.shape[0] // n
        # dispatch: each worker's tokens at their slots, [n, E, cap, D]
        disp = []
        for w in range(n):
            buf = tokens.new_zeros((n, cap, D))
            for c in range(top_k):
                buf = buf.index_put(
                    (e_rows[w][:, c], s_rows[w][:, c].clamp(0, cap - 1)),
                    tok_rows[w] * k_rows[w][:, c:c + 1].to(tokens.dtype),
                    accumulate=True)
            disp.append(buf)
        slabs = sum_rows(all_to_all(torch.stack(disp), mesh, axis)
                         .transpose(0, 1))                      # [E, cap, D]
        out_slabs = torch.stack([expert_fn({k: v[e] for k, v in
                                            stacked.items()}, slabs[e])
                                 for e in range(n)])           # [E, cap, D']
        # combine: every worker gets every expert's outputs back
        back = all_to_all(out_slabs.unsqueeze(1).expand(
            (n, n) + tuple(out_slabs.shape[1:])), mesh, axis)  # [w, E, ...]
        outs = []
        for w in range(n):
            o = back.new_zeros((Nw, out_slabs.shape[-1]))
            for c in range(top_k):
                got = back[w][e_rows[w][:, c],
                              s_rows[w][:, c].clamp(0, cap - 1)]
                o = o + got * (k_rows[w][:, c].to(got.dtype)
                               * w_rows[w][:, c])[:, None]
            outs.append(o)
        return sh.gather(torch.stack(outs))[:N]

    return fn


def expert_sharding(mesh: Mesh, axis: str = "expert") -> Sharding:
    """Stacked expert parameters: the leading axis on ``axis``."""
    axis_size(mesh, axis)
    return Sharding(mesh, axis, 0)


def load_balancing_loss(gate_logits: torch.Tensor,
                        top_k: int = 1) -> torch.Tensor:
    """The Switch/GShard auxiliary loss ``E * sum_e f_e * P_e``: f_e the
    fraction of tokens whose top-k choices include expert e, P_e the mean
    routing probability; ``top_k`` at uniform routing."""
    n = gate_logits.shape[-1]
    probs = torch.softmax(gate_logits, dim=-1)
    top_e = torch.topk(probs, top_k, dim=-1).indices
    chosen = torch.nn.functional.one_hot(top_e, n).to(probs.dtype).sum(1)
    f = chosen.mean(0)
    p = probs.mean(0)
    return n * (f * p).sum()
