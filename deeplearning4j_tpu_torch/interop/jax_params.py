"""Carry a JAX network's weights and updater state into the port's.

The JAX package keeps a network's parameters as ``net.params``: a tuple
with one dict per vertex of a ComputationGraph (in ``net.vertex_names``
order) or per layer of a MultiLayerNetwork (in layer order), under the same
names and layouts the port's layers use (a conv's ``W`` is HWIO
[kh, kw, C, F] in both; a vertex without parameters, such as a pooling,
LRN or merge vertex, has an empty dict). The port never imports JAX, so
the caller turns those arrays into numpy first, e.g.
``[{k: np.asarray(v) for k, v in p.items()} for p in jax_net.params]``.
The updater state (``net.opt_state``) has one more level, the state name
(Adam's ``m`` and ``v``, RmsProp's ``h``), so a parity test can start both
packages from one mid-training state. A ``ParallelWrapper``'s accumulator
carry (``_acc_state``, ``[n, num_params]``) crosses both ways too.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch


def _groups(net, what: str, items, vertex_names) -> dict:
    """``items`` (one entry per vertex or layer) keyed as the port network
    keys its parameters: by vertex name for a graph (``vertex_names``,
    default the port graph's own order, which its topological sort makes
    equal to the JAX graph's), by layer index for a MultiLayerNetwork."""
    if not net.initialized:
        raise RuntimeError(f"call init() on the port network before loading "
                           f"{what} into it")
    own = list(net.param_dicts())
    if hasattr(net, "vertex_names"):
        names = list(vertex_names) if vertex_names is not None else own
    elif vertex_names is not None:
        raise ValueError("a MultiLayerNetwork's groups are its layers, in "
                         "order; it takes no vertex names")
    else:
        names = own
    if len(names) != len(items):
        raise ValueError(f"{len(items)} {what} dicts for {len(names)} "
                         f"vertices or layers")
    src = dict(zip(names, items))
    if set(src) != set(own):
        raise ValueError(
            f"vertex names differ: missing {sorted(set(own) - set(src))}, "
            f"unexpected {sorted(set(src) - set(own))}")
    return src


def load_jax_params(net, params: Sequence[Mapping[str, np.ndarray]],
                    vertex_names: Optional[Sequence[str]] = None) -> None:
    """Copy ``params`` (one dict of numpy arrays per vertex of a graph, in
    ``vertex_names`` order, or per layer of a MultiLayerNetwork, in layer
    order) into the initialized port network ``net``, matching by vertex
    name (or layer index) and parameter name. Every shape is checked; a
    missing, extra or misshapen entry raises before anything is copied."""
    src = _groups(net, "parameter", params, vertex_names)
    pairs = []
    for name, own in net.param_dicts().items():
        theirs = src[name]
        if set(own) != set(theirs):
            raise ValueError(
                f"vertex {name!r}: parameters {sorted(theirs)} do not match "
                f"the port's {sorted(own)}")
        for pname, p in own.items():
            arr = np.asarray(theirs[pname])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"vertex {name!r} parameter {pname!r}: shape "
                    f"{tuple(arr.shape)} does not match the port's "
                    f"{tuple(p.shape)}")
            pairs.append((p, arr))
    with torch.no_grad():
        for p, arr in pairs:
            p.copy_(torch.tensor(arr, dtype=p.dtype))


def load_jax_opt_state(net, opt_state, *, iteration_count: int,
                       vertex_names: Optional[Sequence[str]] = None) -> None:
    """Copy a JAX network's updater state into the port network ``net``:
    ``opt_state`` is one dict per vertex or layer (in the order
    ``load_jax_params`` takes) of {parameter name: {state name: numpy
    array}}, e.g. Adam's ``m`` and ``v``, as in the JAX network's
    ``net.opt_state`` turned into numpy. ``iteration_count`` is the JAX
    network's, which the schedules and Adam's bias correction read. Every
    name and shape is checked before anything is copied."""
    src = _groups(net, "state", opt_state, vertex_names)
    pairs = []
    for name in net.param_dicts():
        own, theirs = net.opt_state[name], src[name]
        if set(own) != set(theirs):
            raise ValueError(f"vertex {name!r}: state for parameters "
                             f"{sorted(theirs)} does not match the port's "
                             f"{sorted(own)}")
        for pname, states in own.items():
            if set(states) != set(theirs[pname]):
                raise ValueError(
                    f"vertex {name!r} parameter {pname!r}: state "
                    f"{sorted(theirs[pname])} does not match the port's "
                    f"updater state {sorted(states)}")
            for sname, t in states.items():
                arr = np.asarray(theirs[pname][sname])
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(
                        f"vertex {name!r} state {pname}.{sname}: shape "
                        f"{tuple(arr.shape)} does not match the port's "
                        f"{tuple(t.shape)}")
                pairs.append((t, arr))
    with torch.no_grad():
        for t, arr in pairs:
            t.copy_(torch.tensor(arr, dtype=t.dtype))
    net.iteration_count = int(iteration_count)


def load_jax_acc_state(wrapper, acc_state: np.ndarray) -> None:
    """Copy a JAX ``ParallelWrapper._acc_state`` (``[n, num_params]``, the
    per-worker carry of its gradient accumulator, as numpy) into the port's
    ``wrapper``. Both packages lay a worker's row out in the same order
    (``parallel.data_parallel.flat_param_order``: vertices or layers in
    order, each one's parameter names sorted, as ``ravel_pytree``), so the
    carry crosses as a copy."""
    arr = np.asarray(acc_state)
    want = (wrapper.n, int(wrapper.net.num_params()))
    if tuple(arr.shape) != want:
        raise ValueError(f"accumulator carry of shape {tuple(arr.shape)} "
                         f"does not match the wrapper's {want}")
    wrapper._acc_state = torch.tensor(arr, dtype=wrapper.net.dtype,
                                      device=wrapper.net.device)


def acc_state_to_numpy(wrapper) -> np.ndarray:
    """The port wrapper's accumulator carry as a float32 numpy array
    ``[n, num_params]``, in the layout the JAX wrapper's has (bf16 values
    are exact in float32)."""
    if wrapper._acc_state is None:
        raise ValueError("the wrapper has no accumulator carry yet: it is "
                         "made at the first accumulator step")
    return wrapper._acc_state.detach().float().cpu().numpy()
