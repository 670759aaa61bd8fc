"""Carry a JAX graph's weights and updater state into the port's graph.

The JAX package keeps a ComputationGraph's parameters as ``net.params``: a
tuple with one dict per vertex, in ``net.vertex_names`` order, under the
same names and layouts the port's layers use. The port never imports JAX,
so the caller turns those arrays into numpy first, e.g.
``[{k: np.asarray(v) for k, v in p.items()} for p in jax_net.params]``.
The updater state (``net.opt_state``) has one more level, the state name,
so a parity test can start both packages from one mid-training state.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch


def load_jax_params(net, params: Sequence[Mapping[str, np.ndarray]],
                    vertex_names: Optional[Sequence[str]] = None) -> None:
    """Copy ``params`` (one dict of numpy arrays per vertex, in
    ``vertex_names`` order; default the port graph's own order, which its
    topological sort makes equal to the JAX graph's) into the initialized
    port graph ``net``, matching by vertex name and parameter name. Every
    shape is checked; a missing, extra or misshapen entry raises before
    anything is copied."""
    if not net.initialized:
        raise RuntimeError("call init() on the port graph before loading "
                           "parameters into it")
    names = list(vertex_names) if vertex_names is not None \
        else list(net.vertex_names)
    if len(names) != len(params):
        raise ValueError(f"{len(params)} parameter dicts for "
                         f"{len(names)} vertex names")
    src = dict(zip(names, params))
    if set(src) != set(net.vertex_names):
        raise ValueError(
            f"vertex names differ: missing {sorted(set(net.vertex_names) - set(src))}, "
            f"unexpected {sorted(set(src) - set(net.vertex_names))}")
    pairs = []
    for name in net.vertex_names:
        own = net.vertices[name].param_dict()
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
    """Copy a JAX graph's updater state into the port graph ``net``:
    ``opt_state`` is one dict per vertex (in ``vertex_names`` order, default
    the port graph's own) of {parameter name: {state name: numpy array}},
    e.g. Adam's ``m`` and ``v``, as in the JAX graph's ``net.opt_state``
    turned into numpy. ``iteration_count`` is the JAX graph's, which the
    schedules and Adam's bias correction read. Every name and shape is
    checked before anything is copied."""
    if not net.initialized:
        raise RuntimeError("call init() on the port graph before loading "
                           "updater state into it")
    names = list(vertex_names) if vertex_names is not None \
        else list(net.vertex_names)
    if len(names) != len(opt_state):
        raise ValueError(f"{len(opt_state)} state dicts for {len(names)} "
                         f"vertex names")
    src = dict(zip(names, opt_state))
    if set(src) != set(net.vertex_names):
        raise ValueError(
            f"vertex names differ: missing {sorted(set(net.vertex_names) - set(src))}, "
            f"unexpected {sorted(set(src) - set(net.vertex_names))}")
    pairs = []
    for name in net.vertex_names:
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
