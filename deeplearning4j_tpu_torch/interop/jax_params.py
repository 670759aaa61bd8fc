"""Carry a JAX graph's weights into the port's graph.

The JAX package keeps a ComputationGraph's parameters as ``net.params``: a
tuple with one dict per vertex, in ``net.vertex_names`` order, under the
same names and layouts the port's layers use. The port never imports JAX,
so the caller turns those arrays into numpy first, e.g.
``[{k: np.asarray(v) for k, v in p.items()} for p in jax_net.params]``.
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
