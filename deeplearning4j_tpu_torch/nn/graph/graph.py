"""ComputationGraph: the DAG executor's forward.

Counterpart of ``deeplearning4j_tpu/nn/graph/graph.py``: ``init``, the
topological forward ``apply_fn`` and ``output``. Fit, scoring and the
updater come with the training slice.

The graph is an ``nn.Module`` on one device, given at construction; its
vertices live in ``self.vertices`` under their configuration names, in
topological order.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device, torch_dtype
from ..conf.graph_conf import ComputationGraphConfiguration


class ComputationGraph(nn.Module):
    def __init__(self, conf: ComputationGraphConfiguration, *,
                 device: DeviceLike = None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = torch_dtype(conf.dtype)
        self.vertex_names = list(conf.vertex_names)
        self.vertices = nn.ModuleDict(
            (n, conf.vertices[n]) for n in self.vertex_names)
        self.initialized = False

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Create every vertex's parameters on the graph's device, drawing
        from one CPU ``torch.Generator`` seeded with ``seed`` (default: the
        configuration's seed), vertex by vertex in topological order."""
        gen = torch.Generator().manual_seed(
            self.conf.seed if seed is None else int(seed))
        itypes: Dict[str, object] = {}
        if self.conf.input_types is not None:
            itypes.update(zip(self.conf.network_inputs,
                              self.conf.input_types))
        for name in self.vertex_names:
            v = self.vertices[name]
            in_types = [itypes.get(i) for i in self.conf.vertex_inputs[name]]
            v.init_params(in_types, self.dtype, self.device, gen)
            itypes[name] = (v.output_type(in_types)
                            if all(t is not None for t in in_types) else None)
        self.initialized = True
        return self

    # ------------------------------------------------------------ forward
    def apply_fn(self, inputs) -> Dict[str, torch.Tensor]:
        """Forward in topological order. ``inputs``: one tensor per network
        input (a bare tensor for a single input). Returns every vertex's
        activation by name."""
        if not self.initialized:
            raise RuntimeError("call init() before running the graph")
        if isinstance(inputs, torch.Tensor):
            inputs = [inputs]
        acts = dict(zip(self.conf.network_inputs, inputs))
        for name in self.vertex_names:
            acts[name] = self.vertices[name](
                [acts[i] for i in self.conf.vertex_inputs[name]])
        return acts

    def _as_input(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, device=self.device)
        return t if not t.is_floating_point() else t.to(self.dtype)

    @torch.inference_mode()
    def output(self, *inputs):
        """Network output(s) for numpy arrays or tensors (token ids stay
        integer; float inputs take the graph's dtype)."""
        acts = self.apply_fn([self._as_input(x) for x in inputs])
        outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs
