"""ComputationGraph: the DAG executor, its loss and its training loop.

Counterpart of ``deeplearning4j_tpu/nn/graph/graph.py``: ``init``, the
topological forward ``apply_fn`` with its feature-mask flow (``:91-176``),
``loss_fn`` (``:178-241``), ``output`` / ``_output_pure`` /
``feed_forward`` (``:249-263``), ``score`` (``:265-273``),
``params_flat`` / ``set_params_flat`` (``:305-334``), ``num_params`` and
``fit`` (``:350-370``) with the updater state (``opt_state``) and
``iteration_count`` the net carries.

The graph is an ``nn.Module`` on one device, given at construction; its
vertices live in ``self.vertices`` under their configuration names, in
topological order. Parameters are the modules' own, so ``loss_fn`` takes
none: gradients come from ``torch.autograd`` over the graph's parameters.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device, torch_dtype
from ...optimize.solver import score_listeners
from ...optimize.updaters import MultiLayerUpdater
from ..conf.graph_conf import ComputationGraphConfiguration
from .vertices import LayerVertex


def _as_list(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


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
        self.updater = MultiLayerUpdater(
            {n: getattr(self.vertices[n], "layer", None)
             for n in self.vertex_names},
            conf.updater, conf.gradient_normalization,
            conf.gradient_normalization_threshold)
        self.opt_state = None
        self.iteration_count = 0
        self.listeners: List = []
        self.initialized = False

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Create every vertex's parameters on the graph's device, drawing
        from one CPU ``torch.Generator`` seeded with ``seed`` (default: the
        configuration's seed), vertex by vertex in topological order, and
        the updater's state for them."""
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
        self.opt_state = self.updater.init(self.param_dicts())
        self.initialized = True
        return self

    def param_dicts(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """Every vertex's parameters by reference name, in vertex order."""
        return {n: self.vertices[n].param_dict() for n in self.vertex_names}

    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def _ordered_params(self):
        for name in self.vertex_names:
            own = self.vertices[name].param_dict()
            layer = getattr(self.vertices[name], "layer", None)
            order = (getattr(layer, "param_order", tuple(own))
                     if layer is not None else sorted(own))
            for pname in order:
                if pname in own:
                    yield own[pname]

    def params_flat(self) -> torch.Tensor:
        """All parameters as one 1-D vector: vertices in topological
        order, each layer's in its ``param_order`` (reference ``:305-315``)."""
        leaves = [p.detach().reshape(-1) for p in self._ordered_params()]
        if not leaves:
            return torch.zeros(0, dtype=self.dtype, device=self.device)
        return torch.cat(leaves)

    @torch.no_grad()
    def set_params_flat(self, flat) -> None:
        flat = torch.as_tensor(flat)
        expected = self.num_params()
        if tuple(flat.shape) != (expected,):
            raise ValueError(f"Expected flat parameter vector of length "
                             f"{expected}, got shape {tuple(flat.shape)}")
        off = 0
        for p in self._ordered_params():
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    # ------------------------------------------------------------ forward
    def apply_fn(self, inputs, *, train: bool = False,
                 gen: Optional[torch.Generator] = None,
                 features_masks=None) -> Dict[str, torch.Tensor]:
        """Forward in topological order. ``inputs``: one tensor per network
        input (a bare tensor for a single input). Returns every vertex's
        activation by name. A [B,T] feature mask per network input flows
        vertex to vertex: a vertex's mask is its first masked input's, and
        is dropped once the time axis changes length."""
        if not self.initialized:
            raise RuntimeError("call init() before running the graph")
        acts = dict(zip(self.conf.network_inputs, _as_list(inputs)))
        masks: Dict[str, torch.Tensor] = {}
        if features_masks is not None:
            masks.update((k, m) for k, m in zip(self.conf.network_inputs,
                                                _as_list(features_masks))
                         if m is not None)
        for name in self.vertex_names:
            in_names = self.conf.vertex_inputs[name]
            vin = [acts[i] for i in in_names]
            in_mask = next((masks[i] for i in in_names if i in masks), None)
            v = self.vertices[name]
            if isinstance(v, LayerVertex):
                out = v(vin, in_mask, train=train, gen=gen)
            else:
                out = v(vin)
            acts[name] = out
            if in_mask is not None and out.dim() == 3 and \
                    out.shape[1] == in_mask.shape[1]:
                masks[name] = in_mask
        return acts

    def loss_fn(self, x, labels, *, train: bool = True,
                gen: Optional[torch.Generator] = None, labels_mask=None,
                features_mask=None) -> torch.Tensor:
        """Sum of the output layers' losses plus regularization: each
        output's per-example loss is averaged over the batch, or summed
        and divided by max(sum(labels mask), 1) under a [B,T] labels
        mask."""
        inputs = _as_list(x)
        labels = _as_list(labels)
        lmasks = _as_list(labels_mask) or [None] * len(labels)
        acts = self.apply_fn(inputs, train=train, gen=gen,
                             features_masks=features_mask)
        total = 0.0
        for k, out_name in enumerate(self.conf.network_outputs):
            layer = getattr(self.vertices[out_name], "layer", None)
            if not hasattr(layer, "compute_loss_per_example"):
                if k < len(labels) and labels[k] is not None:
                    raise ValueError(
                        f"Network output {out_name!r} is not an output layer; "
                        f"it can be predicted via output() but not scored "
                        f"against labels")
                continue
            feed = acts[self.conf.vertex_inputs[out_name][0]]
            per_ex = layer.compute_loss_per_example(
                feed, labels[k], lmasks[k], train=train, gen=gen)
            lm = lmasks[k]
            if lm is not None and per_ex.dim() == 1 and lm.dim() >= 2:
                total = total + per_ex.sum() / torch.clamp(lm.sum(), min=1.0)
            else:
                total = total + per_ex.mean()
        for name in self.vertex_names:
            layer = getattr(self.vertices[name], "layer", None)
            if layer is not None:
                total = total + layer.regularization()
        return total

    # ---------------------------------------------------------- inference
    def _as_input(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, device=self.device)
        return t if not t.is_floating_point() else t.to(self.dtype)

    def _output_pure(self, inputs, *, train: bool = False):
        """The list of network outputs for input tensors (one per network
        input, or a bare tensor), in ``network_outputs`` order: the
        reference's ``_output_pure`` (``:256-258``), which
        ``serving.programs.default_forward`` calls."""
        acts = self.apply_fn(inputs, train=train)
        return [acts[o] for o in self.conf.network_outputs]

    @torch.inference_mode()
    def output(self, *inputs, train: bool = False):
        """Network output(s) for numpy arrays or tensors (token ids stay
        integer; float inputs take the graph's dtype); ``train`` runs the
        layers in training mode, as the reference's keyword does."""
        outs = self._output_pure([self._as_input(x) for x in inputs],
                                 train=train)
        return outs[0] if len(outs) == 1 else outs

    @torch.inference_mode()
    def feed_forward(self, *inputs, train: bool = False):
        """Every vertex's activation (and each network input) by name."""
        return self.apply_fn([self._as_input(x) for x in inputs], train=train)

    @torch.no_grad()
    def score(self, x=None, y=None, dataset=None) -> float:
        """The loss (train=False) on features ``x`` and labels ``y``, or on
        a ``DataSet``'s."""
        if dataset is not None:
            x, y = dataset.features, dataset.labels
        xs = [self._as_input(v) for v in _as_list(x)]
        ys = [self._as_input(v) for v in _as_list(y)]
        return float(self.loss_fn(xs, ys, train=False))

    # ---------------------------------------------------------------- train
    def set_listeners(self, *listeners) -> "ComputationGraph":
        """Score callbacks: each is called as
        ``listener.iteration_done(net, iteration, loss)`` after every step.
        Epoch and performance listeners come with telemetry (ROADMAP A8)."""
        self.listeners = score_listeners(listeners)
        return self

    def fit(self, data=None, labels=None, *, epochs: int = 1,
            batch_size: Optional[int] = None, iterator=None, dataset=None,
            async_prefetch: bool = False,
            steps_per_dispatch: int = 1) -> "ComputationGraph":
        """Train with the per-step SGD path of ``optimize.solver.Solver``:
        on arrays or tensors (batched by ``batch_size``), a ``DataSet`` or
        an iterator of them. Device prefetch
        (``async_prefetch``) and fused multi-step windows
        (``steps_per_dispatch > 1``) are not ported yet (ROADMAP A10)."""
        if not hasattr(self, "_solver_inst"):
            from ...optimize.solver import Solver
            self._solver_inst = Solver(self)
        self._solver_inst.fit(data=data, labels=labels, epochs=epochs,
                              batch_size=batch_size, iterator=iterator,
                              dataset=dataset, async_prefetch=async_prefetch,
                              steps_per_dispatch=steps_per_dispatch)
        return self

    # ------------------------------------------------- not ported yet
    def rnn_time_step(self, *inputs):
        raise NotImplementedError("streaming inference through a graph "
                                  "(rnn_time_step) is not ported yet "
                                  "(ROADMAP A10)")

    def rnn_clear_previous_state(self):
        raise NotImplementedError("streaming inference through a graph "
                                  "(rnn_clear_previous_state) is not ported "
                                  "yet (ROADMAP A10)")

    def pretrain(self, iterator, epochs: int = 1):
        raise NotImplementedError("layerwise pretraining is not ported yet "
                                  "(ROADMAP A5)")

    def evaluate(self, iterator_or_x, y=None):
        raise NotImplementedError("evaluation (eval/Evaluation) is not "
                                  "ported yet (ROADMAP A5)")

    def clone(self):
        raise NotImplementedError("clone, checkpointing and model zips are "
                                  "not ported yet (ROADMAP A10)")
