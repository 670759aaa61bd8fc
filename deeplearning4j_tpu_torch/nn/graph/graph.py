"""ComputationGraph: the DAG executor, its loss and its training loop.

Counterpart of ``deeplearning4j_tpu/nn/graph/graph.py``: ``init``, the
topological forward ``apply_fn`` with its feature-mask flow and the
recurrent-state carry (``rnn_states`` / ``collect_rnn_states``,
``:91-176``), ``loss_fn`` (``:178-241``), ``output`` / ``_output_pure`` /
``feed_forward`` (``:249-263``), ``score`` (``:265-273``), the streaming
``rnn_time_step`` and ``rnn_clear_previous_state`` (``:276-301``),
``params_flat`` / ``set_params_flat`` (``:305-334``), ``num_params``,
``fit`` (``:350-370``; tBPTT when the configuration asks for it) with the
updater state (``opt_state``) and ``iteration_count`` the net carries,
``pretrain`` (``:372``), ``evaluate`` (``:379``) and ``clone``
(``:418``). The executor hands ``LastTimeStepVertex`` the mask of its
``mask_input`` (else its input's; none where the time axis changed
length) and ``DuplicateToTimeSeriesVertex`` the length of its
``reference_input`` (``:128-140``). Mixed precision and gradient
checkpointing are the ``MultiLayerNetwork``'s (``nn/multilayer.py``
``run_layer``), per layer vertex; the final recurrent states are indexed
by vertex, in topological order.

The graph is an ``nn.Module`` on one device, given at construction; its
vertices live in ``self.vertices`` under their configuration names, in
topological order. Parameters and layer state (``state_dicts``, in
vertex order) are the modules' own, so ``loss_fn`` takes none: gradients
come from ``torch.autograd`` over the graph's parameters, and a training
step writes the new layer state once (``nn/tape.py``
``record_state``).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...device import DeviceLike, resolve_device, torch_dtype
from ...optimize.solver import check_listeners
from ...optimize.updaters import MultiLayerUpdater
from ..conf.graph_conf import ComputationGraphConfiguration
from ..multilayer import (cast_floats, compute_dtype_of, copy_state,
                          run_layer, to_numpy)
from .vertices import (DuplicateToTimeSeriesVertex, LastTimeStepVertex,
                       LayerVertex)


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
        self._rnn_state: Optional[list] = None

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

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every vertex's non-parameter state by reference name (a
        BatchNormalization's ``mean`` and ``var``; empty for most), in
        vertex order: the reference's ``net.state``."""
        return {n: self.vertices[n].layer_state() for n in self.vertex_names}

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
        from ...parallel.tensor_parallel import full, specs_by_id
        specs = specs_by_id(self)         # a model axis' rows are joined
        leaves = [full(p, specs[id(p)]).detach().reshape(-1)
                  for p in self._ordered_params()]
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
        from ...parallel.tensor_parallel import (global_shape, place_like,
                                                 specs_by_id)
        specs = specs_by_id(self)         # a model axis' rows take their cut
        for p in self._ordered_params():
            n = p.numel()
            v = flat[off:off + n].reshape(global_shape(p, specs[id(p)]))
            p.copy_(place_like(v.to(p.dtype), p))
            off += n

    # ------------------------------------------------------------ forward
    def _forward(self, inputs, *, train: bool = False,
                 gen: Optional[torch.Generator] = None,
                 features_masks=None, rnn_states=None,
                 collect_rnn_states: bool = False):
        """The forward in the compute dtype (see ``apply_fn``): every
        vertex's activation by name and each recurrent vertex's final
        (h, c) by vertex index, None for the others."""
        if not self.initialized:
            raise RuntimeError("call init() before running the graph")
        inputs = _as_list(inputs)
        cd = compute_dtype_of(self.conf)
        remat = getattr(self.conf, "gradient_checkpointing", False)
        if cd is not None:
            inputs = cast_floats(inputs, cd)
            rnn_states = cast_floats(rnn_states, cd)
        acts = dict(zip(self.conf.network_inputs, inputs))
        masks: Dict[str, torch.Tensor] = {}
        if features_masks is not None:
            masks.update((k, m) for k, m in zip(self.conf.network_inputs,
                                                _as_list(features_masks))
                         if m is not None)
        rnn_out = [None] * len(self.vertex_names)
        for idx, name in enumerate(self.vertex_names):
            in_names = self.conf.vertex_inputs[name]
            vin = [acts[i] for i in in_names]
            in_mask = next((masks[i] for i in in_names if i in masks), None)
            v = self.vertices[name]
            init = rnn_states[idx] if rnn_states is not None else None
            if isinstance(v, LayerVertex) and v.recurrent and \
                    (collect_rnn_states or init is not None):
                out, rnn_out[idx] = run_layer(
                    v, lambda *xs, _v=v, _m=in_mask, _init=init:
                    _v.apply_with_final_state(list(xs), _m, train=train,
                                              gen=gen, initial_state=_init),
                    vin, compute_dtype=cd)
            elif isinstance(v, LayerVertex):
                out = run_layer(v, lambda *xs, _v=v, _m=in_mask:
                                _v(list(xs), _m, train=train, gen=gen),
                                vin, compute_dtype=cd, remat=remat)
            elif isinstance(v, LastTimeStepVertex):
                mask = masks.get(v.mask_input) if v.mask_input else in_mask
                if mask is not None and vin[0].dim() == 3 and \
                        mask.shape[1] != vin[0].shape[1]:
                    mask = None       # the sequence length changed upstream
                out = v(vin, mask)
            elif isinstance(v, DuplicateToTimeSeriesVertex):
                out = v(vin, None if v.reference_input is None
                        else acts[v.reference_input].shape[1])
            else:
                out = v(vin)
            acts[name] = out
            if in_mask is not None and out.dim() == 3 and \
                    out.shape[1] == in_mask.shape[1]:
                masks[name] = in_mask
        return acts, rnn_out

    def apply_fn(self, inputs, *, train: bool = False,
                 gen: Optional[torch.Generator] = None,
                 features_masks=None, rnn_states=None,
                 collect_rnn_states: bool = False):
        """Forward in topological order. ``inputs``: one tensor per network
        input (a bare tensor for a single input). Returns every vertex's
        activation by name and, with ``collect_rnn_states``, each
        recurrent vertex's final (h, c) by vertex index (the tBPTT and
        streaming carry); a recurrent vertex starts from
        ``rnn_states[idx]`` when given. A [B,T] feature mask per network
        input flows vertex to vertex: a vertex's mask is its first masked
        input's, and is dropped once the time axis changes length. Under a
        compute dtype the activations and states come back in the master
        dtype."""
        acts, rnn_out = self._forward(
            inputs, train=train, gen=gen, features_masks=features_masks,
            rnn_states=rnn_states, collect_rnn_states=collect_rnn_states)
        if compute_dtype_of(self.conf) is not None:
            acts = cast_floats(acts, self.dtype)
            rnn_out = cast_floats(rnn_out, self.dtype)
        return (acts, rnn_out) if collect_rnn_states else acts

    def loss_fn(self, x, labels, *, train: bool = True,
                gen: Optional[torch.Generator] = None, labels_mask=None,
                features_mask=None, rnn_states=None,
                collect_rnn_states: bool = False):
        """Sum of the output layers' losses plus regularization on the
        master parameters: each output's per-example loss is averaged over
        the batch, or summed and divided by max(sum(labels mask), 1) under
        a [B,T] labels mask. With ``collect_rnn_states`` it returns (loss,
        final recurrent states in the master dtype). Under a compute dtype
        each head runs in it and its per-example loss is reduced in the
        master dtype."""
        labels = _as_list(labels)
        lmasks = _as_list(labels_mask) or [None] * len(labels)
        cd = compute_dtype_of(self.conf)
        acts, rnn_out = self._forward(
            x, train=train, gen=gen, features_masks=features_mask,
            rnn_states=rnn_states, collect_rnn_states=collect_rnn_states)
        total = 0.0
        for k, out_name in enumerate(self.conf.network_outputs):
            v = self.vertices[out_name]
            layer = getattr(v, "layer", None)
            if not hasattr(layer, "compute_loss_per_example"):
                if k < len(labels) and labels[k] is not None:
                    raise ValueError(
                        f"Network output {out_name!r} is not an output layer; "
                        f"it can be predicted via output() but not scored "
                        f"against labels")
                continue
            feed = acts[self.conf.vertex_inputs[out_name][0]]
            if v.preprocessor is not None:
                feed = v.preprocessor.apply(feed)
            per_ex = run_layer(
                layer, lambda f, _l=layer, _y=labels[k], _m=lmasks[k]:
                _l.compute_loss_per_example(f, _y, _m, train=train, gen=gen),
                (feed,), compute_dtype=cd)
            if cd is not None:
                per_ex = per_ex.to(self.dtype)      # reduced at master dtype
            lm = lmasks[k]
            if lm is not None and per_ex.dim() == 1 and lm.dim() >= 2:
                total = total + per_ex.sum() / torch.clamp(lm.sum(), min=1.0)
            else:
                total = total + per_ex.mean()
        for name in self.vertex_names:
            layer = getattr(self.vertices[name], "layer", None)
            if layer is not None:
                total = total + layer.regularization()
        if not collect_rnn_states:
            return total
        if cd is not None:
            rnn_out = cast_floats(rnn_out, self.dtype)
        return total, rnn_out

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
        """Training listeners (``optimize/listeners.py``) or bare score
        callbacks: each is called as ``listener.iteration_done(net,
        iteration, loss)`` after every step, and its epoch hooks and
        ``note_window`` / ``note_batch`` where it has them."""
        self.listeners = check_listeners(listeners)
        return self

    def fit(self, data=None, labels=None, *, epochs: int = 1,
            batch_size: Optional[int] = None, iterator=None, dataset=None,
            async_prefetch: bool = True, prefetch_depth: int = 2,
            steps_per_dispatch: int = 1,
            skip_first_batches: int = 0) -> "ComputationGraph":
        """Train with ``optimize.solver.Solver`` on arrays or tensors
        (batched by ``batch_size``), a ``DataSet``, lists of arrays (one
        per network input and output, fed whole) or an iterator of
        ``DataSet``s or ``MultiDataSet``s; the options are
        ``MultiLayerNetwork.fit``'s (multi-input batches run per step)."""
        if not hasattr(self, "_solver_inst"):
            from ...optimize.solver import Solver
            self._solver_inst = Solver(self)
        self._solver_inst.fit(data=data, labels=labels, epochs=epochs,
                              batch_size=batch_size, iterator=iterator,
                              dataset=dataset, async_prefetch=async_prefetch,
                              prefetch_depth=prefetch_depth,
                              steps_per_dispatch=steps_per_dispatch,
                              skip_first_batches=skip_first_batches)
        return self

    # ---------------------------------------------------------- streaming
    @torch.inference_mode()
    def rnn_time_step(self, *inputs):
        """Stateful streaming inference (reference ``rnnTimeStep``): feed
        [B,F] one step (or [B,T,F] a chunk) per network input; each
        recurrent vertex's state carries between calls until
        ``rnn_clear_previous_state``. Returns the network output(s) for the
        fed step(s)."""
        xs = [self._as_input(x).to(self.dtype) for x in inputs]
        single = all(x.dim() == 2 for x in xs)
        if single:
            xs = [x[:, None, :] for x in xs]
        acts, self._rnn_state = self.apply_fn(
            xs, rnn_states=self._rnn_state, collect_rnn_states=True)
        outs = [acts[o] for o in self.conf.network_outputs]
        if single:
            outs = [o[:, -1] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    def pretrain(self, iterator, epochs: int = 1) -> "ComputationGraph":
        """Layerwise unsupervised pretraining of every layer vertex whose
        layer has a ``pretrain_loss`` (``optimize.solver.Solver.pretrain``):
        its input vertex's activations are its data."""
        if not hasattr(self, "_solver_inst"):
            from ...optimize.solver import Solver
            self._solver_inst = Solver(self)
        self._solver_inst.pretrain(iterator, epochs=epochs)
        return self

    # ---------------------------------------------------------------- eval
    def evaluate(self, iterator_or_x, y=None):
        """Classification evaluation of the eval forward: one
        ``eval.Evaluation`` for a single-output graph, a list (one per
        network output, in order) otherwise. Takes features and labels
        (a list of one per output for several; None skips an output) or
        an iterator of ``DataSet``s or ``MultiDataSet``s, whose labels
        masks and per-example ``metadata`` reach ``Evaluation.eval`` (not
        for [B,T,C] labels)."""
        from ...eval.evaluation import Evaluation
        n_out = len(self.conf.network_outputs)
        evals = [Evaluation() for _ in range(n_out)]

        def eval_batch(features, labels, lmask, metadata=None):
            outs = self.output(*_as_list(features))
            outs = outs if isinstance(outs, list) else [outs]
            labels_l = _as_list(labels)
            if len(labels_l) != n_out:
                raise ValueError(
                    f"evaluate() got {len(labels_l)} label array(s) for a "
                    f"{n_out}-output graph ({self.conf.network_outputs}); "
                    f"pass one per output (None to skip an output)")
            masks_l = _as_list(lmask) if lmask is not None else [None] * n_out
            if len(masks_l) != n_out:
                raise ValueError(
                    f"evaluate() got {len(masks_l)} label mask(s) for a "
                    f"{n_out}-output graph; pass one per output (None for "
                    f"unmasked outputs)")
            for e, o, lab, m in zip(evals, outs, labels_l, masks_l):
                if lab is not None:
                    lab = to_numpy(lab)
                    md = metadata if lab.ndim != 3 else None
                    e.eval(lab, to_numpy(o), mask=to_numpy(m),
                           record_meta_data=md)

        if y is not None:
            eval_batch(iterator_or_x, y, None)
        else:
            for ds in iterator_or_x:
                eval_batch(ds.features, ds.labels, ds.labels_mask,
                           metadata=getattr(ds, "metadata", None))
        return evals[0] if n_out == 1 else evals

    # ---------------------------------------------------------------- misc
    def clone(self) -> "ComputationGraph":
        """A graph of a deep copy of the configuration on the same device,
        with real copies of the parameters and the layer state (the
        vertices are the configuration's modules) and of the updater
        state. As the reference's, the iteration count and the listeners
        are not carried."""
        other = ComputationGraph(copy.deepcopy(self.conf),
                                 device=self.device)
        if self.initialized:
            other.opt_state = copy_state(self.opt_state)
            other.initialized = True
        return other
