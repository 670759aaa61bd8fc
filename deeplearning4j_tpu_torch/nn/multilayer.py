"""MultiLayerNetwork: the sequential-stack executor.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (``:43-393``):
``init``, the forward ``apply_fn`` with its feature-mask flow and the
recurrent-state carry (``rnn_states`` / ``collect_rnn_states``,
``:80-163``), ``loss_fn`` with the chunk carry (``:165-222``), ``output``,
``feed_forward``, ``score``, the streaming ``rnn_time_step`` and
``rnn_clear_previous_state`` (``:263-284``), ``params_flat`` /
``set_params_flat`` / ``num_params`` in the layers' ``param_order``,
``fit`` (``:332-353``; truncated BPTT when the configuration asks for it)
with ``set_listeners``, ``pretrain`` (``:359``), ``evaluate``
(``:364-380``) and ``clone`` (``:383-393``). A layer's input
preprocessor (``conf.preprocessor(i)``) runs before it, in the forward and
in the loss, as the reference's walk runs it.

Mixed precision and gradient checkpointing (``:100-147``) are read from
the configuration at every forward, so a caller may set
``conf.compute_dtype`` on a built network, as a JSON configuration
carries it. Under ``compute_dtype`` (``cast_floats``, ``run_layer``) each
layer reads its parameters as casts to the compute dtype, inputs and
carried recurrent states are cast down, and activations, final recurrent
states and the per-example loss come back in the master dtype, so the
gradients reach the master parameters in their own dtype through the
casts' backward. With ``gradient_checkpointing`` each layer without a
state carry runs under ``torch.utils.checkpoint`` and its dropout masks
are replayed in the recompute.

The network is an ``nn.Module`` on one device, given at construction
(default: the CUDA card); its layers live in ``self.layers`` and their
parameters are the modules' own, so ``loss_fn`` takes none: gradients come
from ``torch.autograd``. Parameters, layer state (``state_dicts``: a
BatchNormalization's running statistics, which a training step moves
once, ``nn/tape.py`` ``record_state``), updater state and gradients
are keyed by layer index. Model zips are ``util/serialization.py``.
"""
from __future__ import annotations

import contextlib
import copy
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device, torch_dtype
from ..optimize.solver import check_listeners
from ..optimize.updaters import MultiLayerUpdater
from .conf.config import MultiLayerConfiguration
from .tape import dropout_masks


def cast_floats(tree, dtype):
    """Cast every floating tensor of a nest of lists, tuples and dicts to
    ``dtype`` (the mixed-precision boundary; integer tensors, token ids,
    and None pass through)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree


def compute_dtype_of(conf) -> Optional[torch.dtype]:
    """The configuration's compute dtype, or None without mixed
    precision."""
    cd = getattr(conf, "compute_dtype", None)
    return torch_dtype(cd) if cd else None


@contextlib.contextmanager
def params_as(module: nn.Module, dtype: Optional[torch.dtype]):
    """Within the block, every floating parameter of ``module`` (and its
    children) reads as its cast to ``dtype``, a differentiable copy;
    nothing changes when ``dtype`` is None."""
    swaps = [] if dtype is None else [
        (m, n, p) for m in module.modules()
        for n, p in m._parameters.items()
        if p is not None and p.is_floating_point() and p.dtype != dtype]
    for m, n, p in swaps:
        m._parameters[n] = p.to(dtype)
    try:
        yield
    finally:
        for m, n, p in swaps:
            m._parameters[n] = p


def run_layer(layer: nn.Module, call, inputs, *,
              compute_dtype: Optional[torch.dtype] = None,
              remat: bool = False):
    """``call(*inputs)``, a call of ``layer``, under the network's policy:
    the layer's parameters cast to ``compute_dtype`` (``params_as``) and,
    with ``remat``, under ``torch.utils.checkpoint`` (non-reentrant, no
    global generator state kept: the layers draw from an explicit one), so
    its activations are recomputed in the backward instead of kept. The
    first forward's dropout masks are kept and replayed in the recompute
    (``nn/tape.py`` ``dropout_masks``), so the recompute computes what the
    forward did."""
    def body(*xs):
        with params_as(layer, compute_dtype):
            return call(*xs)
    if not remat:
        return body(*inputs)
    masks, runs = [], [0]

    def recomputable(*xs):
        replay = runs[0] > 0
        runs[0] += 1
        with dropout_masks(masks, replay):
            return body(*xs)
    return checkpoint(recomputable, *inputs, use_reentrant=False,
                      preserve_rng_state=False)


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf: MultiLayerConfiguration, *,
                 device: DeviceLike = None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = torch_dtype(conf.dtype)
        self.layers = nn.ModuleList(conf.layers)
        self.updater = MultiLayerUpdater(
            dict(enumerate(self.layers)), conf.updater,
            conf.gradient_normalization,
            conf.gradient_normalization_threshold)
        self.opt_state = None
        self.iteration_count = 0
        self.listeners: List = []
        self.initialized = False
        self._rnn_state: Optional[list] = None

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Create every layer's parameters on the network's device, drawing
        from one CPU ``torch.Generator`` seeded with ``seed`` (default: the
        configuration's seed), layer by layer, and the updater's state."""
        gen = torch.Generator().manual_seed(
            self.conf.seed if seed is None else int(seed))
        itype = self.conf.input_type
        for i, layer in enumerate(self.layers):
            pre = self.conf.preprocessor(i)
            if pre is not None and itype is not None:
                itype = pre.output_type(itype)
            layer.init_params(itype, self.dtype, self.device, gen)
            if itype is not None:
                itype = layer.output_type(itype)
        self.opt_state = self.updater.init(self.param_dicts())
        self.initialized = True
        return self

    def param_dicts(self):
        """Every layer's parameters by reference name, keyed by index."""
        return {i: layer.param_dict() for i, layer in enumerate(self.layers)}

    def state_dicts(self):
        """Every layer's non-parameter state by reference name (a
        BatchNormalization's ``mean`` and ``var``; empty for most), keyed
        by index: the reference's ``net.state``."""
        return {i: layer.layer_state() for i, layer in enumerate(self.layers)}

    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def _ordered_params(self):
        for layer in self.layers:
            own = layer.param_dict()
            for name in getattr(layer, "param_order", tuple(own)):
                if name in own:
                    yield own[name]

    def params_flat(self) -> torch.Tensor:
        """All parameters as one 1-D vector, each layer's in its
        ``param_order`` (reference flattenedParams)."""
        from ..parallel.tensor_parallel import full, specs_by_id
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
        from ..parallel.tensor_parallel import (global_shape, place_like,
                                                 specs_by_id)
        specs = specs_by_id(self)         # a model axis' rows take their cut
        for p in self._ordered_params():
            n = p.numel()
            v = flat[off:off + n].reshape(global_shape(p, specs[id(p)]))
            p.copy_(place_like(v.to(p.dtype), p))
            off += n

    # --------------------------------------------------------------- forward
    def _forward(self, x, *, train: bool = False,
                 gen: Optional[torch.Generator] = None,
                 to_layer: Optional[int] = None, features_mask=None,
                 rnn_states=None, collect_rnn_states: bool = False):
        """The forward in the compute dtype (see ``apply_fn``): the layer
        outputs and each recurrent layer's final (h, c), None for the
        others."""
        if not self.initialized:
            raise RuntimeError("call init() before running the network")
        n = len(self.layers) if to_layer is None else to_layer + 1
        cd = compute_dtype_of(self.conf)
        remat = getattr(self.conf, "gradient_checkpointing", False)
        if cd is not None:
            x = cast_floats(x, cd)
            rnn_states = cast_floats(rnn_states, cd)
        acts, rnn_out = [], [None] * len(self.layers)
        cur_mask = features_mask
        if features_mask is not None:
            m = features_mask.to(x.dtype)
            x = x * m.reshape(tuple(m.shape) + (1,) * (x.dim() - m.dim()))
        for i in range(n):
            pre = self.conf.preprocessor(i)
            if pre is not None:
                x = pre.apply(x)
            layer = self.layers[i]
            kw = {}
            if getattr(layer, "accepts_mask", False) and cur_mask is not None \
                    and cur_mask.dim() == 2 and x.dim() == 3:
                kw["mask"] = cur_mask
            init = rnn_states[i] if rnn_states is not None else None
            if hasattr(layer, "apply_with_final_state") and \
                    (collect_rnn_states or init is not None):
                x, rnn_out[i] = run_layer(
                    layer, lambda xx, _l=layer, _kw=kw, _init=init:
                    _l.apply_with_final_state(xx, train=train, gen=gen,
                                              initial_state=_init, **_kw),
                    (x,), compute_dtype=cd)
            else:
                x = run_layer(layer, lambda xx, _l=layer, _kw=kw:
                              _l(xx, train=train, gen=gen, **_kw),
                              (x,), compute_dtype=cd, remat=remat)
            acts.append(x)
            if x.dim() < 3:
                cur_mask = None           # the time axis collapsed
        return acts, rnn_out

    def apply_fn(self, x, *, train: bool = False,
                 gen: Optional[torch.Generator] = None,
                 to_layer: Optional[int] = None, features_mask=None,
                 rnn_states=None, collect_rnn_states: bool = False):
        """Forward through layers 0..``to_layer`` (default: all). Returns
        the list of layer outputs, and with ``collect_rnn_states`` also
        each recurrent layer's final (h, c) (None for other layers). A
        recurrent layer starts from ``rnn_states[i]`` when given. A [B,T]
        feature mask multiplies the input and reaches mask-aware layers
        until the time axis collapses. Under a compute dtype the outputs
        and final states come back in the master dtype."""
        acts, rnn_out = self._forward(
            x, train=train, gen=gen, to_layer=to_layer,
            features_mask=features_mask, rnn_states=rnn_states,
            collect_rnn_states=collect_rnn_states)
        if compute_dtype_of(self.conf) is not None:
            acts = cast_floats(acts, self.dtype)
            rnn_out = cast_floats(rnn_out, self.dtype)
        return (acts, rnn_out) if collect_rnn_states else acts

    def loss_fn(self, x, labels, *, train: bool = True,
                gen: Optional[torch.Generator] = None, labels_mask=None,
                features_mask=None, rnn_states=None,
                collect_rnn_states: bool = False):
        """Mean per-example loss (or the sum over a [B,T] labels mask's
        active steps) plus regularization on the master parameters. With
        ``collect_rnn_states`` it returns (loss, final recurrent states in
        the master dtype): the tBPTT chunk carry. Under a compute dtype the
        head runs in it and the per-example loss is reduced in the master
        dtype."""
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "compute_loss_per_example"):
            raise ValueError("Last layer must be an output layer to compute "
                             "loss")
        cd = compute_dtype_of(self.conf)
        rnn_out = [None] * len(self.layers)
        if len(self.layers) > 1:
            acts, rnn_out = self._forward(
                x, train=train, gen=gen, to_layer=len(self.layers) - 2,
                features_mask=features_mask, rnn_states=rnn_states,
                collect_rnn_states=collect_rnn_states)
            feed = acts[-1]
        else:
            feed = x if cd is None else cast_floats(x, cd)
            if features_mask is not None:
                m = features_mask.to(feed.dtype)
                feed = feed * m.reshape(tuple(m.shape)
                                        + (1,) * (feed.dim() - m.dim()))
        pre = self.conf.preprocessor(len(self.layers) - 1)
        if pre is not None:
            feed = pre.apply(feed)
        per_ex = run_layer(
            out_layer, lambda f: out_layer.compute_loss_per_example(
                f, labels, labels_mask, train=train, gen=gen),
            (feed,), compute_dtype=cd)
        if cd is not None:
            per_ex = per_ex.to(self.dtype)          # reduced at master dtype
            rnn_out = cast_floats(rnn_out, self.dtype)
        if labels_mask is not None and per_ex.dim() == 1 and \
                labels_mask.dim() >= 2:
            score = per_ex.sum() / torch.clamp(labels_mask.sum(), min=1.0)
        else:
            score = per_ex.mean()
        for layer in self.layers:
            score = score + layer.regularization()
        return (score, rnn_out) if collect_rnn_states else score

    # ------------------------------------------------------------- inference
    def _as_input(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, device=self.device)
        return t if not t.is_floating_point() else t.to(self.dtype)

    def _output_pure(self, x, *, train: bool = False):
        """The last layer's activations for an input tensor: the
        reference's ``_output_pure``, which
        ``serving.programs.default_forward`` calls."""
        return self.apply_fn(x, train=train)[-1]

    @torch.inference_mode()
    def output(self, x, train: bool = False):
        """The last layer's activations for a numpy array or tensor."""
        return self._output_pure(self._as_input(x), train=train)

    @torch.inference_mode()
    def feed_forward(self, x, train: bool = False):
        """[input] + every layer's output (reference feedForward)."""
        x = self._as_input(x)
        return [x] + self.apply_fn(x, train=train)

    @torch.no_grad()
    def score(self, x=None, y=None, dataset=None) -> float:
        lm = fm = None
        if dataset is not None:
            x, y = dataset.features, dataset.labels
            lm = None if dataset.labels_mask is None \
                else self._as_input(dataset.labels_mask)
            fm = None if dataset.features_mask is None \
                else self._as_input(dataset.features_mask)
        return float(self.loss_fn(self._as_input(x), self._as_input(y),
                                  train=False, labels_mask=lm,
                                  features_mask=fm))

    # ------------------------------------------------------------- streaming
    @torch.inference_mode()
    def rnn_time_step(self, x):
        """Stateful streaming inference (reference rnnTimeStep): feed [B,F]
        one step (or [B,T,F] a chunk); the recurrent state carries between
        calls until ``rnn_clear_previous_state``."""
        x = self._as_input(x).to(self.dtype)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        acts, self._rnn_state = self.apply_fn(
            x, rnn_states=self._rnn_state, collect_rnn_states=True)
        out = acts[-1]
        return out[:, -1] if (single and out.dim() == 3) else out

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    # ----------------------------------------------------------------- train
    def set_listeners(self, *listeners) -> "MultiLayerNetwork":
        """Training listeners, as ``ComputationGraph.set_listeners``."""
        self.listeners = check_listeners(listeners)
        return self

    def fit(self, data=None, labels=None, *, epochs: int = 1,
            batch_size: Optional[int] = None, iterator=None, dataset=None,
            async_prefetch: bool = True, prefetch_depth: int = 2,
            steps_per_dispatch: int = 1,
            skip_first_batches: int = 0) -> "MultiLayerNetwork":
        """Train with ``optimize.solver.Solver``, in tBPTT chunks when the
        configuration's backprop type is ``"tbptt"``. ``async_prefetch`` /
        ``prefetch_depth``: iterator feeds run through a
        ``DevicePrefetchIterator`` (batch N+1 is staged and copied to the
        device while step N computes). ``steps_per_dispatch=K``: windows of
        K same-shape batches run as one program (a CUDA graph of the step
        replayed K times on the card), equal to K single steps; tBPTT and
        ragged windows run per step. ``skip_first_batches=S``: the first S
        batches of the first epoch are consumed, not trained (the
        mid-epoch resume)."""
        if not hasattr(self, "_solver_inst"):
            from ..optimize.solver import Solver
            self._solver_inst = Solver(self)
        self._solver_inst.fit(data=data, labels=labels, epochs=epochs,
                              batch_size=batch_size, iterator=iterator,
                              dataset=dataset, async_prefetch=async_prefetch,
                              prefetch_depth=prefetch_depth,
                              steps_per_dispatch=steps_per_dispatch,
                              skip_first_batches=skip_first_batches)
        return self

    def pretrain(self, iterator, epochs: int = 1) -> "MultiLayerNetwork":
        """Layerwise unsupervised pretraining of every layer with a
        ``pretrain_loss`` (``optimize.solver.Solver.pretrain``)."""
        if not hasattr(self, "_solver_inst"):
            from ..optimize.solver import Solver
            self._solver_inst = Solver(self)
        self._solver_inst.pretrain(iterator, epochs=epochs)
        return self

    def evaluate(self, iterator_or_x, y=None):
        """Classification evaluation (``eval.Evaluation``) of the eval
        forward: on features and labels, or on an iterator of
        ``DataSet``s, whose labels masks and per-example ``metadata`` (the
        prediction-record workflow; not for [B,T,C] labels, which flatten
        to N·T rows) reach ``Evaluation.eval``."""
        from ..eval.evaluation import Evaluation
        e = Evaluation()
        if y is not None:
            e.eval(to_numpy(y), to_numpy(self.output(iterator_or_x)))
            return e
        for ds in iterator_or_x:
            out = to_numpy(self.output(ds.features))
            labels = to_numpy(ds.labels)
            md = (getattr(ds, "metadata", None) if labels.ndim != 3
                  else None)
            e.eval(labels, out, mask=to_numpy(ds.labels_mask),
                   record_meta_data=md)
        return e

    def clone(self) -> "MultiLayerNetwork":
        """A network of a deep copy of the configuration on the same
        device, with real copies of the parameters, the layer state and
        the updater state (the layers are the configuration's modules, so
        copying it copies them). As the reference's, the iteration count
        and the listeners are not carried."""
        other = MultiLayerNetwork(copy.deepcopy(self.conf),
                                  device=self.device)
        if self.initialized:
            other.opt_state = copy_state(self.opt_state)
            other.initialized = True
        return other


def to_numpy(v):
    """A tensor (any device; bf16 widened to float32), array or None as a
    numpy array or None: what the numpy-only ``eval`` classes take."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def copy_state(state):
    """A real copy of a nest of dicts of tensors (the updater state)."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    return {k: copy_state(v) for k, v in state.items()}
