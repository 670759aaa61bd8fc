"""MultiLayerNetwork: the sequential-stack executor.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (``:43-322``):
``init``, the forward ``apply_fn`` with its feature-mask flow and the
recurrent-state carry (``rnn_states`` / ``collect_rnn_states``,
``:80-163``), ``loss_fn`` with the chunk carry (``:165-222``), ``output``,
``feed_forward``, ``score``, the streaming ``rnn_time_step`` and
``rnn_clear_previous_state`` (``:263-284``), ``params_flat`` /
``set_params_flat`` / ``num_params`` in the layers' ``param_order``, and
``fit`` (truncated BPTT when the configuration asks for it) with
``set_listeners``.

The network is an ``nn.Module`` on one device, given at construction
(default: the CUDA card); its layers live in ``self.layers`` and their
parameters are the modules' own, so ``loss_fn`` takes none: gradients come
from ``torch.autograd``. Parameters, updater state and gradients are keyed
by layer index. ``evaluate`` and ``pretrain`` (ROADMAP A5), ``clone`` and
checkpointing (A10) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device, torch_dtype
from ..optimize.solver import score_listeners
from ..optimize.updaters import MultiLayerUpdater
from .conf.config import MultiLayerConfiguration


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
        for layer in self.layers:
            layer.init_params(itype, self.dtype, self.device, gen)
            if itype is not None:
                itype = layer.output_type(itype)
        self.opt_state = self.updater.init(self.param_dicts())
        self.initialized = True
        return self

    def param_dicts(self):
        """Every layer's parameters by reference name, keyed by index."""
        return {i: layer.param_dict() for i, layer in enumerate(self.layers)}

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

    # --------------------------------------------------------------- forward
    def apply_fn(self, x, *, train: bool = False,
                 gen: Optional[torch.Generator] = None,
                 to_layer: Optional[int] = None, features_mask=None,
                 rnn_states=None, collect_rnn_states: bool = False):
        """Forward through layers 0..``to_layer`` (default: all). Returns
        the list of layer outputs, and with ``collect_rnn_states`` also
        each recurrent layer's final (h, c) (None for other layers). A
        recurrent layer starts from ``rnn_states[i]`` when given. A [B,T]
        feature mask multiplies the input and reaches mask-aware layers
        until the time axis collapses."""
        if not self.initialized:
            raise RuntimeError("call init() before running the network")
        n = len(self.layers) if to_layer is None else to_layer + 1
        acts, rnn_out = [], [None] * len(self.layers)
        cur_mask = features_mask
        if features_mask is not None:
            m = features_mask.to(x.dtype)
            x = x * m.reshape(tuple(m.shape) + (1,) * (x.dim() - m.dim()))
        for i in range(n):
            layer = self.layers[i]
            kwargs = {}
            if getattr(layer, "accepts_mask", False) and cur_mask is not None \
                    and cur_mask.dim() == 2 and x.dim() == 3:
                kwargs["mask"] = cur_mask
            init = rnn_states[i] if rnn_states is not None else None
            if hasattr(layer, "apply_with_final_state") and \
                    (collect_rnn_states or init is not None):
                x, rnn_out[i] = layer.apply_with_final_state(
                    x, train=train, gen=gen, initial_state=init, **kwargs)
            else:
                x = layer(x, train=train, gen=gen, **kwargs)
            acts.append(x)
            if x.dim() < 3:
                cur_mask = None           # the time axis collapsed
        return (acts, rnn_out) if collect_rnn_states else acts

    def loss_fn(self, x, labels, *, train: bool = True,
                gen: Optional[torch.Generator] = None, labels_mask=None,
                features_mask=None, rnn_states=None,
                collect_rnn_states: bool = False):
        """Mean per-example loss (or the sum over a [B,T] labels mask's
        active steps) plus regularization. With ``collect_rnn_states`` it
        returns (loss, final recurrent states): the tBPTT chunk carry."""
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "compute_loss_per_example"):
            raise ValueError("Last layer must be an output layer to compute "
                             "loss")
        rnn_out = [None] * len(self.layers)
        if len(self.layers) > 1:
            res = self.apply_fn(x, train=train, gen=gen,
                                to_layer=len(self.layers) - 2,
                                features_mask=features_mask,
                                rnn_states=rnn_states,
                                collect_rnn_states=collect_rnn_states)
            acts, rnn_out = res if collect_rnn_states else (res, rnn_out)
            feed = acts[-1]
        else:
            feed = x
            if features_mask is not None:
                m = features_mask.to(x.dtype)
                feed = feed * m.reshape(tuple(m.shape)
                                        + (1,) * (feed.dim() - m.dim()))
        per_ex = out_layer.compute_loss_per_example(feed, labels, labels_mask,
                                                    train=train, gen=gen)
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
        """Score callbacks, as ``ComputationGraph.set_listeners``."""
        self.listeners = score_listeners(listeners)
        return self

    def fit(self, data=None, labels=None, *, epochs: int = 1,
            batch_size: Optional[int] = None, iterator=None, dataset=None,
            async_prefetch: bool = False,
            steps_per_dispatch: int = 1) -> "MultiLayerNetwork":
        """Train with the per-step SGD path of ``optimize.solver.Solver``,
        in tBPTT chunks when the configuration's backprop type is
        ``"tbptt"``. Device prefetch and fused multi-step windows are not
        ported yet (ROADMAP A10)."""
        if not hasattr(self, "_solver_inst"):
            from ..optimize.solver import Solver
            self._solver_inst = Solver(self)
        self._solver_inst.fit(data=data, labels=labels, epochs=epochs,
                              batch_size=batch_size, iterator=iterator,
                              dataset=dataset, async_prefetch=async_prefetch,
                              steps_per_dispatch=steps_per_dispatch)
        return self

    def pretrain(self, iterator, epochs: int = 1):
        raise NotImplementedError("layerwise pretraining is not ported yet "
                                  "(ROADMAP A5)")

    def evaluate(self, iterator_or_x, y=None):
        raise NotImplementedError("evaluation (eval/Evaluation) is not "
                                  "ported yet (ROADMAP A5)")

    def clone(self):
        raise NotImplementedError("clone, checkpointing and model zips are "
                                  "not ported yet (ROADMAP A10)")
