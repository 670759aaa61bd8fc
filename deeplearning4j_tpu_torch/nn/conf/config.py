"""Network-wide defaults, their cascade into layers, and the
``MultiLayerNetwork`` configuration.

Counterpart of ``deeplearning4j_tpu/nn/conf/config.py``:
``NeuralNetConfiguration`` (``:79-142``), the global defaults a builder
fills into every layer field left None (reference
NeuralNetConfiguration.java:604-608), the global updater (``Sgd`` at the
given or default learning rate when none is named), l1/l2, per-parameter
learning rates and gradient normalization; ``ListBuilder`` and
``MultiLayerConfiguration`` (``:27-64``, ``:144-236``): layers in order,
``n_in`` inferred from the input type, the backprop type and the tBPTT
length. JSON serde comes with ROADMAP A2.

Training takes the per-step SGD path only. Other optimization algorithms
and layerwise pretraining (ROADMAP A5), gradient checkpointing and mixed
precision (``compute_dtype``, ROADMAP A10) raise ``NotImplementedError``.
No input preprocessor is ported yet (A5), so ``preprocessor(i)`` is None
for every layer; ``_infer_n_in`` (``:231-236``) gives a CNN layer its
input channels.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...optimize.updaters import Sgd, updater_from_name
from ..inputs import (InputTypeConvolutional, InputTypeFeedForward,
                      check_input_family)

_CASCADED = ("activation", "weight_init", "distribution", "bias_init", "l1",
             "l2", "dropout", "bias_learning_rate")


def _infer_n_in(layer, itype) -> int:
    """A layer's ``n_in`` from its input type: the channels for a CNN
    layer on convolutional input, else the flat feature width."""
    from ..layers.base import resolve_ff_size
    if layer.expected_input == "cnn" and \
            isinstance(itype, InputTypeConvolutional):
        return itype.channels
    return resolve_ff_size(itype)


class NeuralNetConfiguration:
    def __init__(self, seed: int = 12345, activation: str = "sigmoid",
                 weight_init: str = "xavier", bias_init: float = 0.0,
                 distribution=None, l1: float = 0.0, l2: float = 0.0,
                 dropout: float = 0.0, updater=None,
                 learning_rate: Optional[float] = None,
                 bias_learning_rate: Optional[float] = None,
                 gradient_normalization: Optional[str] = None,
                 gradient_normalization_threshold: float = 1.0,
                 dtype: str = "float32", optimization_algorithm: str = "sgd",
                 max_num_line_search_iterations: int = 5,
                 gradient_checkpointing: bool = False,
                 compute_dtype: Optional[str] = None, **workspace_noops):
        if optimization_algorithm.lower() not in (
                "sgd", "stochastic_gradient_descent"):
            raise NotImplementedError(
                f"optimization_algorithm {optimization_algorithm!r}: the "
                f"second-order solvers are not ported yet (ROADMAP A5); "
                f"only 'sgd' trains")
        if gradient_checkpointing:
            raise NotImplementedError("gradient checkpointing is not ported "
                                      "yet (ROADMAP A10)")
        if compute_dtype is not None:
            raise NotImplementedError("mixed precision (compute_dtype) is "
                                      "not ported yet (ROADMAP A10)")
        if updater is None:
            updater = Sgd(learning_rate=learning_rate
                          if learning_rate is not None else 0.1)
        elif isinstance(updater, str):
            updater = updater_from_name(updater, learning_rate or 0.1)
        elif learning_rate is not None and \
                updater.learning_rate != learning_rate:
            updater = dataclasses.replace(updater,
                                          learning_rate=learning_rate)
        self.seed = seed
        self.activation = activation
        self.weight_init = weight_init
        self.bias_init = bias_init
        self.distribution = distribution
        self.l1 = l1
        self.l2 = l2
        self.dropout = dropout
        self.updater = updater
        self.bias_learning_rate = bias_learning_rate
        self.gradient_normalization = gradient_normalization
        self.gradient_normalization_threshold = \
            gradient_normalization_threshold
        self.dtype = dtype
        # read by the second-order solvers (ROADMAP A5); the workspace and
        # cache-mode keywords are accepted and ignored, as the reference's
        self.max_num_line_search_iterations = max_num_line_search_iterations

    def _cascade(self, layer):
        """A copy of ``layer`` with its None fields set from the globals
        (the caller's layer object is left untouched)."""
        layer = copy.deepcopy(layer)
        for name in _CASCADED:
            if getattr(layer, name) is None:
                setattr(layer, name, getattr(self, name))
        return layer

    def list(self, *layers) -> "ListBuilder":
        return ListBuilder(self, list(layers))

    def graph_builder(self):
        from .graph_conf import GraphBuilder
        return GraphBuilder(self)


@dataclass
class MultiLayerConfiguration:
    layers: List[Any] = field(default_factory=list)
    input_preprocessors: Dict[str, Any] = field(default_factory=dict)
    input_type: Optional[Any] = None
    seed: int = 12345
    dtype: str = "float32"
    backprop_type: str = "standard"       # "standard" | "tbptt"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    updater: Optional[Any] = None
    max_num_line_search_iterations: int = 5

    def preprocessor(self, idx: int):
        return self.input_preprocessors.get(str(idx))


class ListBuilder:
    def __init__(self, nn_conf: NeuralNetConfiguration, layers: List[Any]):
        self.nn_conf = nn_conf
        self.layers = layers
        self._input_type = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20

    def layer(self, layer_or_idx, maybe_layer=None) -> "ListBuilder":
        self.layers.append(maybe_layer if maybe_layer is not None
                           else layer_or_idx)
        return self

    def set_input_type(self, itype) -> "ListBuilder":
        self._input_type = itype
        return self

    def backprop_type(self, bp: str) -> "ListBuilder":
        self._backprop_type = bp
        return self

    def tbptt_length(self, fwd: int, bwd: Optional[int] = None
                     ) -> "ListBuilder":
        """Truncated BPTT in chunks of ``fwd`` steps. Each chunk's step
        backpropagates through the whole chunk, so bwd != fwd is refused,
        as the reference refuses it."""
        self._backprop_type = "tbptt"
        if bwd is not None and bwd != fwd:
            raise ValueError(
                "tbptt bwd length must equal fwd length: the chunk step "
                "computes exact gradients over the full chunk")
        self._tbptt_fwd = fwd
        self._tbptt_bwd = fwd
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        if flag:
            raise NotImplementedError("layerwise pretraining is not ported "
                                      "yet (ROADMAP A5)")
        return self

    def build(self) -> MultiLayerConfiguration:
        nc = self.nn_conf
        itype = self._input_type
        if itype is None:
            n_in = getattr(self.layers[0], "n_in", None)
            if n_in:
                itype = InputTypeFeedForward(n_in)
                self._input_type = itype
        resolved = []
        for layer in self.layers:
            layer = nc._cascade(layer)
            if itype is not None:
                check_input_family(itype, layer.expected_input)
                if getattr(layer, "n_in", "absent") is None:
                    layer.n_in = _infer_n_in(layer, itype)
                itype = layer.output_type(itype)
            resolved.append(layer)
        return MultiLayerConfiguration(
            layers=resolved, input_type=self._input_type, seed=nc.seed,
            dtype=nc.dtype, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            gradient_normalization=nc.gradient_normalization,
            gradient_normalization_threshold=(
                nc.gradient_normalization_threshold),
            updater=nc.updater,
            max_num_line_search_iterations=nc.max_num_line_search_iterations)
