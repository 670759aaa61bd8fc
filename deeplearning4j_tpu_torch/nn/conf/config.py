"""Network-wide defaults, their cascade into layers, and the
``MultiLayerNetwork`` configuration.

Counterpart of ``deeplearning4j_tpu/nn/conf/config.py``:
``NeuralNetConfiguration`` (``:79-142``), the global defaults a builder
fills into every layer field left None (reference
NeuralNetConfiguration.java:604-608), the global updater (``Sgd`` at the
given or default learning rate when none is named), l1/l2, per-parameter
learning rates and gradient normalization; ``ListBuilder`` and
``MultiLayerConfiguration`` (``:27-64``, ``:144-236``): layers in order,
``n_in`` inferred from the input type, the input preprocessors the
reference inserts where a layer family changes (keyed by layer index as a
string), the backprop type and the tBPTT length, and JSON serde
(``to_json`` / ``from_json``, ``nn/conf/serde.py``) with the reference's
field names.

Gradient checkpointing (each layer's forward recomputed in the backward)
and mixed precision (``compute_dtype``: master parameters and updater
state in ``dtype``, the forward and backward in ``compute_dtype``) are the
reference's (``:44-53, 112-121``) and reach the network through both
configurations, and so do ``optimization_algorithm`` (the second-order
solvers, ``optimize/second_order.py``) with
``max_num_line_search_iterations``, and the ``pretrain`` flag.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...device import torch_dtype
from ...optimize.updaters import Sgd, updater_from_name
from ..inputs import InputTypeConvolutional, InputTypeFeedForward
from ..preprocessors import auto_preprocessor
from . import serde

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
        if compute_dtype is not None:
            try:
                torch_dtype(compute_dtype)
            except ValueError as e:
                raise ValueError(
                    f"Unknown compute_dtype {compute_dtype!r} (expected a "
                    f"dtype name like 'bfloat16' or 'float32')") from e
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
        self.optimization_algorithm = optimization_algorithm.lower()
        # read by the second-order solvers; the workspace and cache-mode
        # keywords are accepted and ignored, as the reference's
        self.max_num_line_search_iterations = max_num_line_search_iterations
        self.gradient_checkpointing = gradient_checkpointing
        self.compute_dtype = compute_dtype

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


@serde.register
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
    pretrain: bool = False                # carried, as the reference's
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    updater: Optional[Any] = None
    # or "line_gradient_descent", "conjugate_gradient", "lbfgs"
    optimization_algorithm: str = "sgd"
    max_num_line_search_iterations: int = 5
    # recompute each layer's forward in the backward instead of keeping
    # its activations (memory for compute)
    gradient_checkpointing: bool = False
    # mixed precision: master parameters and updater state stay ``dtype``;
    # the forward and backward run in this dtype (e.g. "bfloat16")
    compute_dtype: Optional[str] = None

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return serde.from_json(s)

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
        self._pretrain = False

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
        """The configuration's ``pretrain`` flag, carried as the
        reference carries it (``net.pretrain`` runs the pretraining)."""
        self._pretrain = flag
        return self

    def build(self) -> MultiLayerConfiguration:
        nc = self.nn_conf
        itype = self._input_type
        if itype is None:
            n_in = getattr(self.layers[0], "n_in", None)
            if n_in:
                itype = InputTypeFeedForward(n_in)
                self._input_type = itype
        resolved, preprocs = [], {}
        for i, layer in enumerate(self.layers):
            layer = nc._cascade(layer)
            if itype is not None:
                pre, itype = auto_preprocessor(itype, layer.expected_input)
                if pre is not None:
                    preprocs[str(i)] = pre
                if getattr(layer, "n_in", "absent") is None:
                    layer.n_in = _infer_n_in(layer, itype)
                itype = layer.output_type(itype)
            resolved.append(layer)
        return MultiLayerConfiguration(
            layers=resolved, input_preprocessors=preprocs,
            input_type=self._input_type, seed=nc.seed,
            dtype=nc.dtype, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd, pretrain=self._pretrain,
            gradient_normalization=nc.gradient_normalization,
            gradient_normalization_threshold=(
                nc.gradient_normalization_threshold),
            updater=nc.updater,
            optimization_algorithm=nc.optimization_algorithm,
            max_num_line_search_iterations=nc.max_num_line_search_iterations,
            gradient_checkpointing=nc.gradient_checkpointing,
            compute_dtype=nc.compute_dtype)
