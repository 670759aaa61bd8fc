"""Network-wide defaults and their cascade into layers.

Counterpart of ``NeuralNetConfiguration`` in
``deeplearning4j_tpu/nn/conf/config.py`` (``:79-142``): the global
defaults a graph builder fills into every layer field left None (reference
NeuralNetConfiguration.java:604-608), the global updater (``Sgd`` at the
given or default learning rate when none is named), l1/l2, per-parameter
learning rates and gradient normalization. JSON serde comes with a later
slice.

This slice trains with the per-step SGD path only. Other optimization
algorithms (ROADMAP A5), gradient checkpointing and mixed precision
(``compute_dtype``, ROADMAP A10) raise ``NotImplementedError``, as does
``list`` (``MultiLayerNetwork``, ROADMAP A10).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

from ...optimize.updaters import Sgd, updater_from_name

_CASCADED = ("activation", "weight_init", "distribution", "bias_init", "l1",
             "l2", "dropout", "bias_learning_rate")


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
                 gradient_checkpointing: bool = False,
                 compute_dtype: Optional[str] = None):
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

    def _cascade(self, layer):
        """A copy of ``layer`` with its None fields set from the globals
        (the caller's layer object is left untouched)."""
        layer = copy.deepcopy(layer)
        for name in _CASCADED:
            if getattr(layer, name) is None:
                setattr(layer, name, getattr(self, name))
        return layer

    def list(self, *layers):
        raise NotImplementedError("MultiLayerNetwork is not ported yet "
                                  "(ROADMAP A10); build a graph with "
                                  "graph_builder()")

    def graph_builder(self):
        from .graph_conf import GraphBuilder
        return GraphBuilder(self)
