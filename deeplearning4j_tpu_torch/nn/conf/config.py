"""Network-wide defaults and their cascade into layers.

Counterpart of ``NeuralNetConfiguration`` in
``deeplearning4j_tpu/nn/conf/config.py``: the global defaults a graph
builder fills into every layer field left None (reference
NeuralNetConfiguration.java:604-608). The port carries the fields the
inference path reads; regularization, updater rules and JSON serde come
with the training slice (``updater`` is held as given).
"""
from __future__ import annotations

import copy
from typing import Any, Optional


class NeuralNetConfiguration:
    def __init__(self, seed: int = 12345, activation: str = "sigmoid",
                 weight_init: str = "xavier", bias_init: float = 0.0,
                 distribution=None, dropout: float = 0.0,
                 updater: Optional[Any] = None, dtype: str = "float32"):
        self.seed = seed
        self.activation = activation
        self.weight_init = weight_init
        self.bias_init = bias_init
        self.distribution = distribution
        self.dropout = dropout
        self.updater = updater
        self.dtype = dtype

    def _cascade(self, layer):
        """A copy of ``layer`` with its None fields set from the globals
        (the caller's layer object is left untouched)."""
        layer = copy.deepcopy(layer)
        for field in ("activation", "weight_init", "distribution",
                      "bias_init", "dropout"):
            if getattr(layer, field) is None:
                setattr(layer, field, getattr(self, field))
        return layer

    def graph_builder(self):
        from .graph_conf import GraphBuilder
        return GraphBuilder(self)
