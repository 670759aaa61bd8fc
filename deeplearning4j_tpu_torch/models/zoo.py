"""The zoo's shared graph-builder defaults.

Counterpart of ``_base_builder`` in ``deeplearning4j_tpu/models/zoo.py``
(``:27-30``). The zoo models of that module (ResNet-50, VGG, AlexNet,
LeNet, SimpleCNN) need BatchNorm and input preprocessors and come with
ROADMAP A5.
"""
from __future__ import annotations

from ..nn.conf.config import NeuralNetConfiguration
from ..optimize.updaters import Adam


def _base_builder(seed, updater, dtype="float32", **kw):
    """A graph builder with the zoo's defaults: relu weight init, identity
    activation, ``Adam(1e-3)`` unless ``updater`` is given."""
    return NeuralNetConfiguration(seed=seed, updater=updater or Adam(1e-3),
                                  weight_init="relu", activation="identity",
                                  dtype=dtype, **kw).graph_builder()
