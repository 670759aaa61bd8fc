"""Activation registry.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``, with the
activations the transformer LM and the losses' fused forms use (relu,
sigmoid and tanh come with the losses). ``gelu`` is the tanh approximation,
because the reference registers ``jax.nn.gelu``, whose default is that
approximation (``activations.py:50``); PyTorch's default is the exact erf
form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get_activation(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation {name!r}; available: "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]
