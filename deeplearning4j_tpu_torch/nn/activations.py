"""Activation registry.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same 19 names,
each computed as the JAX function the reference registers, with
``register_activation`` and ``activation_names``. ``gelu`` is the tanh
approximation, because the reference registers ``jax.nn.gelu``, whose
default is that approximation (``activations.py:50``); PyTorch's default is
the exact erf form. ``hardsigmoid`` is ``jax.nn.hard_sigmoid``,
relu6(x + 3) / 6, not DL4J's 0.2x + 0.5, and ``selu`` takes JAX's
constants. ``rrelu`` is deterministic, with the mean slope, as the
reference's is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTIVATIONS = {}


def register_activation(name):
    def deco(fn):
        _ACTIVATIONS[name] = fn
        return fn
    return deco


def get_activation(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation {name!r}; available: "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


def activation_names():
    return sorted(_ACTIVATIONS)


# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946

register_activation("identity")(lambda x: x)
register_activation("relu")(torch.relu)
register_activation("relu6")(lambda x: torch.clamp(x, 0.0, 6.0))
register_activation("sigmoid")(torch.sigmoid)
register_activation("tanh")(torch.tanh)
register_activation("softplus")(F.softplus)
register_activation("softsign")(lambda x: x / (1.0 + torch.abs(x)))
register_activation("elu")(F.elu)
register_activation("selu")(
    lambda x: _SELU_SCALE * torch.where(x > 0, x,
                                        _SELU_ALPHA * torch.expm1(x)))
register_activation("gelu")(lambda x: F.gelu(x, approximate="tanh"))
register_activation("swish")(F.silu)
register_activation("cube")(lambda x: x ** 3)
register_activation("hardtanh")(lambda x: torch.clamp(x, -1.0, 1.0))
register_activation("hardsigmoid")(lambda x: torch.clamp(x + 3.0, 0.0,
                                                         6.0) / 6.0)
register_activation("softmax")(lambda x: torch.softmax(x, dim=-1))
register_activation("logsoftmax")(lambda x: torch.log_softmax(x, dim=-1))
register_activation("leakyrelu")(lambda x: F.leaky_relu(x, 0.01))
register_activation("rrelu")(
    lambda x: F.leaky_relu(x, (1.0 / 8.0 + 1.0 / 3.0) / 2.0))


@register_activation("rationaltanh")
def rational_tanh(x):
    """Rational approximation of 1.7159 tanh(2x/3) (reference
    ``activations.py:79-85``)."""
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = 1.0 - 1.0 / (1.0 + a + y * y + 1.41645 * (y ** 4))
    return 1.7159 * torch.sign(y) * approx
