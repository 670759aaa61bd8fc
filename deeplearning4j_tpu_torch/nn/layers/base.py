"""Layer base: a configurable ``nn.Module`` whose parameters are made at init.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py`` (``LayerConf``). In
the reference a layer is a config dataclass with pure ``init``/``apply``
over a parameter pytree; here it is an ``nn.Module`` that holds its
hyperparameters from construction and its parameters from
``init_params`` on, under the reference's names and layouts (Dense ``W`` is
[n_in, n_out], applied as ``x @ W``), so carrying weights across is a copy.

Fields left None inherit the network-wide default when the configuration
is built (``NeuralNetConfiguration._cascade``). Dropout is held as
configuration; the port so far runs inference only, where dropout is the
identity.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..activations import get_activation
from ..inputs import InputTypeFeedForward, InputTypeRecurrent
from ..weights import init_weights


class LayerConf(nn.Module):
    expected_input: str = "ff"      # the input family: "ff", "rnn" or "any"

    def __init__(self, *, activation: Optional[str] = None,
                 weight_init: Optional[str] = None, distribution=None,
                 bias_init: Optional[float] = None,
                 dropout: Optional[float] = None):
        super().__init__()
        self.activation = activation
        self.weight_init = weight_init
        self.distribution = distribution
        self.bias_init = bias_init
        self.dropout = dropout

    # ---- shape inference and parameters ----
    def output_type(self, itype):
        return itype

    def init_params(self, itype, dtype: torch.dtype, device: torch.device,
                    gen: torch.Generator) -> None:
        """Create this layer's parameters for input type ``itype``."""

    def param_dict(self) -> dict:
        """Parameters by their reference names."""
        return dict(self.named_parameters(recurse=False))

    # ---- helpers ----
    def act(self, x):
        return get_activation(self.activation or "identity")(x)

    def _winit(self, gen, shape, fan_in, fan_out, dtype, device):
        return nn.Parameter(init_weights(
            gen, shape, self.weight_init or "xavier", fan_in, fan_out, dtype,
            device, self.distribution))

    def _binit(self, shape, dtype, device):
        return nn.Parameter(torch.full(shape, float(self.bias_init or 0.0),
                                       dtype=dtype, device=device))


def resolve_ff_size(itype) -> int:
    """Feed-forward input width for a layer fed by ``itype``."""
    if isinstance(itype, (InputTypeFeedForward, InputTypeRecurrent)):
        return itype.size
    raise ValueError(f"Cannot infer feed-forward size from {itype}")
