"""Layer base: a configurable ``nn.Module`` whose parameters are made at init.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py`` (``LayerConf``,
``maybe_dropout``). In the reference a layer is a config dataclass with pure
``init``/``apply`` over a parameter pytree; here it is an ``nn.Module`` that
holds its hyperparameters from construction and its parameters from
``init_params`` on, under the reference's names and layouts (Dense ``W`` is
[n_in, n_out], applied as ``x @ W``), so carrying weights across is a copy.

Fields left None inherit the network-wide default when the configuration
is built (``NeuralNetConfiguration._cascade``). The training fields (l1,
l2, a per-layer updater and learning rates, ``frozen``) are the
reference's. Dropout is inverted dropout on the layers the reference
applies it in; its mask draws from a ``torch.Generator`` that the graph
passes down, so its bits differ from JAX's.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..activations import get_activation
from ..inputs import InputTypeFeedForward, InputTypeRecurrent
from ..weights import init_weights


def maybe_dropout(x, retain_prob, gen: Optional[torch.Generator],
                  train: bool):
    """Inverted dropout on a layer's input: ``retain_prob`` is the RETAIN
    probability (reference util/Dropout.java), kept values are scaled by
    1/p at train time so inference is the identity."""
    if not train or retain_prob is None or retain_prob <= 0 \
            or retain_prob >= 1:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < retain_prob
    return torch.where(keep, x / retain_prob, 0.0).to(x.dtype)


class LayerConf(nn.Module):
    expected_input: str = "ff"      # the input family: "ff", "rnn" or "any"
    weight_param_names: Tuple[str, ...] = ("W",)   # what l1/l2 act on

    def __init__(self, *, activation: Optional[str] = None,
                 weight_init: Optional[str] = None, distribution=None,
                 bias_init: Optional[float] = None,
                 l1: Optional[float] = None, l2: Optional[float] = None,
                 dropout: Optional[float] = None,
                 updater: Optional[Any] = None,
                 learning_rate: Optional[float] = None,
                 bias_learning_rate: Optional[float] = None,
                 frozen: bool = False):
        super().__init__()
        self.activation = activation
        self.weight_init = weight_init
        self.distribution = distribution
        self.bias_init = bias_init
        self.l1 = l1
        self.l2 = l2
        self.dropout = dropout          # retain probability; 0/None = off
        self.updater = updater          # per-layer rule override
        self.learning_rate = learning_rate
        self.bias_learning_rate = bias_learning_rate
        self.frozen = frozen            # reference misc/FrozenLayer

    # ---- shape inference and parameters ----
    def output_type(self, itype):
        return itype

    def init_params(self, itype, dtype: torch.dtype, device: torch.device,
                    gen: torch.Generator) -> None:
        """Create this layer's parameters for input type ``itype``."""

    def param_dict(self) -> dict:
        """Parameters by their reference names."""
        return dict(self.named_parameters(recurse=False))

    def regularization(self):
        """0.5*l2*||W||^2 + l1*|W| over the weight parameters only
        (reference BaseLayer.calcL2/calcL1); 0.0 when both are off."""
        l1, l2 = self.l1 or 0.0, self.l2 or 0.0
        reg = 0.0
        if l1 == 0.0 and l2 == 0.0:
            return reg
        params = self.param_dict()
        for name in self.weight_param_names:
            if name in params:
                w = params[name]
                if l2:
                    reg = reg + 0.5 * l2 * torch.sum(w * w)
                if l1:
                    reg = reg + l1 * torch.sum(torch.abs(w))
        return reg

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
