"""Layer normalization over the feature axis.

Counterpart of ``LayerNormalization`` in
``deeplearning4j_tpu/nn/layers/norm.py`` (``:92-123``). The formula is the
reference's, not ``F.layer_norm``'s: var = max(E[x^2] - mean^2, 0), then
rsqrt(var + eps).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .base import LayerConf


class LayerNormalization(LayerConf):
    expected_input = "any"

    def __init__(self, n_out: Optional[int] = None, eps: float = 1e-5,
                 **kw):
        super().__init__(**kw)
        self.n_out = n_out
        self.eps = eps

    def init_params(self, itype, dtype, device, gen):
        nf = self.n_out or (itype.size if itype is not None else None)
        if not nf:
            raise ValueError("LayerNormalization cannot infer its feature "
                             "count: set n_out or provide an input type")
        self.n_out = nf
        self.gain = nn.Parameter(torch.ones(nf, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(nf, dtype=dtype, device=device))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        inv = torch.rsqrt(var + self.eps)
        return self.act((x - mean) * inv * self.gain + self.bias)
