"""Layer normalization over the feature axis, and cross-channel local
response normalization.

Counterpart of ``LayerNormalization`` and ``LocalResponseNormalization`` in
``deeplearning4j_tpu/nn/layers/norm.py`` (``:92-123``, ``:125-143``). The
formulas are the reference's, not ``F.layer_norm``'s or
``F.local_response_norm``'s: var = max(E[x^2] - mean^2, 0), then
rsqrt(var + eps); and x / (k + alpha·Σx²)^beta with the sum over a window
of n channels padded with n//2 zeros on each side (alpha is not divided by
n).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..conf.serde import register
from .base import LayerConf


@register
class LayerNormalization(LayerConf):
    serde_fields = LayerConf.serde_fields + ("n_out", "eps")
    expected_input = "any"
    weight_param_names = ()          # no l1/l2 on gain/bias

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
        self.gain = nn.Parameter(torch.ones(nf, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(nf, dtype=dtype, device=device))

    def forward(self, x, *, train=False, gen=None):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        inv = torch.rsqrt(var + self.eps)
        return self.act((x - mean) * inv * self.gain + self.bias)


@register
class LocalResponseNormalization(LayerConf):
    """Cross-channel LRN over NHWC (reference defaults k=2, n=5,
    alpha=1e-4, beta=0.75)."""
    serde_fields = LayerConf.serde_fields + ("k", "n", "alpha", "beta")
    expected_input = "cnn"

    def __init__(self, k: float = 2.0, n: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, **kw):
        super().__init__(**kw)
        self.k = k
        self.n = n
        self.alpha = alpha
        self.beta = beta

    def forward(self, x, *, train=False, gen=None):
        half = self.n // 2
        sq = F.pad(x * x, (half, half))
        summed = sq.unfold(-1, self.n, 1).sum(dim=-1)
        return x / (self.k + self.alpha * summed) ** self.beta
