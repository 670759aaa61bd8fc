"""Batch normalization, layer normalization over the feature axis, and
cross-channel local response normalization.

Counterpart of ``BatchNormalization``, ``LayerNormalization`` and
``LocalResponseNormalization`` in ``deeplearning4j_tpu/nn/layers/norm.py``
(``:28-87``, ``:92-123``, ``:125-143``). The formulas are the reference's,
not ``F.batch_norm``'s, ``F.layer_norm``'s or ``F.local_response_norm``'s:
var = max(E[x^2] - mean^2, 0), the biased form, then rsqrt(var + eps); a
batch norm's running averages take that biased variance (cuDNN's take the
unbiased one); and x / (k + alpha·Σx²)^beta with the sum over a window of
n channels padded with n//2 zeros on each side (alpha is not divided by
n).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..conf.serde import register
from ..inputs import InputTypeConvolutional
from ..tape import record_state
from .base import LayerConf


@register
class BatchNormalization(LayerConf):
    """Normalization over every axis but the last (NHWC maps or [B, F]
    features): with the batch's own mean and variance in training, with
    the running ones in evaluation. ``gamma`` and ``beta`` are parameters
    (fixed at ``gamma_init``/``beta_init`` under ``lock_gamma_beta``),
    without l1/l2; the running ``mean`` and ``var`` are float32 state
    whatever the network's dtype or compute dtype, moved by
    ``decay·old + (1 - decay)·batch`` once a training step."""
    serde_fields = LayerConf.serde_fields + (
        "n_out", "decay", "eps", "lock_gamma_beta", "gamma_init", "beta_init")
    expected_input = "any"
    param_order = ("gamma", "beta")
    weight_param_names = ()          # no l1/l2 on gamma/beta

    def __init__(self, n_out: Optional[int] = None, decay: float = 0.9,
                 eps: float = 1e-5, lock_gamma_beta: bool = False,
                 gamma_init: float = 1.0, beta_init: float = 0.0, **kw):
        super().__init__(**kw)
        self.n_out = n_out
        self.decay = decay
        self.eps = eps
        self.lock_gamma_beta = lock_gamma_beta
        self.gamma_init = gamma_init
        self.beta_init = beta_init

    def _nf(self, itype) -> int:
        if self.n_out:
            return self.n_out
        if itype is None:
            raise ValueError(
                "BatchNormalization cannot infer its feature count: set "
                "n_out explicitly or provide an input type (set_input_type "
                "or n_in on the first layer)")
        if isinstance(itype, InputTypeConvolutional):
            return itype.channels
        return itype.size

    def init_params(self, itype, dtype, device, gen):
        nf = self._nf(itype)
        if not self.lock_gamma_beta:
            self.gamma = nn.Parameter(torch.full(
                (nf,), float(self.gamma_init), dtype=dtype, device=device))
            self.beta = nn.Parameter(torch.full(
                (nf,), float(self.beta_init), dtype=dtype, device=device))
        self.register_buffer("mean", torch.zeros(
            nf, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            nf, dtype=torch.float32, device=device))

    def forward(self, x, *, train=False, gen=None):
        dims = tuple(range(x.dim() - 1))
        if train:
            # in x's dtype, as jnp.mean's result is (bf16 under a bf16
            # compute dtype); only the running averages are float32
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                d = self.decay
                record_state(self, {
                    "mean": d * self.mean + (1 - d) * mean.float(),
                    "var": d * self.var + (1 - d) * var.float()})
        else:
            mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        inv = torch.rsqrt(var + torch.tensor(self.eps, dtype=x.dtype))
        y = (x - mean) * inv
        if self.lock_gamma_beta:
            y = y * self.gamma_init + self.beta_init
        else:
            y = y * self.gamma + self.beta
        return self.act(y)


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
