"""Multi-head self-attention layer.

Counterpart of ``SelfAttentionLayer`` in
``deeplearning4j_tpu/nn/layers/attention.py`` (``:25-88``), with its
dispatch rule: the flash-attention kernel when
``fused_attention_applicable`` admits the shapes, the plain
``parallel.ring_attention.attention`` otherwise.
"""
from __future__ import annotations

from typing import Optional

from ...ops.flash_attention import flash_attention, fused_attention_applicable
from ...parallel.ring_attention import attention
from ..inputs import InputTypeRecurrent
from .base import LayerConf, resolve_ff_size


class SelfAttentionLayer(LayerConf):
    """[B,T,F] -> [B,T,n_out]; ``n_out`` divisible by ``n_heads``. With
    ``causal`` each position attends to itself and earlier steps; a [B,T]
    mask excludes padded timesteps as keys."""
    expected_input = "rnn"

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 n_heads: int = 4, causal: bool = False,
                 project_out: bool = True, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out
        self.n_heads = n_heads
        self.causal = causal
        self.project_out = project_out

    def output_type(self, itype):
        t = itype.timestep_length if isinstance(itype, InputTypeRecurrent) \
            else -1
        return InputTypeRecurrent(self.n_out, t)

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or resolve_ff_size(itype)
        self.n_in = n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out={self.n_out} must be divisible by "
                             f"n_heads={self.n_heads}")
        d = self.n_out
        self.Wq = self._winit(gen, (n_in, d), n_in, d, dtype, device)
        self.Wk = self._winit(gen, (n_in, d), n_in, d, dtype, device)
        self.Wv = self._winit(gen, (n_in, d), n_in, d, dtype, device)
        self.Wo = self._winit(gen, (d, d), d, d, dtype, device)
        self.b = self._binit((d,), dtype, device)

    def _heads(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_heads, -1).transpose(1, 2)

    def forward(self, x, mask=None):
        q = self._heads(x @ self.Wq)
        k = self._heads(x @ self.Wk)
        v = self._heads(x @ self.Wv)
        B, H, T, Dh = q.shape
        if fused_attention_applicable(B, H, T, Dh, q.dtype):
            out = flash_attention(q, k, v, causal=self.causal, key_mask=mask)
        else:
            out = attention(q, k, v, causal=self.causal, key_mask=mask)
        out = out.transpose(1, 2).reshape(B, T, H * Dh)
        if self.project_out:
            out = out @ self.Wo + self.b
        return self.act(out)
