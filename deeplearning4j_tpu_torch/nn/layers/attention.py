"""Multi-head self-attention layer.

Counterpart of ``SelfAttentionLayer`` in
``deeplearning4j_tpu/nn/layers/attention.py`` (``:25-88``), with its
dispatch rule: the flash-attention kernel when
``fused_attention_applicable`` admits the shapes, the plain
``parallel.ring_attention.attention`` otherwise. The kernel path is
differentiable (``ops.flash_attention.FlashAttentionFunction``), so a loss
on the card trains ``Wq/Wk/Wv`` through it.

One forward serves every layout (``parallel/tensor_parallel.py``). On a
model axis of m ``Wq/Wk/Wv`` are column rows and ``Wo`` row rows: rank r
owns heads ``[r H/m, (r+1) H/m)``, its Q/K/V come from its own columns,
the attention runs once over every rank's heads (stacked, in the
unsharded head order: heads are independent), and each rank's output
block times its rows of ``Wo`` is a partial that the ranks add in rank
order before the bias (the reference's GSPMD psum, ``:64-78``). Whole
weights are one rank's (m = 1), where every step is the plain product. A
head count the axis does not divide joins the rows first (m = 1).
"""
from __future__ import annotations

from typing import Optional

from ...ops.flash_attention import flash_attention, fused_attention_applicable
from ...parallel.ring_attention import attention
from ...parallel.tensor_parallel import (COLUMN, ROW, column, full,
                                         is_rows, join_blocks, partial_sum)
from ..conf.serde import register
from ..inputs import InputTypeRecurrent
from .base import LayerConf, maybe_dropout, resolve_ff_size


@register
class SelfAttentionLayer(LayerConf):
    """[B,T,F] -> [B,T,n_out]; ``n_out`` divisible by ``n_heads``. With
    ``causal`` each position attends to itself and earlier steps; a [B,T]
    mask excludes padded timesteps as keys."""
    serde_fields = LayerConf.serde_fields + (
        "n_in", "n_out", "n_heads", "causal", "project_out")
    expected_input = "rnn"
    weight_param_names = ("Wq", "Wk", "Wv", "Wo")
    accepts_mask = True

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

    def model_shards(self) -> int:
        """m when ``Wq/Wk/Wv`` are column rows whose ranks hold whole heads
        (rank r: heads ``[r H/m, (r+1) H/m)``), else 1."""
        m = self.Wq.shape[0] if is_rows(self.Wq, COLUMN) else 1
        return m if self.n_heads % m == 0 else 1

    def rank_weights(self):
        """(m, Wq, Wk, Wv, Wo) as the forward uses them: each rank's rows
        on a model axis of m whose ranks hold whole heads, else (m = 1)
        the whole weights (rows joined)."""
        m = self.model_shards()
        if m > 1:
            return m, self.Wq, self.Wk, self.Wv, self.Wo
        return (1, full(self.Wq, COLUMN), full(self.Wk, COLUMN),
                full(self.Wv, COLUMN), full(self.Wo, ROW))

    def forward(self, x, mask=None, *, train=False, gen=None):
        x = maybe_dropout(x, self.dropout, gen, train)
        m, Wq, Wk, Wv, Wo = self.rank_weights()
        B, T, _ = x.shape
        H = self.n_heads

        def heads(w):       # [m, B, T, d/m] -> [B, H, T, Dh], rank-major
            y = column(x, w)
            if m == 1:
                return self._heads(y[0])
            return y.reshape(m, B, T, H // m, -1).permute(
                1, 0, 3, 2, 4).reshape(B, H, T, -1)

        q, k, v = heads(Wq), heads(Wk), heads(Wv)
        Dh = q.shape[-1]
        if fused_attention_applicable(B, H, T, Dh, q.dtype):
            out = flash_attention(q, k, v, causal=self.causal, key_mask=mask)
        else:
            out = attention(q, k, v, causal=self.causal, key_mask=mask)
        if m == 1:                                      # [1, B, T, d]
            out = out.transpose(1, 2).reshape(B, T, H * Dh).unsqueeze(0)
        else:                                           # rank blocks
            out = out.reshape(B, m, H // m, T, Dh).permute(
                1, 0, 3, 2, 4).reshape(m, B, T, (H // m) * Dh)
        if self.project_out:
            return self.act(partial_sum(out, Wo) + self.b)
        return self.act(join_blocks(out))
