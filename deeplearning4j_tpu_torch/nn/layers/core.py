"""Core layers of the transformer LM: Dense, EmbeddingSequence, Positional
embedding and the time-distributed RnnOutput head.

Counterpart of ``deeplearning4j_tpu/nn/layers/core.py`` (``DenseLayer``
``:34``, ``EmbeddingSequenceLayer`` ``:106``, ``PositionalEmbeddingLayer``
``:144``, ``RnnOutputLayer`` ``:209``). Parameter names and layouts are the
reference's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..inputs import InputTypeFeedForward, InputTypeRecurrent
from .base import LayerConf, resolve_ff_size


class DenseLayer(LayerConf):
    """Fully connected: ``x @ W + b`` with W [n_in, n_out], per timestep on
    [B,T,F] input."""

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out

    def output_type(self, itype):
        if isinstance(itype, InputTypeRecurrent):
            return InputTypeRecurrent(self.n_out, itype.timestep_length)
        return InputTypeFeedForward(self.n_out)

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or resolve_ff_size(itype)
        self.W = self._winit(gen, (n_in, self.n_out), n_in, self.n_out,
                             dtype, device)
        self.b = self._binit((self.n_out,), dtype, device)

    def pre_output(self, x):
        return x @ self.W + self.b

    def forward(self, x):
        return self.act(self.pre_output(x))


class EmbeddingSequenceLayer(LayerConf):
    """[B,T] (or [B,T,1]) int token ids -> [B,T,n_out]: one gather."""
    expected_input = "any"

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0, **kw):
        super().__init__(**kw)
        self.n_in = n_in             # vocab size (required)
        self.n_out = n_out

    def output_type(self, itype):
        return InputTypeRecurrent(self.n_out,
                                  getattr(itype, "timestep_length", -1))

    def init_params(self, itype, dtype, device, gen):
        if not self.n_in:
            raise ValueError("EmbeddingSequenceLayer needs n_in (the vocab "
                             "size) — it cannot be inferred from a [B,T] "
                             "index input")
        self.W = self._winit(gen, (self.n_in, self.n_out), self.n_in,
                             self.n_out, dtype, device)

    def forward(self, x):
        idx = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
        return self.act(self.W[idx.long()])


class PositionalEmbeddingLayer(LayerConf):
    """Learned absolute positions added to [B,T,F]; ``max_length`` bounds T
    and shorter sequences use the table's prefix."""
    expected_input = "rnn"

    def __init__(self, n_out: Optional[int] = None, max_length: int = 2048,
                 **kw):
        super().__init__(**kw)
        self.n_out = n_out
        self.max_length = max_length

    def init_params(self, itype, dtype, device, gen):
        nf = self.n_out or resolve_ff_size(itype)
        self.n_out = nf
        # small-scale normal init (transformer convention)
        P = 0.02 * torch.randn((self.max_length, nf), generator=gen,
                               dtype=torch.float32)
        self.P = nn.Parameter(P.to(dtype=dtype, device=device))

    def forward(self, x):
        T = x.shape[1]
        if T > self.max_length:
            raise ValueError(f"sequence length {T} exceeds max_length "
                             f"{self.max_length}")
        return self.act(x + self.P[:T][None])


class RnnOutputLayer(DenseLayer):
    """Time-distributed output layer for [B,T,F] activations. ``loss`` is
    held as configuration for the training slice."""
    expected_input = "rnn"

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 loss: str = "mcxent", **kw):
        super().__init__(n_in=n_in, n_out=n_out, **kw)
        self.loss = loss

    def output_type(self, itype):
        t = itype.timestep_length if isinstance(itype, InputTypeRecurrent) \
            else -1
        return InputTypeRecurrent(self.n_out, t)
