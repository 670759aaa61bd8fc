"""Core layers: Dense, Activation, Dropout, Embedding, EmbeddingSequence,
Positional embedding, the Output, Loss and time-distributed RnnOutput
heads, and the denoising AutoEncoder.

Counterpart of ``deeplearning4j_tpu/nn/layers/core.py`` (``DenseLayer``
``:34``, ``ActivationLayer`` ``:60``, ``DropoutLayer`` ``:69``,
``EmbeddingLayer`` ``:78``, ``EmbeddingSequenceLayer`` ``:106``,
``PositionalEmbeddingLayer`` ``:144``, ``OutputLayer`` ``:189``,
``LossLayer`` ``:195``, ``RnnOutputLayer`` ``:209``,
``CenterLossOutputLayer`` ``:222-248`` and ``AutoEncoder`` ``:251-287``,
with the loss of ``BaseOutputLayerMixin`` ``:175-184``). Parameter names
and layouts are the reference's, and so are the places dropout applies: a
Dense layer's input, an embedding's output.

A Dense layer runs one forward for every layout
(``parallel/tensor_parallel.py``): column-parallel, each rank's output
columns from its rows of ``W`` with its bias rows added and the blocks
laid side by side (an elementwise activation, gelu in ff1, then acts on
each rank's block as it would on that rank; a whole ``W`` is one rank's,
the plain ``x @ W + b``), unless ``W`` is row rows, then row-parallel:
each rank multiplies its block of the input, the partials are added in
rank order, then the replicated bias (the MLP's ff1 and ff2).

An ``EmbeddingLayer`` takes one id a row, float or integer ([B] or
[B,1]), cast to int64 (the reference casts to int32); its backward is
torch's gather backward, an index_put with accumulation (atomics on the
card, so two runs may differ in the last bits unless
``torch.use_deterministic_algorithms`` is on). The AutoEncoder's
corruption is a draw (``pretrain_noise``, through ``nn/tape.py``) and a
plain function of it (``pretrain_loss_given``), so a test can hand it the
reference's own mask.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..conf.serde import register
from ..inputs import InputTypeFeedForward, InputTypeRecurrent
from ..losses import get_loss
from ...parallel.tensor_parallel import (VECTOR, column, is_rows,
                                         join_blocks, partial_sum,
                                         rank_blocks)
from ..tape import taped
from .base import LayerConf, maybe_dropout, resolve_ff_size


@register
class DenseLayer(LayerConf):
    """Fully connected: ``x @ W + b`` with W [n_in, n_out], per timestep on
    [B,T,F] input."""
    serde_fields = LayerConf.serde_fields + ("n_in", "n_out")

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

    def pre_output(self, x, *, train=False, gen=None):
        x = maybe_dropout(x, self.dropout, gen, train)
        W = self.W
        if W.dim() == 3 and W.shape[1] != x.shape[-1]:
            # row rows [m, n_in/m, n_out]: partials in rank order, then bias
            return partial_sum(rank_blocks(x, W.shape[0]), W) + self.b
        # column rows [m, n_in, n_out/m] (a whole W is one rank's) with
        # each rank's bias block
        b = self.b if is_rows(self.b, VECTOR) else self.b.view(1, -1)
        h = column(x, W)
        return join_blocks(h + b.view((b.shape[0],) + (1,) * (h.dim() - 2)
                                      + (b.shape[1],)))

    def forward(self, x, *, train=False, gen=None):
        return self.act(self.pre_output(x, train=train, gen=gen))


@register
class ActivationLayer(LayerConf):
    """The activation alone, on input of any family."""
    expected_input = "any"

    def forward(self, x, *, train=False, gen=None):
        return self.act(x)


@register
class DropoutLayer(LayerConf):
    """Dropout alone (``dropout`` is the retain probability), on input of
    any family; the identity outside training."""
    expected_input = "any"

    def forward(self, x, *, train=False, gen=None):
        return maybe_dropout(x, self.dropout, gen, train)


@register
class EmbeddingLayer(LayerConf):
    """One id a row -> ``act(W[id] + b)``: ids [B] or [B,1], float or
    integer, W [n_in (the vocabulary), n_out]."""
    serde_fields = LayerConf.serde_fields + ("n_in", "n_out")
    expected_input = "any"
    param_order = ("W", "b")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out

    def output_type(self, itype):
        return InputTypeFeedForward(self.n_out)

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or resolve_ff_size(itype)
        self.W = self._winit(gen, (n_in, self.n_out), n_in, self.n_out,
                             dtype, device)
        self.b = self._binit((self.n_out,), dtype, device)

    def forward(self, x, *, train=False, gen=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        return self.act(self.W[idx] + self.b)


class BaseOutputLayerMixin:
    """The output layers' loss, taken on the pre-activation so softmax
    cross-entropy takes ``log_softmax``."""

    def compute_loss_per_example(self, x, labels, mask=None, *, train=False,
                                 gen=None):
        """Per-example loss [B] of ``labels`` against this layer's
        pre-activation on ``x``, under an optional [B,T] mask."""
        pre = self.pre_output(x, train=train, gen=gen)
        return get_loss(self.loss)(labels, pre, self.activation or "identity",
                                   mask)


@register
class OutputLayer(DenseLayer, BaseOutputLayerMixin):
    """A Dense layer scored by ``loss``."""
    serde_fields = DenseLayer.serde_fields + ("loss",)

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 loss: str = "mcxent", **kw):
        super().__init__(n_in=n_in, n_out=n_out, **kw)
        self.loss = loss


@register
class LossLayer(LayerConf, BaseOutputLayerMixin):
    """A loss on the incoming activations; no parameters."""
    serde_fields = LayerConf.serde_fields + ("loss",)
    expected_input = "any"

    def __init__(self, loss: str = "mcxent", **kw):
        super().__init__(**kw)
        self.loss = loss

    def pre_output(self, x, *, train=False, gen=None):
        return x

    def forward(self, x, *, train=False, gen=None):
        return self.act(x)


@register
class EmbeddingSequenceLayer(LayerConf):
    """[B,T] (or [B,T,1]) int token ids -> [B,T,n_out]: one gather."""
    serde_fields = LayerConf.serde_fields + ("n_in", "n_out")
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

    def forward(self, x, *, train=False, gen=None):
        idx = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
        return self.act(maybe_dropout(self.W[idx.long()], self.dropout, gen,
                                      train))


@register
class PositionalEmbeddingLayer(LayerConf):
    """Learned absolute positions added to [B,T,F]; ``max_length`` bounds T
    and shorter sequences use the table's prefix."""
    serde_fields = LayerConf.serde_fields + ("n_out", "max_length")
    expected_input = "rnn"
    weight_param_names = ()          # no decay on positions

    def __init__(self, n_out: Optional[int] = None, max_length: int = 2048,
                 **kw):
        super().__init__(**kw)
        self.n_out = n_out
        self.max_length = max_length

    def init_params(self, itype, dtype, device, gen):
        nf = self.n_out or resolve_ff_size(itype)
        # small-scale normal init (transformer convention)
        P = 0.02 * torch.randn((self.max_length, nf), generator=gen,
                               dtype=torch.float32)
        self.P = nn.Parameter(P.to(dtype=dtype, device=device))

    def forward(self, x, *, train=False, gen=None):
        T = x.shape[1]
        if T > self.max_length:
            raise ValueError(f"sequence length {T} exceeds max_length "
                             f"{self.max_length}")
        return self.act(x + self.P[:T][None])


@register
class RnnOutputLayer(OutputLayer):
    """Time-distributed output layer for [B,T,F] activations, scored per
    timestep."""
    expected_input = "rnn"

    def output_type(self, itype):
        t = itype.timestep_length if isinstance(itype, InputTypeRecurrent) \
            else -1
        return InputTypeRecurrent(self.n_out, t)


@register
class CenterLossOutputLayer(OutputLayer):
    """An output layer with center loss: ``lambda_ * ||f - c_y||²`` pulls
    the features toward their class's center and ``alpha`` moves the
    per-class ``centers`` [n_out, n_in], a parameter the updater moves,
    toward the features. Each term is one-sided (a ``.detach()`` where the
    reference's ``stop_gradient`` is), so plain SGD on the ``alpha`` term
    is the reference's moving-average center update."""
    serde_fields = OutputLayer.serde_fields + ("alpha", "lambda_")
    param_order = ("W", "b", "centers")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 loss: str = "mcxent", alpha: float = 0.05,
                 lambda_: float = 2e-4, **kw):
        super().__init__(n_in=n_in, n_out=n_out, loss=loss, **kw)
        self.alpha = alpha
        self.lambda_ = lambda_

    def init_params(self, itype, dtype, device, gen):
        super().init_params(itype, dtype, device, gen)
        n_in = self.n_in or resolve_ff_size(itype)
        self.centers = nn.Parameter(torch.zeros((self.n_out, n_in),
                                                dtype=dtype, device=device))

    def compute_loss_per_example(self, x, labels, mask=None, *, train=False,
                                 gen=None):
        base = super().compute_loss_per_example(x, labels, mask, train=train,
                                                gen=gen)
        centers_batch = labels @ self.centers      # one-hot labels: [B, n_in]
        pull = torch.sum((x - centers_batch.detach()) ** 2, dim=-1)
        chase = torch.sum((x.detach() - centers_batch) ** 2, dim=-1)
        return base + 0.5 * self.lambda_ * pull + 0.5 * self.alpha * chase


@register
class AutoEncoder(LayerConf):
    """Denoising autoencoder: as a layer it is ``encode``, ``act(x @ W +
    b)``; its pretraining loss reconstructs the input from a corrupted copy
    (each entry zeroed with probability ``corruption_level``) through the
    tied ``W.T`` and the visible bias ``vb``."""
    serde_fields = LayerConf.serde_fields + ("n_in", "n_out",
                                             "corruption_level", "loss")
    param_order = ("W", "b", "vb")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 corruption_level: float = 0.3, loss: str = "mse", **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out
        self.corruption_level = corruption_level
        self.loss = loss

    def output_type(self, itype):
        return InputTypeFeedForward(self.n_out)

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or resolve_ff_size(itype)
        self.W = self._winit(gen, (n_in, self.n_out), n_in, self.n_out,
                             dtype, device)
        self.b = self._binit((self.n_out,), dtype, device)
        self.vb = self._binit((n_in,), dtype, device)

    def encode(self, x):
        return self.act(x @ self.W + self.b)

    def decode(self, h):
        return self.act(h @ self.W.T + self.vb)

    def forward(self, x, *, train=False, gen=None):
        return self.encode(maybe_dropout(x, self.dropout, gen, train))

    def pretrain_noise(self, x, gen):
        """The corruption: a keep mask, True with probability 1 -
        ``corruption_level``."""
        return taped(lambda: torch.rand(
            x.shape, generator=gen, device=x.device,
            dtype=x.dtype) < 1.0 - self.corruption_level)

    def pretrain_loss_given(self, x, keep):
        """The mean reconstruction loss of ``x`` from its entries where
        ``keep`` (zero elsewhere)."""
        corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
        recon_pre = self.encode(corrupted) @ self.W.T + self.vb
        return get_loss(self.loss)(x, recon_pre, self.activation
                                   or "identity", None).mean()

    def pretrain_loss(self, x, gen):
        return self.pretrain_loss_given(x, self.pretrain_noise(x, gen))
