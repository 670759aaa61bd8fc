"""Recurrent layers: LSTM, GravesLSTM (peepholes), GravesBidirectionalLSTM
and LastTimeStepLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``. Parameter
names and layouts are the reference's: ``W`` [n_in, 4H], ``R`` [H, 4H], ``b``
[4H] with the forget-gate bias at ``[H:2H]``, peepholes ``pi/pf/po`` [H];
the bidirectional layer keeps one set per direction (``Wf/Rf/bf/pif/pff/pof``
and ``Wb/.../pob``) and sums the two directions' outputs. Gate order along
the 4H axis is [i, f, o, g]. The input projection ``x @ W + b`` of every
step is one matmul outside the time loop; ``_lstm_scan`` runs the loop.
Layout: [B, T, F], batch-major. Masked steps carry state through.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.lstm import (fused_lstm, fused_lstm_applicable,
                         fused_lstm_peephole)
from ..activations import get_activation
from ..inputs import InputTypeFeedForward, InputTypeRecurrent
from .base import LayerConf, maybe_dropout


def _lstm_scan(x_proj, h0, c0, R, act, gate_act, peepholes=None, mask=None,
               reverse=False, activation_names=("", "")):
    """Run an LSTM over time (``_lstm_scan`` ``:32-97``): the K5/K6 kernels
    when ``fused_lstm_applicable`` admits the call, else the plain
    recurrence, the reference's own rule. x_proj [T,B,4H]; peepholes None
    or (pi, pf, po); mask [T,B,1] or None. Returns (hs [T,B,H], (hT, cT)).
    A reverse LSTM is a forward LSTM over the flipped sequence."""
    H = h0.shape[-1]
    if fused_lstm_applicable(h0.shape[0], H, x_proj.dtype,
                             peepholes=peepholes, mask=mask, reverse=False,
                             activation=activation_names[0],
                             gate_activation=activation_names[1]):
        m2d = None if mask is None else mask[:, :, 0].to(x_proj.dtype)
        if reverse:
            x_proj = torch.flip(x_proj, (0,))
            m2d = None if m2d is None else torch.flip(m2d, (0,))
        args = (x_proj.contiguous(), h0.contiguous(), c0.contiguous(), R)
        if peepholes is not None:
            hs, final = fused_lstm_peephole(*args, *peepholes, mask=m2d)
        else:
            hs, final = fused_lstm(*args, mask=m2d)
        return (torch.flip(hs, (0,)) if reverse else hs), final

    T = x_proj.shape[0]
    h, c = h0, c0
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[t] + h @ R
        zi, zf = gates[..., :H], gates[..., H:2 * H]
        zo, zg = gates[..., 2 * H:3 * H], gates[..., 3 * H:]
        if peepholes is not None:
            p_i, p_f, p_o = peepholes
            zi = zi + c * p_i
            zf = zf + c * p_f
        i, f, g = gate_act(zi), gate_act(zf), act(zg)
        c_new = f * c + i * g
        if peepholes is not None:
            zo = zo + c_new * p_o
        h_new = gate_act(zo) * act(c_new)
        if mask is not None:
            m = mask[t]
            h_new = m * h_new + (1 - m) * h
            c_new = m * c_new + (1 - m) * c
        h, c = h_new, c_new
        hs[t] = h
    return torch.stack(hs), (h, c)


def _time_mask(mask, dtype):
    """[B,T] feature mask -> [T,B,1] in the activations' dtype."""
    return None if mask is None else mask.to(dtype).T[..., None]


class LSTM(LayerConf):
    """Standard LSTM without peepholes (reference nn/conf/layers/LSTM.java)."""
    expected_input = "rnn"
    accepts_mask = True
    has_peepholes = False
    param_order = ("W", "R", "b")
    weight_param_names = ("W", "R")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 forget_gate_bias_init: float = 1.0,
                 gate_activation: str = "sigmoid", **kw):
        super().__init__(**kw)
        if self.activation is None:
            self.activation = "tanh"
        self.n_in = n_in
        self.n_out = n_out
        self.forget_gate_bias_init = forget_gate_bias_init
        self.gate_activation = gate_activation

    def output_type(self, itype):
        return InputTypeRecurrent(self.n_out,
                                  getattr(itype, "timestep_length", -1))

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or itype.size
        H = self.n_out
        self.W = self._winit(gen, (n_in, 4 * H), n_in, H, dtype, device)
        self.R = self._winit(gen, (H, 4 * H), H, H, dtype, device)
        b = torch.zeros(4 * H, dtype=dtype, device=device)
        b[H:2 * H] = self.forget_gate_bias_init
        self.b = nn.Parameter(b)
        if self.has_peepholes:
            for name in ("pi", "pf", "po"):
                setattr(self, name, nn.Parameter(
                    torch.zeros(H, dtype=dtype, device=device)))

    def _peepholes(self):
        return (self.pi, self.pf, self.po) if self.has_peepholes else None

    def apply_with_final_state(self, x, *, train=False, gen=None, mask=None,
                               initial_state=None):
        """The layer's output [B,T,H] and its final (h_T, c_T): the state
        tBPTT carries between chunks and ``rnn_time_step`` between calls."""
        x = maybe_dropout(x, self.dropout, gen, train)
        B = x.shape[0]
        H = self.n_out
        x_proj = (x @ self.W + self.b).transpose(0, 1)          # [T,B,4H]
        if initial_state is None:
            zero = torch.zeros((B, H), dtype=x.dtype, device=x.device)
            initial_state = (zero, zero)
        hs, final = _lstm_scan(
            x_proj, initial_state[0], initial_state[1], self.R,
            get_activation(self.activation),
            get_activation(self.gate_activation), self._peepholes(),
            _time_mask(mask, x.dtype),
            activation_names=(self.activation, self.gate_activation))
        return hs.transpose(0, 1), final

    def forward(self, x, *, train=False, gen=None, mask=None,
                initial_state=None):
        return self.apply_with_final_state(
            x, train=train, gen=gen, mask=mask,
            initial_state=initial_state)[0]


class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference GravesLSTM.java:47,
    LSTMHelpers peephole terms)."""
    has_peepholes = True
    param_order = ("W", "R", "b", "pi", "pf", "po")


class GravesBidirectionalLSTM(LayerConf):
    """Bidirectional Graves LSTM; the forward and backward outputs are
    summed (reference GravesBidirectionalLSTM.activateOutput)."""
    expected_input = "rnn"
    accepts_mask = True
    param_order = ("Wf", "Rf", "bf", "pif", "pff", "pof",
                   "Wb", "Rb", "bb", "pib", "pfb", "pob")
    weight_param_names = ("Wf", "Rf", "Wb", "Rb")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 forget_gate_bias_init: float = 1.0,
                 gate_activation: str = "sigmoid", **kw):
        super().__init__(**kw)
        if self.activation is None:
            self.activation = "tanh"
        self.n_in = n_in
        self.n_out = n_out
        self.forget_gate_bias_init = forget_gate_bias_init
        self.gate_activation = gate_activation

    def output_type(self, itype):
        return InputTypeRecurrent(self.n_out,
                                  getattr(itype, "timestep_length", -1))

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or itype.size
        H = self.n_out
        for d in "fb":
            setattr(self, f"W{d}", self._winit(gen, (n_in, 4 * H), n_in, H,
                                               dtype, device))
            setattr(self, f"R{d}", self._winit(gen, (H, 4 * H), H, H, dtype,
                                               device))
            b = torch.zeros(4 * H, dtype=dtype, device=device)
            b[H:2 * H] = self.forget_gate_bias_init
            setattr(self, f"b{d}", nn.Parameter(b))
            for p in ("pi", "pf", "po"):
                setattr(self, f"{p}{d}", nn.Parameter(
                    torch.zeros(H, dtype=dtype, device=device)))

    def forward(self, x, *, train=False, gen=None, mask=None):
        x = maybe_dropout(x, self.dropout, gen, train)
        B = x.shape[0]
        H = self.n_out
        m = _time_mask(mask, x.dtype)
        p = self.param_dict()
        out = None
        for d, reverse in (("f", False), ("b", True)):
            x_proj = (x @ p[f"W{d}"] + p[f"b{d}"]).transpose(0, 1)
            zero = torch.zeros((B, H), dtype=x.dtype, device=x.device)
            hs, _ = _lstm_scan(
                x_proj, zero, zero, p[f"R{d}"],
                get_activation(self.activation),
                get_activation(self.gate_activation),
                (p[f"pi{d}"], p[f"pf{d}"], p[f"po{d}"]), m, reverse=reverse,
                activation_names=(self.activation, self.gate_activation))
            hs = hs.transpose(0, 1)
            out = hs if out is None else out + hs
        return out


class LastTimeStepLayer(LayerConf):
    """[B,T,F] -> [B,F]: each sequence's last unmasked step (reference
    recurrent/LastTimeStep)."""
    expected_input = "rnn"
    accepts_mask = True
    weight_param_names = ()

    def output_type(self, itype):
        return InputTypeFeedForward(itype.size)

    def forward(self, x, *, train=False, gen=None, mask=None):
        if mask is not None:
            idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        return x[:, -1]
