"""Convolution, pooling and padding layers over NHWC activations.

Counterpart of ``deeplearning4j_tpu/nn/layers/conv.py``:
``conv_output_size`` (``:40``), ``ConvolutionLayer`` (``:48-114``, with
the fused 1x1 conv + bias + relu seam at ``:101-114``),
``SubsamplingLayer`` (``:161-214``), ``ZeroPaddingLayer`` (``:266``) and
``GlobalPoolingLayer`` (``:318-361``). Activations are NHWC and ``W`` is
HWIO [kh, kw, C, F], as in the reference, so weights carry across as a
copy. The stock paths hand ``F.conv2d`` and the pooling functions NCHW
views of the NHWC tensors (``permute``, so the memory stays channels-last)
and permute the result back.

Padding follows ``lax``: "same" pads each spatial dim by
``max((ceil(H/s) - 1)·s + k_eff - H, 0)``, low half rounded down and the
rest high (asymmetric at stride 2); "truncate"/"strict" pad
``padding`` on both sides. The padding is explicit (``F.pad``): zeros for
the conv and for sum/avg/pnorm pooling, -inf for max pooling, the
``reduce_window`` init values. The 1-D layers (``Convolution1DLayer``,
``Subsampling1DLayer``, ``ZeroPadding1DLayer``) raise
``NotImplementedError`` until ROADMAP A5.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.kernels.conv import (conv1x1_bias_relu,
                                 conv1x1_bias_relu_applicable)
from ..inputs import (InputTypeConvolutional, InputTypeFeedForward,
                      InputTypeRecurrent)
from .base import LayerConf, maybe_dropout


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv_output_size(size, k, s, p, mode):
    if mode == "same":
        return -(-size // s)  # ceil
    return (size + 2 * p - k) // s + 1


def same_padding(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """``lax``'s "SAME" padding of one spatial dim: (low, high)."""
    k_eff = (k - 1) * d + 1
    total = max((math.ceil(size / s) - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x, kernel, stride, padding, mode, dilation=(1, 1)):
    """(top, bottom, left, right) for an NHWC ``x``."""
    if mode == "same":
        return (*same_padding(x.shape[1], kernel[0], stride[0], dilation[0]),
                *same_padding(x.shape[2], kernel[1], stride[1], dilation[1]))
    return (padding[0], padding[0], padding[1], padding[1])


def _pad_nhwc(x, pads, value=0.0):
    t, b, l, r = pads
    if not any(pads):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class ConvolutionLayer(LayerConf):
    """2-D convolution, NHWC in and out, ``W`` [kh, kw, C, F] and ``b``
    [F] (``has_bias``). ``convolution_mode`` is "truncate"/"strict"
    (explicit ``padding``) or "same"."""
    expected_input = "cnn"
    param_order = ("W", "b")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 kernel_size=(3, 3), stride=(1, 1), padding=(0, 0),
                 convolution_mode: str = "truncate", dilation=(1, 1),
                 cudnn_algo_mode: Optional[str] = None, has_bias: bool = True,
                 **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.convolution_mode = convolution_mode
        self.dilation = dilation
        self.cudnn_algo_mode = cudnn_algo_mode   # accepted, as a no-op
        self.has_bias = has_bias

    def _geom(self):
        return (_pair(self.kernel_size), _pair(self.stride),
                _pair(self.padding), _pair(self.dilation))

    def output_type(self, itype):
        (kh, kw), (sh, sw), (ph, pw), _ = self._geom()
        mode = self.convolution_mode
        return InputTypeConvolutional(
            conv_output_size(itype.height, kh, sh, ph, mode),
            conv_output_size(itype.width, kw, sw, pw, mode), self.n_out)

    def init_params(self, itype, dtype, device, gen):
        (kh, kw), _, _, _ = self._geom()
        c_in = self.n_in if self.n_in else itype.channels
        self.W = self._winit(gen, (kh, kw, c_in, self.n_out), kh * kw * c_in,
                             kh * kw * self.n_out, dtype, device)
        if self.has_bias:
            self.b = self._binit((self.n_out,), dtype, device)

    def pre_output(self, x, *, train=False, gen=None):
        x = maybe_dropout(x, self.dropout, gen, train)
        k, s, p, d = self._geom()
        x = _pad_nhwc(x, _spatial_pads(x, k, s, p, self.convolution_mode, d))
        y = _nhwc(F.conv2d(_nchw(x), self.W.permute(3, 2, 0, 1), stride=s,
                           dilation=d))
        return y + self.b if self.has_bias else y

    def forward(self, x, *, train=False, gen=None):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = self._geom()
        if self.has_bias and x.dim() == 4 and conv1x1_bias_relu_applicable(
                (kh, kw), (sh, sw), (dh, dw), (ph, pw),
                self.convolution_mode, True, self.activation,
                int(x.shape[-1]), int(self.W.shape[-1]), x.dtype):
            x = maybe_dropout(x, self.dropout, gen, train)
            return conv1x1_bias_relu(x, self.W, self.b)
        return self.act(self.pre_output(x, train=train, gen=gen))


class SubsamplingLayer(LayerConf):
    """Spatial pooling: max, avg, sum or pnorm. Average pooling divides by
    the full window (padding included), as the reference does, unless
    ``avg_pool_include_pad_in_divisor`` is False in "same" mode."""
    expected_input = "cnn"

    def __init__(self, pooling_type: str = "max", kernel_size=(2, 2),
                 stride=(2, 2), padding=(0, 0),
                 convolution_mode: str = "truncate", pnorm: int = 2,
                 avg_pool_include_pad_in_divisor: bool = True, **kw):
        super().__init__(**kw)
        self.pooling_type = pooling_type
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.convolution_mode = convolution_mode
        self.pnorm = pnorm
        self.avg_pool_include_pad_in_divisor = avg_pool_include_pad_in_divisor

    def output_type(self, itype):
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        ph, pw = _pair(self.padding)
        mode = self.convolution_mode
        return InputTypeConvolutional(
            conv_output_size(itype.height, kh, sh, ph, mode),
            conv_output_size(itype.width, kw, sw, pw, mode), itype.channels)

    def forward(self, x, *, train=False, gen=None):
        k, s = _pair(self.kernel_size), _pair(self.stride)
        pads = _spatial_pads(x, k, s, _pair(self.padding),
                             self.convolution_mode)
        pt = self.pooling_type.lower()

        def window_sum(v):
            return _nhwc(F.avg_pool2d(_nchw(_pad_nhwc(v, pads)), k, s,
                                      divisor_override=1))

        if pt == "max":
            return _nhwc(F.max_pool2d(
                _nchw(_pad_nhwc(x, pads, float("-inf"))), k, s))
        if pt in ("avg", "sum"):
            y = window_sum(x)
            if pt == "sum":
                return y
            if self.convolution_mode == "same" and \
                    not self.avg_pool_include_pad_in_divisor:
                ones = torch.ones(x.shape[:3] + (1,), dtype=x.dtype,
                                  device=x.device)
                return y / window_sum(ones)
            return y / (k[0] * k[1])
        if pt == "pnorm":
            p = float(self.pnorm)
            return window_sum(torch.abs(x) ** p) ** (1.0 / p)
        raise ValueError(f"Unknown pooling type {self.pooling_type!r}")


class ZeroPaddingLayer(LayerConf):
    """Spatial zero padding: ``padding`` is (top, bottom, left, right) or
    (h, w)."""
    expected_input = "cnn"

    def __init__(self, padding=(0, 0), **kw):
        super().__init__(**kw)
        self.padding = padding

    def _pads(self):
        p = tuple(int(v) for v in self.padding)
        return (p[0], p[0], p[1], p[1]) if len(p) == 2 else p

    def output_type(self, itype):
        t, b, l, r = self._pads()
        return InputTypeConvolutional(itype.height + t + b,
                                      itype.width + l + r, itype.channels)

    def forward(self, x, *, train=False, gen=None):
        return _pad_nhwc(x, self._pads())


class GlobalPoolingLayer(LayerConf):
    """Global pooling over the spatial dims of [B,H,W,C] or the time dim of
    [B,T,F] (under an optional [B,T] mask): max, sum, avg or pnorm."""
    expected_input = "any"
    accepts_mask = True

    def __init__(self, pooling_type: str = "max", pnorm: int = 2,
                 collapse_dimensions: bool = True, **kw):
        super().__init__(**kw)
        self.pooling_type = pooling_type
        self.pnorm = pnorm
        self.collapse_dimensions = collapse_dimensions

    def output_type(self, itype):
        if isinstance(itype, InputTypeRecurrent):
            return InputTypeFeedForward(itype.size)
        if isinstance(itype, InputTypeConvolutional):
            return InputTypeFeedForward(itype.channels)
        return itype

    def forward(self, x, *, train=False, gen=None, mask=None):
        dims = (1,) if x.dim() == 3 else (1, 2)
        pt = self.pooling_type.lower()
        masked = mask is not None and x.dim() == 3
        if masked:
            m = mask.to(x.dtype)[..., None]
            x = torch.where(m > 0, x, float("-inf")) if pt == "max" \
                else x * m
        if pt == "max":
            return torch.amax(x, dim=dims)
        if pt == "sum":
            return torch.sum(x, dim=dims)
        if pt == "avg":
            if masked:
                denom = torch.clamp(mask.to(x.dtype).sum(dim=1), min=1.0)
                return x.sum(dim=1) / denom[:, None]
            return torch.mean(x, dim=dims)
        if pt == "pnorm":
            p = float(self.pnorm)
            return torch.sum(torch.abs(x) ** p, dim=dims) ** (1.0 / p)
        raise ValueError(f"Unknown pooling type {self.pooling_type!r}")


class _NotPorted(LayerConf):
    def __init__(self, *a, **kw):
        raise NotImplementedError(f"{type(self).__name__} is not ported yet "
                                  f"(ROADMAP A5)")


class Convolution1DLayer(_NotPorted):
    """Temporal convolution over [B,T,F] (reference ``:117-156``)."""


class Subsampling1DLayer(_NotPorted):
    """Temporal pooling over [B,T,F] (reference ``:217-261``)."""


class ZeroPadding1DLayer(_NotPorted):
    """Temporal zero padding over [B,T,F] (reference ``:289-313``)."""
