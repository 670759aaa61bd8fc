"""The fused 1x1 conv + bias + relu for Hopper (K7), its plain PyTorch
version, the autograd Function around it and the probe a conv layer asks.

Counterpart of ``deeplearning4j_tpu/ops/kernels/conv.py``:
``conv1x1_bias_relu_applicable`` (``:43-67``), ``_conv1x1_pallas`` /
``_conv_kernel`` (``:74-102``), ``_conv1x1_xla`` (``:105-112``) and the
``custom_vjp`` ``conv1x1_bias_relu`` (``:115-148``). A 1x1/stride-1 conv is
a product over the channel axis, ``relu(x[M,C] · W[C,F] + b)`` with
M = N·H·W; the kernel (``csrc/conv1x1_bias_relu.cu``) accumulates in f32,
adds the bias in f32 and writes the activation map once, in x's dtype.
The source says what bounds it and what its simple design leaves.

The port's probe admits every 1x1/stride-1/dilation-1 conv with bias and
relu and no explicit padding, for any C and F, in f32 or bf16; the TPU
probe also needs C % 128 == 0 and F % 128 == 0 (``:65``). Both compute the
same function (ROADMAP §C).

Dispatch: the wrapper ``conv1x1_fused`` computes the plain version on a
CPU tensor and launches the kernel on a CUDA tensor or raises; each launch
adds one to ``conv1x1_fused.launches``. The backward is the reference's:
the pre-activation recomputed, the relu mask, three plain products.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..nvcc import PKG, build_library, load_symbol

SOURCE = PKG / "csrc" / "conv1x1_bias_relu.cu"
_SYMBOL = "dl4j_conv1x1_bias_relu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


def conv1x1_bias_relu_applicable(kernel_size, stride, dilation, padding,
                                 mode: str, has_bias: bool, activation,
                                 C: int, F: int, dtype) -> bool:
    """Can K7 take this conv? A pointwise geometry (no explicit padding
    unless "same", which pads nothing at 1x1/stride 1), bias and relu, f32
    or bf16, any C >= 1 and F >= 1."""
    if tuple(kernel_size) != (1, 1) or tuple(stride) != (1, 1) \
            or tuple(dilation) != (1, 1):
        return False
    if mode != "same" and tuple(padding) != (0, 0):
        return False
    if not has_bias or activation != "relu":
        return False
    return dtype in _DTYPES and C >= 1 and F >= 1


def build() -> Path:
    """Compile K7 for sm_90a unless this source's library exists."""
    return build_library(SOURCE)


def _conv1x1_plain(xm, wm, b):
    """K7's function in torch ops, the recipe of ``_conv1x1_xla``: the
    product accumulated in f32, the bias added in f32, relu, cast to
    xm's dtype."""
    acc = xm.float() @ wm.float()
    return torch.relu(acc + b.float()[None, :]).to(xm.dtype)


def conv1x1_fused(xm, wm, b):
    """The ``_conv1x1_pallas`` counterpart: relu(xm [M,C] · wm [C,F] + b
    [F]) as [M,F] in xm's dtype. CPU tensors take the plain version; CUDA
    tensors launch K7 on the current stream."""
    if xm.device.type == "cpu":
        return _conv1x1_plain(xm, wm, b)
    if xm.device.type != "cuda":
        raise ValueError(f"K7 runs on CPU or CUDA tensors, not {xm.device}")
    if xm.dtype not in _DTYPES:
        raise ValueError(f"K7 takes float32 or bfloat16, not {xm.dtype}")
    M, C = xm.shape
    F = wm.shape[1]
    for name, t, shape in (("xm", xm, (M, C)), ("wm", wm, (C, F)),
                           ("b", b, (F,))):
        if tuple(t.shape) != shape or t.dtype != xm.dtype or \
                t.device != xm.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} "
                             f"{xm.dtype} tensor on {xm.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if M < 1 or C < 1 or F < 1 or M * max(C, F) >= 2 ** 31:
        raise ValueError(f"K7 takes 1 <= M, C, F and M·max(C, F) < 2^31; "
                         f"got M={M} C={C} F={F}")
    out = torch.empty((M, F), dtype=xm.dtype, device=xm.device)
    fn = load_symbol(_SYMBOL, build, [_P] * 4 + [_I] * 4 + [_P])
    with torch.cuda.device(xm.device):
        stream = torch.cuda.current_stream(xm.device).cuda_stream
        err = fn(xm.data_ptr(), wm.data_ptr(), b.data_ptr(), out.data_ptr(),
                 M, C, F, int(xm.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{_SYMBOL} launch failed with CUDA error {err} "
                           f"(M={M}, C={C}, F={F}, {xm.dtype})")
    conv1x1_fused.launches += 1
    return out


conv1x1_fused.launches = 0      # K7 launches


class Conv1x1BiasReluFunction(torch.autograd.Function):
    """K7 forward with the reference's plain backward (``_bwd``,
    ``:129-145``): the pre-activation recomputed in f32, the relu mask,
    dx = dy·Wᵀ, dW = xᵀ·dy, db = Σ dy, each cast to its input's dtype."""

    @staticmethod
    def forward(ctx, xm, wm, b):
        ctx.save_for_backward(xm, wm, b)
        return conv1x1_fused(xm, wm, b)

    @staticmethod
    def backward(ctx, dy):
        xm, wm, b = ctx.saved_tensors
        pre = xm.float() @ wm.float() + b.float()[None, :]
        dym = dy.float() * (pre > 0)
        dx = (dym @ wm.float().T).to(xm.dtype)
        dW = (xm.float().T @ dym).to(wm.dtype)
        db = dym.sum(dim=0).to(b.dtype)
        return dx, dW, db


def conv1x1_bias_relu(x, W, b):
    """relu(conv1x1(x, W) + b) for x [N,H,W,C], W [1,1,C,F], b [F];
    differentiable on both devices."""
    N, H, Wd, C = x.shape
    F = W.shape[-1]
    y = Conv1x1BiasReluFunction.apply(x.reshape(-1, C).contiguous(),
                                      W.reshape(C, F).contiguous(),
                                      b.contiguous())
    return y.reshape(N, H, Wd, F)


def roofline(M: int, C: int, F: int, itemsize: int = 4):
    """(flops, bytes) of one call, the reference's count (``:165-170``):
    2·M·C·F flops and (M·C + C·F + F + M·F) elements of ``itemsize``
    bytes (4 in the reference's f32 count)."""
    return 2.0 * M * C * F, float(itemsize * (M * C + C * F + F + M * F))
