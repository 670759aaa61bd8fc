"""The fused 1x1 conv + bias + relu for Hopper (K7), its plain PyTorch
version, the autograd Function around it and the probe a conv layer asks.

Counterpart of ``deeplearning4j_tpu/ops/kernels/conv.py``:
``conv1x1_bias_relu_applicable`` (``:43-67``), ``_conv1x1_pallas`` /
``_conv_kernel`` (``:74-102``), ``_conv1x1_xla`` (``:105-112``) and the
``custom_vjp`` ``conv1x1_bias_relu`` (``:115-148``). A 1x1/stride-1 conv is
a product over the channel axis, ``relu(x[M,C] · W[C,F] + b)`` with
M = N·H·W; the kernel (``csrc/conv1x1_bias_relu.cu``) accumulates in f32,
adds the bias in f32 and writes the activation map once, in x's dtype.
The source says what bounds it and how its design answers that.

``tile_plan`` chooses, on the host, how a call is cut into blocks: one of
the kernel's compiled tile shapes (BM rows x BN output channels) and a
split of C over the blocks of a thread-block cluster where the output
tiles alone are too few to fill the card.

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
import functools
import math
from pathlib import Path
from typing import NamedTuple, Tuple

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


# the kernel's compiled tile shapes (rows, output channels), in the order a
# plan prefers them at a tie, and its C step (csrc/conv1x1_bias_relu.cu)
TILES = ((64, 32), (64, 64), (128, 32))
C_STEP = 32
MAX_SPLITS = 8            # blocks of a portable cluster
# the blocks a plan aims at, per SM: a few resident on each, so one's loads
# hide under another's FMAs (the band that served GoogLeNet's 1x1 convs at
# B 1, 8 and 32 fastest among those k7_study.py's sweep tried)
BLOCKS_PER_SM = (2.5, 4.5)
H100_SMS = 132


class TilePlan(NamedTuple):
    """How K7 cuts one call: ``bm`` x ``bn`` output tiles, C split into
    ``splits`` ranges of ``k_per`` channels (the last may be shorter), each
    range taken by one block of a cluster."""
    bm: int
    bn: int
    splits: int
    k_per: int

    def grid(self, M: int, F: int) -> Tuple[int, int, int]:
        return (-(-M // self.bm), -(-F // self.bn), self.splits)

    def blocks(self, M: int, F: int) -> int:
        gx, gy, gz = self.grid(M, F)
        return gx * gy * gz


@functools.lru_cache(maxsize=4096)
def tile_plan(M: int, C: int, F: int, sms: int = H100_SMS) -> TilePlan:
    """K7's plan for relu(x[M,C] · W[C,F] + b) on a card of ``sms`` SMs:
    among the compiled tiles and the splits of C into at most 8 ranges of
    a multiple of 32 channels, the plan whose blocks come nearest to
    2.5-4.5 per SM; ties go to the first tile of ``TILES`` (the narrowest,
    so an F of 32 or less never takes a wider one), then the fewer splits.
    Cached: a served network asks for the same few shapes on every
    forward, and the search costs more host time than a launch."""
    if M < 1 or C < 1 or F < 1:
        raise ValueError(f"K7 takes 1 <= M, C, F; got M={M} C={C} F={F}")
    lo, hi = BLOCKS_PER_SM
    steps = -(-C // C_STEP)
    best = None
    for bm, bn in TILES:
        for splits in range(1, min(MAX_SPLITS, steps) + 1):
            k_per = -(-steps // splits) * C_STEP
            if -(-C // k_per) != splits:         # a range would be empty
                continue
            plan = TilePlan(bm, bn, splits, k_per)
            per_sm = plan.blocks(M, F) / sms
            miss = max(math.log(lo / per_sm), math.log(per_sm / hi), 0.0)
            if best is None or round(miss, 9) < best[0]:
                best = (round(miss, 9), plan)
    return best[1]


def build() -> Path:
    """Compile K7 for sm_90a unless this source's library exists."""
    return build_library(SOURCE)


def shared_memory_bytes(bm: int, bn: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of the ``bm`` x ``bn`` tile takes, as
    the kernel's source sizes it (builds the library)."""
    fn = load_symbol(f"{_SYMBOL}_smem", build, [_I] * 3)
    return fn(bm, bn, int(dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    out = _launch(xm, wm, b)
    conv1x1_fused.launches += 1
    return out


def _launch(xm, wm, b):
    """Launch K7 on the current stream with this call's tile plan; raise on
    a CUDA error."""
    M, C = xm.shape
    F = wm.shape[1]
    # the kernel copies rows in 16-byte pieces where it can: a view that
    # starts off a 16-byte boundary is copied to fresh (aligned) memory
    if xm.data_ptr() % 16:
        xm = xm.clone()
    out = torch.empty((M, F), dtype=xm.dtype, device=xm.device)
    plan = tile_plan(M, C, F, _sm_count(xm.device.index))
    fn = load_symbol(_SYMBOL, build, [_P] * 4 + [_I] * 8 + [_P])
    with torch.cuda.device(xm.device):
        stream = torch.cuda.current_stream(xm.device).cuda_stream
        err = fn(xm.data_ptr(), wm.data_ptr(), b.data_ptr(), out.data_ptr(),
                 M, C, F, int(xm.dtype == torch.bfloat16), *plan, stream)
    if err != 0:
        raise RuntimeError(f"{_SYMBOL} launch failed with CUDA error {err} "
                           f"(M={M}, C={C}, F={F}, {xm.dtype}, "
                           f"{plan})")
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
