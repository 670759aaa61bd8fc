"""The int8 serving tier: dynamic-quantized matmul for Hopper (K8), its plain
PyTorch version, the quantizers around it and the serving ``forward_fn``.

Counterpart of ``deeplearning4j_tpu/ops/kernels/quantized.py``: weights get
static symmetric per-output-channel scales (amax/127 over the input dim),
activations dynamic symmetric per-row scales; the product of the int8
values is summed exactly in int32 and rescaled once in f32 as
``(f32(acc) * x_scale[m]) * w_scale[n]``. Exact integer sums make the
kernel (``csrc/int8_matmul.cu``, integer ``mma.sync`` on the tensor cores)
and the plain version bitwise equal: the reference pins this kernel at 0.0.
The source says what bounds the kernel and how its design answers it; the
host picks its plan (``tile_plan``: how many blocks of a cluster split K).

The port's probe admits any M, K, N >= 1; the TPU probe also needs
M % 32, K % 128 and N % 128 (``:75``). Both compute the same function
(ROADMAP §C). The quantizers, ``int8_dense`` and ``int8_forward_fn`` are
plain torch, as the reference computes them outside Pallas; ``torch.round``
rounds half to even, as ``jnp.round`` does.

Dispatch: the wrapper ``int8_matmul_fused`` computes the plain version on a
CPU tensor and launches K8 on a CUDA tensor or raises; each launch adds one
to ``int8_matmul_fused.launches``. The serving path calls it three times a
batch and a call's host time is longer than the kernel's, so the host path
is kept short: the C entry is resolved once and takes one argument array,
shapes are checked by one chain of comparisons, the card and its stream
are read through PyTorch's raw calls, and the device context is entered
only when the tensors lie on another card than the current one.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Tuple

import torch

from ..nvcc import PKG, build_library, load_symbol

SOURCE = PKG / "csrc" / "int8_matmul.cu"
_SYMBOL = "dl4j_int8_matmul"
# the C entry takes its 11 arguments as one array of 64-bit integers: one
# pointer for ctypes to convert instead of eleven
_ARGS = ctypes.c_longlong * 11

BM, BN = 16, 32          # the kernel's output tile
K_STEP = 32              # k of one mma; a split's k range is a multiple
MAX_SPLITS = 8           # blocks of a portable cluster
MIN_BLOCKS = 64          # a call's blocks the plan reaches for when it can


def build() -> Path:
    """Compile K8 for sm_90a unless this source's library exists."""
    return build_library(SOURCE)


def _scale(amax):
    return torch.where(amax > 0, amax / 127.0,
                       torch.ones_like(amax)).to(torch.float32)


def quantize_weights(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] f32 -> (int8 [K, N], f32 scale [N]): symmetric per output
    channel; a zero column gets scale 1 so dequantization stays finite."""
    scale = _scale(torch.amax(torch.abs(w), dim=0))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, K] f32 -> (int8 [M, K], f32 scale [M]): dynamic symmetric per
    row (per example)."""
    scale = _scale(torch.amax(torch.abs(x), dim=1))
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_applicable(M: int, K: int, N: int) -> bool:
    """Can K8 take this product? Any M, K, N >= 1."""
    return M >= 1 and K >= 1 and N >= 1


def int8_matmul_plain(x_q, w_q, x_scale, w_scale):
    """K8's function in torch ops, the recipe of ``int8_matmul_xla``. The
    exact int32 sum is ``torch.mm`` of int32 on the CPU; CUDA has no
    integer ``mm``, so there it is taken in float64, exact for int8
    products while K·127² < 2^53, then cast to int32."""
    if x_q.device.type == "cpu":
        acc = torch.mm(x_q.to(torch.int32), w_q.to(torch.int32))
    else:
        acc = torch.mm(x_q.to(torch.float64),
                       w_q.to(torch.float64)).to(torch.int32)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]


@functools.lru_cache(maxsize=256)
def tile_plan(M: int, K: int, N: int) -> Tuple[int, int]:
    """(splits, k_per): K8's 16x32 output tiles, each split over the fewest
    blocks of a cluster (1, 2, 4 or 8) that give the call at least
    ``MIN_BLOCKS`` blocks, with at least two k-steps of 32 a split; each
    block takes ``k_per`` of K (a multiple of 32), every split some of it.
    The int8 net's products: M 8 -> 4 or 8 splits, M 32 -> 2 or 4, M 256
    -> none."""
    tiles = -(-M // BM) * -(-N // BN)
    steps = -(-K // K_STEP)
    splits = 1
    while (tiles * splits < MIN_BLOCKS and splits < MAX_SPLITS
           and steps >= 4 * splits):
        splits *= 2
    k_per = -(-steps // splits) * K_STEP
    splits = -(-K // k_per)              # no split left without k
    return splits, k_per


def _bad(name, t, shape, dtype, device):
    return ValueError(f"{name} must be a contiguous {shape} {dtype} tensor "
                      f"on {device}; got {tuple(t.shape)} {t.dtype} on "
                      f"{t.device}")


def _full_check(x_q, w_q, x_scale, w_scale):
    """(M, K, N), or raise the error that says what of K8's operands is
    wrong (``_check``'s slow path)."""
    dev = x_q.device
    if x_q.dim() != 2:
        raise _bad("x_q", x_q, "[M, K]", torch.int8, dev)
    M, K = x_q.shape
    if w_q.dim() != 2 or w_q.shape[0] != K:
        raise _bad("w_q", w_q, f"[{K}, N]", torch.int8, dev)
    N = w_q.shape[1]
    for name, t, shape, dtype in (
            ("x_q", x_q, (M, K), torch.int8), ("w_q", w_q, (K, N), torch.int8),
            ("x_scale", x_scale, (M,), torch.float32),
            ("w_scale", w_scale, (N,), torch.float32)):
        if t.dtype != dtype or t.device != dev or not t.is_contiguous() or \
                tuple(t.shape) != shape:
            raise _bad(name, t, shape, dtype, dev)
    if not int8_matmul_applicable(M, K, N) or max(M * K, K * N,
                                                  M * N) >= _LIMIT:
        raise ValueError(f"K8 takes 1 <= M, K, N with every operand under "
                         f"2^31 elements; got M={M} K={K} N={N}")
    return M, K, N


_I8, _F32, _LIMIT = torch.int8, torch.float32, 2 ** 31


def _check(x_q, w_q, x_scale, w_scale, index):
    """(M, K, N) if x_q [M,K] and w_q [K,N] are int8, x_scale [M] and
    w_scale [N] f32, all contiguous on x_q's device, 1 <= M, K, N and every
    operand under 2^31 elements; else ``_full_check`` raises. ``index`` is
    x_q's card; on a card, one chain of integer and identity comparisons
    decides, since this runs on every serving call."""
    xs, ws = x_q.shape, w_q.shape
    if index >= 0 and len(xs) == 2 and len(ws) == 2:
        (M, K), N = xs, ws[1]
        if (ws[0] == K and x_scale.shape == (M,) and w_scale.shape == (N,)
                and x_q.dtype is _I8 and w_q.dtype is _I8
                and x_scale.dtype is _F32 and w_scale.dtype is _F32
                and w_q.get_device() == index
                and x_scale.get_device() == index
                and w_scale.get_device() == index and x_q.is_contiguous()
                and w_q.is_contiguous() and x_scale.is_contiguous()
                and w_scale.is_contiguous() and M >= 1 and K >= 1
                and N >= 1 and M * K < _LIMIT and K * N < _LIMIT
                and M * N < _LIMIT):
            return M, K, N
    return _full_check(x_q, w_q, x_scale, w_scale)


_entry = []                    # the C entry point, resolved once
_local = threading.local()     # each thread's argument array


def _launch(x_q, w_q, x_scale, w_scale):
    """Check the operands, allocate the output and launch K8 on the current
    stream of x_q's card with ``tile_plan``'s plan; raise on a CUDA error.
    The current card and its stream are read through PyTorch's raw calls,
    the cheapest it has."""
    index, current = x_q.get_device(), torch._C._cuda_getDevice()
    if index >= 0 and index != current:      # another card than the current
        with torch.cuda.device(index):
            return _launch(x_q, w_q, x_scale, w_scale)
    M, K, N = _check(x_q, w_q, x_scale, w_scale, index)
    splits, k_per = tile_plan(M, K, N)
    out = torch.empty(M, N, dtype=_F32, device=x_q.device)
    if not _entry:
        _entry.append(load_symbol(_SYMBOL, build, [ctypes.c_void_p]))
    args = getattr(_local, "args", None)
    if args is None:
        args = _local.args = _ARGS()
    args[:] = (x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
               w_scale.data_ptr(), out.data_ptr(), M, K, N, splits, k_per,
               torch._C._cuda_getCurrentRawStream(current))
    err = _entry[0](ctypes.addressof(args))
    if err != 0:
        raise RuntimeError(f"{_SYMBOL} launch failed with CUDA error {err} "
                           f"(M={M}, K={K}, N={N})")
    return out


def int8_matmul_fused(x_q, w_q, x_scale, w_scale):
    """The ``int8_matmul_pallas`` counterpart: x_q [M,K] int8 · w_q [K,N]
    int8 -> [M,N] f32, rescaled by x_scale [M] and w_scale [N]. CPU tensors
    take the plain version; CUDA tensors launch K8 on the current
    stream."""
    kind = x_q.device.type
    if kind == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale)
    if kind != "cuda":
        raise ValueError(f"K8 runs on CPU or CUDA tensors, not {x_q.device}")
    out = _launch(x_q, w_q, x_scale, w_scale)
    int8_matmul_fused.launches += 1
    return out


int8_matmul_fused.launches = 0      # K8 launches


def int8_matmul(x, w_q, w_scale):
    """Dynamic-quantized matmul: f32 activations [M,K] against
    pre-quantized weights, through the probe."""
    x_q, x_scale = quantize_rows(x)
    M, K = x.shape
    N = w_q.shape[1]
    if int8_matmul_applicable(M, K, N):
        return int8_matmul_fused(x_q.contiguous(), w_q.contiguous(),
                                 x_scale, w_scale)
    return int8_matmul_plain(x_q, w_q, x_scale, w_scale)


def int8_dense(params, x):
    """One Dense-family layer's pre-output with the matmul quantized, for
    inputs of any leading rank ([..., K] @ [K, N] + b)."""
    w_q, w_scale = quantize_weights(params["W"])
    lead, K = x.shape[:-1], x.shape[-1]
    y = int8_matmul(x.reshape(-1, K), w_q, w_scale)
    return y.reshape(lead + (y.shape[-1],)) + params["b"]


def int8_forward_fn(net):
    """A ``ProgramSet`` forward_fn for a ``MultiLayerNetwork``: the
    inference walk with every Dense-family matmul (DenseLayer,
    OutputLayer) through ``int8_matmul`` and every other layer on its own
    forward. It is called as ``forward(net, x)`` with the program set's
    network, so the weights are quantized from that network's live
    parameters on every call and a hot-swapped set re-quantizes. f32
    networks only: the tier quantizes from full precision."""
    from ...nn.layers.core import DenseLayer

    if getattr(net.conf, "compute_dtype", None):
        raise ValueError("int8_forward_fn expects a full-precision net "
                         "(compute_dtype nets already run a reduced-"
                         "precision forward)")

    def forward(net_, x):
        for i, layer in enumerate(net_.layers):
            if net_.conf.preprocessor(i) is not None:
                raise NotImplementedError("input preprocessors are not "
                                          "ported yet (ROADMAP A5)")
            if isinstance(layer, DenseLayer):
                x = layer.act(int8_dense(layer.param_dict(), x))
            else:
                x = layer(x, train=False)
        return x

    return forward


def roofline(M: int, K: int, N: int):
    """(operations, bytes) of one call, the reference's count
    (``:191-196``): 2·M·K·N, and M·K + K·N int8 in, 4·M·N f32 out,
    4·(M + N) of scales."""
    return 2.0 * M * K * N, float(M * K + K * N + 4 * M * N + 4 * (M + N))
