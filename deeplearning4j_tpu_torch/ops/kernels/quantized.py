"""The int8 serving tier: dynamic-quantized matmul for Hopper (K8), its plain
PyTorch version, the quantizers around it and the serving ``forward_fn``.

Counterpart of ``deeplearning4j_tpu/ops/kernels/quantized.py``: weights get
static symmetric per-output-channel scales (amax/127 over the input dim),
activations dynamic symmetric per-row scales; the product of the int8
values is summed exactly in int32 and rescaled once in f32 as
``(f32(acc) * x_scale[m]) * w_scale[n]``. Exact integer sums make the
kernel (``csrc/int8_matmul.cu``) and the plain version bitwise equal: the
reference pins this kernel at 0.0. The source says what bounds the kernel
and what its simple design leaves.

The port's probe admits any M, K, N >= 1; the TPU probe also needs
M % 32, K % 128 and N % 128 (``:75``). Both compute the same function
(ROADMAP §C). The quantizers, ``int8_dense`` and ``int8_forward_fn`` are
plain torch, as the reference computes them outside Pallas; ``torch.round``
rounds half to even, as ``jnp.round`` does.

Dispatch: the wrapper ``int8_matmul_fused`` computes the plain version on a
CPU tensor and launches K8 on a CUDA tensor or raises; each launch adds one
to ``int8_matmul_fused.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..nvcc import PKG, build_library, load_symbol

SOURCE = PKG / "csrc" / "int8_matmul.cu"
_SYMBOL = "dl4j_int8_matmul"
_P, _I = ctypes.c_void_p, ctypes.c_int


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


def int8_matmul_fused(x_q, w_q, x_scale, w_scale):
    """The ``int8_matmul_pallas`` counterpart: x_q [M,K] int8 · w_q [K,N]
    int8 -> [M,N] f32, rescaled by x_scale [M] and w_scale [N]. CPU tensors
    take the plain version; CUDA tensors launch K8 on the current
    stream."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, w_q, x_scale, w_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"K8 runs on CPU or CUDA tensors, not {x_q.device}")
    M, K = x_q.shape
    N = w_q.shape[1]
    for name, t, shape, dtype in (
            ("x_q", x_q, (M, K), torch.int8), ("w_q", w_q, (K, N), torch.int8),
            ("x_scale", x_scale, (M,), torch.float32),
            ("w_scale", w_scale, (N,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != x_q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {x_q.device}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if not int8_matmul_applicable(M, K, N) or max(M * K, K * N,
                                                  M * N) >= 2 ** 31:
        raise ValueError(f"K8 takes 1 <= M, K, N with every operand under "
                         f"2^31 elements; got M={M} K={K} N={N}")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    fn = load_symbol(_SYMBOL, build, [_P] * 5 + [_I] * 3 + [_P])
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = fn(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"{_SYMBOL} launch failed with CUDA error {err} "
                           f"(M={M}, K={K}, N={N})")
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
