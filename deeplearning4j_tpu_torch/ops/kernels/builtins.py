"""Builtin kernel registrations: the library's spine.

Counterpart of ``deeplearning4j_tpu/ops/kernels/builtins.py``: the same
five names, each with the reference's parity pin (its shapes, its draws
from ``np.random.default_rng(seed)`` in the same order, its tolerance)
and its roofline formula with the same shape-signature string
(``builtins.py:36``, ``:97``, ``:141``, ``quantized.py:191``,
``conv.py:165``). The attention formula counts the full T² square and f32
bytes, as the reference's does, also for a causal call.

``tunable`` and ``default_choice`` describe the port's tiling, never the
TPU's: K1-K4 have fixed tiles; K5 and K6 take ``fwd_plan`` / ``loop_plan``
(``ops/lstm.py``); K7 and K8 take ``tile_plan`` (``conv.py``,
``quantized.py``). The plans are analytic (the card's co-residency and SM
count), so nothing here is measured.

Imported lazily by ``registry._ensure_builtins()``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...device import resolve_device
from .registry import KernelSpec, ParityPin, register


def _draw(rng, shape, scale=1.0, device=None):
    """``rng.standard_normal(shape) * scale`` as an f32 tensor on
    ``device``: the reference's ``jnp.asarray(..., f32)`` of the same
    draw."""
    a = np.asarray(rng.standard_normal(shape) * scale, np.float32)
    return torch.from_numpy(a).to(device)


# --------------------------------------------------------------- attention
def _attention_parity(seed: int, device=None):
    from .. import flash_attention as fa
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, H, T, D = 1, 2, 256, 64
    q, k, v = (_draw(rng, (B, H, T, D), 0.3, dev).reshape(B * H, T, D)
               for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    fused, _ = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    plain, _ = fa.flash_attention_reference(q, k, v, True, scale)
    return [fused.reshape(B, H, T, D)], [plain.reshape(B, H, T, D)]


def _attention_roofline(shape_sig: str):
    B, H, T, D = (int(v) for v in shape_sig.split("x"))
    flops = 4.0 * B * H * T * T * D          # QK^T + PV
    nbytes = 4.0 * 4 * B * H * T * D         # q/k/v/o, f32
    return flops, nbytes


def _register_attention():
    from .. import flash_attention as fa
    register(KernelSpec(
        name="attention",
        fused=fa.flash_attention,
        fallback=fa.flash_attention_reference,
        applicable=fa.fused_attention_applicable,
        parity=ParityPin(run=_attention_parity, tol=2e-5,
                         note="online-softmax f32 recurrence vs one-shot "
                              "softmax: associativity-level error only"),
        roofline=_attention_roofline,
        dtype="float32",
        tunable="none: fixed tiles (K1 (BQ, BK) = (64, 64) f32, (128, 64) "
                "bf16; K2 and K3 64-row tiles; K4 K1's key loop)",
        default_choice=(64, 64),
        notes="flash attention: K1 forward (the pin), K2 dq and K3 dk/dv "
              "backward, K4 one ring hop into a carry; O(T) HBM traffic",
    ))


# -------------------------------------------------------------------- lstm
def _lstm_parity(seed: int, device=None):
    from .. import lstm
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    T, B, H = 4, 8, 128
    xp = _draw(rng, (T, B, 4 * H), 0.3, dev)
    h0 = _draw(rng, (B, H), 0.1, dev)
    c0 = _draw(rng, (B, H), 0.1, dev)
    R = _draw(rng, (H, 4 * H), 0.1, dev)
    got = lstm.fused_lstm_fwd(xp, h0, c0, R)
    want = lstm.lstm_fwd_reference(xp, h0, c0, R)
    return [got[0], got[5], got[6]], [want[0], want[5], want[6]]


def _lstm_roofline(shape_sig: str):
    T, B, H = (int(v) for v in shape_sig.split("x"))
    flops = T * 2.0 * B * H * 4 * H          # the recurrent gemm chain
    nbytes = 4.0 * (16 * H * H + T * B * 4 * H + T * B * H)
    return flops, nbytes


def _register_lstm():
    from .. import lstm
    register(KernelSpec(
        name="lstm",
        fused=lstm.fused_lstm_fwd,
        fallback=lstm.lstm_fwd_reference,
        applicable=lstm.fused_lstm_applicable,
        parity=ParityPin(run=_lstm_parity, tol=1e-5,
                         note="one cooperative launch vs the step loop"),
        roofline=_lstm_roofline,
        dtype="float32",
        tunable="fwd_plan / loop_plan: (blocks a cluster, units a "
                "cluster) of (2, 8) or (2, 16), the most blocks whose "
                "clusters the card holds at once (analytic)",
        default_choice=(2, 8),
        notes="K5 the fused LSTM time loop (the pin), K6 its reverse "
              "loop with dR folded in; plain and peephole variants",
    ))


# -------------------------------------------------------- threshold_encode
def _encode_parity(seed: int, device=None):
    from ..threshold_encode import (threshold_encode_fused,
                                    threshold_encode_plain)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = (1 << 16) + 777          # one full block + ragged tail
    r = _draw(rng, (n,), 1e-3, dev)
    thr = 1e-3
    s1, nr1 = threshold_encode_fused(r, thr)
    s2, nr2 = threshold_encode_plain(r, thr)
    return [s1, nr1], [s2, nr2]


def _encode_roofline(shape_sig: str):
    n = int(shape_sig)
    return 3.0 * n, 9.0 * n      # compare+sub+mul; 4B in + 1B + 4B out


def _register_encode():
    # names from the module path: ``ops`` exports the function
    # threshold_encode, which hides the module of that name
    from ..threshold_encode import (fused_threshold_encode_applicable,
                                    threshold_encode_fused,
                                    threshold_encode_plain)
    register(KernelSpec(
        name="threshold_encode",
        fused=threshold_encode_fused,
        fallback=threshold_encode_plain,
        applicable=fused_threshold_encode_applicable,
        parity=ParityPin(run=_encode_parity, tol=0.0,
                         note="bit-identical by construction (same "
                              "elementwise ops)"),
        roofline=_encode_roofline,
        dtype="float32",
        tunable="none: 256-thread blocks, 16-byte vectors, at most 8 "
                "blocks an SM (bytes-bound)",
        default_choice=(256,),
        notes="K9: one-pass sign-map encode + residual update",
    ))


# ------------------------------------------------------------- int8_matmul
def _int8_parity(seed: int, device=None):
    from . import quantized as qz
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    M, K, N = 64, 256, 256
    x = _draw(rng, (M, K), 1.0, dev)
    w = _draw(rng, (K, N), 1.0, dev)
    w_q, w_s = qz.quantize_weights(w)
    x_q, x_s = qz.quantize_rows(x)
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    fused = qz.int8_matmul_fused(x_q, w_q, x_s, w_s)
    plain = qz.int8_matmul_plain(x_q, w_q, x_s, w_s)
    return [fused], [plain]


def _int8_roofline(shape_sig: str):
    from . import quantized as qz
    M, K, N = (int(v) for v in shape_sig.split("x"))
    return qz.roofline(M, K, N)


def _register_int8_matmul():
    from . import quantized as qz
    register(KernelSpec(
        name="int8_matmul",
        fused=qz.int8_matmul_fused,
        fallback=qz.int8_matmul_plain,
        applicable=qz.int8_matmul_applicable,
        parity=ParityPin(run=_int8_parity, tol=0.0,
                         note="exact int32 accumulation both paths"),
        roofline=_int8_roofline,
        dtype="int8",
        tunable="tile_plan: 16x32 int8 output tiles, K split over 1-8 "
                "blocks of a cluster until a call has >= 64 blocks",
        default_choice=(16, 32),
        notes="K8: dynamic per-row activation scales x static "
              "per-channel weight scales, f32 rescale",
    ))


# -------------------------------------------------------- conv1x1_bias_relu
def _conv_parity(seed: int, device=None):
    from . import conv as cv
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N, H, Wd, C, F = 2, 4, 4, 128, 128
    x = _draw(rng, (N, H, Wd, C), 1.0, dev)
    W = _draw(rng, (1, 1, C, F), 0.1, dev)
    b = _draw(rng, (F,), 0.1, dev)
    xm, wm = x.reshape(-1, C), W.reshape(C, F)
    fused = cv.conv1x1_fused(xm, wm, b).reshape(N, H, Wd, F)
    plain = cv._conv1x1_plain(xm, wm, b).reshape(N, H, Wd, F)
    return [fused], [plain]


def _conv_roofline(shape_sig: str):
    from . import conv as cv
    M, C, F = (int(v) for v in shape_sig.split("x"))
    return cv.roofline(M, C, F)


def _register_conv():
    from . import conv as cv
    register(KernelSpec(
        name="conv1x1_bias_relu",
        fused=cv.conv1x1_bias_relu,
        fallback=cv._conv1x1_plain,
        applicable=cv.conv1x1_bias_relu_applicable,
        parity=ParityPin(run=_conv_parity, tol=1e-5,
                         note="same f32-accumulate recipe both paths"),
        roofline=_conv_roofline,
        dtype="float32",
        tunable="tile_plan: (BM, BN) of 64x32, 64x64, 128x32, C split "
                "over a cluster of up to 8, 2.5-4.5 blocks an SM",
        default_choice=(64, 32),
        notes="K7: pointwise conv + bias + relu in one write; the "
              "reference's plain backward",
    ))


for _reg in (_register_attention, _register_lstm, _register_encode,
             _register_int8_matmul, _register_conv):
    _reg()
