"""Threshold encode for Hopper: the one-pass kernel (K9) that turns a flat
residual into its int8 sign map and its error-feedback residual, its plain
PyTorch version, and the probe that decides when the dense encoder takes it.

Counterpart of ``deeplearning4j_tpu/ops/pallas_compression.py``:
``fused_threshold_encode_applicable`` (its ``:56-71``, without the
environment switches: the port has none around a kernel),
``threshold_encode_pallas`` (``:89-116``) and ``_encode_kernel``
(``:78-86``). The kernel is ``csrc/threshold_encode.cu``; the source says
what bounds it (bytes: 9 an element in f32, 5 in bf16) and how it reads.

Dispatch: ``threshold_encode_fused`` computes the plain version on a CPU
tensor and launches the kernel on a CUDA tensor or raises. There is no
fallback around the kernel on the card. Each launch adds one to
``threshold_encode_fused.launches``. The two are pinned bitwise equal (the
reference's parity pin for this kernel is 0.0).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .nvcc import PKG, build_library, load_symbol

SOURCE = PKG / "csrc" / "threshold_encode.cu"
# Below this many elements the dense encoder stays on stock elementwise
# ops, as the reference's probe keeps sub-block residuals off its kernel.
MIN_ELEMENTS = 1 << 16


def fused_threshold_encode_applicable(n: int, dtype: torch.dtype) -> bool:
    """Can the kernel take a flat [n] residual? The TPU probe's rules:
    f32 or bf16 and at least one 64K block of elements."""
    return dtype in (torch.float32, torch.bfloat16) and n >= MIN_ELEMENTS


def build() -> Path:
    """Compile the kernel for sm_90a unless this source's library exists."""
    return build_library(SOURCE)


_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_int, _P]


def threshold_in_dtype(threshold: float, dtype: torch.dtype) -> torch.Tensor:
    """The threshold rounded to the residual's dtype before any compare, as
    the reference's ``jnp.asarray(threshold, r.dtype)`` (for bf16 that
    changes its value). A 0-d CPU tensor."""
    return torch.tensor(float(threshold), dtype=dtype)


# ----------------------------------------------------------- plain version
def xla_sign(r: torch.Tensor) -> torch.Tensor:
    """sign(r) with a zero keeping its own sign, as XLA's sign does
    (``torch.sign(-0.)`` is +0)."""
    return torch.where(r == 0, r, torch.sign(r))


def threshold_encode_plain(residual: torch.Tensor, threshold: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch ops, every step in the residual's
    dtype: ``s = sign(r) where |r| >= t else 0``; returns ``(int8(s),
    r - s * t)``. NaN compares false, so it ships sign 0 and stays in the
    residual."""
    t = threshold_in_dtype(threshold, residual.dtype).to(residual.device)
    s = torch.where(residual.abs() >= t, xla_sign(residual),
                    torch.zeros((), dtype=residual.dtype,
                                device=residual.device))
    return s.to(torch.int8), residual - s * t


# ----------------------------------------------------------------- wrapper
def threshold_encode_fused(residual: torch.Tensor, threshold: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``threshold_encode_pallas`` counterpart (K9): a flat [n] f32 or
    bf16 residual in, ``(signs int8[n], new_residual [n])`` out, in one pass.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on the current stream into fresh outputs. A contiguous 1-D view at any
    element offset is taken as it is (a row of an [n, P] carry)."""
    if residual.dim() != 1:
        raise ValueError(f"threshold_encode_fused expects the flat 1-D "
                         f"gradient view, got shape {tuple(residual.shape)}")
    if residual.device.type == "cpu":
        return threshold_encode_plain(residual, threshold)
    if residual.device.type != "cuda":
        raise ValueError(f"threshold encode runs on CPU or CUDA tensors, "
                         f"not {residual.device}")
    if residual.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the residual must be float32 or bfloat16, got "
                         f"{residual.dtype}")
    n = residual.shape[0]
    if n < 1 or not residual.is_contiguous():
        raise ValueError("the residual must be a non-empty contiguous 1-D "
                         "tensor")
    signs = torch.empty(n, dtype=torch.int8, device=residual.device)
    new_residual = torch.empty_like(residual)
    t = float(threshold_in_dtype(threshold, residual.dtype))
    fn = load_symbol("dl4j_threshold_encode", build, _ARGTYPES)
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream(residual.device).cuda_stream
        err = fn(residual.data_ptr(), signs.data_ptr(),
                 new_residual.data_ptr(), n, t,
                 int(residual.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dl4j_threshold_encode launch failed with CUDA "
                           f"error {err} (n={n}, {residual.dtype})")
    threshold_encode_fused.launches += 1
    return signs, new_residual


threshold_encode_fused.launches = 0     # K9 launches


def roofline_bytes(n: int, dtype: torch.dtype) -> int:
    """Bytes the function must move: the residual read once, the sign map
    and the new residual written once."""
    item = torch.finfo(dtype).bits // 8
    return n * (2 * item + 1)
