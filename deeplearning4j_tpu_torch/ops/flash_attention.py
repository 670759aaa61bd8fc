"""Flash-attention forward: a hand-written CUDA kernel for Hopper, its plain
PyTorch version, and the probe that decides when a layer takes it.

Counterpart of ``deeplearning4j_tpu/ops/pallas_attention.py``:
``fused_attention_applicable`` (its ``:61-87``), ``flash_attention``
(``:513-525``) and the forward kernel ``_fwd`` / ``_fwd_body``
(``:138-220``). The kernel is ``csrc/flash_attention_fwd.cu``; its source
says what it computes, what bounds it and what its simple design leaves for
later.

Dispatch: ``flash_attention_fwd`` on a CPU tensor computes the plain version
(``flash_attention_reference``); on a CUDA tensor it launches the kernel or
raises. There is no fallback around the kernel on the card. Each launch adds
one to ``flash_attention.launches``.

Build: on first use the source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``ops/_build/`` (named by
the source's hash, so an edited source rebuilds) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG = -1e30

# Head dims the kernel is compiled for. The TPU probe admits D in {64, 96}
# or any multiple of 128; the Hopper kernel keeps a quarter of a row's f32
# accumulator per thread, which stays in registers up to D = 256.
KERNEL_HEAD_DIMS = (64, 96, 128, 256)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "flash_attention_fwd.cu"
BUILD_DIR = _PKG / "ops" / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib_lock = threading.Lock()
_launcher = None        # the loaded C entry point, set once by _kernel()


def fused_attention_applicable(B: int, H: int, T: int, D: int,
                               dtype: torch.dtype) -> bool:
    """Can the kernel take this call? The TPU probe's rules (f32/bf16,
    T % 128 == 0 and T >= 256) with the head dims this kernel is built
    for. When False, callers take ``parallel.ring_attention.attention``,
    as the reference's layer does."""
    return (dtype in (torch.float32, torch.bfloat16)
            and D in KERNEL_HEAD_DIMS and T % 128 == 0 and T >= 256)


# --------------------------------------------------------------- the build
def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the flash-attention kernel "
                           "cannot be built")
    return found


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libflash_attention_fwd_{tag}.so"


def build() -> Path:
    """Compile the kernel for sm_90a unless this source's library exists.
    Returns the library path; nvcc's report (registers, shared memory,
    spills) is kept beside it with the suffix ``.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                           f"{SOURCE.name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _kernel():
    global _launcher
    with _lib_lock:
        if _launcher is None:
            fn = ctypes.CDLL(str(build())).dl4j_flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _launcher = fn
        return _launcher


# ----------------------------------------------------------- plain version
def flash_attention_reference(q3, k3, v3, causal: bool, scale: float,
                              key_mask=None) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The kernel's function in torch ops: q3/k3/v3 [BH,T,D], key_mask
    [B,T] or None. Returns (O [BH,T,D] in q3's dtype, lse [BH,T] f32).
    Scores are f32; causal and masked keys are filled with -1e30, as the
    TPU kernel fills them."""
    BH, T, _ = q3.shape
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        above = torch.ones(T, T, dtype=torch.bool,
                           device=q3.device).triu(diagonal=1)
        s = s.masked_fill(above, NEG)
    if key_mask is not None:
        hidden = ~(key_mask.to(torch.float32) > 0)                 # [B,T]
        hidden = hidden.repeat_interleave(BH // key_mask.shape[0], dim=0)
        s = s.masked_fill(hidden[:, None, :], NEG)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v3.float())
    return o.to(q3.dtype), lse


# ----------------------------------------------------------------- wrapper
def _check(q3, k3, v3, key_mask):
    if q3.dim() != 3 or k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError(f"q/k/v must share one [BH,T,D] shape, got "
                         f"{tuple(q3.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype) or \
            q3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q/k/v must all be float32 or bfloat16, got "
                         f"{q3.dtype}, {k3.dtype}, {v3.dtype}")
    if not (q3.device == k3.device == v3.device):
        raise ValueError("q/k/v must lie on one device")
    BH, T, D = q3.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built for "
                         f"{KERNEL_HEAD_DIMS}")
    if not (q3.is_contiguous() and k3.is_contiguous()
            and v3.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    if key_mask is not None:
        if key_mask.dim() != 2 or key_mask.shape[1] != T or \
                BH % key_mask.shape[0]:
            raise ValueError(f"key_mask must be [B,T] with B dividing "
                             f"BH={BH}, T={T}; got {tuple(key_mask.shape)}")
        if key_mask.device != q3.device:
            raise ValueError("key_mask must lie on q's device")


def flash_attention_fwd(q3, k3, v3, key_mask=None, *, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``_fwd`` counterpart: q3/k3/v3 [BH,T,D], key_mask [B,T] or None.
    Returns (O [BH,T,D], lse [BH,T] f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    if q3.device.type == "cpu":
        return flash_attention_reference(q3, k3, v3, causal, scale, key_mask)
    if q3.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, not "
                         f"{q3.device}")
    _check(q3, k3, v3, key_mask)
    BH, T, D = q3.shape
    mask = None
    heads = 1
    if key_mask is not None:
        mask = key_mask.to(torch.float32).contiguous()
        heads = BH // key_mask.shape[0]
    o = torch.empty_like(q3)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q3.device)
    launch = _kernel()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = launch(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), BH, heads, T, D,
                     int(q3.dtype == torch.bfloat16), int(bool(causal)),
                     float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed with CUDA "
                           f"error {err} (BH={BH}, T={T}, D={D}, "
                           f"{q3.dtype})")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, key_mask=None):
    """Fused softmax attention, [B,H,T,D] in and out: the drop-in for
    ``parallel.ring_attention.attention`` when
    ``fused_attention_applicable``. ``key_mask`` [B,T] excludes padded
    timesteps as keys."""
    B, H, T, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    # reshape may return a strided view (the layer's [B,T,H,D] -> [B,H,T,D]
    # transpose), and the kernel reads rows of D contiguous elements
    q3, k3, v3 = (t.reshape(B * H, T, D).contiguous() for t in (q, k, v))
    o, _ = flash_attention_fwd(q3, k3, v3, key_mask, causal=causal,
                               scale=scale)
    return o.reshape(B, H, T, D)


flash_attention.launches = 0     # kernel launches, counted in flash_attention_fwd
