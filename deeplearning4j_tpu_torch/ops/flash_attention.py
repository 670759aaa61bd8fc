"""Flash attention for Hopper: the forward kernel (K1), the two backward
kernels (K2 dq, K3 dk/dv), the ring hop's carry kernel (K4), their plain
PyTorch versions, the autograd Function that joins K1-K3, and the probes
that decide when a layer or a ring takes them.

Counterpart of ``deeplearning4j_tpu/ops/pallas_attention.py``:
``fused_attention_applicable`` (its ``:61-87``), ``flash_attention``
(``:513-525``), the ``custom_vjp`` ``_flash`` / ``_flash_fwd`` /
``_flash_bwd`` (``:490-510``), the forward kernel ``_fwd`` / ``_fwd_body``
(``:138-220``) and the backward ``_bwd`` with ``_dq_body`` / ``_dkv_body``
(``:224-389``), and for ring attention ``flash_block_update`` /
``_fwd_carry_body`` (``:393-470``), ``flash_block_bwd`` (``:473-479``) and
``fused_ring_applicable`` (``:482-486``). The kernels are
``csrc/flash_attention_fwd.cu`` (K1), ``csrc/flash_attention_bwd.cu`` (K2),
``csrc/flash_attention_bwd_dkv.cu`` (K3) and ``csrc/flash_block_update.cu``
(K4); each source says what it computes, what bounds it and what its
design leaves for later. K1, K2, K3 and K4 run bf16 on the tensor cores
(``wgmma``, ``csrc/hopper_mma.cuh``) and f32 in full f32 FMAs; K1 and K4
share the forward's key loop (``csrc/flash_fwd_tile.cuh``).

Dispatch: each kernel wrapper (``flash_attention_fwd``,
``flash_attention_bwd_dq``, ``flash_attention_bwd_dkv``,
``flash_block_update``) computes its plain
version on a CPU tensor and launches its kernel on a CUDA tensor or raises.
There is no fallback around a kernel on the card. Each launch adds one to
the wrapper's ``launches`` (the forward's count is
``flash_attention.launches``).

Build: on first use each source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``ops/_build/`` (named by
the source's hash, so an edited source rebuilds) and loaded with ``ctypes``
(``ops/nvcc.py``).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..telemetry.perf import note_kernel
from .nvcc import PKG, build_library, load_symbol
from .nvcc import library_path as _lib_path

NEG = -1e30
DEAD = -1e29            # an lse at or below this: the row sees no key

# Head dims the kernel is compiled for. The TPU probe admits D in {64, 96}
# or any multiple of 128; the Hopper kernels keep their f32 accumulators in
# registers up to D = 256 (D = 96 runs as 128 with zero columns).
KERNEL_HEAD_DIMS = (64, 96, 128, 256)

SOURCE = PKG / "csrc" / "flash_attention_fwd.cu"
BWD_SOURCE = PKG / "csrc" / "flash_attention_bwd.cu"
DKV_SOURCE = PKG / "csrc" / "flash_attention_bwd_dkv.cu"
BLOCK_UPDATE_SOURCE = PKG / "csrc" / "flash_block_update.cu"


def fused_attention_applicable(B: int, H: int, T: int, D: int,
                               dtype: torch.dtype) -> bool:
    """Can the kernel take this call? The TPU probe's rules (f32/bf16,
    T % 128 == 0 and T >= 256) with the head dims this kernel is built
    for. When False, callers take ``parallel.ring_attention.attention``,
    as the reference's layer does."""
    return (dtype in (torch.float32, torch.bfloat16)
            and D in KERNEL_HEAD_DIMS and T % 128 == 0 and T >= 256)


# --------------------------------------------------------------- the build
def library_path() -> Path:
    return _lib_path(SOURCE)


def bwd_library_path() -> Path:
    return _lib_path(BWD_SOURCE)


def build() -> Path:
    """Compile the forward kernel for sm_90a unless this source's library
    exists. Returns the library path; nvcc's report (registers, shared
    memory, spills) is kept beside it with the suffix ``.log``."""
    return build_library(SOURCE)


def build_bwd() -> Path:
    """Compile the backward's dq kernel, as ``build``."""
    return build_library(BWD_SOURCE)


def build_bwd_dkv() -> Path:
    """Compile the backward's dk/dv kernel, as ``build``."""
    return build_library(DKV_SOURCE)


def build_block_update() -> Path:
    """Compile the ring hop's carry kernel, as ``build``."""
    return build_library(BLOCK_UPDATE_SOURCE)


_P, _I = ctypes.c_void_p, ctypes.c_int
# symbol -> (its library's build function, argument types); every entry
# returns a CUDA error code
_ENTRIES = {
    "dl4j_flash_attention_fwd":
        (build, [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P]),
    "dl4j_flash_attention_bwd_dq":
        (build_bwd, [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P]),
    "dl4j_flash_attention_bwd_dkv":
        (build_bwd_dkv, [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P]),
    "dl4j_flash_attention_fwd_smem": (build, [_I, _I]),
    "dl4j_flash_attention_bwd_dq_smem": (build_bwd, [_I, _I]),
    "dl4j_flash_attention_bwd_dkv_smem": (build_bwd_dkv, [_I, _I]),
    "dl4j_flash_block_update":
        (build_block_update, [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P]),
    "dl4j_flash_block_update_smem": (build_block_update, [_I, _I]),
}


def _kernel(symbol: str):
    return load_symbol(symbol, *_ENTRIES[symbol])


def shared_memory_bytes(symbol: str, head_dim: int,
                        dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of K1 (``"dl4j_flash_attention_fwd"``),
    K2 (``"dl4j_flash_attention_bwd_dq"``), K3
    (``"dl4j_flash_attention_bwd_dkv"``) or K4
    (``"dl4j_flash_block_update"``) takes at this head dim and dtype, as the
    kernel's source sizes it (builds the library)."""
    return _kernel(f"{symbol}_smem")(head_dim, int(dtype == torch.bfloat16))


# ----------------------------------------------------------- plain version
def _scores(q3, k3, causal, scale, key_mask):
    """f32 scores [BH,T,T] with causal and masked keys filled with -1e30,
    as the TPU kernels fill them."""
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
    return s


def flash_attention_reference(q3, k3, v3, causal: bool, scale: float,
                              key_mask=None) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The forward kernel's function in torch ops: q3/k3/v3 [BH,T,D],
    key_mask [B,T] or None. Returns (O [BH,T,D] in q3's dtype, lse [BH,T]
    f32)."""
    s = _scores(q3, k3, causal, scale, key_mask)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v3.float())
    return o.to(q3.dtype), lse


def _bwd_probs(q3, k3, v3, dout, lse, delta, causal, scale, key_mask):
    """P and dS of the FA-2 backward, recomputed from lse and delta as both
    backward kernels do, each rounded to the input dtype as the operand of
    the products that take it. A row with no visible key (lse at or below
    -1e29, see ``csrc/flash_attention_bwd.cu``) takes P = 1/T and dS = 0,
    which is what autograd gives through the plain forward."""
    T = q3.shape[1]
    s = _scores(q3, k3, causal, scale, key_mask)
    dead = (lse <= DEAD)[..., None]
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dout.float(), v3.float().transpose(1, 2))
    ds = torch.where(dead, 0.0, p * (dp - delta[..., None]) * scale)
    p = torch.where(dead, 1.0 / T, p)
    dt = q3.dtype
    return p.to(dt).float(), ds.to(dt).float()


def flash_attention_bwd_dq_reference(q3, k3, v3, dout, lse, delta,
                                     causal: bool, scale: float,
                                     key_mask=None) -> torch.Tensor:
    """The dq kernel's function in torch ops: dq = dS.K in q's dtype."""
    _, ds = _bwd_probs(q3, k3, v3, dout, lse, delta, causal, scale,
                       key_mask)
    return torch.matmul(ds, k3.float()).to(q3.dtype)


def flash_attention_bwd_dkv_reference(q3, k3, v3, dout, lse, delta,
                                      causal: bool, scale: float,
                                      key_mask=None):
    """The dk/dv kernel's function in torch ops: dk = dS^T.Q and
    dv = P^T.dO, in k's and v's dtypes."""
    p, ds = _bwd_probs(q3, k3, v3, dout, lse, delta, causal, scale,
                       key_mask)
    dk = torch.matmul(ds.transpose(1, 2), q3.float())
    dv = torch.matmul(p.transpose(1, 2), dout.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_attention_bwd_reference(q3, k3, v3, dout, lse, delta,
                                  causal: bool, scale: float,
                                  key_mask=None):
    """The FA-2 backward in torch ops, both kernels' functions: q3/k3/v3/
    dout [BH,T,D], lse and delta = rowsum(dO*O) [BH,T] f32, key_mask [B,T]
    or None. Returns (dq, dk, dv) in the input dtype, products in f32."""
    args = (q3, k3, v3, dout, lse, delta, causal, scale, key_mask)
    return (flash_attention_bwd_dq_reference(*args),
            *flash_attention_bwd_dkv_reference(*args))


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


def _check_bwd(q3, k3, v3, dout, lse, delta, key_mask):
    _check(q3, k3, v3, key_mask)
    if dout.shape != q3.shape or dout.dtype != q3.dtype or \
            dout.device != q3.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous {tuple(q3.shape)} "
                         f"{q3.dtype} tensor on q's device")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q3.shape[:2] or t.dtype != torch.float32 or \
                t.device != q3.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"{tuple(q3.shape[:2])} float32 tensor on q's "
                             f"device")


def _on_cpu(q3) -> bool:
    if q3.device.type == "cpu":
        return True
    if q3.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, not "
                         f"{q3.device}")
    return False


def _launch(symbol: str, ins, key_mask, outs, *, causal: bool,
            scale: float) -> None:
    """Launch ``symbol`` on the current stream with pointers ``ins``, the
    key mask (or null) and ``outs``, then the shape, type and mode
    arguments every entry point takes; raise on a CUDA error."""
    q3 = ins[0]
    BH, T, D = q3.shape
    # K1, K2 and K3 copy rows in 16-byte pieces: a view that starts off a
    # 16-byte boundary is copied to fresh (aligned) memory first
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    mask, heads = None, 1
    if key_mask is not None:
        mask = key_mask.to(torch.float32).contiguous()
        heads = BH // key_mask.shape[0]
    fn = _kernel(symbol)
    ptrs = ([t.data_ptr() for t in ins]
            + [None if mask is None else mask.data_ptr()]
            + [t.data_ptr() for t in outs])
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = fn(*ptrs, BH, heads, T, D, int(q3.dtype == torch.bfloat16),
                 int(bool(causal)), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err} "
                           f"(BH={BH}, T={T}, D={D}, {q3.dtype})")


def _pairs(T: int, causal: bool) -> float:
    """Visible query/key pairs of one head: the kernels' analytic counts
    (``telemetry.note_kernel``) are flops a pair times these. They count
    model flops, 2·D a product of a pair: K1 4·D (S = QK^T, O = PV), the
    backward 8·D in all, K2 4·D (dP = dO V^T, dQ = dS K) and K3 4·D
    (dV = P^T dO, dK = dS^T Q). The backward kernels' recompute of S, and
    K3's second dP, are work the card does that the counts leave out, so
    ``mfu`` is not flattered by the recomputation."""
    return T * (T + 1) / 2 if causal else float(T * T)


def flash_attention_fwd(q3, k3, v3, key_mask=None, *, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``_fwd`` counterpart (K1): q3/k3/v3 [BH,T,D], key_mask [B,T] or
    None. Returns (O [BH,T,D], lse [BH,T] f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    if _on_cpu(q3):
        return flash_attention_reference(q3, k3, v3, causal, scale, key_mask)
    _check(q3, k3, v3, key_mask)
    o = torch.empty_like(q3)
    lse = torch.empty(q3.shape[:2], dtype=torch.float32, device=q3.device)
    _launch("dl4j_flash_attention_fwd", [q3, k3, v3], key_mask, [o, lse],
            causal=causal, scale=scale)
    flash_attention.launches += 1
    note_kernel(4.0 * q3.shape[2] * _pairs(q3.shape[1], causal) * q3.shape[0],
                q3, k3, v3, o, lse)
    return o, lse


def flash_attention_bwd_dq(q3, k3, v3, dout, lse, delta, key_mask=None, *,
                           causal: bool, scale: float) -> torch.Tensor:
    """The ``_dq_body`` pass (K2): dq [BH,T,D] in q's dtype from q/k/v/dout
    [BH,T,D], K1's lse and delta [BH,T] f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    if _on_cpu(q3):
        return flash_attention_bwd_dq_reference(q3, k3, v3, dout, lse, delta,
                                                causal, scale, key_mask)
    _check_bwd(q3, k3, v3, dout, lse, delta, key_mask)
    dq = torch.empty_like(q3)
    _launch("dl4j_flash_attention_bwd_dq", [q3, k3, v3, dout, lse, delta],
            key_mask, [dq], causal=causal, scale=scale)
    flash_attention_bwd_dq.launches += 1
    note_kernel(4.0 * q3.shape[2] * _pairs(q3.shape[1], causal) * q3.shape[0],
                q3, k3, v3, dout, lse, delta, dq)
    return dq


def flash_attention_bwd_dkv(q3, k3, v3, dout, lse, delta, key_mask=None, *,
                            causal: bool, scale: float):
    """The ``_dkv_body`` pass (K3): (dk, dv) [BH,T,D] in k's and v's dtypes,
    from the same inputs as ``flash_attention_bwd_dq``."""
    if _on_cpu(q3):
        return flash_attention_bwd_dkv_reference(q3, k3, v3, dout, lse,
                                                 delta, causal, scale,
                                                 key_mask)
    _check_bwd(q3, k3, v3, dout, lse, delta, key_mask)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launch("dl4j_flash_attention_bwd_dkv", [q3, k3, v3, dout, lse, delta],
            key_mask, [dk, dv], causal=causal, scale=scale)
    flash_attention_bwd_dkv.launches += 1
    note_kernel(4.0 * q3.shape[2] * _pairs(q3.shape[1], causal) * q3.shape[0],
                q3, k3, v3, dout, lse, delta, dk, dv)
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward and K2/K3 backward as one differentiable op on
    [B,H,T,D] q/k/v: the ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``
    ``custom_vjp`` of the reference. The forward saves the [BH,T,D]
    operands, O, lse and the key mask; the backward takes
    delta = rowsum(dO*O) in f32, as the reference does outside its kernels,
    then the dq and dk/dv passes. The key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal: bool, scale: float):
        B, H, T, D = q.shape
        # reshape may return a strided view (the layer's [B,T,H,D] ->
        # [B,H,T,D] transpose); the kernels read rows of D contiguous values
        q3, k3, v3 = (t.reshape(B * H, T, D).contiguous() for t in (q, k, v))
        o3, lse = flash_attention_fwd(q3, k3, v3, key_mask, causal=causal,
                                      scale=scale)
        ctx.save_for_backward(q3, k3, v3, o3, lse, key_mask)
        ctx.causal, ctx.scale = causal, scale
        return o3.reshape(B, H, T, D)

    @staticmethod
    def backward(ctx, dout):
        q3, k3, v3, o3, lse, key_mask = ctx.saved_tensors
        do3 = dout.reshape(o3.shape).to(o3.dtype).contiguous()
        delta = (do3.float() * o3.float()).sum(dim=-1)
        args = (q3, k3, v3, do3, lse, delta, key_mask)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_attention_bwd_dq(*args, **kw)
        dk, dv = flash_attention_bwd_dkv(*args, **kw)
        shape = dout.shape
        return (dq.reshape(shape), dk.reshape(shape), dv.reshape(shape),
                None, None, None)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, key_mask=None):
    """Fused softmax attention, [B,H,T,D] in and out: the drop-in for
    ``parallel.ring_attention.attention`` when
    ``fused_attention_applicable``. ``key_mask`` [B,T] excludes padded
    timesteps as keys. Differentiable in q, k and v on both devices."""
    D = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    return FlashAttentionFunction.apply(q, k, v, key_mask, bool(causal),
                                        scale)


flash_attention.launches = 0     # K1 launches, counted in flash_attention_fwd
flash_attention_bwd_dq.launches = 0      # K2 launches
flash_attention_bwd_dkv.launches = 0     # K3 launches


# ------------------------------------------------- the ring hop (K4)
def fused_ring_applicable(t_local: int, D: int, dtype: torch.dtype) -> bool:
    """Can the ring take the carry kernel? The TPU probe's rules (f32/bf16,
    the per-worker sequence block ``t_local = T / ring_size`` a positive
    multiple of 128) with the head dims the kernels are built for."""
    return (dtype in (torch.float32, torch.bfloat16)
            and D in KERNEL_HEAD_DIMS and t_local > 0 and t_local % 128 == 0)


def flash_block_update_reference(acc, m, l, q3, k3, v3, causal: bool,
                                 scale: float):
    """The carry kernel's function in torch ops: fold the [BH,Tq,D] x
    [BH,Tk,D] block into the carry (acc [BH,Tq,D], m, l [BH,Tq], all f32)
    and return it raw. ``causal`` is the ring's diagonal hop (Tq == Tk):
    keys above the diagonal are filled with -1e30. P is rounded to v's dtype
    before the P.V product, as the kernel rounds it."""
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        Tq, Tk = s.shape[1:]
        above = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=q3.device).triu(diagonal=1)
        s = s.masked_fill(above, NEG)
    m_new = torch.maximum(m, s.max(dim=-1).values)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.matmul(
        p.to(v3.dtype).float(), v3.float())
    return acc_new, m_new, l_new


def _check_block_update(acc, m, l, q3, k3, v3, causal):
    if q3.dim() != 3 or k3.dim() != 3 or k3.shape != v3.shape or \
            q3.shape[0] != k3.shape[0] or q3.shape[2] != k3.shape[2]:
        raise ValueError(f"q must be [BH,Tq,D] and k/v [BH,Tk,D], got "
                         f"{tuple(q3.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype) or \
            q3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q/k/v must all be float32 or bfloat16, got "
                         f"{q3.dtype}, {k3.dtype}, {v3.dtype}")
    BH, Tq, D = q3.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built for "
                         f"{KERNEL_HEAD_DIMS}")
    if causal and Tq != k3.shape[1]:
        raise ValueError(f"causal is the diagonal hop: Tq {Tq} must equal "
                         f"Tk {k3.shape[1]}")
    for name, t, shape in (("acc", acc, (BH, Tq, D)), ("m", m, (BH, Tq)),
                           ("l", l, (BH, Tq))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"the carry's {name} must be a float32 "
                             f"{shape} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (acc, m, l, q3, k3, v3):
        if t.device != q3.device or not t.is_contiguous():
            raise ValueError("the carry and q/k/v must be contiguous and "
                             "lie on one device")


def flash_block_update(acc, m, l, q3, k3, v3, *, causal: bool, scale: float):
    """The ``flash_block_update`` counterpart (K4): one ring hop's block
    folded into the running online-softmax carry without the [Tq,Tk] scores
    ever reaching device memory. acc [BH,Tq,D], m and l [BH,Tq], all f32
    (the first hop passes m = -1e30, l = 0, acc = 0). Returns the updated
    carry raw, in fresh tensors (the incoming carry is left as it was; the
    caller normalises after the last hop). CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    if _on_cpu(q3):
        return flash_block_update_reference(acc, m, l, q3, k3, v3, causal,
                                            scale)
    _check_block_update(acc, m, l, q3, k3, v3, causal)
    BH, Tq, D = q3.shape
    Tk = k3.shape[1]
    # the kernel copies q/k/v rows and reads the carry's acc in 16-byte
    # pieces: a view off a 16-byte boundary is copied to fresh memory first
    q3, k3, v3, acc = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (q3, k3, v3, acc))
    outs = (torch.empty_like(acc), torch.empty_like(m), torch.empty_like(l))
    fn = _kernel("dl4j_flash_block_update")
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q3, k3, v3, acc, m, l, *outs)),
                 BH, Tq, Tk, D, int(q3.dtype == torch.bfloat16),
                 int(bool(causal)), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"dl4j_flash_block_update launch failed with CUDA "
                           f"error {err} (BH={BH}, Tq={Tq}, Tk={Tk}, D={D}, "
                           f"{q3.dtype})")
    flash_block_update.launches += 1
    return outs


def flash_block_bwd(q3, k3, v3, o3, lse, do3, *, causal: bool, scale: float):
    """One ring hop's backward contribution (FA-2 math with the GLOBAL
    logsumexp, so the hops' contributions sum exactly): (dq_contrib, dk,
    dv) for this (q, k-block) pair through the dq and dk/dv kernels (K2,
    K3; their plain versions on CPU tensors). q3/k3/v3/o3/do3 [BH,t,D],
    lse [BH,t] f32."""
    do3 = do3.to(o3.dtype).contiguous()
    delta = (do3.float() * o3.float()).sum(dim=-1)
    args = (q3, k3, v3, do3, lse, delta)
    dq = flash_attention_bwd_dq(*args, causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv(*args, causal=causal, scale=scale)
    return dq, dk, dv


flash_block_update.launches = 0          # K4 launches
