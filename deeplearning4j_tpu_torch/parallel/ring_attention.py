"""Ring attention: sequence parallelism over a mesh axis, and the plain
softmax attention it is held against.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``:
``attention`` (``:52-68``), ``_block_update`` (``:33-49``), the plain ring
``_ring_body`` (``:71-99``), the fused ring ``_ring_fused_fwd``
(``:116-158``) with its backward ``_ring_fused_bwd_rule`` (``:172-217``) as
one ``torch.autograd.Function``, ``_ring_body_fused``,
``ring_attention_sharded`` (``:230-285``) and ``sequence_sharding``
(``:288``).

The sequence is cut over a mesh axis: each worker holds one Q/K/V block,
the K/V blocks travel round the ring (``ppermute_next``) while an online
softmax folds each visiting block into a running (acc, m, l), so a worker
never holds more than O(T/n) of the sequence. The workers are the rows of
``parallel/mesh.py``'s logical mesh: every body below takes and returns
tensors with the worker axis leading, and a hop runs the workers one after
the other on the one device. The plain ring materialises one [t, t] score
block a hop; the fused ring folds each hop through the carry kernel
(``ops.flash_attention.flash_block_update``, K4) and its backward through
the dq and dk/dv kernels (K2, K3) with the global logsumexp.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import check_same_device
from ..ops.flash_attention import (KERNEL_HEAD_DIMS, flash_block_bwd,
                                   flash_block_update, fused_ring_applicable)
from .mesh import Mesh, Sharding, axis_index, axis_size, ppermute_next


def attention(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None, key_mask=None):
    """[B,H,T,D] in and out. ``key_mask`` [B,Tk] excludes padded timesteps
    as keys with -1e30 (so a fully masked query row is uniform, not NaN).
    Causal fills with -1e30 when a key mask is given and with -inf
    otherwise, as the reference does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_mask is not None:
        visible = key_mask.to(q.dtype)[:, None, None, :] > 0
        s = s.masked_fill(~visible, -1e30)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        above = torch.ones(tq, tk, dtype=torch.bool,
                           device=q.device).triu(diagonal=tk - tq + 1)
        s = s.masked_fill(above, -1e30 if key_mask is not None
                          else float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)


def _block_update(acc, m, l, q, k, v, scale, mask=None):
    """One block of the online-softmax recurrence: q [...,Tq,D], k/v
    [...,Tk,D]; carry (acc [...,Tq,D], m, l [...,Tq]). A masked score is
    -inf and a block that is masked whole adds nothing."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m_new = torch.maximum(m, s.max(dim=-1).values)
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    seen = torch.isfinite(s)
    p = torch.where(seen, torch.exp(torch.where(
        seen, s - safe_m[..., None], float("-inf"))), 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.matmul(p, v)
    return acc_new, m_new, l_new


def _ring_body(q, k0, v0, mesh, axis, causal, scale, t_local):
    """The plain ring on per-worker blocks [n,B,H,t,D]: each worker's q
    stays, k/v travel n hops, the online softmax accumulates across them.
    Stock torch ops throughout, so autograd gives its gradient."""
    n = axis_size(mesh, axis)
    idx = axis_index(mesh, axis)
    Tq = q.shape[-2]
    acc = torch.zeros_like(q)
    m = torch.full(q.shape[:-1], float("-inf"), dtype=q.dtype,
                   device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    k, v = k0, v0
    pos = torch.arange(Tq, device=q.device)
    for j in range(n):
        mask = None
        if causal:
            src = (idx - j) % n     # whose k/v block each worker holds now
            q_pos = idx[:, None, None] * t_local + pos[None, :, None]
            k_pos = src[:, None, None] * t_local + pos[None, None, :]
            mask = (k_pos <= q_pos)[:, None, None]        # [n,1,1,Tq,Tk]
        acc, m, l = _block_update(acc, m, l, q, k, v, scale, mask)
        k = ppermute_next(k, mesh, axis)
        v = ppermute_next(v, mesh, axis)
    return acc / torch.clamp(l, min=1e-20)[..., None]


# ------------------------------------------------------------- fused ring
# With equal blocks the causal relation between a worker's q block and the
# visiting k/v block is one of three cases: wholly visible (src < idx), the
# diagonal (src == idx), wholly hidden (src > idx). So the hop is the carry
# kernel without a mask, the same kernel with its causal mask, or nothing,
# and the kernel needs no global offsets.

def _hop_kind(causal: bool, i: int, j: int, n: int) -> str:
    if not causal:
        return "full"
    src = (i - j) % n
    return "diag" if src == i else ("full" if src < i else "skip")


def _ring_fused_fwd(q3, k3, v3, mesh, axis, causal, scale):
    """q3/k3/v3 [n,BH,t,D] -> (o3 [n,BH,t,D] in q's dtype, lse [n,BH,t]
    f32). Each worker's carry starts at (0, -1e30, 0) and takes one
    ``flash_block_update`` a visible hop."""
    n = axis_size(mesh, axis)
    _, BH, t, D = q3.shape
    f32 = dict(dtype=torch.float32, device=q3.device)
    carry = [(torch.zeros(BH, t, D, **f32), torch.full((BH, t), -1e30, **f32),
              torch.zeros(BH, t, **f32)) for _ in range(n)]
    k, v = k3, v3
    for j in range(n):
        for i in range(n):
            kind = _hop_kind(causal, i, j, n)
            if kind != "skip":
                carry[i] = flash_block_update(
                    *carry[i], q3[i], k[i], v[i], causal=(kind == "diag"),
                    scale=scale)
        k = ppermute_next(k, mesh, axis)
        v = ppermute_next(v, mesh, axis)
    acc, m, l = (torch.stack(ts) for ts in zip(*carry))
    # a row that gathered no probability mass gives zeros, not NaN
    o3 = (acc / torch.clamp(l, min=1e-20)[..., None]).to(q3.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o3, lse


class _RingFused(torch.autograd.Function):
    """The fused ring as one differentiable op on per-worker blocks
    [n,BH,t,D]: the reference's ``_ring_fused`` ``custom_vjp``. The
    backward is the ring decomposition: per hop the FA-2 contribution with
    the global logsumexp; dq stays with its worker, dk and dv travel with
    their k/v blocks and land home after n hops."""

    @staticmethod
    def forward(ctx, q3, k3, v3, mesh, axis, causal, scale):
        q3, k3, v3 = (x.contiguous() for x in (q3, k3, v3))
        o3, lse = _ring_fused_fwd(q3, k3, v3, mesh, axis, causal, scale)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.ring = (mesh, axis, causal, scale)
        return o3

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.ring
        n = axis_size(mesh, axis)
        do3 = do3.to(o3.dtype).contiguous()
        f32 = torch.float32
        dq = torch.zeros(q3.shape, dtype=f32, device=q3.device)
        dk = torch.zeros(k3.shape, dtype=f32, device=q3.device)
        dv = torch.zeros(v3.shape, dtype=f32, device=q3.device)
        k, v = k3, v3
        for j in range(n):
            for i in range(n):
                kind = _hop_kind(causal, i, j, n)
                if kind == "skip":
                    continue
                dq_c, dk_c, dv_c = flash_block_bwd(
                    q3[i], k[i], v[i], o3[i], lse[i], do3[i],
                    causal=(kind == "diag"), scale=scale)
                dq[i] += dq_c
                dk[i] += dk_c
                dv[i] += dv_c
            k, v, dk, dv = (ppermute_next(x, mesh, axis)
                            for x in (k, v, dk, dv))
        return (dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype),
                None, None, None, None)


def _ring_body_fused(q, k0, v0, mesh, axis, causal, scale):
    n, B, H, t, D = q.shape
    o3 = _RingFused.apply(q.reshape(n, B * H, t, D),
                          k0.reshape(n, B * H, t, D),
                          v0.reshape(n, B * H, t, D), mesh, axis, causal,
                          scale)
    return o3.reshape(n, B, H, t, D)


def sequence_sharding(mesh: Mesh, axis: str = "seq") -> Sharding:
    """Sharding for [B,H,T,D] tensors with the time axis on ``axis``."""
    axis_size(mesh, axis)
    return Sharding(mesh, axis, 2)


def ring_attention_sharded(mesh: Mesh, axis: str = "seq", *,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           use_fused: Optional[bool] = None):
    """Build the ring-attention function over ``mesh``: it takes q, k, v
    [B,H,T,D] on the mesh's device with T dividing evenly over ``axis``,
    cuts them into the workers' blocks, runs the ring and returns the
    [B,H,T,D] output, differentiable in q, k and v.

        fn = ring_attention_sharded(mesh, "seq", causal=True)
        out = fn(q, k, v)

    ``use_fused``: None (default) asks ``fused_ring_applicable`` and takes
    the carry kernel when the local block qualifies; True forces it (any
    shape the kernels take: a positive multiple of 128 and a head dim they
    are built for), False keeps the plain ring."""
    n = axis_size(mesh, axis)
    sharding = sequence_sharding(mesh, axis)

    def fn(q, k, v):
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_same_device(name, x.device, mesh.device)
        D = q.shape[-1]
        sc = float(scale) if scale is not None else 1.0 / math.sqrt(D)
        t_local = q.shape[2] // n
        fused = use_fused
        if fused is None:
            fused = fused_ring_applicable(t_local, D, q.dtype)
        elif fused and not (t_local > 0 and t_local % 128 == 0
                            and D in KERNEL_HEAD_DIMS):
            # refuse the explicit opt-in here, at the misuse site
            raise ValueError(
                f"use_fused=True, but the fused ring-hop kernels cannot "
                f"serve this call: t_local = T/ring_size = "
                f"{q.shape[2]}/{n} = {t_local} must be a positive "
                f"multiple of 128, with head dim {D} in "
                f"{KERNEL_HEAD_DIMS}. Pass use_fused=None to fall back to "
                f"the plain ring body instead")
        qs, ks, vs = (sharding.split(x) for x in (q, k, v))
        if fused:
            out = _ring_body_fused(qs, ks, vs, mesh, axis, causal, sc)
        else:
            out = _ring_body(qs, ks, vs, mesh, axis, causal, sc, t_local)
        return sharding.gather(out)

    return fn
