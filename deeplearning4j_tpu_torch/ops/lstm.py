"""The LSTM time loop for Hopper: the forward kernel (K5), the backward
kernel (K6), their plain PyTorch versions, the autograd Functions that join
them, and the probe that decides when a layer takes them.

Counterpart of ``deeplearning4j_tpu/ops/pallas_lstm.py``:
``fused_lstm_applicable`` (its ``:54-81``), ``_fwd_call`` / ``_fwd_body``
(``:90-189``), ``_bwd_call`` / ``_bwd_body`` (``:193-326``) and the
``custom_vjp`` pairs ``_fused_lstm_m`` and ``_fused_lstm_pm``
(``:332-388``) behind ``fused_lstm`` and ``fused_lstm_peephole``. The
kernels are ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu``; each source
says what it computes, what bounds it and what its design leaves for later.
Gate order along the 4H axis is [i, f, o, g]; Graves peepholes let i and f
peep at c_{t-1} and o at c_t.

Each kernel is one cooperative launch of thread-block clusters whose grid
a host plan chooses per shape: Q blocks a cluster and U hidden units a
cluster, among the pairs the kernel is compiled for, with no more clusters
than the card can hold at once (``cudaOccupancyMaxActiveClusters``, asked
through the library). K6's blocks (``loop_plan``) each take a slice of the
gate axis; K5's (``fwd_plan``) each a slice of the product's reduction
axis, the k rows of R.

Dispatch: each kernel wrapper (``fused_lstm_fwd``, ``fused_lstm_bwd``)
computes its plain version on a CPU tensor and launches its kernel on a
CUDA tensor or raises. There is no fallback around a kernel on the card.
Each launch adds one to the wrapper's ``launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .nvcc import PKG, build_library, load_symbol

# The probe admits what the kernels take: f32 or bf16, tanh with sigmoid
# gates, any batch, and H up to 1024 (K5: its (Q 2, U 16) plan keeps
# R[512 k rows, 64 gate columns], 128 KB at H 1024 f32, beside 16-row
# chunks of h; K6: its (Q 2, U 16) plan keeps R[16 units, 2 gates], 131 KB
# at H 1024 f32, beside 8-row chunks of dz). The TPU probe also
# needs B % 8 (f32) or B % 16 (bf16), H % 128 and H <= 512 (VMEM); those
# shapes take the kernels here too.
MAX_H = 1024

FWD_SOURCE = PKG / "csrc" / "lstm_fwd.cu"
BWD_SOURCE = PKG / "csrc" / "lstm_bwd.cu"


def fused_lstm_applicable(B: int, H: int, dtype, *, peepholes, mask,
                          reverse: bool, activation: str,
                          gate_activation: str) -> bool:
    """Can the kernels take this call? ``peepholes`` may be None or the
    (pi, pf, po) tuple and ``mask`` None or a per-step mask: all four
    combinations run fused. A reverse caller flips the sequence itself and
    probes with ``reverse=False``, as the reference's does."""
    if reverse:
        return False
    if activation != "tanh" or gate_activation != "sigmoid":
        return False
    return (dtype in (torch.float32, torch.bfloat16) and B >= 1
            and 1 <= H <= MAX_H)


# --------------------------------------------------------------- the build
def build_fwd() -> Path:
    """Compile K5 for sm_90a unless this source's library exists."""
    return build_library(FWD_SOURCE)


def build_bwd() -> Path:
    """Compile K6 (the whole backward, one kernel) unless its library
    exists."""
    return build_library(BWD_SOURCE)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "dl4j_lstm_fwd": (build_fwd, [_P] * 18 + [_I] * 6 + [_P]),
    "dl4j_lstm_fwd_layout": (build_fwd, [_I] * 5 + [_P]),
    "dl4j_lstm_bwd": (build_bwd, [_P] * 21 + [_I] * 6 + [_P]),
    "dl4j_lstm_bwd_layout": (build_bwd, [_I] * 5 + [_P]),
}


# ------------------------------------------------------------ K6's plan
# (blocks a cluster Q, hidden units a cluster U) the kernel is compiled for
# (csrc/lstm_bwd.cu DL4J_BY_UNITS), in the order a plan prefers them at a
# tie: a block takes 4H / Q columns of the gate axis, two gates. (Four
# blocks of one gate each fit 30 clusters on an H100, too few for H 512 at
# 16 units; at 20 units they measured slower than 2 x 8, PERF.md §6.)
LOOP_CANDIDATES = ((2, 8), (2, 16))


class LoopPlan(NamedTuple):
    """How K6 cuts one call: ``clusters`` clusters of ``q`` blocks; cluster
    p owns hidden units [p u, (p + 1) u) (the last may hold fewer), its
    block r the gate columns [r 4H/q, (r + 1) 4H/q)."""
    q: int
    u: int
    clusters: int

    @property
    def blocks(self) -> int:
        return self.q * self.clusters


@functools.lru_cache(maxsize=1024)
def loop_plan(H: int, B: int, sms: int,
              max_clusters: Tuple[int, ...]) -> LoopPlan:
    """K6's plan for hidden size H and batch B on a card of ``sms`` SMs;
    ``max_clusters[i]`` is how many clusters of ``LOOP_CANDIDATES[i]`` the
    card holds at once at this shape (0: it does not fit a block). Among
    the pairs whose clusters all fit and whose blocks fit one an SM, the
    plan with the most blocks; ties go to the earlier pair. Cached: a
    layer asks for the same shape on every step. Raises ValueError when no
    pair fits."""
    return _most_blocks(H, B, sms, max_clusters, LOOP_CANDIDATES, LoopPlan,
                        "K6")


def _most_blocks(H, B, sms, max_clusters, candidates, make, kernel):
    """Among the ``candidates`` pairs (q, u) whose clusters all fit
    (``max_clusters``, one count a pair) and whose blocks fit one an SM,
    the plan ``make(q, u, clusters)`` with the most blocks; ties go to the
    earlier pair. Raises ValueError when no pair fits."""
    if H < 1 or B < 1 or len(max_clusters) != len(candidates):
        raise ValueError(f"{kernel} plans 1 <= H, B with one cluster count "
                         f"for each of {candidates}; got H={H} B={B} "
                         f"{max_clusters}")
    best = None
    for (q, u), fit in zip(candidates, max_clusters):
        plan = make(q, u, -(-H // u))
        if plan.clusters <= fit and plan.blocks <= sms and (
                best is None or plan.blocks > best.blocks):
            best = plan
    if best is None:
        raise ValueError(f"no {kernel} plan fits H={H} B={B} on {sms} SMs "
                         f"(clusters that fit: {max_clusters})")
    return best


class LoopLayout(NamedTuple):
    """What a plan takes at a shape (``dl4j_lstm_bwd_layout``,
    ``dl4j_lstm_fwd_layout``): dynamic shared memory a block (0: it does
    not fit), f32 scratch for the grid, clusters the card holds at once,
    batch rows a chunk, chunks a step, blocks."""
    smem: int
    scratch: int
    max_clusters: int
    rows: int
    chunks: int
    blocks: int


def _query_layout(symbol: str, index: int, H: int, B: int, dtype, q: int,
                  u: int) -> LoopLayout:
    fn = load_symbol(symbol, *_ENTRIES[symbol])
    out = (ctypes.c_longlong * 6)()
    with torch.cuda.device(index):
        err = fn(H, B, q, u, int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"{symbol} failed with CUDA error {err} (H={H}, "
                           f"B={B}, q={q}, u={u}, {dtype})")
    return LoopLayout(*out)


@functools.lru_cache(maxsize=1024)
def _layout(index: int, H: int, B: int, dtype, q: int,
            u: int) -> LoopLayout:
    """The library's layout of K6's plan pair (q, u) at (H, B, dtype) on
    card ``index``, its co-resident clusters included."""
    return _query_layout("dl4j_lstm_bwd_layout", index, H, B, dtype, q, u)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _bwd_plan(index: int, H: int, B: int, dtype):
    """This card's plan for K6 at (H, B, dtype) and its layout."""
    fits = tuple(_layout(index, H, B, dtype, q, u).max_clusters
                 for q, u in LOOP_CANDIDATES)
    plan = loop_plan(H, B, _sm_count(index), fits)
    return plan, _layout(index, H, B, dtype, plan.q, plan.u)


# ------------------------------------------------------------ K5's plan
# (blocks a cluster Q, hidden units a cluster U) K5 is compiled for
# (csrc/lstm_fwd.cu DL4J_BY_UNITS), in the order a plan prefers them at a
# tie: a block keeps R[its k rows, the cluster's 4U gate columns]. (Four
# blocks of 16 units fit 30 clusters on an H100, too few for H 512; one
# block of 4 units, reading all of h, measured slower than 2 x 8 at every
# path shape, PERF.md §6.)
FWD_CANDIDATES = ((2, 8), (2, 16))


class FwdPlan(NamedTuple):
    """How K5 cuts one call: ``clusters`` clusters of ``q`` blocks; cluster
    p owns hidden units [p u, (p + 1) u) (the last may hold fewer) and
    their 4u gate columns, its block r the rows [r k, (r + 1) k) of R
    below H, k = ``k_rows(H)`` (the last block's may be fewer, or none)."""
    q: int
    u: int
    clusters: int

    @property
    def blocks(self) -> int:
        return self.q * self.clusters

    def k_rows(self, H: int) -> int:
        """Rows of R a block keeps: ceil(H / q), rounded up to 4."""
        return (-(-H // self.q) + 3) // 4 * 4


@functools.lru_cache(maxsize=1024)
def fwd_plan(H: int, B: int, sms: int,
             max_clusters: Tuple[int, ...]) -> FwdPlan:
    """K5's plan for hidden size H and batch B on a card of ``sms`` SMs;
    ``max_clusters[i]`` is how many clusters of ``FWD_CANDIDATES[i]`` the
    card holds at once at this shape (0: it does not fit a block). Among
    the pairs whose clusters all fit and whose blocks fit one an SM, the
    plan with the most blocks; ties go to the earlier pair. Cached: a
    layer asks for the same shape on every step. Raises ValueError when no
    pair fits."""
    return _most_blocks(H, B, sms, max_clusters, FWD_CANDIDATES, FwdPlan,
                        "K5")


@functools.lru_cache(maxsize=1024)
def _fwd_layout(index: int, H: int, B: int, dtype, q: int,
                u: int) -> LoopLayout:
    """The library's layout of K5's plan pair (q, u) at (H, B, dtype) on
    card ``index``, its co-resident clusters included."""
    return _query_layout("dl4j_lstm_fwd_layout", index, H, B, dtype, q, u)


@functools.lru_cache(maxsize=1024)
def _fwd_plan(index: int, H: int, B: int, dtype):
    """This card's plan for K5 at (H, B, dtype) and its layout."""
    fits = tuple(_fwd_layout(index, H, B, dtype, q, u).max_clusters
                 for q, u in FWD_CANDIDATES)
    plan = fwd_plan(H, B, _sm_count(index), fits)
    return plan, _fwd_layout(index, H, B, dtype, plan.q, plan.u)


# ----------------------------------------------------------- plain versions
def lstm_fwd_reference(x_proj, h0, c0, R, mask=None, peep=None):
    """K5's function in torch ops, the step loop of ``_fwd_body``: x_proj
    [T,B,4H], h0/c0 [B,H], R [H,4H], mask [T,B] or None, peep None or
    (pi, pf, po) [H]. Returns (hs, gates, cs, c_prev, h_prev [T,B,*], hT,
    cT [B,H]) in x_proj's dtype; the carries are f32 and the product takes
    h in R's dtype with f32 accumulation."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    io, f32 = x_proj.dtype, torch.float32
    Rf = R.float()
    h, c = h0.float(), c0.float()
    if peep is not None:
        pi, pf, po = (p.float() for p in peep)
    outs = {k: [] for k in ("hs", "gates", "cs", "c_prev", "h_prev")}
    for t in range(T):
        z = x_proj[t].float() + h.to(R.dtype).to(f32) @ Rf
        zi, zf, zo, zg = z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:]
        if peep is not None:
            zi = zi + c * pi
            zf = zf + c * pf
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        c_new = f * c + i * g
        if peep is not None:
            zo = zo + c_new * po
        o = torch.sigmoid(zo)
        h_new = o * torch.tanh(c_new)
        if mask is not None:
            m = mask[t].to(f32)[:, None]
            h_t = m * h_new + (1.0 - m) * h
            c_t = m * c_new + (1.0 - m) * c
        else:
            h_t, c_t = h_new, c_new
        outs["hs"].append(h_t.to(io))
        outs["gates"].append(torch.cat([i, f, o, g], dim=-1).to(io))
        outs["cs"].append(c_new.to(io))
        outs["c_prev"].append(c.to(io))
        outs["h_prev"].append(h.to(io))
        h, c = h_t, c_t
    return (*(torch.stack(v) for v in outs.values()), h.to(io), c.to(io))


def lstm_bwd_reference(gates, cs, c_prev, h_prev, dhs, R, dhT, dcT,
                       mask=None, peep=None):
    """K6's function in torch ops, the reverse step loop of ``_bwd_body``.
    Returns (dx_proj [T,B,4H], dh0, dc0 [B,H], dR [H,4H]) and, with
    peepholes, dpi, dpf, dpo [1,H], in gates' dtype. Carries and sums are
    f32; the products take dz, h_prev and R in R's dtype."""
    T, B, H4 = gates.shape
    H = H4 // 4
    io, f32 = gates.dtype, torch.float32
    Rf = R.float()
    dh, dc = dhT.float(), dcT.float()
    dR = torch.zeros(H, H4, dtype=f32, device=gates.device)
    if peep is not None:
        pi, pf, po = (p.float() for p in peep)
        dpi, dpf, dpo = (torch.zeros(H, dtype=f32, device=gates.device)
                         for _ in range(3))
    dxp = [None] * T
    for t in range(T - 1, -1, -1):
        gt = gates[t].float()
        i, f, o, g = gt[:, :H], gt[:, H:2 * H], gt[:, 2 * H:3 * H], gt[:, 3 * H:]
        c, cp = cs[t].float(), c_prev[t].float()
        tc = torch.tanh(c)
        dh_tot = dh + dhs[t].float()
        dc_tot = dc
        if mask is not None:
            m = mask[t].to(f32)[:, None]
            dh_new, dc_in = m * dh_tot, m * dc_tot
        else:
            dh_new, dc_in = dh_tot, dc_tot
        dzo = dh_new * tc * o * (1.0 - o)
        dcv = dc_in + dh_new * o * (1.0 - tc * tc)
        if peep is not None:
            dcv = dcv + dzo * po
        dzi = dcv * g * i * (1.0 - i)
        dzf = dcv * cp * f * (1.0 - f)
        dzg = dcv * i * (1.0 - g * g)
        dz = torch.cat([dzi, dzf, dzo, dzg], dim=-1).to(io)
        dxp[t] = dz
        dzr = dz.to(R.dtype).to(f32)
        dR = dR + h_prev[t].to(R.dtype).to(f32).T @ dzr
        new_dc = dcv * f
        if mask is not None:
            new_dc = new_dc + (1.0 - m) * dc_tot
        if peep is not None:
            dpi = dpi + (dzi * cp).sum(0)
            dpf = dpf + (dzf * cp).sum(0)
            dpo = dpo + (dzo * c).sum(0)
            new_dc = new_dc + dzi * pi + dzf * pf
        new_dh = dzr @ Rf.T
        if mask is not None:
            new_dh = new_dh + (1.0 - m) * dh_tot
        dh, dc = new_dh, new_dc
    out = (torch.stack(dxp), dh.to(io), dc.to(io), dR.to(io))
    if peep is not None:
        out += tuple(d.reshape(1, H).to(io) for d in (dpi, dpf, dpo))
    return out


# ----------------------------------------------------------------- wrappers
def _on_cpu(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"the LSTM kernels run on CPU or CUDA tensors, not "
                         f"{x.device}")
    return False


def _check(named: Sequence, dtype, device) -> None:
    """Every (name, tensor, shape) must be contiguous, of ``dtype`` and on
    ``device`` with the given shape."""
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
                t.device != device or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {tuple(shape)} {dtype} tensor "
                f"on {device}; got {tuple(t.shape)} {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_common(x, T, B, H, R, mask, peep) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the LSTM kernels take float32 or bfloat16, not "
                         f"{x.dtype}")
    if not 1 <= H <= MAX_H:
        raise ValueError(f"hidden size {H} is outside the kernels' 1..{MAX_H}")
    named = [("R", R, (H, 4 * H))]
    if peep is not None:
        named += [(n, p, (H,)) for n, p in zip(("pi", "pf", "po"), peep)]
    _check(named, x.dtype, x.device)
    if mask is not None:
        _check([("mask", mask, (T, B))], torch.float32, x.device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_lstm_fwd(x_proj, h0, c0, R, mask=None, peep=None):
    """The ``_fwd_call`` counterpart (K5). Returns (hs, gates, cs, c_prev,
    h_prev, hT, cT) as ``lstm_fwd_reference`` does. CPU tensors take the
    plain version; CUDA tensors launch the kernel (one cooperative cluster
    launch, this shape's ``fwd_plan``) on the current stream (``mask`` is
    passed to it as [T,B] f32)."""
    if _on_cpu(x_proj):
        return lstm_fwd_reference(x_proj, h0, c0, R, mask, peep)
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    _check_common(x_proj, T, B, H, R, mask, peep)
    _check([("x_proj", x_proj, (T, B, 4 * H)), ("h0", h0, (B, H)),
            ("c0", c0, (B, H))], x_proj.dtype, x_proj.device)
    out = _fwd_launch(x_proj, h0, c0, R, mask, peep)
    fused_lstm_fwd.launches += 1
    return out


def _fwd_launch(x_proj, h0, c0, R, mask, peep, plan=None, trace=None):
    """Allocate K5's outputs, the exchange buffer of h (a call of more than
    one step) and the scratch the plan's layout asks for, and launch it on
    the current stream of x_proj's card with ``plan`` (by default this
    card's ``fwd_plan``); raise on a CUDA error, a grid that cannot be
    co-resident (720) included. ``trace``, a [T + 1, 8] int64 tensor on
    the card, receives block 0's clock at eight points of each step and,
    in its last row, at the kernel's start, the end of its prologue and
    its end (``csrc/lstm_fwd.cu`` TRACE_MARKS; ``lstm_study.py`` reads
    it)."""
    index, current = x_proj.get_device(), torch._C._cuda_getDevice()
    if index >= 0 and index != current:      # another card than the current
        with torch.cuda.device(index):
            return _fwd_launch(x_proj, h0, c0, R, mask, peep, plan, trace)
    T, B, H4 = x_proj.shape
    H = H4 // 4
    own, layout = _fwd_plan(current, H, B, x_proj.dtype)
    if plan is None:
        plan = own
    elif plan != own:
        layout = _fwd_layout(current, H, B, x_proj.dtype, plan.q, plan.u)
    new = lambda *shape, dtype=x_proj.dtype: torch.empty(
        shape, dtype=dtype, device=x_proj.device)
    hs, cs, c_prev, h_prev = (new(T, B, H) for _ in range(4))
    gates = new(T, B, 4 * H)
    hT, cT = new(B, H), new(B, H)
    hbuf = new(2, B, H, dtype=torch.float32) if T > 1 else None
    scratch = (new(layout.scratch, dtype=torch.float32) if layout.scratch
               else None)
    pi, pf, po = peep if peep is not None else (None, None, None)
    ptrs = [_ptr(t) for t in (x_proj, R, h0, c0, mask, pi, pf, po, hs, gates,
                              cs, c_prev, h_prev, hT, cT, hbuf, scratch,
                              trace)]
    fn = load_symbol("dl4j_lstm_fwd", *_ENTRIES["dl4j_lstm_fwd"])
    err = fn(*ptrs, T, B, H, int(x_proj.dtype == torch.bfloat16), plan.q,
             plan.u, torch._C._cuda_getCurrentRawStream(current))
    if err != 0:
        raise RuntimeError(f"dl4j_lstm_fwd launch failed with CUDA error "
                           f"{err}{_why(err)} (T={T}, B={B}, H={H}, "
                           f"{x_proj.dtype}, {plan})")
    return hs, gates, cs, c_prev, h_prev, hT, cT


def _why(err: int) -> str:
    return (" (the plan's clusters cannot all be resident at once)"
            if err == 720 else "")


def fused_lstm_bwd(gates, cs, c_prev, h_prev, dhs, R, dhT, dcT, mask=None,
                   peep=None):
    """The ``_bwd_call`` counterpart (K6). Returns (dx_proj, dh0, dc0, dR
    [, dpi, dpf, dpo]) as ``lstm_bwd_reference`` does. CPU tensors take the
    plain version; CUDA tensors launch the kernel (one cooperative cluster
    launch, this shape's ``loop_plan``) on the current stream."""
    if _on_cpu(gates):
        return lstm_bwd_reference(gates, cs, c_prev, h_prev, dhs, R, dhT,
                                  dcT, mask, peep)
    T, B, H4 = gates.shape
    H = H4 // 4
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    _check_common(gates, T, B, H, R, mask, peep)
    _check([("gates", gates, (T, B, 4 * H))]
           + [(n, t, (T, B, H)) for n, t in (("cs", cs), ("c_prev", c_prev),
                                             ("h_prev", h_prev),
                                             ("dhs", dhs))]
           + [("dhT", dhT, (B, H)), ("dcT", dcT, (B, H))],
           gates.dtype, gates.device)
    out = _bwd_launch(gates, cs, c_prev, h_prev, dhs, R, dhT, dcT, mask,
                      peep)
    fused_lstm_bwd.launches += 1
    return out


def _bwd_launch(gates, cs, c_prev, h_prev, dhs, R, dhT, dcT, mask, peep,
                plan=None, trace=None):
    """Allocate K6's outputs (and scratch, where the plan's layout asks for
    it) and launch it on the current stream of gates' card with ``plan``
    (by default this card's ``loop_plan``); raise on a CUDA error, a grid
    that cannot be co-resident (720) included. ``trace``, a [T, 8] int64
    tensor on the card, receives block 0's clock at eight points of each
    step (``csrc/lstm_bwd.cu`` TRACE_MARKS; ``lstm_study.py`` reads it)."""
    index, current = gates.get_device(), torch._C._cuda_getDevice()
    if index >= 0 and index != current:      # another card than the current
        with torch.cuda.device(index):
            return _bwd_launch(gates, cs, c_prev, h_prev, dhs, R, dhT, dcT,
                               mask, peep, plan, trace)
    T, B, H4 = gates.shape
    H = H4 // 4
    own, layout = _bwd_plan(current, H, B, gates.dtype)
    if plan is None:
        plan = own
    elif plan != own:
        layout = _layout(current, H, B, gates.dtype, plan.q, plan.u)
    new = lambda *shape, dtype=gates.dtype: torch.empty(
        shape, dtype=dtype, device=gates.device)
    dxp, dh0, dc0, dR = new(T, B, 4 * H), new(B, H), new(B, H), new(H, 4 * H)
    dps = tuple(new(1, H) for _ in range(3)) if peep is not None else None
    scratch = (new(layout.scratch, dtype=torch.float32) if layout.scratch
               else None)
    pi, pf, po = peep if peep is not None else (None, None, None)
    dpi, dpf, dpo = dps if dps is not None else (None, None, None)
    ptrs = [_ptr(t) for t in (gates, cs, c_prev, h_prev, dhs, R, dhT, dcT,
                              mask, pi, pf, po, dxp, dh0, dc0, dR, dpi, dpf,
                              dpo, scratch, trace)]
    fn = load_symbol("dl4j_lstm_bwd", *_ENTRIES["dl4j_lstm_bwd"])
    err = fn(*ptrs, T, B, H, int(gates.dtype == torch.bfloat16), plan.q,
             plan.u, torch._C._cuda_getCurrentRawStream(current))
    if err != 0:
        raise RuntimeError(f"dl4j_lstm_bwd launch failed with CUDA error "
                           f"{err}{_why(err)} (T={T}, B={B}, H={H}, "
                           f"{gates.dtype}, {plan})")
    return (dxp, dh0, dc0, dR) + (dps if dps is not None else ())


fused_lstm_fwd.launches = 0     # K5 launches
fused_lstm_bwd.launches = 0     # K6 launches


# -------------------------------------------------------------- autograd
def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class FusedLSTMFunction(torch.autograd.Function):
    """K5 forward and K6 backward of the plain LSTM: the ``_fused_lstm_m``
    ``custom_vjp``. Returns (hs, hT, cT); the mask gets no gradient."""

    @staticmethod
    def forward(ctx, x_proj, h0, c0, R, mask):
        hs, gates, cs, c_prev, h_prev, hT, cT = fused_lstm_fwd(
            x_proj, h0, c0, R, mask)
        ctx.save_for_backward(gates, cs, c_prev, h_prev, R, mask)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, c_prev, h_prev, R, mask = ctx.saved_tensors
        dxp, dh0, dc0, dR = fused_lstm_bwd(
            gates, cs, c_prev, h_prev, _zeros_if_none(dhs, cs), R,
            _zeros_if_none(dhT, cs[0]), _zeros_if_none(dcT, cs[0]), mask)
        return dxp, dh0, dc0, dR, None


class FusedLSTMPeepholeFunction(torch.autograd.Function):
    """K5 forward and K6 backward of the Graves (peephole) LSTM: the
    ``_fused_lstm_pm`` ``custom_vjp``. Returns (hs, hT, cT)."""

    @staticmethod
    def forward(ctx, x_proj, h0, c0, R, pi, pf, po, mask):
        hs, gates, cs, c_prev, h_prev, hT, cT = fused_lstm_fwd(
            x_proj, h0, c0, R, mask, (pi, pf, po))
        ctx.save_for_backward(gates, cs, c_prev, h_prev, R, pi, pf, po, mask)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, c_prev, h_prev, R, pi, pf, po, mask = ctx.saved_tensors
        dxp, dh0, dc0, dR, dpi, dpf, dpo = fused_lstm_bwd(
            gates, cs, c_prev, h_prev, _zeros_if_none(dhs, cs), R,
            _zeros_if_none(dhT, cs[0]), _zeros_if_none(dcT, cs[0]), mask,
            (pi, pf, po))
        return (dxp, dh0, dc0, dR, dpi.reshape(-1), dpf.reshape(-1),
                dpo.reshape(-1), None)


def fused_lstm(x_proj, h0, c0, R, mask=None):
    """The fused plain LSTM over time: x_proj [T,B,4H] input projections
    (+bias), mask [T,B] or None (masked steps carry state through).
    Returns (hs [T,B,H], (hT, cT)), differentiable on both devices."""
    hs, hT, cT = FusedLSTMFunction.apply(x_proj, h0, c0, R, mask)
    return hs, (hT, cT)


def fused_lstm_peephole(x_proj, h0, c0, R, pi, pf, po, mask=None):
    """The fused GravesLSTM (peephole) variant; pi/pf/po [H]."""
    hs, hT, cT = FusedLSTMPeepholeFunction.apply(x_proj, h0, c0, R, pi, pf,
                                                 po, mask)
    return hs, (hT, cT)
