#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one NVIDIA
card and check it. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero before a result is printed:

1. Device: requires CUDA, prints the card's name and power limit, turns
   TF32 off so float32 products are full float32.
2. Kernels: builds every kernel of the serving and training paths from
   this checkout's sources (one ``nvcc`` per source, started together),
   then holds each kernel against its plain PyTorch version on the card:
   - K1, the flash-attention forward, at the shapes the serving path gives
     it (float32 at atol 2e-5, bfloat16 at atol 2e-2);
   - K2 and K3, the backward's dq and dk/dv kernels, at the training
     shapes (BH 64 = B 8 x H 8, T 1024, D 64, causal) at rel-to-max 1e-4
     in float32 and 2e-2 in bfloat16;
   - each also at coverage shapes (other head dims, a key mask with a
     fully masked row, T 200 causal with a mask).
   Times each kernel, its plain version and the PyTorch library call for
   the same function (SDPA, its backward for K2/K3), beside the least
   time the card could take.
3. Serve: ``transformer_lm`` at the repository's end-to-end width
   (bench.py ``_TLM``: vocab 4096, d_model 512, 8 heads, 12 blocks,
   T 1024) with random weights from a seed, served by ``GenerationEngine``
   to 8 concurrent greedy requests of 300-900 prompt tokens and 32 new
   tokens each. One request's tokens must equal ``naive_generate``'s
   token for token.
4. Train: the same model in bfloat16 with ``Adam(3e-4)`` takes 6 steps of
   ``net.fit`` on one fixed batch of B 8 token sequences (bench.py
   ``bench_transformer_lm``'s feed). Each of K1, K2 and K3 must launch 12
   times a step; the loss must be finite every step and fall.
5. Cross-device: one float32 step of a 2-block model at d_model 512,
   T 1024, B 2 on the card and on the CPU (plain versions) from the same
   weights: the loss at rel 1e-5, every gradient at rel-to-max 1e-4, and
   the attention projections' gradients nonzero.
   In phases 3 and 4 the launch counts are set to 0 just before the path
   is driven and read just after; every kernel of the path must launch.
6. Report: JSON lines of per-shape kernel times, the serving and training
   metrics and the kernels, then last ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine

SEED = 20261016
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}     # rel-to-max
# bench.py _TLM, the repository's end-to-end transformer configuration
TLM = dict(vocab_size=4096, d_model=512, n_heads=8, n_blocks=12,
           max_length=1024)
ENGINE = dict(block_len=16, max_seq_len=1024, decode_slots=8,
              prefill_batches=(1, 2), prompt_rungs=(512, 1024))
N_REQUESTS, MAX_TOKENS = 8, 32
TRAIN_B, TRAIN_STEPS = 8, 6                  # bench.py _TLM batch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ phase 1
def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


# ------------------------------------------------------------------ phase 2
BUILDS = {"flash_attention_fwd": fa.build,
          "flash_attention_bwd": fa.build_bwd}


def build_phase():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as ex:
        paths = dict(zip(BUILDS, ex.map(lambda b: b(), BUILDS.values())))
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f}s")
    for name, path in paths.items():
        log(path.with_suffix(".log").read_text()[-2000:])


def _time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# per kernel: (flops per visible query/key pair per unit of D, [BH,T,D]
# tensors read or written once, [BH,T] f32 rows read or written once)
WORK = {"fwd": (4, 4, 1),      # q,k,v in, O out; lse out
        "dq": (6, 5, 2),       # q,k,v,dO in, dq out; lse, delta in
        "dkv": (8, 6, 2)}      # q,k,v,dO in, dk,dv out; lse, delta in


def _bound(kind, BH, T, D, dtype, causal):
    """Least time (ms) for the card: every input read once and every output
    written once at the memory rate, against the kernel's flops per
    visible query/key pair at the dtype's peak. Returns
    (ms, "bytes" | "operations")."""
    per_pair, n_big, n_rows = WORK[kind]
    pairs = T * (T + 1) / 2 if causal else T * T
    t_ops = per_pair * D * pairs * BH / PEAK_FLOPS[dtype]
    nbytes = (n_big * BH * T * D * torch.finfo(dtype).bits // 8
              + n_rows * BH * T * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _case(gen, BH, T, D, dtype, causal, masked, B=None):
    q, k, v = (torch.randn(BH, T, D, generator=gen).to(dtype).cuda()
               for _ in range(3))
    km = None
    if masked:
        km = (torch.rand(B, T, generator=gen) > 0.3).float()
        km[-1] = 0.0                          # one fully masked batch row
        km = km.cuda()
    return q, k, v, km


def _compare(q, k, v, km, causal, scale):
    o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal, scale=scale)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal, scale, km)
    torch.cuda.synchronize()
    if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
        raise AssertionError("kernel output is not finite")
    err_o = (o.float() - ro.float()).abs().max().item()
    visible = torch.ones_like(lse, dtype=torch.bool)
    if km is not None:
        rows = (km > 0).any(dim=1).repeat_interleave(q.shape[0] // km.shape[0])
        visible = rows[:, None].expand_as(lse)
        # a fully masked row's lse is -1e30 + log(T), which is -1e30 in f32
        if not bool((lse[~visible] <= -1e29).all()
                    and (rlse[~visible] <= -1e29).all()):
            raise AssertionError("fully masked rows' lse is not -1e30")
    err_lse = (lse - rlse)[visible].abs().max().item()
    return err_o, err_lse


def kernel_phase():
    gen = torch.Generator().manual_seed(SEED)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    # the serving prefills' shapes, then the training step's (B 8 x H 8)
    main = [(8, 512), (16, 512), (8, 1024), (16, 1024), (64, 1024)]
    # (D, dtype, T, causal): masked, with one fully masked batch row; T=200
    # is not a multiple of the kernel's 64-row tiles
    cover = [(D, dtype, 256, False) for dtype in (torch.float32,
                                                  torch.bfloat16)
             for D in (96, 128, 256)]
    cover += [(64, torch.float32, 200, True), (64, torch.bfloat16, 200, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for BH, T in main:
            D = 64
            q, k, v, _ = _case(gen, BH, T, D, dtype, True, False)
            scale = 1.0 / math.sqrt(D)
            e_o, e_l = _compare(q, k, v, None, True, scale)
            worst = max(e_o, e_l)
            if worst > TOL[dtype]:
                raise AssertionError(f"kernel disagrees with plain at "
                                     f"BH={BH} T={T} D={D} {dtype}: O "
                                     f"{e_o:.3g}, lse {e_l:.3g} > "
                                     f"{TOL[dtype]}")
            errs[dtype] = max(errs[dtype], worst)
            B, H = BH // 8, 8
            q4, k4, v4 = (t.view(B, H, T, D) for t in (q, k, v))
            ms = _time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, None, causal=True, scale=scale))
            plain_ms = _time_ms(lambda: fa.flash_attention_reference(
                q, k, v, True, scale))
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True))
            bound_ms, bound_by = _bound("fwd", BH, T, D, dtype, True)
            rows.append({"BH": BH, "T": T, "D": D, "dtype": str(dtype),
                         "causal": True, "max_abs_err": worst, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
    for D, dtype, T, causal in cover:
        B, H = 2, 2
        q, k, v, km = _case(gen, B * H, T, D, dtype, causal, True, B=B)
        e_o, e_l = _compare(q, k, v, km, causal, 1.0 / math.sqrt(D))
        worst = max(e_o, e_l)
        if worst > TOL[dtype]:
            raise AssertionError(f"kernel disagrees with plain at D={D} "
                                 f"T={T} causal={causal} {dtype} (masked): "
                                 f"O {e_o:.3g}, lse {e_l:.3g} > "
                                 f"{TOL[dtype]}")
        errs[dtype] = max(errs[dtype], worst)
    log("kernel phase: max abs err f32", errs[torch.float32], "bf16",
        errs[torch.bfloat16])
    return errs, rows


def _bwd_case(gen, BH, T, D, dtype, causal, masked, B=None):
    """Backward inputs from K1's forward: (q, k, v, dO, lse, delta, mask)."""
    q, k, v, km = _case(gen, BH, T, D, dtype, causal, masked, B=B)
    if masked:
        km[0, :8] = 0.0               # causal rows 0..7 see no key
    do = torch.randn(BH, T, D, generator=gen).to(dtype).cuda()
    o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal,
                                    scale=1.0 / math.sqrt(D))
    delta = (do.float() * o.float()).sum(dim=-1)
    return q, k, v, do, lse, delta, km


def _rel_to_max(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def bwd_kernel_phase():
    """K2 (dq) and K3 (dk/dv) against their plain versions, at the training
    shapes and at coverage shapes; timings at the training shapes."""
    gen = torch.Generator().manual_seed(SEED + 1)
    # per kernel and dtype: (max abs error, max rel-to-max error)
    errs = {k: {d: (0.0, 0.0) for d in (torch.float32, torch.bfloat16)}
            for k in ("dq", "dkv")}
    rows = []
    B, H, T, D = TRAIN_B, TLM["n_heads"], TLM["max_length"], 64
    cover = [(D_, dtype, 256, False) for dtype in (torch.float32,
                                                   torch.bfloat16)
             for D_ in (96, 128, 256)]
    cover += [(64, torch.float32, 200, True), (64, torch.bfloat16, 200, True)]
    cases = [(B * H, T, D, dtype, True, False, None)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(4, T_, D_, dtype, causal, True, 2)
              for D_, dtype, T_, causal in cover]
    for BH, T_, D_, dtype, causal, masked, B_ in cases:
        args = _bwd_case(gen, BH, T_, D_, dtype, causal, masked, B=B_)
        kw = dict(causal=causal, scale=1.0 / math.sqrt(D_))
        got = {"dq": (fa.flash_attention_bwd_dq(*args, **kw),),
               "dkv": fa.flash_attention_bwd_dkv(*args, **kw)}
        torch.cuda.synchronize()
        q, k, v, do, lse, delta, km = args
        plain_args = (q, k, v, do, lse, delta, causal, kw["scale"], km)
        want = {"dq": (fa.flash_attention_bwd_dq_reference(*plain_args),),
                "dkv": fa.flash_attention_bwd_dkv_reference(*plain_args)}
        for kind in ("dq", "dkv"):
            if not all(torch.isfinite(t.float()).all() for t in got[kind]):
                raise AssertionError(f"{kind} kernel output is not finite")
            err = max(_rel_to_max(g, w) for g, w in zip(got[kind],
                                                         want[kind]))
            if err > BWD_TOL[dtype]:
                raise AssertionError(
                    f"{kind} kernel disagrees with plain at BH={BH} T={T_} "
                    f"D={D_} {dtype} causal={causal} masked={masked}: "
                    f"rel-to-max {err:.3g} > {BWD_TOL[dtype]}")
            err_abs = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got[kind], want[kind]))
            errs[kind][dtype] = (max(errs[kind][dtype][0], err_abs),
                                 max(errs[kind][dtype][1], err))
        if masked:
            continue
        # timings at the training shapes; SDPA's backward (forward excluded)
        # computes dq, dk and dv together
        q4, k4, v4 = (t.view(B, H, T, D).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), do.view(B, H, T, D), retain_graph=True))
        for kind, kernel, plain in (
                ("dq", fa.flash_attention_bwd_dq,
                 fa.flash_attention_bwd_dq_reference),
                ("dkv", fa.flash_attention_bwd_dkv,
                 fa.flash_attention_bwd_dkv_reference)):
            ms = _time_ms(lambda: kernel(*args, **kw))
            plain_ms = _time_ms(lambda: plain(*plain_args))
            bound_ms, bound_by = _bound(kind, BH, T, D, dtype, True)
            rows.append({"kernel": kind, "BH": BH, "T": T, "D": D,
                         "dtype": str(dtype), "causal": True, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
    log("backward kernel phase: (max abs, rel-to-max) err", {
        k: {str(d): e for d, e in v.items()} for k, v in errs.items()})
    return errs, rows


# ------------------------------------------------------------------ phase 3
def slice_phase():
    net = transformer_lm(**TLM, token_input=True).init(seed=SEED)
    eng = GenerationEngine(net, **ENGINE)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(300, 901, size=N_REQUESTS)
    prompts = [rng.integers(1, TLM["vocab_size"], size=int(n)).tolist()
               for n in lens]
    try:
        fa.flash_attention.launches = 0          # the serving run's count
        t0 = time.perf_counter()
        streams = [eng.generate(p, max_tokens=MAX_TOKENS, stream=True)
                   for p in prompts]
        results = [s.result() for s in streams]
        wall_s = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        snap = eng.metrics()["default"]
    finally:
        eng.stop()
    for i, (toks, reason) in enumerate(results):
        if len(toks) != MAX_TOKENS or reason != "length":
            raise AssertionError(f"request {i}: {len(toks)} tokens, "
                                 f"finish reason {reason!r}")
        if not all(0 <= t < TLM["vocab_size"] for t in toks):
            raise AssertionError(f"request {i}: token out of range")
    prefills = snap["prefills"]
    if launches < TLM["n_blocks"] * prefills or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"for {prefills} prefill batches of "
                             f"{TLM['n_blocks']} blocks")
    # the repository's own pin: paged decode equals full recompute
    spec = TransformerDecodeSpec(net)
    cap = ENGINE["max_seq_len"]
    buf = torch.zeros((1, cap), dtype=torch.long, device=net.device)
    buf[0, :len(prompts[0])] = torch.as_tensor(prompts[0])
    logits, ks, vs = spec.prefill_forward(buf)
    if not (torch.isfinite(logits).all()
            and all(torch.isfinite(x).all() for x in ks + vs)):
        raise AssertionError("prefill logits or K/V are not finite")
    ref = naive_generate(net, prompts[0], MAX_TOKENS, pad_to=cap)
    if ref != results[0][0]:
        first = next(i for i, (a, b) in enumerate(zip(ref, results[0][0]))
                     if a != b)
        raise AssertionError(f"engine tokens differ from naive_generate at "
                             f"step {first}: {results[0][0]} vs {ref}")
    return {"requests": N_REQUESTS, "tokens": N_REQUESTS * MAX_TOKENS,
            "prompt_lens": [int(n) for n in lens],
            "prefill_batches": prefills, "decode_steps": snap["decode_steps"],
            "ttft_ms_p50": snap["ttft_ms"]["p50"],
            "ttft_ms_p99": snap["ttft_ms"]["p99"],
            "decode_step_ms_p50": snap["decode_step_ms"]["p50"],
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "wall_s": wall_s, "flash_attention_launches": launches}


# ------------------------------------------------------------------ phase 4
COUNTED = {"flash_attention_fwd": fa.flash_attention,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}


def _reset_launches():
    for fn in COUNTED.values():
        fn.launches = 0


def _launches():
    return {name: fn.launches for name, fn in COUNTED.items()}


def _one_hot_prev(x, V, dtype):
    """bench.py bench_transformer_lm's labels: one-hot of each sequence
    rolled by one step."""
    return F.one_hot(torch.roll(x, 1, dims=1), V).to(dtype)


class _Losses:
    """A score callback: keeps each step's loss (a device tensor)."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration, loss):
        self.losses.append(loss)


def train_phase():
    """``transformer_lm`` at the _TLM width in bf16 with Adam(3e-4): 6 steps
    of ``net.fit`` on one fixed batch, each step timed to its end."""
    V, T = TLM["vocab_size"], TLM["max_length"]
    net = transformer_lm(**TLM, token_input=True, dtype="bfloat16",
                         updater=Adam(3e-4)).init(seed=SEED)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.integers(0, V, (TRAIN_B, T)), device=net.device)
    y = _one_hot_prev(x, V, torch.bfloat16)
    rec = _Losses()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    _reset_launches()                            # the training run's count
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=TRAIN_B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in rec.losses]
    want = TLM["n_blocks"] * TRAIN_STEPS
    if launches != {name: want for name in COUNTED}:
        raise AssertionError(f"training launched {launches}, not {want} of "
                             f"each ({TLM['n_blocks']} blocks x "
                             f"{TRAIN_STEPS} steps)")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v)
                                             for v in losses):
        raise AssertionError(f"training losses are not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    p50 = float(np.median(step_ms[1:]))
    return {"model": "transformer_lm _TLM bf16 Adam(3e-4)",
            "batch": TRAIN_B, "seq_len": T, "steps": TRAIN_STEPS,
            "losses": losses, "step_ms": step_ms,
            "step_ms_p50_after_first": p50,
            "tokens_per_sec": TRAIN_B * T / (p50 / 1e3),
            "max_memory_allocated_bytes": peak, "launches": launches}


# ------------------------------------------------------------------ phase 5
def cross_device_phase():
    """One f32 step's loss and gradients of a 2-block model at d_model 512,
    T 1024, B 2, on the card (kernels) and on the CPU (plain versions),
    from the same weights."""
    cfg = dict(TLM, n_blocks=2)
    V, T = cfg["vocab_size"], cfg["max_length"]
    gpu = transformer_lm(**cfg, token_input=True).init(seed=SEED + 2)
    cpu = transformer_lm(**cfg, token_input=True, device="cpu").init()
    load_jax_params(cpu, [{k: v.detach().cpu().numpy()
                           for k, v in gpu.vertices[n].param_dict().items()}
                          for n in gpu.vertex_names])
    ids = np.random.default_rng(SEED + 3).integers(0, V, (2, T))
    def loss_and_grads(net):
        x = torch.as_tensor(ids, device=net.device)
        loss = net.loss_fn(x, _one_hot_prev(x, V, torch.float32))
        named = [(f"{n}.{k}", p) for n, pd in net.param_dicts().items()
                 for k, p in pd.items()]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.item(), {name: g.cpu()
                             for (name, _), g in zip(named, grads)}

    _reset_launches()                     # the card's step, counted alone
    l_gpu, g_gpu = loss_and_grads(gpu)
    launches = _launches()
    l_cpu, g_cpu = loss_and_grads(cpu)
    if launches != {name: cfg["n_blocks"] for name in COUNTED}:
        raise AssertionError(f"cross-device step launched {launches}")
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if loss_rel > 1e-5:
        raise AssertionError(f"loss on the card {l_gpu} vs CPU {l_cpu}")
    worst = max(g_gpu, key=lambda n: _rel_to_max(g_gpu[n], g_cpu[n]))
    grad_rel = _rel_to_max(g_gpu[worst], g_cpu[worst])
    if grad_rel > 1e-4:
        raise AssertionError(f"gradient {worst} on the card differs from "
                             f"the CPU's: rel-to-max {grad_rel:.3g}")
    for b in range(cfg["n_blocks"]):
        for w in ("Wq", "Wk", "Wv"):
            if not float(g_gpu[f"b{b}_attn.{w}"].abs().max()) > 0:
                raise AssertionError(f"b{b}_attn.{w} got no gradient on "
                                     f"the card")
    return {"loss_rel": loss_rel, "grad_rel_to_max": grad_rel,
            "worst_grad": worst, "launches": launches}


# ------------------------------------------------------------------- main
def main() -> int:
    smi = device_phase()
    build_phase()
    errs, rows = kernel_phase()
    bwd_errs, bwd_rows = bwd_kernel_phase()
    slice_row = slice_phase()
    train_row = train_phase()
    cross_row = cross_device_phase()
    top = next(r for r in rows if r["BH"] == 16 and r["T"] == 1024
               and r["dtype"] == str(torch.float32))
    serve_k1 = slice_row["flash_attention_launches"]
    train_k = train_row["launches"]
    src = "deeplearning4j_tpu_torch/csrc/flash_attention_{}.cu"
    ref = "deeplearning4j_tpu/ops/pallas_attention.py:{}"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src.format("fwd"), "replaces": ref.format(186),
        "launches": serve_k1 + train_k["flash_attention_fwd"],
        "launches_by_path": {"serve": serve_k1,
                             "train": train_k["flash_attention_fwd"]},
        "max_abs_err": errs[torch.float32],
        "max_abs_err_f32": errs[torch.float32],
        "max_abs_err_bf16": errs[torch.bfloat16],
        "shape": "BH=16 T=1024 D=64 float32 causal",
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"]}]
    for kind, name, line in (("dq", "flash_attention_bwd_dq", 224),
                             ("dkv", "flash_attention_bwd_dkv", 268)):
        r = next(r for r in bwd_rows if r["kernel"] == kind
                 and r["dtype"] == str(torch.bfloat16))
        kernels.append({
            "name": name, "route": "cuda", "source": src.format("bwd"),
            "replaces": ref.format(line), "launches": train_k[name],
            "max_abs_err": max(e[0] for e in bwd_errs[kind].values()),
            "max_rel_err_f32": bwd_errs[kind][torch.float32][1],
            "max_rel_err_bf16": bwd_errs[kind][torch.bfloat16][1],
            "shape": "BH=64 T=1024 D=64 bfloat16 causal",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernel_shapes": rows, "bwd_kernel_shapes": bwd_rows,
                      "card": smi}), flush=True)
    print(json.dumps({"slice": slice_row, "card": smi}), flush=True)
    print(json.dumps({"train": train_row, "cross_device": cross_row,
                      "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
