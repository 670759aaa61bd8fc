#!/usr/bin/env python3
"""K6 (the LSTM backward) on one NVIDIA card: this checkout's kernel, each
plan it compiles, another checkout's kernel and cuDNN's LSTM backward, by
device time, in one process. Run from the repository root:

    python3 lstm_study.py [--parent DIR] [--out DIR]

At the char-RNN's training shape (T 64 and its tBPTT chunks 50 and 14,
B 32, H 512, float32, Graves peepholes; ``chip_smoke.py`` phase 6) it
holds this K6 against its plain version (atol 3e-5) and against itself (two
runs, the same bits), then times, alternated (other, this, this, other):

- this K6 under the plan ``loop_plan`` picks, by device time (the
  profiler's kernel sums over 20 calls, each kernel of a call named);
- every other plan of ``lstm.LOOP_CANDIDATES`` that fits the card at H 512
  (each also held against the plain version);
- with ``--parent DIR`` (an unpacked ``git archive`` of an earlier commit
  whose K6 entry takes three [B,H] f32 scratch buffers and no plan, as the
  reverse loop and its separate dR pass did), that K6, also checked;
- cuDNN's ``torch.nn.LSTM(87, 512)`` backward (``autograd.grad`` of the
  forward's output, input and parameters) at T 64, B 32.

The loop's microseconds a step are the T 64 and T 14 calls' difference
over their 50 steps. For each plan of this K6 it also reads where a step's
time goes: block 0's thread 0 stamps its clock at eight points of each step
(``_bwd_launch(trace=...)``; ``csrc/lstm_bwd.cu`` TRACE_MARKS), and the
median over the steps of each stretch is printed in cycles and, at the SM
clock ``nvidia-smi`` reads just after, in microseconds. Prints a summary
and, with ``--out``, writes the readings as JSON there; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from deeplearning4j_tpu_torch.ops import lstm, nvcc

H, B = cs.CHAR["hidden"], cs.CHAR_B
STEPS = (cs.CHAR_T, 50, 14)
ROUNDS = 2                       # (other, this, this, other) rounds


def device_split(fn, n=20):
    """{kernel name: device ms a call} over ``n`` calls of ``fn``: each
    kernel's profiled time over the launches the profiler recorded."""
    top = cs._device_kernels(lambda: [fn() for _ in range(n)],
                             top=1000)["top"]
    return {r["kernel"]: r["ms"] / r["calls"] for r in top
            if "lstm" in r["kernel"]}


def library_device_ms(fn, n=20):
    """Device time of one call of a library call that launches several
    kernels: the whole session over the calls recorded, read from the
    kernels launched once a call (the profiler drops a few records)."""
    rep = cs._device_kernels(lambda: [fn() for _ in range(n)], top=1000)
    once = max(r["calls"] for r in rep["top"] if r["calls"] <= n)
    return rep["device_ms"] / once


# the stretches between TRACE_MARKS' points, in order
STRETCHES = ("a", "arrive_and_hidden_work", "barrier_wait", "copy_issue",
             "product_and_block_reduce", "cluster_barrier", "cluster_reduce")


def step_trace(bargs, plan, reps=3):
    """Median cycles of each stretch of a step, and of a whole step, over
    the steps of a call (the first and last left out), with the SM clock
    (MHz) read just after."""
    T = bargs[0].shape[0]
    buf = torch.zeros(T, len(STRETCHES) + 1, dtype=torch.int64,
                      device="cuda")
    for _ in range(reps):
        lstm._bwd_launch(*bargs, plan=plan, trace=buf)
    torch.cuda.synchronize()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    tr = buf.cpu().tolist()
    steps = range(1, T - 1)
    cycles = {name: statistics.median(tr[r][k + 1] - tr[r][k] for r in steps)
              for k, name in enumerate(STRETCHES)}
    cycles["step"] = statistics.median(tr[r + 1][0] - tr[r][0]
                                       for r in steps)
    return {"sm_mhz": mhz, "cycles": cycles,
            "us": {k: v / mhz for k, v in cycles.items()}}


def parent_entry(parent: Path):
    """The K6 entry point of the checkout ``parent`` and a launcher taking
    the wrapper's arguments."""
    lib = nvcc.build_library(
        parent / "deeplearning4j_tpu_torch" / "csrc" / "lstm_bwd.cu")
    fn = ctypes.CDLL(str(lib)).dl4j_lstm_bwd
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(gates, cs_, c_prev, h_prev, dhs, R, dhT, dcT, mask, peep):
        T, B_, H4 = gates.shape
        H_ = H4 // 4
        new = lambda *shape, dtype=gates.dtype: torch.empty(
            shape, dtype=dtype, device=gates.device)
        dxp, dh0, dc0, dR = new(T, B_, H4), new(B_, H_), new(B_, H_), \
            new(H_, H4)
        dps = [new(1, H_) for _ in range(3)]
        scratch = [new(B_, H_, dtype=torch.float32) for _ in range(3)]
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(*[ptr(t) for t in (gates, cs_, c_prev, h_prev, dhs, R, dhT,
                                    dcT, mask, *peep, dxp, dh0, dc0, dR,
                                    *dps, *scratch)],
                 T, B_, H_, int(gates.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's dl4j_lstm_bwd failed: {err}")
        return (dxp, dh0, dc0, dR, *dps)
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    smi = cs.device_phase()
    gen = torch.Generator().manual_seed(cs.SEED + 40)
    f32 = torch.float32
    index = torch.cuda.current_device()
    plan, layout = lstm._bwd_plan(index, H, B, f32)
    sides = {"this": lambda *a: lstm.fused_lstm_bwd(*a)}
    plans = {"this": (plan, layout)}
    for q, u in lstm.LOOP_CANDIDATES:
        lay = lstm._layout(index, H, B, f32, q, u)
        other = lstm.LoopPlan(q, u, -(-H // u))
        if other != plan and lay.smem and other.clusters <= lay.max_clusters:
            name = f"plan_q{q}_u{u}"
            sides[name] = (lambda p: lambda *a: lstm._bwd_launch(
                *a, plan=p))(other)
            plans[name] = (other, lay)
    if args.parent is not None:
        sides["parent"] = parent_entry(args.parent.resolve())
    cases = {}
    for T in STEPS:
        fwd, mask, peeps, (dhs, dhT, dcT) = cs._lstm_case(
            gen, T, B, H, f32, True, False)
        res = lstm.lstm_fwd_reference(*fwd, mask, peeps)[1:5]
        cases[T] = (*res, dhs, fwd[3], dhT, dcT, mask, peeps)
    out = {"card": smi, "software": cs.SOFTWARE,
           "plans": {k: {"plan": p._asdict(), "layout": lay._asdict()}
                     for k, (p, lay) in plans.items()},
           "errors": {}, "bitwise_two_runs": {}, "device_ms": {}}
    bargs = cases[cs.CHAR_T]
    want = lstm.lstm_bwd_reference(*bargs)
    for name, fn in sides.items():
        got, again = fn(*bargs), fn(*bargs)
        torch.cuda.synchronize()
        err = cs._max_err(got, want)
        out["errors"][name] = err
        out["bitwise_two_runs"][name] = all(
            torch.equal(a, b) for a, b in zip(got, again))
        if err > cs.LSTM_TOL[("bwd", f32)]:
            raise AssertionError(f"K6 ({name}) disagrees with plain: {err}")
    readings = {name: {T: [] for T in STEPS} for name in sides}
    others = [n for n in sides if n != "this"]
    order = (["this"] + others + others[::-1] + ["this"]) * ROUNDS
    for name in order:
        for T in STEPS:
            readings[name][T].append(device_split(
                lambda: sides[name](*cases[T])))
    for name, by_t in readings.items():
        row = {}
        for T, splits in by_t.items():
            totals = [sum(s.values()) for s in splits]
            row[f"T{T}_ms"] = statistics.median(totals)
            row[f"T{T}_ms_all"] = totals
            row[f"T{T}_kernels"] = splits[0]
        row["us_per_step"] = (row[f"T{cs.CHAR_T}_ms"] - row["T14_ms"]) \
            / (cs.CHAR_T - 14) * 1e3
        out["device_ms"][name] = row
    out["step_trace"] = {name: step_trace(bargs, p)
                         for name, (p, _) in plans.items()}
    cud = torch.nn.LSTM(cs.CHAR["vocab_size"], H).cuda()
    xin = torch.randn(cs.CHAR_T, B, cs.CHAR["vocab_size"],
                      generator=gen).cuda().requires_grad_(True)
    o, _ = cud(xin)
    dout = torch.randn(cs.CHAR_T, B, H, generator=gen).cuda()
    leaves = [xin, *cud.parameters()]
    grad = lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True)
    grad()
    out["cudnn_bwd_device_ms"] = [library_device_ms(grad)
                                  for _ in range(3)]
    out["bound_ms"] = cs._lstm_bound("bwd", cs.CHAR_T, B, H, f32, True,
                                     False)
    print(json.dumps(out, indent=1))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "lstm_study.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
