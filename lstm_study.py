#!/usr/bin/env python3
"""The LSTM kernels on one NVIDIA card, by device time, in one process: K5
(the forward) against another checkout's K5 and each plan it compiles, and
K6 (the backward) under each of its plans, both beside cuDNN's LSTM. Run
from the repository root:

    python3 lstm_study.py [--parent DIR] [--out DIR]

K5, at each shape a path launches it with (float32, Graves peepholes,
H 512; ``chip_smoke.py`` phase 19): a decode step (T 1, B 8), the two
prefills (T 128 at B 4 and T 64 at B 1, masked) and the training chunks
(T 64, 50 and 14 at B 32). At each it holds every side against the plain
version (atol 1e-5) and against itself (two runs, the same bits), then
times, alternated (this, others, others reversed, this):

- this K5 under the plan ``fwd_plan`` picks (the profiler's kernel sums
  over 20 calls);
- every other plan of ``lstm.FWD_CANDIDATES`` that fits the card;
- with ``--parent DIR`` (an unpacked ``git archive`` of an earlier commit
  whose K5 entry takes 17 pointers, the [2,B,H] and [B,H] f32 scratch of
  h and c among them, 4 ints and the stream: one block a unit group, no
  plan), that K5;
- cuDNN's ``torch.nn.LSTM(87, 512)`` forward at the same T and B.

K6, at the training chunks (T 64, 50, 14, B 32): this K6 under
``loop_plan``'s plan and every other plan of ``lstm.LOOP_CANDIDATES``
that fits, held against its plain version (atol 3e-5), alternated, beside
cuDNN's backward at T 64.

A kernel's microseconds a step are the T 64 and T 14 calls' difference
over their 50 steps. For each plan of this checkout's K5 and K6 it also
reads where a step's time goes: block 0's thread 0 stamps its clock at
eight points of each step (``trace=`` of ``_fwd_launch`` and
``_bwd_launch``; ``TRACE_MARKS`` in ``csrc/lstm_fwd.cu`` and
``csrc/lstm_bwd.cu``), and the median over the steps of each stretch is
printed in cycles and, at the SM clock ``nvidia-smi`` reads just after, in
microseconds. Prints a summary and, with ``--out``, writes the readings as
JSON there; needs a card.
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
ROUNDS = 2                       # (this, others, others reversed, this) rounds
# (name, T, B, masked): the shapes each path launches K5 with
FWD_PATHS = (("decode_T1_B8", 1, 8, False),
             ("prefill_T128_B4", 128, 4, True),
             ("prefill_T64_B1", 64, 1, True),
             ("train_T64_B32", cs.CHAR_T, B, False),
             ("train_T50_B32", 50, B, False),
             ("train_T14_B32", 14, B, False))


def device_split(fn, n=20):
    """{kernel name: device ms a call} over ``n`` calls of ``fn``: each
    kernel's profiled time over the launches the profiler recorded."""
    top = cs._device_kernels(lambda: [fn() for _ in range(n)],
                             top=1000)["top"]
    return {r["kernel"]: r["ms"] / r["calls"] for r in top
            if "lstm" in r["kernel"]}


# the stretches between TRACE_MARKS' points, in order
FWD_STRETCHES = ("copy", "product", "block_sum_and_push",
                 "cluster_barrier", "cell_update", "arrive_and_hidden_work",
                 "barrier_wait")
BWD_STRETCHES = ("a", "arrive_and_hidden_work", "barrier_wait", "copy_issue",
                 "product_and_block_reduce", "cluster_barrier",
                 "cluster_reduce")


def step_trace(launch, T, stretches, reps=3, rows=None):
    """Median cycles of each stretch of a step, and of a whole step, over
    the steps of a call (the first and last left out; a one-step call's
    one step), with the SM clock (MHz) read just after. ``launch(trace)``
    runs the kernel once on a [``rows`` (default T), 8] trace. K5's trace
    has a row more, its prologue and end: those stretches too."""
    rows = T if rows is None else rows
    buf = torch.zeros(rows, len(stretches) + 1, dtype=torch.int64,
                      device="cuda")
    for _ in range(reps):
        launch(buf)
    torch.cuda.synchronize()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    tr = buf.cpu().tolist()
    steps = range(1, T - 1) if T > 2 else range(T)
    cycles = {name: statistics.median(tr[r][k + 1] - tr[r][k] for r in steps)
              for k, name in enumerate(stretches)}
    if T > 2:
        cycles["step"] = statistics.median(tr[r + 1][0] - tr[r][0]
                                           for r in steps)
    if rows > T:
        cycles["prologue"] = tr[T][1] - tr[T][0]
        cycles["prologue_to_step_0"] = tr[0][0] - tr[T][1]
        cycles["kernel"] = tr[T][2] - tr[T][0]
    return {"sm_mhz": mhz, "cycles": cycles,
            "us": {k: v / mhz for k, v in cycles.items()}}


def parent_fwd(parent: Path):
    """The K5 entry point of the checkout ``parent`` (17 pointers, 4 ints,
    the stream) and a launcher taking the wrapper's arguments."""
    lib = nvcc.build_library(
        parent / "deeplearning4j_tpu_torch" / "csrc" / "lstm_fwd.cu")
    fn = ctypes.CDLL(str(lib)).dl4j_lstm_fwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x_proj, h0, c0, R, mask, peep):
        T, B_, H4 = x_proj.shape
        H_ = H4 // 4
        new = lambda *shape, dtype=x_proj.dtype: torch.empty(
            shape, dtype=dtype, device=x_proj.device)
        outs = [new(T, B_, H_) for _ in range(4)]       # hs, cs, c/h_prev
        gates, hT, cT = new(T, B_, H4), new(B_, H_), new(B_, H_)
        hbuf = new(2, B_, H_, dtype=torch.float32)
        cbuf = new(B_, H_, dtype=torch.float32)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(*[ptr(t) for t in (x_proj, R, h0, c0, mask, *peep,
                                    outs[0], gates, *outs[1:], hT, cT,
                                    hbuf, cbuf)],
                 T, B_, H_, int(x_proj.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's dl4j_lstm_fwd failed: {err}")
        return (outs[0], gates, *outs[1:], hT, cT)
    return launch


def alternate(sides, cases, sessions):
    """Device ms of each side at each case, alternated (this, others,
    others reversed, this) ``ROUNDS`` times: {side: {case: [ms, ...]}}."""
    readings = {name: {c: [] for c in cases} for name in sides}
    others = [n for n in sides if n != "this"]
    for name in (["this"] + others + others[::-1] + ["this"]) * ROUNDS:
        for c, args in cases.items():
            readings[name][c].append(sessions(sides[name], args))
    return readings


def cudnn_fwd_ms(gen, T, B_):
    """cuDNN's ``nn.LSTM(87, 512)`` forward at (T, B) by device time."""
    cud = torch.nn.LSTM(cs.CHAR["vocab_size"], H).cuda()
    xin = torch.randn(T, B_, cs.CHAR["vocab_size"], generator=gen).cuda()
    with torch.no_grad():
        return cs._library_device_ms(lambda: cud(xin))


def fwd_study(args, gen):
    f32 = torch.float32
    index = torch.cuda.current_device()
    cases, plans, sides = {}, {}, {}
    for tag, T, B_, masked in FWD_PATHS:
        fwd, mask, peeps, _ = cs._lstm_case(gen, T, B_, H, f32, True, masked)
        cases[tag] = (*fwd, mask, peeps)
    plan, layout = lstm._fwd_plan(index, H, B, f32)
    plans["this"] = plan
    sides["this"] = lambda *a: lstm.fused_lstm_fwd(*a)
    for q, u in lstm.FWD_CANDIDATES:
        other = lstm.FwdPlan(q, u, -(-H // u))
        lay = lstm._fwd_layout(index, H, B, f32, q, u)
        if other != plan and lay.smem and other.clusters <= lay.max_clusters \
                and other.blocks <= lstm._sm_count(index):
            name = f"plan_q{q}_u{u}"
            plans[name] = other
            sides[name] = (lambda p: lambda *a: lstm._fwd_launch(
                *a, plan=p))(other)
    if args.parent is not None:
        sides["parent"] = parent_fwd(args.parent.resolve())
    out = {"plans": {k: {"plan": p._asdict(), "layout": {
        tag: lstm._fwd_layout(index, H, B_, f32, p.q, p.u)._asdict()
        for tag, _, B_, _ in FWD_PATHS}} for k, p in plans.items()},
        "errors": {}, "bitwise_two_runs": {}, "device_ms": {}}
    for name, fn in sides.items():
        out["errors"][name], out["bitwise_two_runs"][name] = {}, {}
        for tag, args_ in cases.items():
            got, again = fn(*args_), fn(*args_)
            torch.cuda.synchronize()
            err = cs._max_err(got, lstm.lstm_fwd_reference(*args_))
            out["errors"][name][tag] = err
            out["bitwise_two_runs"][name][tag] = all(
                torch.equal(a, b) for a, b in zip(got, again))
            if err > cs.LSTM_TOL[("fwd", f32)]:
                raise AssertionError(f"K5 ({name}) disagrees with plain at "
                                     f"{tag}: {err}")
    readings = alternate(sides, cases,
                         lambda fn, a: sum(device_split(lambda: fn(*a))
                                           .values()))
    for name, by_tag in readings.items():
        row = {f"{tag}_ms": statistics.median(v) for tag, v in by_tag.items()}
        row.update({f"{tag}_ms_all": v for tag, v in by_tag.items()})
        row["us_per_step"] = (row["train_T64_B32_ms"]
                              - row["train_T14_B32_ms"]) / (cs.CHAR_T - 14) * 1e3
        out["device_ms"][name] = row
    out["step_trace"] = {
        f"{name} {tag}": step_trace(
            lambda buf, p=p, a=cases[tag]: lstm._fwd_launch(
                *a, plan=p, trace=buf), cases[tag][0].shape[0],
            FWD_STRETCHES, rows=cases[tag][0].shape[0] + 1)
        for name, p in plans.items()
        for tag in ("train_T64_B32", "prefill_T128_B4", "decode_T1_B8")}
    out["cudnn_fwd_device_ms"] = {tag: cudnn_fwd_ms(gen, T, B_)
                                  for tag, T, B_, _ in FWD_PATHS}
    out["bound_ms"] = {tag: cs._lstm_bound("fwd", T, B_, H, f32, True,
                                           masked)
                       for tag, T, B_, masked in FWD_PATHS}
    return out


def bwd_study(gen):
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
    cases = {}
    for T in STEPS:
        fwd, mask, peeps, (dhs, dhT, dcT) = cs._lstm_case(
            gen, T, B, H, f32, True, False)
        res = lstm.lstm_fwd_reference(*fwd, mask, peeps)[1:5]
        cases[T] = (*res, dhs, fwd[3], dhT, dcT, mask, peeps)
    out = {"plans": {k: {"plan": p._asdict(), "layout": lay._asdict()}
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
    readings = alternate(sides, cases,
                         lambda fn, a: sum(device_split(lambda: fn(*a))
                                           .values()))
    for name, by_t in readings.items():
        row = {f"T{T}_ms": statistics.median(v) for T, v in by_t.items()}
        row.update({f"T{T}_ms_all": v for T, v in by_t.items()})
        row["us_per_step"] = (row[f"T{cs.CHAR_T}_ms"] - row["T14_ms"]) \
            / (cs.CHAR_T - 14) * 1e3
        out["device_ms"][name] = row
    out["step_trace"] = {
        name: step_trace(lambda buf, p=p: lstm._bwd_launch(
            *bargs, plan=p, trace=buf), cs.CHAR_T, BWD_STRETCHES)
        for name, (p, _) in plans.items()}
    cud = torch.nn.LSTM(cs.CHAR["vocab_size"], H).cuda()
    xin = torch.randn(cs.CHAR_T, B, cs.CHAR["vocab_size"],
                      generator=gen).cuda().requires_grad_(True)
    o, _ = cud(xin)
    dout = torch.randn(cs.CHAR_T, B, H, generator=gen).cuda()
    leaves = [xin, *cud.parameters()]
    grad = lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True)
    grad()
    out["cudnn_bwd_device_ms"] = [cs._library_device_ms(grad)
                                  for _ in range(3)]
    out["bound_ms"] = cs._lstm_bound("bwd", cs.CHAR_T, B, H, f32, True,
                                     False)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    smi = cs.device_phase()
    gen = torch.Generator().manual_seed(cs.SEED + 40)
    out = {"card": smi, "software": cs.SOFTWARE,
           "k5": fwd_study(args, gen), "k6": bwd_study(gen)}
    print(json.dumps(out, indent=1))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "lstm_study.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
