#!/usr/bin/env python3
"""Two studies of K7 (the fused 1x1 conv + bias + relu) on one NVIDIA card,
using ``chip_smoke.py``'s helpers. Run from the repository root:

    python3 k7_study.py sweep [--out DIR]
    python3 k7_study.py serve --parent DIR [--out DIR]

``sweep`` times every plan the kernel admits (each compiled tile, C cut
into 1-8 ranges of a multiple of 32 channels) at every distinct 1x1 shape
of a GoogLeNet forward at the served batches (1, 8 and 32), holds each
plan's output against the plain version, and sums each batch's 37 calls
under the plan ``tile_plan`` picks, under the plans simpler rules would
pick, under the best plan measured at each shape, and under
``relu(addmm)``. It is the evidence for ``tile_plan``'s rules.

``serve`` holds this checkout's K7, and the same K7 with no call split
(no cluster launch), against the K7 of another checkout ``DIR`` (an
unpacked ``git archive`` of an earlier commit whose entry point takes M,
C, F and the dtype and no plan), alternated in one process: the host time
of one wrapper call and of the entry points alone, a GoogLeNet forward at
B 1, 8 and 32 (loop time, the host's enqueue time, the card's span with
the gaps between kernels, profiled device time and K7's part of it) and
closed-loop serving under ``chip_smoke.py``'s traffic, three times as
long.

Device times in ``sweep`` and host times in ``serve`` are taken behind a
sleep kernel that holds the stream while every call is enqueued, so CUDA
events around groups of calls time the card alone, and the host's clock
around the enqueue times the host alone. Both print a summary, and write
their readings as JSON into ``--out`` when it is given; both need a card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from deeplearning4j_tpu_torch.models.zoo_extra import googlenet
from deeplearning4j_tpu_torch.ops import nvcc
from deeplearning4j_tpu_torch.ops.kernels import conv as k7
from deeplearning4j_tpu_torch.serving import InferenceEngine

BATCHES = (1, 8, 32)              # the GoogLeNet serving buckets
REPS = 20                         # calls a timed group
SLEEP_CYCLES = int(2e8)           # ~0.1 s at the card's clock


def _behind_sleep(enqueue, cycles=SLEEP_CYCLES):
    """Run ``enqueue(record)`` while a sleep kernel of ``cycles`` holds the
    current stream; ``record()`` records and returns a timing event.
    Returns the host's ms for the enqueue. Raises if the card woke before
    the host was done, since the events would then time the host."""
    torch.cuda.synchronize()
    start, woke = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    woke.record()
    t0 = time.perf_counter()

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    enqueue(record)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    slept = start.elapsed_time(woke)
    if slept <= host_ms:
        raise RuntimeError(f"the sleep kernel ({slept:.1f} ms) ended before "
                           f"the host had enqueued ({host_ms:.1f} ms)")
    return host_ms


def device_ms(calls, reps=REPS):
    """Device time (ms) of one call of each zero-arg callable: ``reps``
    calls of each, back to back between two events, behind a sleep."""
    for fn in calls:                  # warm: library loaded, attributes set
        fn()
    marks = []

    def enqueue(record):
        marks.append(record())
        for fn in calls:
            for _ in range(reps):
                fn()
            marks.append(record())

    _behind_sleep(enqueue)
    return [marks[i].elapsed_time(marks[i + 1]) / reps
            for i in range(len(calls))]


# ------------------------------------------------------------------ sweep
def admissible(M, C, F):
    """Every plan the kernel takes: a compiled tile and C cut into 1-8
    non-empty ranges of a multiple of 32 channels."""
    steps = -(-C // k7.C_STEP)
    for bm, bn in k7.TILES:
        for s in range(1, min(k7.MAX_SPLITS, steps) + 1):
            k_per = -(-steps // s) * k7.C_STEP
            if -(-C // k_per) == s:
                yield k7.TilePlan(bm, bn, s, k_per)


def least_padding_widths(F):
    """The tile widths that pad F least."""
    padded = {bn: -(-F // bn) * bn for _, bn in k7.TILES}
    return [bn for bn, p in padded.items() if p == min(padded.values())]


def rule_pick(M, C, F, sms, min_split=k7.C_STEP, ties=(), widths=False,
              band=k7.BLOCKS_PER_SM):
    """The plan a variant of ``tile_plan``'s rule picks: the ``band`` of
    blocks per SM, then the tie-breaks ``ties`` in order (the first plan in
    ``admissible``'s order wins what remains); ``min_split`` is the least
    range of channels a split may take, ``widths`` whether the tile's width
    must pad F least."""
    lo, hi = band
    cols = least_padding_widths(F) if widths else [bn for _, bn in k7.TILES]

    def key(p):
        per = p.blocks(M, F) / sms
        miss = max(math.log(lo / per), math.log(per / hi), 0.0)
        tie = {"-bn": -p.bn, "splits": p.splits, "-bm": -p.bm}
        return (round(miss, 9), *(tie[t] for t in ties))

    return min((p for p in admissible(M, C, F) if p.bn in cols
                and (p.splits == 1 or p.k_per >= min_split)), key=key)


# tile_plan's rule, and rules it was or could be: the rule before the
# sweeps (a width that pads F least, ranges of at least 128 channels, three
# tie-breaks), each of those parts alone, other bands of blocks
RULES = {"tile_plan": {},
         "pad F least, ranges >= 128, ties -bn, splits, -bm": {
             "widths": True, "min_split": 128,
             "ties": ("-bn", "splits", "-bm")},
         "pad F least": {"widths": True},
         "ranges >= 128": {"min_split": 128},
         "ties -bn, splits": {"ties": ("-bn", "splits")},
         "ties -bm": {"ties": ("-bm",)},
         **{f"band {b}": {"band": b}
            for b in ((2, 4), (3, 5), (1.5, 3), (4, 8))}}


def sweep():
    """Every admissible plan at every served shape, timed and checked;
    each batch's 37 calls summed under each rule of ``RULES``."""
    cs.device_phase()
    sms = k7._sm_count(torch.cuda.current_device())
    fn = k7.load_symbol(k7._SYMBOL, k7.build,
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    calls = {B: [(M, C, F) for _, M, C, F in cs.googlenet_1x1_shapes(B)]
             for B in BATCHES}
    shapes = sorted({s for B in BATCHES for s in calls[B]})
    for M, C, F in shapes:              # the rules' copy is tile_plan's
        if rule_pick(M, C, F, sms) != k7.tile_plan(M, C, F, sms):
            raise AssertionError(f"rule_pick disagrees with tile_plan at "
                                 f"{M}x{C}x{F}")
    gen = torch.Generator().manual_seed(cs.SEED + 11)
    rows, worst = {}, 0.0
    for M, C, F in shapes:
        x = torch.randn(M, C, generator=gen).cuda()
        w = (torch.randn(C, F, generator=gen) * (2.0 / C) ** 0.5).cuda()
        b = (torch.randn(F, generator=gen) * 0.1 + 0.2).cuda()
        want = k7._conv1x1_plain(x, w, b)
        out = torch.empty(M, F, device="cuda")
        plans = list(admissible(M, C, F))
        launches = []
        for p in plans:
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                    M, C, F, 0, *p, stream)
            err = fn(*args)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"K7 plan {tuple(p)} at {M}x{C}x{F}: "
                                   f"CUDA error {err}")
            rel = cs._rel_to_max(out, want)
            if rel > 1e-5:
                raise AssertionError(f"K7 plan {tuple(p)} at {M}x{C}x{F}: "
                                     f"rel-to-max {rel:.3g}")
            worst = max(worst, rel)
            launches.append(lambda a=args: fn(*a))
        ms = []
        for i in range(0, len(launches), 16):      # <= 336 launches a sleep
            ms += device_ms(launches[i:i + 16])
        lib = device_ms([lambda: torch.relu(torch.addmm(b, x, w))])[0]
        rows[(M, C, F)] = {"M": M, "C": C, "F": F, "library_ms": lib,
                           "plans": {",".join(map(str, p)): t
                                     for p, t in zip(plans, ms)}}
    summary = {}
    for B in BATCHES:
        tot = {"library": 0.0, "best": 0.0}
        for M, C, F in calls[B]:
            row = rows[(M, C, F)]
            tot["library"] += row["library_ms"]
            tot["best"] += min(row["plans"].values())
        for name, kw in RULES.items():
            tot[name] = sum(rows[s]["plans"][",".join(map(
                str, rule_pick(*s, sms, **kw)))] for s in calls[B])
        summary[B] = tot
    for (M, C, F), row in rows.items():
        p = ",".join(map(str, k7.tile_plan(M, C, F, sms)))
        best = min(row["plans"], key=row["plans"].get)
        print(f"{M}x{C}x{F}: library {row['library_ms'] * 1e3:.1f} us, "
              f"tile_plan ({p}) {row['plans'][p] * 1e3:.1f} us, best ({best})"
              f" {row['plans'][best] * 1e3:.1f} us", flush=True)
    for B, tot in summary.items():
        print(f"B {B}, 37 calls, ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in tot.items()), flush=True)
    print(f"worst rel-to-max over every plan: {worst:.3g}", flush=True)
    return {"sms": sms, "rows": list(rows.values()), "summary_ms": summary,
            "worst_rel": worst}


# ------------------------------------------------------------------ serve
def other_entry(checkout):
    """The other checkout's K7 entry point, built from its source: it takes
    the four pointers, M, C, F, the dtype and the stream."""
    lib = nvcc.build_library(Path(checkout).resolve() / "deeplearning4j_tpu_"
                             "torch" / "csrc" / "conv1x1_bias_relu.cu")
    fn = ctypes.CDLL(str(lib)).dl4j_conv1x1_bias_relu
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def other_launch(fn):
    """``_launch`` as the other checkout's wrapper does it, on its entry
    point ``fn``."""

    def launch(xm, wm, b):
        M, C = xm.shape
        F = wm.shape[1]
        out = torch.empty((M, F), dtype=xm.dtype, device=xm.device)
        with torch.cuda.device(xm.device):
            stream = torch.cuda.current_stream(xm.device).cuda_stream
            err = fn(xm.data_ptr(), wm.data_ptr(), b.data_ptr(),
                     out.data_ptr(), M, C, F,
                     int(xm.dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"the other K7 failed with CUDA error {err}")
        return out

    return launch


def _calls(x, w, b, n):
    """``n`` wrapper calls, each output dropped before the next call, so
    the allocator hands the same block back and never calls cudaMalloc
    (which would wait for the sleep kernel)."""
    for _ in range(n):
        k7.conv1x1_fused(x, w, b)


def serve(parent):
    """This K7 against the one of the checkout ``parent``, alternated: host
    time a call, forwards at each batch, serving, then device time."""
    cs.device_phase()
    other = other_entry(parent)
    this = k7.load_symbol(k7._SYMBOL, k7.build,
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p])
    launchers = {"parent": other_launch(other), "this": k7._launch,
                 "this unsplit": k7._launch}
    plan = k7.tile_plan
    # this K7 with no call split: the band's best plan of one range
    unsplit = functools.lru_cache(maxsize=None)(
        lambda M, C, F, sms: rule_pick(M, C, F, sms, min_split=math.inf))
    pair = ["parent", "this", "this", "parent"] * 2
    order = ["parent", "this", "this unsplit", "this unsplit", "this",
             "parent"] * 2

    def use(side):
        k7._launch = launchers[side]
        k7.tile_plan = unsplit if side == "this unsplit" else plan

    out = {"order": order, "call_us": [], "forward": [], "device": [],
           "serve": []}
    gen = torch.Generator().manual_seed(cs.SEED + 21)
    try:
        # one wrapper call's host time: 300 calls enqueued behind a sleep,
        # at shapes this K7 splits (B 1's parity shape and 7x7 conv) and
        # one it does not (B 32's 28x28 conv)
        for M, C, F in ((32, 128, 128), (49, 832, 128), (25088, 256, 64)):
            x = torch.randn(M, C, generator=gen).cuda()
            w = torch.randn(C, F, generator=gen).cuda()
            b = torch.randn(F, generator=gen).cuda()
            for side in pair:
                use(side)
                k7.conv1x1_fused(x, w, b)
                host = _behind_sleep(lambda record: _calls(x, w, b, 300))
                out["call_us"].append({"shape": [M, C, F], "k7": side,
                                       "us": host / 300 * 1e3})
            # the entry points alone (ctypes and the CUDA launch): the
            # other's, and this one's with the plan unsplit and split
            o = torch.empty(M, F, device="cuda")
            ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr())
            stream = torch.cuda.current_stream().cuda_stream
            plans = {"this unsplit": (64, 64, 1, -(-C // 32) * 32),
                     "this split 4": (64, 64, 4, -(-C // 128) * 32)}
            raw = {"parent": lambda: other(*ptrs, M, C, F, 0, stream)}
            for name, p in plans.items():
                raw[name] = lambda p=p: this(*ptrs, M, C, F, 0, *p, stream)
            for name in list(raw) * 2:
                if raw[name]():
                    raise RuntimeError(f"{name} entry point failed at "
                                       f"{M}x{C}x{F}")
                host = _behind_sleep(
                    lambda record: [raw[name]() for _ in range(300)])
                out["call_us"].append({"shape": [M, C, F],
                                       "k7": f"{name}, entry point alone",
                                       "us": host / 300 * 1e3})
        net = googlenet(**cs.GNET).init(seed=cs.SEED + 13)
        fwd = lambda n, x: n._output_pure(x)[0]
        pool = np.random.default_rng(cs.SEED + 14).standard_normal(
            (32, 224, 224, 3)).astype(np.float32)
        with torch.inference_mode():
            for B in BATCHES:
                x = torch.as_tensor(pool[:B], device=net.device)
                for side in order:
                    use(side)
                    wall = cs._time_ms(lambda: fwd(net, x), iters=10)
                    host = []
                    for _ in range(5):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fwd(net, x)
                        host.append((time.perf_counter() - t0) * 1e3)
                    # the card's span for one forward, gaps between its
                    # kernels included: enqueued whole behind a sleep
                    marks = []
                    _behind_sleep(lambda record: (
                        marks.append(record()), fwd(net, x),
                        marks.append(record())), cycles=4 * SLEEP_CYCLES)
                    out["forward"].append({
                        "B": B, "k7": side, "wall_ms": wall,
                        "host_ms": statistics.median(host),
                        "span_ms": marks[0].elapsed_time(marks[1])})
        eng = InferenceEngine(net, feature_shape=(224, 224, 3),
                              buckets=cs.GNET_BUCKETS, forward_fn=fwd)
        # chip_smoke.py's clients, each sending three times as many
        per_client = 3 * cs.GNET_PER_CLIENT
        n_rows = sum(cs.GNET_SIZES[(c + i) % len(cs.GNET_SIZES)]
                     for c in range(cs.GNET_CLIENTS)
                     for i in range(per_client))
        try:
            for side in order:
                use(side)
                lat, wall = cs._serve_closed_loop(
                    eng, pool[:16], cs.GNET_SIZES, cs.GNET_CLIENTS,
                    per_client)
                out["serve"].append({"k7": side,
                                     "images_per_s": n_rows / wall,
                                     "p50_ms": float(np.percentile(lat, 50)),
                                     "p99_ms": float(np.percentile(lat, 99))})
        finally:
            eng.stop()
        # the profiler last: its sessions slow the host afterwards
        with torch.inference_mode():
            for B in BATCHES:
                x = torch.as_tensor(pool[:B], device=net.device)
                for side in launchers:
                    use(side)
                    kern = cs._device_kernels(lambda: fwd(net, x), top=1000)
                    k7_ms = sum(r["ms"] for r in kern["top"]
                                if "conv1x1" in r["kernel"])
                    out["device"].append({"B": B, "k7": side,
                                          "device_ms": kern["device_ms"],
                                          "k7_ms": k7_ms})
    finally:
        use("this")
    med = {}
    for key, metric in (("call_us", "us"), ("forward", "wall_ms"),
                        ("forward", "host_ms"), ("forward", "span_ms"),
                        ("serve", "images_per_s"),
                        ("serve", "p50_ms")):
        for row in out[key]:
            tag = (key, metric, str(row.get("B", row.get("shape", ""))),
                   row["k7"])
            med.setdefault(tag, []).append(row[metric])
    out["medians"] = [{"what": f"{k[0]}.{k[1]} {k[2]}".strip(), "k7": k[3],
                       "median": statistics.median(v), "readings": v}
                      for k, v in med.items()]
    for row in out["medians"] + out["device"]:
        print(json.dumps(row), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="study", required=True)
    sw = sub.add_parser("sweep", help="every plan at every served 1x1 shape")
    sv = sub.add_parser("serve", help="this K7 against another checkout's")
    sv.add_argument("--parent", required=True,
                    help="root of the other checkout")
    for p in (sw, sv):
        p.add_argument("--out", type=Path,
                       help="directory for the readings as JSON")
    args = ap.parse_args()
    result = sweep() if args.study == "sweep" else serve(args.parent)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"k7_{args.study}.json").write_text(
            json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
