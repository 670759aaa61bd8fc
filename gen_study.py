#!/usr/bin/env python3
"""The generation engine's host-bound serving metrics, this checkout beside
another, alternated in one call on one NVIDIA card. Run from the
repository root:

    python3 gen_study.py [--parent DIR] [--rounds N] [--out DIR]

Each side runs in a fresh process whose ``deeplearning4j_tpu_torch`` is
that checkout's, so two versions of the package never share a process. A
side serves ``chip_smoke.py``'s two generation workloads with random
weights from its seed:

- phase 3's: ``transformer_lm`` at bench.py's ``_TLM`` width (f32), 8
  concurrent greedy requests of 300-900 prompt tokens and 32 new, on
  ``ENGINE``'s plan;
- phase 7's: the char-RNN (two GravesLSTM(512)), 8 requests of 40-160
  characters and 64 new, on ``CHAR_ENGINE``'s plan.

Each workload is served once untimed (the kernels' builds, plans and
first calls), then ``REPEATS`` times with fresh prompts; the engine's
metrics over the timed repeats give TTFT and decode-step p50/p99 and
decode tokens/s. With ``--parent DIR`` (an unpacked ``git archive`` of an
earlier commit) the order is this, parent, parent, this in each round;
the summary is each side's median over its runs, since host-bound
numbers spread widely from run to run. Both sides run their engine's
defaults: this checkout's decode step is a CUDA graph and its prefix cache
is on (fresh prompts: every request is a miss). Needs a card; writes the
readings as JSON under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPEATS = 3
METRICS = ("ttft_ms_p50", "ttft_ms_p99", "decode_step_ms_p50",
           "decode_step_ms_p99", "decode_tokens_per_sec", "wall_s")


def _serve(make_net, engine_kw, n_req, lens, vocab, max_tokens, seed):
    """One side's workload: an untimed run, then REPEATS timed ones on
    fresh metrics. Returns the timed runs' engine metrics."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
    eng = GenerationEngine(make_net(), **engine_kw)
    rt = eng.runtime() if hasattr(eng, "runtime") else eng._rt

    def run(rep):
        rng = np.random.default_rng(seed + rep)
        prompts = [rng.integers(1, vocab, size=int(n)).tolist()
                   for n in rng.integers(*lens, size=n_req)]
        streams = [eng.generate(p, max_tokens=max_tokens, stream=True)
                   for p in prompts]
        for s in streams:
            toks, reason = s.result()
            assert len(toks) == max_tokens and reason == "length"

    try:
        run(0)
        time.sleep(0.05)                 # the loop records its last step
        rt.metrics = type(rt.metrics)()
        t0 = time.perf_counter()
        for rep in range(1, REPEATS + 1):
            run(rep)
        wall = time.perf_counter() - t0
        time.sleep(0.05)
        snap = rt.metrics.snapshot()
    finally:
        eng.stop()
    return {"ttft_ms_p50": snap["ttft_ms"]["p50"],
            "ttft_ms_p99": snap["ttft_ms"]["p99"],
            "decode_step_ms_p50": snap["decode_step_ms"]["p50"],
            "decode_step_ms_p99": snap["decode_step_ms"]["p99"],
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "decode_steps": snap["decode_steps"], "wall_s": wall}


def side(cfg: dict) -> dict:
    """Serve both workloads with the importable package (one side)."""
    import torch
    from deeplearning4j_tpu_torch.models.zoo_extra import (
        text_generation_lstm, transformer_lm)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = cfg["SEED"]
    tlm = _serve(lambda: transformer_lm(**cfg["TLM"], token_input=True)
                 .init(seed=seed), cfg["ENGINE"], cfg["N_REQUESTS"],
                 (300, 901), cfg["TLM"]["vocab_size"], cfg["MAX_TOKENS"],
                 seed + 40)
    char = _serve(lambda: text_generation_lstm(**cfg["CHAR"]).init(seed=seed),
                  cfg["CHAR_ENGINE"], cfg["CHAR_REQUESTS"], (40, 161),
                  cfg["CHAR"]["vocab_size"], cfg["CHAR_MAX_TOKENS"],
                  seed + 50)
    return {"transformer": tlm, "char_rnn": char}


def _run_side(checkout: Path, cfg: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    out = subprocess.run(
        [sys.executable, str(HERE / "gen_study.py"), "--side",
         json.dumps(cfg)], cwd=checkout, env=env, capture_output=True,
        text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the side at {checkout} failed:\n"
                           f"{out.stderr[-4000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if Path(got["package"]) != checkout / "deeplearning4j_tpu_torch":
        raise RuntimeError(f"the side at {checkout} served the package at "
                           f"{got['package']}")
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--side")
    args = ap.parse_args()
    if args.side is not None:
        # the script's own directory leads sys.path: serve the package of
        # the checkout this side runs in (its working directory) instead
        sys.path[:] = [p for p in sys.path
                       if Path(p or ".").resolve() != HERE]
        sys.path.insert(0, os.getcwd())
        out = side(json.loads(args.side))
        import deeplearning4j_tpu_torch as pkg
        out["package"] = str(Path(pkg.__file__).resolve().parent)
        print(json.dumps(out), flush=True)
        return 0
    import chip_smoke as cs
    smi = cs.device_phase()
    cfg = {k: getattr(cs, k) for k in (
        "SEED", "TLM", "ENGINE", "N_REQUESTS", "MAX_TOKENS", "CHAR",
        "CHAR_ENGINE", "CHAR_REQUESTS", "CHAR_MAX_TOKENS")}
    sides = {"this": HERE}
    if args.parent is not None:
        sides["parent"] = args.parent.resolve()
    order = (["this", "parent", "parent", "this"] if len(sides) > 1
             else ["this", "this"])
    runs = {name: [] for name in sides}
    for r in range(args.rounds):
        for name in order:
            t0 = time.perf_counter()
            runs[name].append(_run_side(sides[name], cfg))
            print(f"round {r} {name}: {time.perf_counter() - t0:.1f} s "
                  f"{json.dumps(runs[name][-1])}", file=sys.stderr,
                  flush=True)
    summary = {name: {w: {m: statistics.median(run[w][m] for run in rs)
                          for m in METRICS}
                      for w in ("transformer", "char_rnn")}
               for name, rs in runs.items()}
    out = {"card": smi, "summary_medians": summary, "runs": runs,
           "repeats_per_run": REPEATS}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "gen_study.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": smi, "summary_medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
