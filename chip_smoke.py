#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one NVIDIA
card and check it. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero before a result is printed:

1. Device: requires CUDA, prints the card's name and power limit and the
   Python, PyTorch, CUDA and cuDNN versions (the library calls timed below
   come with them), turns TF32 off so float32 products are full float32.
2. Kernels: builds every kernel of the serving and training paths
   (flash attention and LSTM) from this checkout's sources (one ``nvcc``
   per source, started together; each source's build seconds are
   reported), prints the registers, spills and shared memory of every
   instantiation of the attention kernels redesigned for Hopper (K1, K2
   and K3) and checks their SASS: the bf16 ones must issue ``wgmma``
   (HGMMA), the f32 ones must not (no TF32); does the same for every tile
   instantiation of K7, none of which may issue HGMMA (f32 on full FMAs,
   bf16 widened to f32), and the same for K6's instantiations (one for
   each pair of units a cluster and rows a thread it is compiled for, f32
   and bf16) and K5's (one for each number of units a cluster, f32 and
   bf16; none may issue HGMMA), then holds each kernel against its
   plain PyTorch version on the card:
   - K1, the flash-attention forward, at the shapes the serving path gives
     it (float32 at atol 2e-5, bfloat16 at atol 2e-2);
   - K2 and K3, the backward's dq and dk/dv kernels, at the training
     shapes (BH 64 = B 8 x H 8, T 1024, D 64, causal) at rel-to-max 1e-4
     in float32 and 2e-2 in bfloat16, at a ring hop's shapes (BH 8,
     Tq = Tk 2048, D 64, both types, the causal diagonal hop and the
     unmasked full hop, with the lse and delta of a longer key set as the
     ring's backward passes the whole sequence's) and at one data-parallel
     worker's (BH 16 = B 2 x H 8, T 1024, float32, causal);
   - each also at coverage shapes (other head dims, a key mask with a
     fully masked row, T 200 causal with a mask) and at the edges of the
     redesigned kernels' tiles, causal: T 320 at BH 3, T 1000, both dtypes;
     bf16 at D 256, T 1000 and at D 128, T 200, BH 3. K2 is also timed at
     the ring's diagonal hop beside its full hop (the causal hop should
     cost about half).
   Times each kernel, its plain version and the PyTorch library call for
   the same function (SDPA, its backward for K2/K3, whose kernels' names
   are recorded: they say which of SDPA's backends ran; at the training
   shape it is also timed pinned to each backend), beside the least time
   the card could take.
3. Serve: ``transformer_lm`` at the repository's end-to-end width
   (bench.py ``_TLM``: vocab 4096, d_model 512, 8 heads, 12 blocks,
   T 1024) with random weights from a seed, served by ``GenerationEngine``
   to 8 concurrent greedy requests of 300-900 prompt tokens and 32 new
   tokens each. One request's tokens must equal ``naive_generate``'s
   token for token; the decode step runs as the cohort's CUDA graph, one
   replay a step.
3b. Generation: the same model (f32, ``ENGINE``) through the rest of
   paged generation, each case on its own engine: (a) the prefix cache —
   one request of a 480-token block-aligned prompt, 7 more of it (hits:
   a copy-on-write copy and one replayed token each), then 8 fresh
   prompts; hit tokens must equal the miss's; (b) the int8 KV tier, the
   same traffic, hit == miss, its bytes a token beside f32's; (c)
   speculation with ``truncated_draft(net, 1)``, ``spec_k`` 4, on the
   fresh prompts: tokens equal (a)'s plain greedy ones, acceptance and
   tokens a target dispatch reported; (d) with the 12-block self-draft:
   every proposal accepted; (e) with an LSTM draft
   (``text_generation_lstm(4096, hidden 512, T 1024)``): tokens equal the
   plain ones, and K5 launches 2 layers x (draft prefills + 5 x
   proposals); (f) a same-architecture ``hot_swap`` while two requests
   decode: they finish equal to the old weights' ``naive_generate``, two
   admitted after equal the new weights'. Every case: no warm run and no
   graph capture after warm-up beyond the cohorts it makes (one; two in
   (f)), one graph replay a decode step, TTFT and decode-step p50/p99 and
   decode tokens/s reported; a divergence names its step and the full
   forward's top-2 logit margin there. (a) also profiles two replays of
   the decode graph (its kernels and device time).
4. Train: the same model in bfloat16 with ``Adam(3e-4)`` takes 6 steps of
   ``net.fit`` on one fixed batch of B 8 token sequences (bench.py
   ``bench_transformer_lm``'s feed). Each of K1, K2 and K3 must launch 12
   times a step; the loss must be finite every step and fall.
5. Cross-device: one float32 step of a 2-block model at d_model 512,
   T 1024, B 2 on the card and on the CPU (plain versions) from the same
   weights: the loss at rel 1e-5, every gradient at rel-to-max 1e-4, and
   the attention projections' gradients nonzero.
6. LSTM kernels: K5 (``lstm_fwd``) and K6 (``lstm_bwd``) against their
   plain versions at the char-RNN's training shapes (T 64 and its tBPTT
   chunks 50 and 14, B 32, H 512, float32, Graves peepholes) and at
   coverage shapes (no peepholes, a mask, bfloat16, H 256, H 1024 at B 32
   and T 64, H 520 (a plan whose units do not divide H), B 1/3/4/8 and
   B 96 (K6's rows in chunks), T 1): forward atol 1e-5 (the reference's
   lstm pin), backward atol 3e-5, bfloat16 2e-2; K5 and K6 must each give
   the same bits in two runs at every shape, and their plans
   (``fwd_plan``, ``loop_plan``: blocks a cluster, units a cluster,
   clusters, and the layout's rows a chunk) are printed for each. Times
   each with its plain version and cuDNN's LSTM
   (``torch.nn.LSTM(87, 512)``, forward and backward) at T 64, B 32.
7. Serve the char-RNN: ``text_generation_lstm`` at bench.py ``bench_lstm``'s
   width (vocab 87, two GravesLSTM(512), T 64) with random weights from a
   seed, served by ``GenerationEngine`` (the "state" adapter) to 8
   concurrent greedy requests of 40-160 prompt characters and 64 new
   tokens each. One request's tokens must equal ``naive_generate_lstm``'s
   (``rnn_time_step``); K5 must launch once per layer for every prefill
   batch and decode step: the prefills' launches by the wrapper's count,
   the decode steps' as the launches the decode graph's capture holds
   times its replays (one a step); two replays under the profiler must
   show 2 x 2 ``lstm_fwd`` kernels.
8. Train the char-RNN: 6 ``net.fit`` calls with RmsProp(1e-3) on one batch
   of B 32 one-hot sequences of T 64 (two tBPTT chunks, 50 and 14 steps);
   K5 and K6 each launch 2 layers x 2 chunks = 4 times a fit; the loss is
   finite and the 50-step chunk's loss falls from the first fit to the
   last.
9. Cross-device LSTM: one f32 tBPTT ``fit`` of the char-RNN at B 8, T 64 on
   the card and on the CPU (plain versions) from the same weights and
   RmsProp state: the first chunk's loss at rel 1e-5, every gradient at
   rel-to-max 1e-4 and every ``R`` gradient nonzero, the parameters after
   the step at rel-to-max 1e-4.
10. K7 and K8: the fused 1x1 conv + bias + relu (``conv1x1_bias_relu``)
   against its plain version at every 1x1 conv shape of a GoogLeNet
   forward at B 32, 224x224 (float32 at rel-to-max 1e-5), at the
   reference's parity shape (N 2, H 4, W 4, C 128, F 128, atol 1e-5) and
   in bfloat16 (rel-to-max 2e-2), at ragged coverage shapes (M 1000, C
   100 or 37, F 50; a view of x off a 16-byte boundary), two runs giving
   the same bits, each shape's tile plan (``tile_plan``) printed; the
   int8 matmul (``int8_matmul``)
   bitwise against its plain version at the int8 serving net's three
   products at every served bucket (M 8, 32 and 256; K 512, N 512 and 256)
   and at coverage shapes (M 1, 5, 17, 33, 300; K and N not multiples of
   16; K 4096; zero rows), each shape's plan (``tile_plan``) printed. Times
   each beside its plain version, the library call (``relu(addmm)``;
   ``torch._int_mm``, recorded as null with its error where it refuses a
   shape, as at M <= 16) and the bound; K7, ``relu(addmm)``, K8 and
   ``_int_mm`` are also timed by device time in phase 19.
11. Serve GoogLeNet: ``googlenet(1000)`` at 224x224x3, f32, random weights
   from a seed, behind ``InferenceEngine`` (buckets 1, 8, 32; a
   ``forward_fn`` returning the graph's one output) to 8 closed-loop
   client threads of 8 requests of 1-8 images each. K7 must launch 37
   times per dispatched batch; one response must equal ``net.output`` at
   rel-to-max 1e-5.
12. Serve the int8 tier: bench.py's int8 serving net (Dense 512 -> 512 ->
   512, softmax 256) behind ``InferenceEngine`` (buckets 8, 32, 256) with
   ``int8_forward_fn``, 8 clients of 16 requests of 1-32 rows. K8 must
   launch 3 times per dispatched batch; at B 256 the int8 forward stays
   within rel 0.05 of the f32 forward.
13. CPU against card: GoogLeNet at 224, B 2, every vertex's activation at
   rel-to-max 1e-4; the int8 forward at B 16 at atol 1e-6.
   In phases 3, 3b, 4, 7, 8, 11, 12, 16 and 17 the launch counts are set
   to 0 just before the path is driven and read just after; every kernel
   of the path must launch.
14. K9 (``threshold_encode_fused``) bitwise against its plain version, in
   float32 and bfloat16, at n = 25,000,000 (bench.py:2222's ResNet-50
   scale), at the ``_TLM`` model's parameter count, at 65,536 + 777, on a
   slice that starts one element off alignment, at threshold 0, and on
   inputs holding NaN, infinities, both zeros and values equal to the
   threshold. Times it beside the plain version and the 9 (5) bytes an
   element bound. No single PyTorch call computes it.
15. K4 (``flash_block_update``) against its plain version from a random
   incoming carry (and from the first hop's empty carry) at BH 8-64,
   t 128-2048, D 64-256, Tq != Tk, ragged lengths, the diagonal and the
   full hop: the normalised result acc / l at atol 2e-5 in float32, 2e-2
   in bfloat16. Times it at the ring's block (BH 8, t 2048, D 64) beside
   the plain version and the bound (device time in phase 19). No PyTorch
   call takes or gives a carry.
16. Ring attention: ``ring_attention_sharded(mesh of 8, "seq",
   causal=True)`` on [1, 8, 16384, 64] (t_local 2048), forward and
   backward, float32 and bfloat16, against ``flash_attention`` on the
   whole sequence (forward atol 2e-5, gradients rel-to-max 1e-4; bf16
   2e-2) and against the plain ring (``use_fused=False``). K4, K2 and K3
   must each launch 36 times a ring (8 diagonal + 28 full hops).
17. Compressed data-parallel training: ``ParallelWrapper(transformer_lm at
   the _TLM width in f32 with Adam(3e-4), mesh of 4 logical workers,
   gradient_accumulator=EncodedAccumulator(threshold))`` takes 5 ``fit``
   steps on one batch of B 8 (2 rows a worker). K9 must launch once a
   worker a step, K1-K3 12 times a worker a step; the loss is finite and
   falls; ``_acc_state`` is [4, num_params] and finite. Times a step
   beside the plain sync path's and a single worker's ``fit`` on the same
   batch.
18. CPU against card, the parallel layer: one fused ring forward at
   T 2048 on 4 workers (atol 2e-5) and one ``EncodedAccumulator.combine``
   (dense and topk) on the same gradients (bitwise).
19. Device time (the profiler's kernel sums over 20 calls), which the
   host's enqueue does not reach: a loop of these short calls times the
   host as much as the card. K7 and ``relu(addmm)`` at GoogLeNet's shapes;
   K2 and K3 at the ring's diagonal and full hops; K8 and ``torch._int_mm``
   at each served product, and the host time of one call of each (300
   calls enqueued behind a sleep kernel); K4 at the ring's full and
   diagonal hops, both dtypes (the median of three alternating rounds);
   K5 at a decode step (T 1, B 8), two
   prefills (T 128 at B 4, T 64 at B 1) and the training chunks (T 64, 50
   and 14 at B 32) beside cuDNN's LSTM forward at each, K6 at the
   training chunk (T 64 and 14: its microseconds a step) beside cuDNN's
   LSTM backward. Its profiler sessions come after every host-bound
   phase.
20. Report: JSON lines of per-shape kernel times, the serving and training
   metrics and the kernels, then last ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import importlib
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_opt_state,
                                                         load_jax_params)
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate,
                                                    naive_generate_lstm,
                                                    truncated_draft)
from deeplearning4j_tpu_torch.models.zoo_extra import (googlenet,
                                                       text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import lstm, nvcc
from deeplearning4j_tpu_torch.ops.kernels import conv as k7
from deeplearning4j_tpu_torch.ops.kernels import quantized as k8
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel.accumulation import EncodedAccumulator
from deeplearning4j_tpu_torch.parallel.ring_attention import \
    ring_attention_sharded
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine

# the package exports the function ``ops.threshold_encode`` (as the
# reference's does), which hides the kernel module of the same name from a
# ``from ... import``
k9 = importlib.import_module("deeplearning4j_tpu_torch.ops.threshold_encode")

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
# bench.py bench_lstm: the char-RNN (vocab 87, 2 x GravesLSTM(512), T 64)
CHAR = dict(vocab_size=87, hidden=512, max_length=64)
CHAR_B, CHAR_T, CHAR_FITS = 32, 64, 6
CHAR_ENGINE = dict(block_len=16, max_seq_len=256, decode_slots=8,
                   prefill_batches=(1, 2, 4), prompt_rungs=(64, 128, 256))
CHAR_REQUESTS, CHAR_MAX_TOKENS = 8, 64
# K5 forward: the reference's lstm parity pin (ops/kernels/builtins.py:114);
# K6 backward: tests/test_pallas_lstm.py:191, 287; bf16 2e-2
LSTM_TOL = {("fwd", torch.float32): 1e-5, ("bwd", torch.float32): 3e-5,
            ("fwd", torch.bfloat16): 2e-2, ("bwd", torch.bfloat16): 2e-2}
# GoogLeNet served at its full width (zoo_extra.googlenet: 224x224x3, 1000
# classes); K7's pin is the reference's conv1x1_bias_relu 1e-5
# (ops/kernels/builtins.py:194), bf16 2e-2
GNET = dict(n_classes=1000, height=224, width=224, channels=3)
GNET_B, GNET_BUCKETS, GNET_CLIENTS, GNET_PER_CLIENT = 32, (1, 8, 32), 8, 8
GNET_SIZES = (1, 2, 3, 5, 8)       # bench.py:1101-1102's sizes to the top bucket
# bench.py:1484-1490: the int8 serving net, batch up to 256 (:1467)
INT8_NET = (512, 512, 256)
INT8_BUCKETS, INT8_CLIENTS, INT8_PER_CLIENT = (8, 32, 256), 8, 16
INT8_SIZES = (1, 2, 3, 5, 8, 13, 21, 32)
PEAK_INT8_OPS = 1979e12
# ring attention: the _TLM head shape at a length that is the reason a ring
# exists, on 8 logical workers (t_local 2048)
RING = dict(B=1, H=8, T=16384, D=64, workers=8)
# compressed data-parallel training: _TLM in f32 on 4 logical workers, B 8
# the threshold sits at the 80th-90th percentile of this model's raw
# gradient entries (loss summed over T: median |g| 0.02, 90 % 0.2)
DP_WORKERS, DP_STEPS, DP_THRESHOLD = 4, 5, 0.1
K9_N = 25_000_000                  # bench.py:2222, a ResNet-50's gradient
# (BH, T, D, dtype), causal: edges of K1's and K3's tiles (64 and 128 rows)
EDGES = [(3, 320, 64, torch.float32), (3, 320, 64, torch.bfloat16),
         (8, 1000, 64, torch.float32), (8, 1000, 64, torch.bfloat16),
         (4, 1000, 256, torch.bfloat16), (3, 200, 128, torch.bfloat16)]


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
    # the library yardsticks (SDPA, cuBLAS, cuDNN) come with this build
    print(json.dumps(SOFTWARE), flush=True)
    return smi


SOFTWARE = {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "cudnn": torch.backends.cudnn.version()}


# ------------------------------------------------------------------ phase 2
BUILDS = {"flash_attention_fwd": fa.build,
          "flash_attention_bwd": fa.build_bwd,
          "flash_attention_bwd_dkv": fa.build_bwd_dkv,
          "lstm_fwd": lstm.build_fwd, "lstm_bwd": lstm.build_bwd,
          "conv1x1_bias_relu": k7.build, "int8_matmul": k8.build,
          "flash_block_update": fa.build_block_update,
          "threshold_encode": k9.build}


# the kernels redesigned for Hopper: (source, C entry point); their bf16
# instantiations must issue wgmma (HGMMA in the SASS), their f32 ones none
REDESIGNED = {"flash_attention_fwd": "dl4j_flash_attention_fwd",
              "flash_attention_bwd": "dl4j_flash_attention_bwd_dq",
              "flash_attention_bwd_dkv": "dl4j_flash_attention_bwd_dkv",
              "flash_block_update": "dl4j_flash_block_update"}


def _ptxas_report(log_text):
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report."""
    out, fn = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = (nums[1], nums[2])
        elif fn and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            out[fn] = (regs, *spill)
            fn = None
    return out


def _sass_functions(lib):
    """{kernel function: its SASS text} from cuobjdump."""
    sass = subprocess.run([nvcc.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True,
                          text=True, check=True).stdout
    parts = sass.split("Function : ")[1:]
    return {p.split()[0]: p for p in parts}


def build_phase():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as ex:
        paths = dict(zip(BUILDS, ex.map(lambda b: b(), BUILDS.values())))
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f}s")
    report = {"build_s": {}, "kernels": {}}
    for name, path in paths.items():
        text = path.with_suffix(".log").read_text()
        first = text.splitlines()[0]
        if first.startswith("# nvcc"):
            report["build_s"][name] = float(first.split()[2])
        log(text[-2000:])
    for name, symbol in REDESIGNED.items():
        usage = _ptxas_report(paths[name].with_suffix(".log").read_text())
        sass = _sass_functions(paths[name])
        for fn, (regs, st, ld) in sorted(usage.items()):
            bf16 = "bf16" in fn
            D = int(fn.split("ILi")[1].split("E")[0])
            hgmma = sass[fn].count("HGMMA")
            if bf16 != (hgmma > 0):
                raise AssertionError(f"{fn}: {hgmma} HGMMA instructions in "
                                     f"its SASS (bf16 must use wgmma, f32 "
                                     f"must not)")
            smem = fa.shared_memory_bytes(
                symbol, D, torch.bfloat16 if bf16 else torch.float32)
            report["kernels"][fn] = {
                "D": D, "dtype": "bf16" if bf16 else "f32",
                "registers": regs, "spill_store_bytes": st,
                "spill_load_bytes": ld, "dynamic_smem_bytes": smem,
                "hgmma": hgmma}
    report["conv1x1_tiles"] = _k7_instantiations(paths["conv1x1_bias_relu"])
    report["int8_matmul"] = _k8_instantiations(paths["int8_matmul"])
    report["lstm_bwd"] = _lstm_instantiations(
        paths["lstm_bwd"], "lstm_bwd_kernel", 2 * len(lstm.LOOP_CANDIDATES))
    report["lstm_fwd"] = _lstm_instantiations(
        paths["lstm_fwd"], "lstm_fwd_kernel",
        2 * len({u for _, u in lstm.FWD_CANDIDATES}))
    log("redesigned kernels:", json.dumps(report, indent=1))
    return report


def _k8_instantiations(lib):
    """K8's two instantiations (16-byte and byte-wise staging): registers,
    spills, and their SASS, which must hold integer tensor-core products
    (IMMA) and no __dp4a (IDP4A)."""
    usage = _ptxas_report(lib.with_suffix(".log").read_text())
    sass = _sass_functions(lib)
    out = {}
    for fn, (regs, st, ld) in sorted(usage.items()):
        imma, dp4a = sass[fn].count("IMMA"), sass[fn].count("IDP4A")
        if imma == 0 or dp4a:
            raise AssertionError(f"{fn}: {imma} IMMA and {dp4a} IDP4A "
                                 f"instructions in its SASS (K8 must run "
                                 f"on the integer tensor cores)")
        out[fn] = {"registers": regs, "spill_store_bytes": st,
                   "spill_load_bytes": ld, "imma": imma, "idp4a": dp4a}
    if len(out) != 2:
        raise AssertionError(f"K8's library holds {sorted(out)}, not its two "
                             f"instantiations")
    return out


def _lstm_instantiations(lib, kernel, count):
    """An LSTM kernel's instantiations, ``count`` of them (K6: one for each
    (units a cluster, rows a thread) pair it is compiled for; K5: one for
    each number of units a cluster; f32 and bf16): registers, spills; none
    may issue HGMMA (f32 FMAs, bf16 widened to f32). Shared memory is a
    plan's (printed with each phase-6 shape)."""
    usage = _ptxas_report(lib.with_suffix(".log").read_text())
    sass = _sass_functions(lib)
    plain = _demangle(fn for fn in usage if kernel in fn)
    out = {}
    for fn, text in plain.items():
        regs, st, ld = usage[fn]
        hgmma = sass[fn].count("HGMMA")
        if hgmma:
            raise AssertionError(f"{text}: {hgmma} HGMMA instructions in its "
                                 f"SASS ({kernel} runs on FMAs)")
        out[text.split(">(")[0] + ">"] = {"registers": regs,
                                   "spill_store_bytes": st,
                                   "spill_load_bytes": ld, "hgmma": hgmma}
    if len(out) != count:
        raise AssertionError(f"{kernel}'s library holds {sorted(out)}, not "
                             f"its {count} instantiations")
    return out


def _demangle(names):
    """{mangled name: its C++ form} by the toolkit's cu++filt."""
    names = sorted(names)
    text = subprocess.run([nvcc.cuda_tool("cu++filt"), *names],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()
    if len(text) != len(names):
        raise AssertionError(f"cu++filt gave {len(text)} names for "
                             f"{len(names)}")
    return dict(zip(names, text))


def _k7_instantiations(lib):
    """K7's tile instantiations, one for each tile of ``k7.TILES``, dtype
    and copy width: registers, spills, shared memory; none may issue HGMMA
    (f32 stays on full FMAs, bf16 is widened to f32)."""
    usage = _ptxas_report(lib.with_suffix(".log").read_text())
    sass = _sass_functions(lib)
    plain = _demangle(fn for fn in usage if "conv1x1_kernel" in fn)
    found = {}
    for fn, text in plain.items():
        # the template's arguments <T, BM, BN, VEC>, as cu++filt writes
        # them ("float, (int)64, (int)32, (bool)1") or without the casts
        args = [re.sub(r"^\(\w+\)", "", a.strip()) for a in
                text.split("conv1x1_kernel<")[1].split(">")[0].split(",")]
        ctype, bm, bn, vec = args
        found[ctype, int(bm), int(bn), vec in ("1", "true")] = fn
    out = {}
    for bm, bn in k7.TILES:
        for ctype, dtype, tag in (("float", torch.float32, "f32"),
                                  ("__nv_bfloat16", torch.bfloat16, "bf16")):
            for vec in (True, False):
                want = f"{ctype}, {bm}, {bn}, {str(vec).lower()}"
                fn = found.pop((ctype, bm, bn, vec), None)
                if fn is None:
                    raise AssertionError(
                        f"no K7 instantiation conv1x1_kernel<{want}> in the "
                        f"library; it holds {sorted(plain.values())}")
                regs, st, ld = usage[fn]
                hgmma = sass[fn].count("HGMMA")
                if hgmma:
                    raise AssertionError(f"{plain[fn]}: {hgmma} HGMMA "
                                         f"instructions in its SASS (K7 "
                                         f"runs on FMAs)")
                out[f"conv1x1_kernel<{want}>"] = {
                    "bm": bm, "bn": bn, "dtype": tag,
                    "vec16": vec, "registers": regs,
                    "spill_store_bytes": st, "spill_load_bytes": ld,
                    "dynamic_smem_bytes": k7.shared_memory_bytes(bm, bn,
                                                                 dtype),
                    "hgmma": hgmma}
    if found:
        raise AssertionError(f"K7 instantiations of no tile in k7.TILES: "
                             f"{sorted(found)}")
    return out


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
    # the redesigned kernels' edges: T not a multiple of their 64/128-row
    # tiles, an odd BH, bf16 at D 256 (one warpgroup's 128 accumulators)
    for BH, T, D, dtype in EDGES:
        q, k, v, _ = _case(gen, BH, T, D, dtype, True, False)
        e_o, e_l = _compare(q, k, v, None, True, 1.0 / math.sqrt(D))
        worst = max(e_o, e_l)
        if worst > TOL[dtype]:
            raise AssertionError(f"kernel disagrees with plain at BH={BH} "
                                 f"T={T} D={D} {dtype} causal: O {e_o:.3g}, "
                                 f"lse {e_l:.3g} > {TOL[dtype]}")
        errs[dtype] = max(errs[dtype], worst)
    log("kernel phase: max abs err f32", errs[torch.float32], "bf16",
        errs[torch.bfloat16])
    return errs, rows


def _bwd_case(gen, BH, T, D, dtype, causal, masked, B=None, ring_hop=False):
    """Backward inputs from K1's forward: (q, k, v, dO, lse, delta, mask).
    ``ring_hop``: lse and delta are those of a longer key set (this block
    and one more that every query sees), as a ring hop's backward gets the
    whole sequence's, not its block's own."""
    q, k, v, km = _case(gen, BH, T, D, dtype, causal, masked, B=B)
    if masked:
        km[0, :8] = 0.0               # causal rows 0..7 see no key
    do = torch.randn(BH, T, D, generator=gen).to(dtype).cuda()
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal, scale=scale)
    if ring_hop:
        k2, v2, _, _ = _case(gen, BH, T, D, dtype, False, False)
        o2, lse2 = fa.flash_attention_fwd(q, k2, v2, None, causal=False,
                                          scale=scale)
        both = torch.logaddexp(lse, lse2)
        o = (o.float() * torch.exp(lse - both)[..., None]
             + o2.float() * torch.exp(lse2 - both)[..., None]).to(dtype)
        lse = both
    delta = (do.float() * o.float()).sum(dim=-1)
    return q, k, v, do, lse, delta, km


def _rel_to_max(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def bwd_kernel_phase():
    """K2 (dq) and K3 (dk/dv) against their plain versions, at the shapes
    each path gives them (the training step, the ring's diagonal and full
    hops, a data-parallel worker) and at coverage shapes; timings at the
    paths' shapes."""
    gen = torch.Generator().manual_seed(SEED + 1)
    # per kernel and dtype: (max abs error, max rel-to-max error)
    errs = {k: {d: (0.0, 0.0) for d in (torch.float32, torch.bfloat16)}
            for k in ("dq", "dkv")}
    rows, backends = [], {}
    B, H, T, D = TRAIN_B, TLM["n_heads"], TLM["max_length"], 64
    cover = [(D_, dtype, 256, False) for dtype in (torch.float32,
                                                   torch.bfloat16)
             for D_ in (96, 128, 256)]
    cover += [(64, torch.float32, 200, True), (64, torch.bfloat16, 200, True)]
    # (BH, T, D, dtype, causal, masked, B of the mask, path): the bf16
    # training step's; the ring's two hops (diagonal and full, with the
    # whole sequence's lse); one data-parallel worker's; coverage
    cases = [(B * H, T, D, dtype, True, False, None, "train")
             for dtype in (torch.float32, torch.bfloat16)]
    t_ring, BH_ring = RING["T"] // RING["workers"], RING["B"] * RING["H"]
    cases += [(BH_ring, t_ring, RING["D"], dtype, causal, False, None, "ring")
              for dtype in (torch.float32, torch.bfloat16)
              for causal in (True, False)]
    cases += [(B // DP_WORKERS * H, T, D, torch.float32, True, False, None,
               "train_data_parallel")]
    cases += [(4, T_, D_, dtype, causal, True, 2, "coverage")
              for D_, dtype, T_, causal in cover]
    cases += [(BH_, T_, D_, dtype, True, False, None, "edge")
              for BH_, T_, D_, dtype in EDGES]
    for BH, T_, D_, dtype, causal, masked, B_, path in cases:
        args = _bwd_case(gen, BH, T_, D_, dtype, causal, masked, B=B_,
                         ring_hop=path == "ring")
        kw = dict(causal=causal, scale=1.0 / math.sqrt(D_))
        got = {"dq": (fa.flash_attention_bwd_dq(*args, **kw),),
               "dkv": fa.flash_attention_bwd_dkv(*args, **kw)}
        torch.cuda.synchronize()
        q, k, v, do, lse, delta, km = args
        plain_args = (q, k, v, do, lse, delta, causal, kw["scale"], km)
        want = {"dq": (fa.flash_attention_bwd_dq_reference(*plain_args),),
                "dkv": fa.flash_attention_bwd_dkv_reference(*plain_args)}
        case_err = {}
        for kind in ("dq", "dkv"):
            if not all(torch.isfinite(t.float()).all() for t in got[kind]):
                raise AssertionError(f"{kind} kernel output is not finite")
            err = max(_rel_to_max(g, w) for g, w in zip(got[kind],
                                                         want[kind]))
            if err > BWD_TOL[dtype]:
                raise AssertionError(
                    f"{kind} kernel disagrees with plain at BH={BH} T={T_} "
                    f"D={D_} {dtype} causal={causal} masked={masked} "
                    f"({path}): rel-to-max {err:.3g} > {BWD_TOL[dtype]}")
            case_err[kind] = err
            err_abs = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got[kind], want[kind]))
            errs[kind][dtype] = (max(errs[kind][dtype][0], err_abs),
                                 max(errs[kind][dtype][1], err))
        if masked or path == "edge":
            continue
        # timings at the paths' shapes; SDPA's backward (forward excluded)
        # computes dq, dk and dv together. It cannot take a ring hop's
        # foreign lse, so those rows have no library time
        lib_ms, lib_kernels = None, None
        if path != "ring":
            q4, k4, v4 = (t.view(1, BH, T_, D_).detach().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            sdpa_bwd = lambda: torch.autograd.grad(
                out, (q4, k4, v4), do.view(1, BH, T_, D_), retain_graph=True)
            lib_ms = _time_ms(sdpa_bwd)
            # which of SDPA's backends the yardstick ran: its kernels' names
            lib_kernels = _device_kernels(sdpa_bwd, top=4)["top"]
            if path == "train":
                backends[str(dtype)] = _sdpa_backward_by_backend(
                    q4, k4, v4, do.view(1, BH, T_, D_), causal)
        for kind, kernel, plain in (
                ("dq", fa.flash_attention_bwd_dq,
                 fa.flash_attention_bwd_dq_reference),
                ("dkv", fa.flash_attention_bwd_dkv,
                 fa.flash_attention_bwd_dkv_reference)):
            ms = _time_ms(lambda: kernel(*args, **kw))
            plain_ms = _time_ms(lambda: plain(*plain_args))
            bound_ms, bound_by = _bound(kind, BH, T_, D_, dtype, causal)
            rows.append({"kernel": kind, "path": path, "BH": BH, "T": T_,
                         "D": D_, "dtype": str(dtype), "causal": causal,
                         "rel_to_max_err": case_err[kind], "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_kernels": lib_kernels,
                         "bound_ms": bound_ms, "bound_by": bound_by})
    log("backward kernel phase: (max abs, rel-to-max) err", {
        k: {str(d): e for d, e in v.items()} for k, v in errs.items()})
    log("SDPA backward by backend at the train shape (ms):", backends)
    # the ring's causal diagonal hop beside its full hop, per kernel
    hops = []
    for kind in ("dq", "dkv"):
        for dtype in (torch.float32, torch.bfloat16):
            by = {r["causal"]: r["ms"] for r in rows if r["kernel"] == kind
                  and r["path"] == "ring" and r["dtype"] == str(dtype)}
            hops.append({"kernel": kind, "dtype": str(dtype),
                         "diagonal_ms": by[True], "full_ms": by[False],
                         "diagonal_over_full": by[True] / by[False]})
    log("ring hops, diagonal against full:", hops)
    return errs, rows, backends, hops


def _sdpa_backward_by_backend(q4, k4, v4, do4, causal):
    """SDPA's forward and backward pinned to each of its CUDA backends in
    turn: {backend: backward ms, or why it refused these inputs}."""
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError as e:                  # a PyTorch before 2.3
        return {"not measured": str(e)}
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                o = F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=causal)
                out[backend.name] = _time_ms(lambda: torch.autograd.grad(
                    o, (q4, k4, v4), do4, retain_graph=True))
        except RuntimeError as e:
            out[backend.name] = f"refused: {str(e).splitlines()[0][:200]}"
    return out


# ------------------------------------------------------------------ phase 3
def slice_phase():
    net = transformer_lm(**TLM, token_input=True).init(seed=SEED)
    eng = GenerationEngine(net, **ENGINE)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(300, 901, size=N_REQUESTS)
    prompts = [rng.integers(1, TLM["vocab_size"], size=int(n)).tolist()
               for n in lens]
    rt = eng.runtime()
    try:
        fa.flash_attention.launches = 0          # the serving run's count
        t0 = time.perf_counter()
        streams = [eng.generate(p, max_tokens=MAX_TOKENS, stream=True)
                   for p in prompts]
        results = [s.result() for s in streams]
        wall_s = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        if not rt.wait_idle(60):
            raise AssertionError("serve: the runtime did not go idle")
        snap = eng.metrics()["default"]
        graphs = rt.graph_stats()
    finally:
        eng.stop()
    if graphs["replays"] != snap["decode_steps"] or graphs["captures"] != 1:
        raise AssertionError(f"serve: {graphs} for {snap['decode_steps']} "
                             f"decode steps")
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
            "graph_replays": graphs["replays"],
            "wall_s": wall_s, "flash_attention_launches": launches}


# ----------------------------------------------------------------- phase 3b
GEN_SHARED, GEN_PROMPT = 8, 480     # 8 requests of one 30-block prompt
GEN_FRESH, GEN_FRESH_LENS = 8, (300, 901)   # then 8 of 300-900 tokens
SPEC_K = 4
# the LSTM draft: the char-RNN's layers at the transformer's vocabulary
LSTM_DRAFT = dict(vocab_size=4096, hidden=512, max_length=1024)


def _gen_engine(net, **kw):
    """A warmed engine over ``net`` at phase 3's plan and what it had done
    when it returned: its warm runs and its runtime's cohorts (graphs)."""
    eng = GenerationEngine(net, **ENGINE, **kw)
    rt = eng.runtime()
    return eng, rt, {"warm_runs": eng.trace_count,
                     "cohorts": rt.cohorts_made}


def _logit_gaps(net, prompt, toks, step):
    """At generated position ``step`` of the greedy stream ``toks``: the
    full forward's top-1 minus top-2 logit and its two tokens (causal, so
    one forward over the sequence gives every position)."""
    cap = ENGINE["max_seq_len"]
    seq = list(prompt) + list(toks[:step])
    buf = torch.zeros((1, cap), dtype=torch.long, device=net.device)
    buf[0, :len(seq)] = torch.as_tensor(seq)
    logp = torch.log(net.output(buf)[0, len(seq) - 1].double())
    top = torch.topk(logp, 2)
    return {"top2_tokens": top.indices.tolist(),
            "top2_margin": float(top.values[0] - top.values[1])}


def _same_tokens(net, what, prompts, got, want):
    """Raise at the first request whose tokens differ, with the step and
    the full forward's top-2 logit margin there."""
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a != b:
            step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(
                f"{what}: request {i} differs at step {step} ({a[step]} "
                f"against {b[step]}): {_logit_gaps(net, p, b, step)}")


def _drive(eng, prompts):
    streams = [eng.generate(p, max_tokens=MAX_TOKENS, stream=True)
               for p in prompts]
    out = [s.result() for s in streams]
    for i, (toks, reason) in enumerate(out):
        if len(toks) != MAX_TOKENS or reason != "length":
            raise AssertionError(f"request {i}: {len(toks)} tokens, "
                                 f"finish reason {reason!r}")
    return [t for t, _ in out]


def _case_checks(name, eng, rt, base, cohorts_added=0):
    """What every case holds: no warm run and no capture beyond the
    cohorts it made, one graph replay a decode step; and its row."""
    if not rt.wait_idle(60):
        raise AssertionError(f"{name}: the runtime did not go idle")
    snap = eng.metrics()["default"]
    gs = rt.graph_stats()
    if eng.trace_count != base["warm_runs"] or snap["decode_recompiles"]:
        raise AssertionError(f"{name}: warm runs after warm-up "
                             f"({eng.trace_count - base['warm_runs']})")
    if rt.cohorts_made != base["cohorts"] + cohorts_added:
        raise AssertionError(f"{name}: {rt.cohorts_made - base['cohorts']} "
                             f"graphs captured after warm-up, "
                             f"{cohorts_added} expected")
    if gs["replays"] != snap["decode_steps"]:
        raise AssertionError(f"{name}: {gs['replays']} graph replays for "
                             f"{snap['decode_steps']} decode steps")
    return {"ttft_ms_p50": snap["ttft_ms"]["p50"],
            "ttft_ms_p99": snap["ttft_ms"]["p99"],
            "decode_step_ms_p50": snap["decode_step_ms"]["p50"],
            "decode_step_ms_p99": snap["decode_step_ms"]["p99"],
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "prefills": snap["prefills"], "decode_steps": snap["decode_steps"],
            "graph_replays": gs["replays"], "graph_captures": gs["captures"],
            "prefix": snap["prefix"], "speculative": snap["speculative"],
            "kv_bytes_per_token": snap["kv_bytes_per_token"]}


def _graph_device_ms(rt):
    """Two replays of the runtime's live decode graph under the profiler:
    the kernels recorded and their device time a replay."""
    g = rt.cohorts[-1].graph
    prof = _device_kernels(lambda: (g.graph.replay(), g.graph.replay()),
                           top=1000)
    return {"kernels_per_replay": sum(r["calls"] for r in prof["top"]) / 2,
            "device_ms_per_replay": prof["device_ms"] / 2,
            "wall_ms_two_replays": prof["wall_ms"], "top": prof["top"]}


def generation_phase():
    """The rest of paged generation at the _TLM width, f32, random weights:
    (a) the prefix cache, (b) the int8 KV tier, (c) speculation with a
    1-block truncated draft, (d) with a 12-block self-draft, (e) with an
    LSTM draft, (f) a same-architecture hot swap during decode."""
    net = transformer_lm(**TLM, token_input=True).init(seed=SEED)
    V = TLM["vocab_size"]
    rng = np.random.default_rng(SEED + 30)
    shared = rng.integers(1, V, size=GEN_PROMPT).tolist()
    fresh = [rng.integers(1, V, size=int(n)).tolist()
             for n in rng.integers(*GEN_FRESH_LENS, size=GEN_FRESH)]
    rows, k1 = {}, {}

    # (a) prefix: one miss, then 7 block-aligned hits (COW + one replayed
    # token each), then 8 fresh misses; hit tokens == the miss's
    eng, rt, base = _gen_engine(net)
    try:
        _reset_launches()
        miss = _drive(eng, [shared])[0]
        hits = _drive(eng, [shared] * (GEN_SHARED - 1))
        plain = _drive(eng, fresh)
        k1["prefix"] = fa.flash_attention.launches
        row = _case_checks("prefix", eng, rt, base)
        row["graph"] = _graph_device_ms(rt)
    finally:
        eng.stop()
    _same_tokens(net, "prefix hit against miss", [shared] * len(hits), hits,
                 [miss] * len(hits))
    pre = row["prefix"]
    if pre["hits"] != GEN_SHARED - 1 or pre["cow_copies"] != GEN_SHARED - 1:
        raise AssertionError(f"prefix: {pre['hits']} hits and "
                             f"{pre['cow_copies']} copies for "
                             f"{GEN_SHARED - 1} repeats of the prompt")
    if k1["prefix"] < TLM["n_blocks"] * row["prefills"]:
        raise AssertionError(f"prefix: {k1['prefix']} K1 launches for "
                             f"{row['prefills']} prefill batches")
    rows["a_prefix"] = row

    # (b) the int8 KV tier: hit == miss, bytes a token beside f32's
    eng, rt, base = _gen_engine(net, kv_cache_dtype="int8")
    try:
        miss8 = _drive(eng, [shared])[0]
        hits8 = _drive(eng, [shared] * (GEN_SHARED - 1))
        plain8 = _drive(eng, fresh)
        row = _case_checks("int8", eng, rt, base)
    finally:
        eng.stop()
    _same_tokens(net, "int8 prefix hit against miss", [shared] * len(hits8),
                 hits8, [miss8] * len(hits8))
    row["kv_bytes_per_token_f32"] = rows["a_prefix"]["kv_bytes_per_token"]
    row["tokens_equal_f32"] = sum(a == b for x, y in zip(plain8, plain)
                                  for a, b in zip(x, y))
    row["tokens"] = GEN_FRESH * MAX_TOKENS
    rows["b_int8"] = row

    # (c), (d), (e): speculation; tokens == the plain greedy of (a)
    lstm_draft = text_generation_lstm(**LSTM_DRAFT).init(seed=SEED + 31)
    n_lstm = sum(hasattr(l, "apply_with_final_state")
                 for l in lstm_draft.layers)
    for case, draft in (("c_spec_truncated_1", truncated_draft(net, 1)),
                        ("d_spec_self",
                         truncated_draft(net, TLM["n_blocks"])),
                        ("e_spec_lstm", lstm_draft)):
        eng, rt, base = _gen_engine(net, draft=draft, spec_k=SPEC_K)
        try:
            _reset_launches()
            got = _drive(eng, fresh)
            k5 = lstm.fused_lstm_fwd.launches
            k1[case] = fa.flash_attention.launches
            runs = dict(rt.active_ps.runs)
            row = _case_checks(case, eng, rt, base)
        finally:
            eng.stop()
        _same_tokens(net, f"{case} against plain greedy", fresh, got, plain)
        sp = row["speculative"]
        row["acceptance_rate"] = (sp["accepted"] / sp["proposed"]
                                  if sp["proposed"] else 0.0)
        row["tokens_per_target_dispatch"] = sp["accepted_tokens_per_verify"]
        row["program_runs"] = runs
        if not sp["verify_steps"]:
            raise AssertionError(f"{case}: no verify window ran")
        if case == "d_spec_self" and sp["accepted"] != sp["proposed"]:
            raise AssertionError(f"self-draft accepted {sp['accepted']} of "
                                 f"{sp['proposed']} proposals")
        if case == "e_spec_lstm":
            want = n_lstm * (runs.get("draft_prefill", 0)
                             + (SPEC_K + 1) * runs.get("propose", 0))
            if k5 != want or not k5:
                raise AssertionError(
                    f"LSTM draft: {k5} K5 launches; {runs} imply {want}")
            row["k5_launches"] = k5
        rows[case] = row

    # (f) a same-architecture hot swap while two requests decode
    net_b = transformer_lm(**TLM, token_input=True).init(seed=SEED + 32)
    eng, rt, base = _gen_engine(net)
    try:
        old = [eng.generate(p, max_tokens=MAX_TOKENS, stream=True)
               for p in fresh[:2]]
        deadline = time.monotonic() + 60
        while min(s.emitted for s in old) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("hot swap: the first requests did not "
                                     "start decoding")
            time.sleep(0.001)
        if eng.hot_swap("default", net_b) != 2:
            raise AssertionError("hot swap: version is not 2")
        new = _drive(eng, fresh[2:4])
        old = [s.result()[0] for s in old]
        row = _case_checks("hot_swap", eng, rt, base, cohorts_added=1)
        live = len(rt.cohorts)
    finally:
        eng.stop()
    cap = ENGINE["max_seq_len"]
    _same_tokens(net, "hot swap, in flight against the old weights",
                 fresh[:2], old, [naive_generate(net, p, MAX_TOKENS,
                                                 pad_to=cap)
                                  for p in fresh[:2]])
    _same_tokens(net_b, "hot swap, admitted after against the new weights",
                 fresh[2:4], new, [naive_generate(net_b, p, MAX_TOKENS,
                                                  pad_to=cap)
                                   for p in fresh[2:4]])
    if live != 1:
        raise AssertionError(f"hot swap: {live} cohorts live after the old "
                             f"one drained")
    rows["f_hot_swap"] = row
    log("generation phase:", {k: {m: v for m, v in r.items()
                                  if m in ("ttft_ms_p50",
                                           "decode_step_ms_p50")}
                              for k, r in rows.items()})
    return {"cases": rows, "k1_launches": k1,
            "prompt_lens": [len(p) for p in fresh]}


# ------------------------------------------------------------------ phase 4
COUNTED = {"flash_attention_fwd": fa.flash_attention,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}
LSTM_COUNTED = {"lstm_fwd": lstm.fused_lstm_fwd,
                "lstm_bwd": lstm.fused_lstm_bwd}
PARALLEL_COUNTED = dict(COUNTED, flash_block_update=fa.flash_block_update,
                        threshold_encode=k9.threshold_encode_fused)


def _reset_launches():
    for fn in (*PARALLEL_COUNTED.values(), *LSTM_COUNTED.values()):
        fn.launches = 0


def _launches(counted=COUNTED):
    return {name: fn.launches for name, fn in counted.items()}


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


# ------------------------------------------------------------------ phase 6
def _lstm_case(gen, T, B, H, dtype, peep, masked):
    """K5's inputs at the scales of a xavier-initialised layer, and K6's
    cotangents."""
    r = lambda *shape, sc: (torch.randn(*shape, generator=gen) * sc).to(
        dtype).cuda()
    fwd = [r(T, B, 4 * H, sc=0.3), r(B, H, sc=0.1), r(B, H, sc=0.1),
           r(H, 4 * H, sc=0.05)]
    mask = ((torch.rand(T, B, generator=gen) > 0.3).float().cuda()
            if masked else None)
    peeps = tuple(r(H, sc=0.2) for _ in range(3)) if peep else None
    cot = [r(T, B, H, sc=0.5), r(B, H, sc=0.5), r(B, H, sc=0.5)]
    return fwd, mask, peeps, cot


def _lstm_bound(kind, T, B, H, dtype, peep, masked):
    """Least time (ms) for the card: each input read once and each output
    written once at the memory rate, against the products' flops
    (2*T*B*H*4H for K5, twice that for K6's dh and dR products) at the
    dtype's peak. Returns (ms, "bytes" | "operations")."""
    n_seq, n_gate = T * B * H, T * B * 4 * H
    if kind == "fwd":      # x_proj, R, h0, c0 in; hs, gates, cs, c/h_prev, hT, cT out
        elems = n_gate + 4 * H * H + 2 * B * H + n_gate + 4 * n_seq \
            + 2 * B * H
        flops = 2.0 * T * B * H * 4 * H
    else:                  # gates, cs, c/h_prev, dhs, R, dhT, dcT in; dxp, dh0, dc0, dR out
        elems = n_gate + 4 * n_seq + 4 * H * H + 2 * B * H + n_gate \
            + 2 * B * H + 4 * H * H
        flops = 4.0 * T * B * H * 4 * H
    elems += (3 * H * (1 if kind == "fwd" else 2)) if peep else 0
    nbytes = elems * torch.finfo(dtype).bits // 8 + (T * B * 4 if masked
                                                       else 0)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _max_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def lstm_kernel_phase():
    """K5 and K6 against their plain versions at the char-RNN's training
    shapes and at coverage shapes; times at the training shapes beside
    the plain versions, cuDNN's LSTM and the bound."""
    gen = torch.Generator().manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    H = CHAR["hidden"]
    errs = {(k, d): 0.0 for k in ("fwd", "bwd") for d in (f32, bf16)}
    # (T, B, H, dtype, peepholes, mask): the tBPTT chunks, then coverage
    main = [(CHAR_T, CHAR_B, H, f32, True, False),
            (50, CHAR_B, H, f32, True, False),
            (14, CHAR_B, H, f32, True, False)]
    cover = [(CHAR_T, CHAR_B, H, f32, False, False),
             (CHAR_T, CHAR_B, H, f32, True, True),
             (CHAR_T, CHAR_B, H, bf16, True, False),
             (CHAR_T, CHAR_B, H, bf16, False, True),
             (CHAR_T, 8, 256, f32, True, False),
             (CHAR_T, CHAR_B, 1024, f32, True, False),
             (CHAR_T, CHAR_B, 520, f32, True, True),
             (CHAR_T, 8, 520, bf16, True, False),
             (16, 96, H, f32, True, True),
             (128, 4, H, f32, True, True),
             (16, 3, H, f32, True, True),
             (1, 8, H, f32, True, False),
             (1, 1, H, f32, True, False),
             (1, 1, H, bf16, True, False)]
    rows, plans, fwd_plans = [], {}, {}
    index = torch.cuda.current_device()
    for T, B, H_, dtype, peep, masked in main + cover:
        fwd, mask, peeps, (dhs, dhT, dcT) = _lstm_case(gen, T, B, H_, dtype,
                                                        peep, masked)
        got = lstm.fused_lstm_fwd(*fwd, mask, peeps)
        again_f = lstm.fused_lstm_fwd(*fwd, mask, peeps)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again_f)):
            raise AssertionError(f"K5 gave other bits in a second run at "
                                 f"T={T} B={B} H={H_} {dtype}")
        fplan, flayout = lstm._fwd_plan(index, H_, B, dtype)
        fwd_plans[f"T{T} B{B} H{H_} {dtype}"] = {**fplan._asdict(),
                                                 **flayout._asdict()}
        want = lstm.lstm_fwd_reference(*fwd, mask, peeps)
        res = want[1:5]
        bargs = (*res, dhs, fwd[3], dhT, dcT, mask, peeps)
        got_b = lstm.fused_lstm_bwd(*bargs)
        again = lstm.fused_lstm_bwd(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise AssertionError(f"K6 gave other bits in a second run at "
                                 f"T={T} B={B} H={H_} {dtype}")
        plan, layout = lstm._bwd_plan(index, H_, B, dtype)
        plans[f"T{T} B{B} H{H_} {dtype}"] = {**plan._asdict(),
                                             **layout._asdict()}
        want_b = lstm.lstm_bwd_reference(*bargs)
        for kind, g, w in (("fwd", got, want), ("bwd", got_b, want_b)):
            if not all(torch.isfinite(t.float()).all() for t in g):
                raise AssertionError(f"{kind} kernel output is not finite")
            err = _max_err(g, w)
            if err > LSTM_TOL[(kind, dtype)]:
                raise AssertionError(
                    f"lstm {kind} kernel disagrees with plain at T={T} B={B} "
                    f"H={H_} {dtype} peep={peep} mask={masked}: {err:.3g} > "
                    f"{LSTM_TOL[(kind, dtype)]}")
            errs[(kind, dtype)] = max(errs[(kind, dtype)], err)
        if (T, B, H_, dtype, peep, masked) not in main:
            continue
        row = {"T": T, "B": B, "H": H_, "dtype": str(dtype), "peepholes": True,
               "fwd_ms": _time_ms(lambda: lstm.fused_lstm_fwd(
                   *fwd, mask, peeps)),
               "bwd_ms": _time_ms(lambda: lstm.fused_lstm_bwd(*bargs))}
        row["fwd_bound_ms"], row["fwd_bound_by"] = _lstm_bound(
            "fwd", T, B, H_, dtype, peep, masked)
        row["bwd_bound_ms"], row["bwd_bound_by"] = _lstm_bound(
            "bwd", T, B, H_, dtype, peep, masked)
        if T == CHAR_T:
            row["fwd_plain_ms"] = _time_ms(lambda: lstm.lstm_fwd_reference(
                *fwd, mask, peeps), iters=5, warmup=1)
            row["bwd_plain_ms"] = _time_ms(lambda: lstm.lstm_bwd_reference(
                *bargs), iters=5, warmup=1)
            # cuDNN's LSTM at the same T, B, H: the no-peephole recurrence
            # plus the input projection of the 87 one-hot inputs
            cud = torch.nn.LSTM(CHAR["vocab_size"], H_).cuda()
            xin = torch.randn(T, B, CHAR["vocab_size"], generator=gen).cuda()
            xin.requires_grad_(True)
            out, _ = cud(xin)
            dout = torch.randn(T, B, H_, generator=gen).cuda()
            leaves = [xin, *cud.parameters()]
            row["fwd_library_ms"] = _time_ms(lambda: cud(xin))
            row["bwd_library_ms"] = _time_ms(lambda: torch.autograd.grad(
                out, leaves, dout, retain_graph=True))
        rows.append(row)
    # the time a step adds (barrier included): the T 64 and T 14 calls'
    # difference over their 50 steps
    t64, t14 = (next(r for r in rows if r["T"] == T) for T in (CHAR_T, 14))
    step_us = {f"{k}_us_per_step": (t64[f"{k}_ms"] - t14[f"{k}_ms"])
               / (CHAR_T - 14) * 1e3 for k in ("fwd", "bwd")}
    # the serving path's shapes: a prefill over a 128 rung at B 4, masked,
    # and one decode step at the 8 slots
    for T, B in ((128, 4), (1, 8)):
        fwd, mask, peeps, _ = _lstm_case(gen, T, B, H, f32, True, T > 1)
        ms = _time_ms(lambda: lstm.fused_lstm_fwd(*fwd, mask, peeps))
        bound, by = _lstm_bound("fwd", T, B, H, f32, True, T > 1)
        rows.append({"T": T, "B": B, "H": H, "dtype": str(f32),
                     "peepholes": True, "masked": T > 1, "fwd_ms": ms,
                     "fwd_bound_ms": bound, "fwd_bound_by": by})
    log("lstm kernel phase: max abs err", {f"{k}/{d}": e
                                           for (k, d), e in errs.items()})
    log("K5 plans:", json.dumps(fwd_plans))
    log("K6 plans:", json.dumps(plans))
    return errs, rows, step_us, {"fwd": fwd_plans, "bwd": plans}


# ------------------------------------------------------------------ phase 7
def char_serve_phase():
    net = text_generation_lstm(**CHAR).init(seed=SEED)
    eng = GenerationEngine(net, **CHAR_ENGINE)
    n_layers = sum(hasattr(l, "apply_with_final_state") for l in net.layers)
    rng = np.random.default_rng(SEED + 6)
    lens = rng.integers(40, 161, size=CHAR_REQUESTS)
    V = CHAR["vocab_size"]
    prompts = [rng.integers(0, V, size=int(n)).tolist() for n in lens]
    rt = eng.runtime()
    try:
        _reset_launches()                       # the serving run's count
        t0 = time.perf_counter()
        streams = [eng.generate(p, max_tokens=CHAR_MAX_TOKENS, stream=True)
                   for p in prompts]
        results = [s.result() for s in streams]
        wall_s = time.perf_counter() - t0
        if not rt.wait_idle(60):
            raise AssertionError("char serve: the runtime did not go idle")
        eager = _launches(LSTM_COUNTED)
        snap = eng.metrics()["default"]
        graphs = rt.graph_stats()
        adapter = eng.models()["default"]["adapter"]
        replay = _replay_kernels(rt, "lstm_fwd", 2 * n_layers)
    finally:
        eng.stop()
    if adapter != "state":
        raise AssertionError(f"the char-RNN was served by the {adapter!r} "
                             f"adapter")
    for i, (toks, reason) in enumerate(results):
        if len(toks) != CHAR_MAX_TOKENS or reason != "length":
            raise AssertionError(f"char request {i}: {len(toks)} tokens, "
                                 f"finish reason {reason!r}")
        if not all(0 <= t < V for t in toks):
            raise AssertionError(f"char request {i}: token out of range")
    # the prefills launch K5 eagerly; the decode steps replay the graph,
    # whose capture holds one K5 launch a layer
    want = n_layers * (snap["prefills"] + snap["decode_steps"])
    if graphs["replays"] != snap["decode_steps"] or graphs["captures"] != 1:
        raise AssertionError(f"char serve: {graphs} for "
                             f"{snap['decode_steps']} decode steps")
    launches = {"lstm_fwd": eager["lstm_fwd"]
                + graphs["kernel_runs"].get("lstm_fwd", 0),
                "lstm_bwd": eager["lstm_bwd"]}
    if launches != {"lstm_fwd": want, "lstm_bwd": 0} \
            or eager["lstm_fwd"] != n_layers * snap["prefills"]:
        raise AssertionError(f"serving launched {eager} eagerly and "
                             f"{graphs['kernel_runs']} in graph replays; "
                             f"{snap['prefills']} prefill batches and "
                             f"{snap['decode_steps']} decode steps of "
                             f"{n_layers} layers imply {want} K5 launches")
    ref = naive_generate_lstm(net, prompts[0], CHAR_MAX_TOKENS)
    if ref != results[0][0]:
        first = next(i for i, (a, b) in enumerate(zip(ref, results[0][0]))
                     if a != b)
        raise AssertionError(f"engine tokens differ from naive_generate_lstm "
                             f"at step {first}: {results[0][0]} vs {ref}")
    return {"requests": CHAR_REQUESTS, "tokens": CHAR_REQUESTS * CHAR_MAX_TOKENS,
            "prompt_lens": [int(n) for n in lens],
            "prefill_batches": snap["prefills"],
            "decode_steps": snap["decode_steps"],
            "ttft_ms_p50": snap["ttft_ms"]["p50"],
            "ttft_ms_p99": snap["ttft_ms"]["p99"],
            "decode_step_ms_p50": snap["decode_step_ms"]["p50"],
            "decode_tokens_per_sec": snap["decode_tokens_per_sec"],
            "graph_replays": graphs["replays"],
            "launches_eager": eager, "launches_in_replays":
                graphs["kernel_runs"], "replay_profile": replay,
            "wall_s": wall_s, "launches": launches}


def _replay_kernels(rt, name, want, tries=3):
    """Two replays of the runtime's live decode graph under the profiler
    must show ``want`` kernels whose name holds ``name``. The profiler
    loses a few records a session (``_device_ms_per_call``), so up to
    ``tries`` sessions are taken; none may show more."""
    g = rt.cohorts[-1].graph
    seen = []
    for _ in range(tries):
        prof = _device_kernels(lambda: (g.graph.replay(), g.graph.replay()),
                               top=1000)
        n = sum(r["calls"] for r in prof["top"] if name in r["kernel"])
        seen.append(n)
        if n > want:
            break
        if n == want:
            return {"kernels": n, "sessions": seen,
                    "device_ms_per_replay": prof["device_ms"] / 2,
                    "kernels_per_replay": sum(r["calls"]
                                              for r in prof["top"]) / 2}
    raise AssertionError(f"two replays of the decode graph showed {seen} "
                         f"{name} kernels in the profiler, not {want}")


# ------------------------------------------------------------------ phase 8
def _char_batch(seed, B, T):
    """bench.py bench_lstm's feed: one-hot characters and the one-hot of
    the next character, ``np.roll(ids, -1, axis=1)``."""
    ids = np.random.default_rng(seed).integers(0, CHAR["vocab_size"], (B, T))
    eye = np.eye(CHAR["vocab_size"], dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def char_train_phase():
    """The char-RNN with RmsProp(1e-3): 6 fits on one batch, each two tBPTT
    chunks (50 and 14 steps), timed to their end. The 50-step chunk's loss
    of each fit is the score of steps 0..49 at the fit's starting weights
    (no dropout: the same forward), taken between the counted fits."""
    net = text_generation_lstm(**CHAR).init(seed=SEED)
    k = net.conf.tbptt_fwd_length
    x_np, y_np = _char_batch(SEED + 7, CHAR_B, CHAR_T)
    x = torch.as_tensor(x_np, device=net.device)
    y = torch.as_tensor(y_np, device=net.device)
    rec = _Losses()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, first_chunk, launches = [], [], {n: 0 for n in LSTM_COUNTED}
    for _ in range(CHAR_FITS):
        first_chunk.append(net.score(x[:, :k], y[:, :k]))
        torch.cuda.synchronize()
        _reset_launches()                      # this fit's count
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=CHAR_B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for name, n in _launches(LSTM_COUNTED).items():
            launches[name] += n
    peak = torch.cuda.max_memory_allocated()
    last_chunk = [float(v) for v in rec.losses]
    want = 2 * 2 * CHAR_FITS                   # layers x chunks x fits
    if launches != {name: want for name in LSTM_COUNTED}:
        raise AssertionError(f"char training launched {launches}, not {want} "
                             f"of each (2 layers x 2 chunks x {CHAR_FITS})")
    if net.iteration_count != 2 * CHAR_FITS:
        raise AssertionError(f"{net.iteration_count} tBPTT iterations")
    losses = first_chunk + last_chunk
    if len(last_chunk) != CHAR_FITS or not all(math.isfinite(v)
                                               for v in losses):
        raise AssertionError(f"char training losses are not finite: {losses}")
    if not first_chunk[-1] < first_chunk[0]:
        raise AssertionError(f"the 50-step chunk's loss did not fall: "
                             f"{first_chunk}")
    p50 = float(np.median(step_ms[1:]))
    return {"model": "text_generation_lstm vocab 87 hidden 512 f32 "
                     "RmsProp(1e-3) tBPTT 50",
            "batch": CHAR_B, "seq_len": CHAR_T, "fits": CHAR_FITS,
            "chunk50_losses": first_chunk, "chunk14_losses": last_chunk,
            "step_ms": step_ms, "step_ms_p50_after_first": p50,
            "tokens_per_sec": CHAR_B * CHAR_T / (p50 / 1e3),
            "max_memory_allocated_bytes": peak, "launches": launches}


# ------------------------------------------------------------------ phase 9
def char_cross_device_phase():
    """One f32 tBPTT fit of the char-RNN at B 8, T 64 on the card (K5/K6)
    and on the CPU (plain versions) from the same weights and RmsProp
    state (one card fit first, so the state is not zero)."""
    B = 8
    gpu = text_generation_lstm(**CHAR).init(seed=SEED + 8)
    cpu = text_generation_lstm(**CHAR, device="cpu").init()
    x0, y0 = _char_batch(SEED + 9, B, CHAR_T)
    gpu.fit(x0, y0, batch_size=B)
    load_jax_params(cpu, [{n: p.detach().cpu().numpy()
                           for n, p in pd.items()}
                          for pd in gpu.param_dicts().values()])
    load_jax_opt_state(cpu, [{n: {s: t.cpu().numpy() for s, t in st.items()}
                              for n, st in layer.items()}
                             for layer in gpu.opt_state.values()],
                       iteration_count=gpu.iteration_count)
    x_np, y_np = _char_batch(SEED + 10, B, CHAR_T)
    k = gpu.conf.tbptt_fwd_length

    def chunk_loss_and_grads(net):
        x = torch.as_tensor(x_np[:, :k], device=net.device)
        y = torch.as_tensor(y_np[:, :k], device=net.device)
        loss = net.loss_fn(x, y)
        named = [(f"{i}.{n}", p) for i, pd in net.param_dicts().items()
                 for n, p in pd.items()]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.item(), {n: g.cpu() for (n, _), g in zip(named, grads)}

    l_gpu, g_gpu = chunk_loss_and_grads(gpu)
    l_cpu, g_cpu = chunk_loss_and_grads(cpu)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    if loss_rel > 1e-5:
        raise AssertionError(f"first chunk's loss on the card {l_gpu} vs "
                             f"CPU {l_cpu}")
    worst = max(g_gpu, key=lambda n: _rel_to_max(g_gpu[n], g_cpu[n]))
    grad_rel = _rel_to_max(g_gpu[worst], g_cpu[worst])
    if grad_rel > 1e-4:
        raise AssertionError(f"gradient {worst} on the card differs from the "
                             f"CPU's: rel-to-max {grad_rel:.3g}")
    for i in (0, 1):
        if not float(g_gpu[f"{i}.R"].abs().max()) > 0:
            raise AssertionError(f"layer {i} R got no gradient on the card")
    _reset_launches()                     # the card's fit, counted alone
    gpu.fit(x_np, y_np, batch_size=B)
    torch.cuda.synchronize()
    launches = _launches(LSTM_COUNTED)
    cpu.fit(x_np, y_np, batch_size=B)
    if launches != {"lstm_fwd": 4, "lstm_bwd": 4}:
        raise AssertionError(f"cross-device fit launched {launches}")
    pairs = [(f"{i}.{n}", p.detach().cpu(), cpu.param_dicts()[i][n].detach())
             for i, pd in gpu.param_dicts().items() for n, p in pd.items()]
    worst_p = max(pairs, key=lambda t: _rel_to_max(t[1], t[2]))
    param_rel = _rel_to_max(worst_p[1], worst_p[2])
    if param_rel > 1e-4:
        raise AssertionError(f"parameter {worst_p[0]} after the step differs "
                             f"from the CPU's: rel-to-max {param_rel:.3g}")
    return {"chunk_loss_rel": loss_rel, "grad_rel_to_max": grad_rel,
            "worst_grad": worst, "param_rel_to_max": param_rel,
            "worst_param": worst_p[0], "launches": launches}


# ----------------------------------------------------------------- phase 10
def googlenet_1x1_shapes(B):
    """(vertex, M, C, F) of every 1x1 conv with bias and relu in a GoogLeNet
    forward at batch B, from the configuration's shape inference."""
    conf = googlenet(**GNET, device="cpu").conf
    itypes = dict(zip(conf.network_inputs, conf.input_types))
    out = []
    for name in conf.vertex_names:
        v = conf.vertices[name]
        it = [itypes[i] for i in conf.vertex_inputs[name]]
        itypes[name] = v.output_type(it)
        layer = getattr(v, "layer", None)
        if isinstance(layer, ConvolutionLayer) and \
                tuple(layer.kernel_size) == (1, 1):
            out.append((name, B * it[0].height * it[0].width, it[0].channels,
                        layer.n_out))
    return out


def _roof_ms(flops, nbytes, peak):
    """(ms, "bytes" | "operations"): the larger of the two times."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _device_ms_per_call(fn, n=20, name=None, tries=3, per_call=1):
    """Device time of one call of ``fn`` (ms) from the profiler's kernel
    times over ``n`` calls. The profiler loses the records of a few
    launches a session (2 of 20 on an H100 under torch 2.11), so the sum is
    divided by the launches it did record: of the kernels whose name holds
    ``name`` (``per_call`` of them a call), or, with no name, of the most
    often recorded kernel (one launch of it a call). A session that records
    no such kernel is taken again, up to ``tries`` sessions; then this
    raises."""
    def many():
        for _ in range(n):
            fn()
    for _ in range(tries):
        top = _device_kernels(many, top=1000)["top"]
        rows = [r for r in top if name is None or name in r["kernel"]]
        ms = sum(r["ms"] for r in rows)
        if ms > 0:
            if name is None:
                return ms / max(r["calls"] for r in rows)
            return ms / sum(r["calls"] for r in rows) * per_call
    raise AssertionError(f"{tries} profiler sessions recorded no kernel"
                         f"{'' if name is None else ' named ' + name} in "
                         f"{n} calls")


def conv_kernel_phase():
    """K7 against its plain version at GoogLeNet's 1x1 shapes (B 32), the
    reference's parity shape, in bf16 and at ragged coverage shapes; loop
    times beside the plain version, ``relu(addmm)`` (cuBLAS) and the
    bound."""
    gen = torch.Generator().manual_seed(SEED + 11)
    f32, bf16 = torch.float32, torch.bfloat16
    sms = k7._sm_count(torch.cuda.current_device())   # the plans' SMs

    def case(M, C, F, dtype, wscale=None):
        x = torch.randn(M, C, generator=gen).to(dtype).cuda()
        sc = (2.0 / C) ** 0.5 if wscale is None else wscale
        w = (torch.randn(C, F, generator=gen) * sc).to(dtype).cuda()
        b = (torch.randn(F, generator=gen) * 0.1 + 0.2).to(dtype).cuda()
        return x, w, b

    def same_bits_twice(x, w, b):
        if not torch.equal(k7.conv1x1_fused(x, w, b),
                           k7.conv1x1_fused(x, w, b)):
            M, C = x.shape
            raise AssertionError(f"two runs of K7 differ at M={M} C={C} "
                                 f"F={w.shape[1]} {x.dtype}")

    errs = {"parity_abs": 0.0, "f32_rel": 0.0, "bf16_rel": 0.0}
    # the reference's parity shape (ops/kernels/conv.py:152-162)
    x, w, b = case(2 * 4 * 4, 128, 128, f32, wscale=0.1)
    errs["parity_abs"] = (k7.conv1x1_fused(x, w, b)
                          - k7._conv1x1_plain(x, w, b)).abs().max().item()
    if errs["parity_abs"] > 1e-5:
        raise AssertionError(f"K7 at the parity shape: {errs['parity_abs']}")
    same_bits_twice(x, w, b)
    rows, seen = [], {}
    shapes = googlenet_1x1_shapes(GNET_B)
    if len(shapes) != 37:
        raise AssertionError(f"{len(shapes)} 1x1 convs in GoogLeNet, not 37")
    for name, M, C, F in shapes:
        if (M, C, F) in seen:            # time each distinct shape once
            rows.append(dict(seen[(M, C, F)], vertex=name))
            continue
        x, w, b = case(M, C, F, f32)
        got = k7.conv1x1_fused(x, w, b)
        torch.cuda.synchronize()
        want = k7._conv1x1_plain(x, w, b)
        if not torch.isfinite(got).all():
            raise AssertionError(f"K7 output not finite at {M}x{C}x{F}")
        err = _rel_to_max(got, want)
        if err > 1e-5:
            raise AssertionError(f"K7 disagrees with plain at M={M} C={C} "
                                 f"F={F} f32: rel-to-max {err:.3g}")
        errs["f32_rel"] = max(errs["f32_rel"], err)
        same_bits_twice(x, w, b)
        flops, nbytes = k7.roofline(M, C, F)
        bound, by = _roof_ms(flops, nbytes, PEAK_FLOPS[f32])
        row = {"vertex": name, "M": M, "C": C, "F": F, "dtype": str(f32),
               "plan": list(k7.tile_plan(M, C, F, sms)),
               "rel_err": err, "abs_err": (got - want).abs().max().item(),
               "ms_loop": _time_ms(lambda: k7.conv1x1_fused(x, w, b)),
               "plain_ms": _time_ms(lambda: k7._conv1x1_plain(x, w, b)),
               "library_ms_loop": _time_ms(
                   lambda: torch.relu(torch.addmm(b, x, w))),
               "bound_ms": bound, "bound_by": by}
        seen[(M, C, F)] = row
        rows.append(row)
    bf_rows = []
    for M, C, F in ((100352, 64, 64), (25088, 192, 96), (1568, 832, 384),
                    (1000, 100, 50), (1000, 37, 51)):
        x, w, b = case(M, C, F, bf16)
        got = k7.conv1x1_fused(x, w, b)
        torch.cuda.synchronize()
        err = _rel_to_max(got, k7._conv1x1_plain(x, w, b))
        if err > 2e-2:
            raise AssertionError(f"K7 disagrees with plain at M={M} C={C} "
                                 f"F={F} bf16: rel-to-max {err:.3g}")
        errs["bf16_rel"] = max(errs["bf16_rel"], err)
        same_bits_twice(x, w, b)
        flops, nbytes = k7.roofline(M, C, F, itemsize=2)
        bound, by = _roof_ms(flops, nbytes, PEAK_FLOPS[bf16])
        bf_rows.append({"M": M, "C": C, "F": F, "dtype": str(bf16),
                        "plan": list(k7.tile_plan(M, C, F, sms)),
                        "rel_err": err,
                        "ms": _time_ms(lambda: k7.conv1x1_fused(x, w, b)),
                        "library_ms": _time_ms(
                            lambda: torch.relu(torch.addmm(b, x, w))),
                        "bound_ms": bound, "bound_by": by})
    # ragged f32 coverage: C a multiple of 4 and not, F not; a view of x
    # that starts 4 bytes off a 16-byte boundary (the wrapper copies it)
    for M, C, F, off in ((1000, 100, 50, 0), (1000, 37, 50, 0),
                         (1000, 100, 52, 1)):
        x, w, b = case(M, C, F, f32)
        if off:
            x = torch.cat([x.flatten(), x.new_zeros(off)])[off:]
            x = x[:M * C].view(M, C)
        got = k7.conv1x1_fused(x, w, b)
        torch.cuda.synchronize()
        err = _rel_to_max(got, k7._conv1x1_plain(x, w, b))
        if err > 1e-5:
            raise AssertionError(f"K7 disagrees with plain at M={M} C={C} "
                                 f"F={F} f32 (coverage, offset {off}): "
                                 f"rel-to-max {err:.3g}")
        errs["f32_rel"] = max(errs["f32_rel"], err)
        same_bits_twice(x, w, b)
    log("K7 phase: errors", errs)
    log("K7 tile plans (bm, bn, splits, k_per):",
        {r["vertex"]: r["plan"] for r in rows})
    return errs, rows, bf_rows


def ring_hop_device_time_phase(hops):
    """K2's and K3's device time at the ring's diagonal and full hops
    (BH 8, Tq = Tk 2048, D 64, the whole sequence's lse), filled into
    ``hops`` beside the loop times ``bwd_kernel_phase`` took."""
    gen = torch.Generator().manual_seed(SEED + 27)
    t_ring, BH = RING["T"] // RING["workers"], RING["B"] * RING["H"]
    names = {"dq": "flash_dq", "dkv": "flash_dkv"}
    wrappers = {"dq": fa.flash_attention_bwd_dq,
                "dkv": fa.flash_attention_bwd_dkv}
    for h in hops:
        dtype = getattr(torch, h["dtype"].split(".")[1])
        ms = {}
        for causal in (True, False):
            args = _bwd_case(gen, BH, t_ring, RING["D"], dtype, causal, False,
                             ring_hop=True)
            kw = dict(causal=causal, scale=1.0 / math.sqrt(RING["D"]))
            ms[causal] = _device_ms_per_call(
                lambda: wrappers[h["kernel"]](*args, **kw),
                name=names[h["kernel"]])
        h.update(diagonal_device_ms=ms[True], full_device_ms=ms[False],
                 diagonal_over_full_device=ms[True] / ms[False])
    log("ring hops by device time:", hops)


def k4_device_time_phase(rows, rounds=3):
    """K4's device time at the ring's full and diagonal hops (BH 8,
    Tq = Tk 2048, D 64, from an earlier hop's carry), both dtypes, filled
    into ``rows`` as "device_ms" beside the loop time ``k4_kernel_phase``
    took, with the diagonal over the full hop. Each hop is timed in
    ``rounds`` profiler sessions, the two hops of a dtype alternating and
    each round reversing the order; "device_ms" is the median and
    "device_ms_rounds" every reading."""
    gen = torch.Generator().manual_seed(SEED + 29)
    calls = []
    for r in rows:
        dtype = getattr(torch, r["dtype"].split(".")[1])
        BH, Tq, Tk, D = r["BH"], r["Tq"], r["Tk"], r["D"]
        q, k, v, kp, vp = (torch.randn(BH, t, D, generator=gen).to(dtype)
                           .cuda() for t in (Tq, Tk, Tk, Tk, Tk))
        scale = 1.0 / math.sqrt(D)
        empty = (torch.zeros(BH, Tq, D, device="cuda"),
                 torch.full((BH, Tq), -1e30, device="cuda"),
                 torch.zeros(BH, Tq, device="cuda"))
        carry = fa.flash_block_update_reference(*empty, q, kp, vp, False,
                                                scale)
        causal = r["hop"] == "diagonal"
        calls.append(lambda carry=carry, q=q, k=k, v=v, causal=causal,
                     scale=scale: fa.flash_block_update(
                         *carry, q, k, v, causal=causal, scale=scale))
        r["device_ms_rounds"] = []
    for dtype in sorted({r["dtype"] for r in rows}):
        pair = [i for i, r in enumerate(rows) if r["dtype"] == dtype]
        for n in range(rounds):
            for i in (pair if n % 2 == 0 else pair[::-1]):
                rows[i]["device_ms_rounds"].append(_device_ms_per_call(
                    calls[i], name="block_update"))
    for r in rows:
        r["device_ms"] = float(np.median(r["device_ms_rounds"]))
    for r in rows:
        full = next(f for f in rows if f["dtype"] == r["dtype"]
                    and f["hop"] == "full")
        r["over_full_device"] = r["device_ms"] / full["device_ms"]
    log("K4 by device time:", rows)


def _library_device_ms(fn, n=20):
    """Device time of one call of a library call that launches several
    kernels: the whole session over the calls recorded, read from the
    kernels launched once a call (the profiler drops a few records)."""
    rep = _device_kernels(lambda: [fn() for _ in range(n)], top=1000)
    once = max(r["calls"] for r in rep["top"] if r["calls"] <= n)
    return rep["device_ms"] / once


def lstm_device_time_phase():
    """K5's device time at the shapes each path launches it with: a decode
    step (T 1 at the 8 slots), a prefill (T 128 rung at B 4 and T 64 at B
    1, masked) and the training chunks (T 64, 50 and 14 at B 32), each
    beside cuDNN's LSTM forward at the same T and B; K6 at the training
    chunk and at T 14 (their difference over 50 steps is its microseconds
    a step) beside cuDNN's LSTM backward at T 64. So a path's launches are
    charged at their own shapes."""
    gen = torch.Generator().manual_seed(SEED + 30)
    H = CHAR["hidden"]
    out = {}
    for tag, T, B, masked in (("decode_T1_B8", 1, 8, False),
                              ("prefill_T128_B4", 128, 4, True),
                              ("prefill_T64_B1", 64, 1, True),
                              ("train_T64_B32", CHAR_T, CHAR_B, False),
                              ("train_T50_B32", 50, CHAR_B, False),
                              ("train_T14_B32", 14, CHAR_B, False)):
        fwd, mask, peeps, (dhs, dhT, dcT) = _lstm_case(
            gen, T, B, H, torch.float32, True, masked)
        out[f"fwd_{tag}"] = _device_ms_per_call(
            lambda: lstm.fused_lstm_fwd(*fwd, mask, peeps), name="lstm")
        # cuDNN's LSTM forward at the same T and B (the no-peephole
        # recurrence and the 87 inputs' projection; several kernels a call)
        cud = torch.nn.LSTM(CHAR["vocab_size"], H).cuda()
        xin = torch.randn(T, B, CHAR["vocab_size"], generator=gen).cuda()
        with torch.no_grad():
            out[f"cudnn_fwd_{tag}"] = _library_device_ms(lambda: cud(xin))
        if tag in ("train_T64_B32", "train_T14_B32"):
            res = lstm.lstm_fwd_reference(*fwd, mask, peeps)[1:5]
            bargs = (*res, dhs, fwd[3], dhT, dcT, mask, peeps)
            # one kernel a call: the loop with dR folded in
            out[f"bwd_{tag}"] = _device_ms_per_call(
                lambda: lstm.fused_lstm_bwd(*bargs), name="lstm_bwd",
                per_call=1)
    for kind in ("fwd", "bwd"):
        out[f"{kind}_us_per_step"] = (
            out[f"{kind}_train_T64_B32"] - out[f"{kind}_train_T14_B32"]) \
            / (CHAR_T - 14) * 1e3
    # cuDNN's LSTM backward at T 64, B 32
    cud = torch.nn.LSTM(CHAR["vocab_size"], H).cuda()
    xin = torch.randn(CHAR_T, CHAR_B, CHAR["vocab_size"],
                      generator=gen).cuda().requires_grad_(True)
    o, _ = cud(xin)
    dout = torch.randn(CHAR_T, CHAR_B, H, generator=gen).cuda()
    leaves = [xin, *cud.parameters()]
    grad = lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True)
    grad()
    out["cudnn_bwd_train_T64_B32"] = _library_device_ms(grad)
    log("K5/K6 by device time:", out)
    return out


def conv_device_time_phase(rows):
    """K7 and ``relu(addmm)`` by device time at each GoogLeNet shape of
    ``rows`` (filled in as "ms" and "library_ms"), on fresh inputs; then
    one forward's 37 calls summed: "ms" and "library_ms" device time, the
    "_loop" ones timed loops of calls."""
    gen = torch.Generator().manual_seed(SEED + 26)
    for M, C, F in sorted({(r["M"], r["C"], r["F"]) for r in rows}):
        x = torch.randn(M, C, generator=gen).cuda()
        w = (torch.randn(C, F, generator=gen) * (2.0 / C) ** 0.5).cuda()
        b = (torch.randn(F, generator=gen) * 0.1 + 0.2).cuda()
        ms = _device_ms_per_call(lambda: k7.conv1x1_fused(x, w, b),
                                 name="conv1x1")
        lib_ms = _device_ms_per_call(lambda: torch.relu(torch.addmm(b, x, w)))
        for r in rows:
            if (r["M"], r["C"], r["F"]) == (M, C, F):
                r["ms"], r["library_ms"] = ms, lib_ms
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "ms_loop",
                       "library_ms_loop")}
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    total["bound_by"] = ("bytes" if by_bytes >= total["bound_ms"] / 2
                         else "operations")
    log("K7 device time, per forward", total)
    return total


def int8_products(M):
    """(M, K, N) of the three products of one int8 net forward at batch M."""
    K, H, V = INT8_NET
    return [(M, K, H), (M, H, H), (M, H, V)]


def _int_mm_or_error(xq, wq):
    """``torch._int_mm`` (the int32 product alone, cuBLASLt) as a callable,
    or None and its error where it refuses the shape (it has required
    M > 16 on CUDA): the yardstick is recorded as null, never padded."""
    try:
        torch._int_mm(xq, wq)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return (lambda: torch._int_mm(xq, wq)), None


def int8_kernel_phase():
    """K8 bitwise against its plain version at the int8 net's products at
    every served bucket (M 8, 32, 256) and at coverage shapes; loop times
    beside the plain version, ``torch._int_mm`` (the int32 product alone,
    cuBLASLt) and the bound. Device times and host times per call come in
    phase 19 (``int8_device_time_phase``)."""
    gen = torch.Generator().manual_seed(SEED + 12)

    def case(M, K, N, zero_rows=()):
        x = torch.randn(M, K, generator=gen)
        x[list(zero_rows)] = 0.0
        w = torch.randn(K, N, generator=gen)
        w_q, w_s = k8.quantize_weights(w.cuda())
        x_q, x_s = k8.quantize_rows(x.cuda())
        return x_q.contiguous(), w_q.contiguous(), x_s, w_s

    main = [s for M in INT8_BUCKETS for s in int8_products(M)]
    cover = [(1, 512, 512), (33, 512, 512), (33, 37, 70), (5, 515, 129),
             (64, 256, 256), (40, 512, 256, (0, 7, 39)), (17, 1040, 24),
             (300, 16, 8), (16, 4096, 40)]
    rows, max_err = [], 0.0
    for i, shape in enumerate(main + cover):
        M, K, N = shape[:3]
        args = case(M, K, N, *shape[3:])
        got = k8.int8_matmul_fused(*args)
        torch.cuda.synchronize()
        want = k8.int8_matmul_plain(*args)
        max_err = max(max_err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(
                f"K8 differs from plain at M={M} K={K} N={N}: max abs "
                f"{(got - want).abs().max().item():.3g} (pinned bitwise)")
        if i >= len(main) or shape in [tuple(r["shape"]) for r in rows]:
            continue
        flops, nbytes = k8.roofline(M, K, N)
        bound, by = _roof_ms(flops, nbytes, PEAK_INT8_OPS)
        lib, lib_err = _int_mm_or_error(args[0], args[1])
        rows.append({"shape": [M, K, N], "M": M, "K": K, "N": N,
                     "plan": list(k8.tile_plan(M, K, N)),
                     "ms_loop": _time_ms(lambda: k8.int8_matmul_fused(*args)),
                     "plain_ms": _time_ms(lambda: k8.int8_matmul_plain(*args)),
                     "library_ms_loop": _time_ms(lib) if lib else None,
                     "library_error": lib_err,
                     "bound_ms": bound, "bound_by": by})
    log("K8 phase: bitwise at", len(main + cover), "shapes;", rows)
    return rows, max_err


def int8_device_time_phase(rows):
    """K8 and ``torch._int_mm`` by device time (the profiler's kernel sums
    over 20 calls) at each served product of ``rows`` (filled in as "ms"
    and "library_ms"), and the host time of one call of each behind a
    sleep kernel (300 calls enqueued while the card sleeps: the host alone;
    "host_us" and "library_host_us"); then per forward at each bucket: the
    three products summed."""
    gen = torch.Generator().manual_seed(SEED + 28)
    for r in rows:
        x = torch.randn(r["M"], r["K"], generator=gen).cuda()
        w = torch.randn(r["K"], r["N"], generator=gen).cuda()
        (xq, xs), (wq, ws) = k8.quantize_rows(x), k8.quantize_weights(w)
        xq, wq = xq.contiguous(), wq.contiguous()
        call = lambda: k8.int8_matmul_fused(xq, wq, xs, ws)
        lib, _ = _int_mm_or_error(xq, wq)
        r["ms"] = _device_ms_per_call(call, name="int8")
        r["library_ms"] = _device_ms_per_call(lib) if lib else None
        for key, fn in (("host_us", call), ("library_host_us", lib)):
            if fn is None:
                r[key] = None
                continue
            fn()
            r[key] = _behind_sleep(lambda record: [fn() for _ in range(300)]
                                   ) / 300 * 1e3
    per = {(r["M"], r["K"], r["N"]): r for r in rows}
    totals = {}
    for M in INT8_BUCKETS:
        prods = [per[s] for s in int8_products(M)]
        t = {"M": M}
        for k in ("ms", "ms_loop", "plain_ms", "library_ms",
                  "library_ms_loop", "bound_ms"):
            vals = [p[k] for p in prods]
            t[k] = None if None in vals else sum(vals)
        t["bound_by"] = prods[0]["bound_by"]
        t["host_us_per_call"] = [p["host_us"] for p in prods]
        t["library_host_us_per_call"] = [p["library_host_us"] for p in prods]
        totals[M] = t
    log("K8 device time, per forward:", totals)
    return totals


# ----------------------------------------------------------------- phase 11
def _serve_closed_loop(eng, pool, sizes, clients, per_client):
    """``clients`` threads, each sending ``per_client`` requests in turn
    (sizes cycling from the client's index), the next when the last
    returns. Returns (per-request latencies in ms, wall s)."""
    lat = [[] for _ in range(clients)]

    def client(c):
        for i in range(per_client):
            n = sizes[(c + i) % len(sizes)]
            x = pool[c % (len(pool) - n + 1):][:n]
            t0 = time.perf_counter()
            out = eng.predict(x, timeout=120)
            lat[c].append((time.perf_counter() - t0) * 1e3)
            if out.shape[0] != n or not np.isfinite(out).all():
                raise AssertionError(f"client {c} request {i}: "
                                     f"{out.shape}, finite "
                                     f"{np.isfinite(out).all()}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        for f in [ex.submit(client, c) for c in range(clients)]:
            f.result()
    wall = time.perf_counter() - t0
    return [v for per in lat for v in per], wall


def _latency_stats(lat, wall, n_rows, snap):
    return {"requests": len(lat), "rows": n_rows,
            "requests_per_s": len(lat) / wall, "rows_per_s": n_rows / wall,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)), "wall_s": wall,
            "batches": snap["batches"], "per_bucket": snap["per_bucket"],
            "batch_occupancy": snap["batch_occupancy"]}


def _device_kernels(fn, top=15):
    """One call of ``fn`` under ``torch.profiler``: the device time of each
    kernel (profiler entries with device time and no host time of their
    own), the top ``top`` by time, and their sum against the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if dev > 0 and ev.self_cpu_time_total == 0:
            rows.append({"kernel": ev.key[:90], "calls": ev.count,
                         "ms": dev})
    rows.sort(key=lambda r: -r["ms"])
    return {"wall_ms": wall_ms, "device_ms": sum(r["ms"] for r in rows),
            "top": rows[:top]}


def googlenet_serve_phase():
    net = googlenet(**GNET).init(seed=SEED + 13)
    fwd = lambda n, x: n._output_pure(x)[0]      # the graph's one output
    t0 = time.perf_counter()
    eng = InferenceEngine(net, feature_shape=(224, 224, 3),
                          buckets=GNET_BUCKETS, forward_fn=fwd)
    warm_s = time.perf_counter() - t0
    pool = np.random.default_rng(SEED + 14).standard_normal(
        (16, 224, 224, 3)).astype(np.float32)
    n_rows = sum(GNET_SIZES[(c + i) % len(GNET_SIZES)]
                 for c in range(GNET_CLIENTS) for i in range(GNET_PER_CLIENT))
    try:
        traces0 = eng.trace_count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k7.conv1x1_fused.launches = 0            # the serving run's count
        lat, wall = _serve_closed_loop(eng, pool, GNET_SIZES, GNET_CLIENTS,
                                       GNET_PER_CLIENT)
        launches = k7.conv1x1_fused.launches
        peak = torch.cuda.max_memory_allocated()
        snap = eng.metrics()["default"]
        if eng.trace_count != traces0:
            raise AssertionError("traffic warmed a program")
        got = eng.predict(pool[:3])
    finally:
        eng.stop()
    if launches != 37 * snap["batches"] or launches == 0:
        raise AssertionError(f"K7 launched {launches} times for "
                             f"{snap['batches']} batches (37 each)")
    want = net.output(pool[:3]).cpu()
    err = _rel_to_max(torch.as_tensor(got), want)
    if err > 1e-5:
        raise AssertionError(f"GoogLeNet response differs from net.output: "
                             f"rel-to-max {err:.3g}")
    # one B 32 forward on the card, alone: its time and its kernels
    x32 = torch.as_tensor(np.concatenate([pool, pool]), device=net.device)
    with torch.inference_mode():
        fwd_ms = _time_ms(lambda: fwd(net, x32), iters=10)
        kernels = _device_kernels(lambda: fwd(net, x32), top=1000)
    # K7's share of the forward's kernel time, over all its tile shapes
    kernels["k7_ms"] = sum(r["ms"] for r in kernels["top"]
                           if "conv1x1" in r["kernel"])
    kernels["top"] = kernels["top"][:15]
    row = _latency_stats(lat, wall, n_rows, snap)
    row.update({"model": "googlenet 1000 classes 224x224x3 f32",
                "buckets": list(GNET_BUCKETS), "warm_s": warm_s,
                "images_per_s": row.pop("rows_per_s"),
                "max_memory_allocated_bytes": peak,
                "response_rel_to_max": err, "k7_launches": launches,
                "forward_ms_b32": fwd_ms, "forward_kernels_b32": kernels})
    return net, row


# ----------------------------------------------------------------- phase 12
def int8_net(device=None):
    K, H, V = INT8_NET
    conf = (NeuralNetConfiguration(seed=7, updater=Sgd(0.1), dtype="float32")
            .list(DenseLayer(n_in=K, n_out=H, activation="relu"),
                  DenseLayer(n_out=H, activation="relu"),
                  OutputLayer(n_out=V, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device)


def int8_serve_phase():
    net = int8_net().init(seed=SEED + 15)
    fwd8 = k8.int8_forward_fn(net)
    eng = InferenceEngine(net, feature_shape=(INT8_NET[0],),
                          buckets=INT8_BUCKETS, forward_fn=fwd8)
    rng = np.random.default_rng(SEED + 16)
    pool = rng.standard_normal((64, INT8_NET[0])).astype(np.float32)
    n_rows = sum(INT8_SIZES[(c + i) % len(INT8_SIZES)]
                 for c in range(INT8_CLIENTS) for i in range(INT8_PER_CLIENT))
    try:
        k8.int8_matmul_fused.launches = 0        # the serving run's count
        lat, wall = _serve_closed_loop(eng, pool, INT8_SIZES, INT8_CLIENTS,
                                       INT8_PER_CLIENT)
        launches = k8.int8_matmul_fused.launches
        snap = eng.metrics()["default"]
        x256 = rng.standard_normal((256, INT8_NET[0])).astype(np.float32)
        y8 = eng.registry.get().active.run(x256)
    finally:
        eng.stop()
    if launches != 3 * snap["batches"] or launches == 0:
        raise AssertionError(f"K8 launched {launches} times for "
                             f"{snap['batches']} batches (3 each)")
    y32 = net.output(x256).cpu().numpy()
    rel = float(np.max(np.abs(y8 - y32)) / (np.max(np.abs(y32)) + 1e-12))
    if not rel < 0.05:
        raise AssertionError(f"int8 forward is {rel:.3g} of f32 (limit 0.05)")
    xt = torch.as_tensor(x256, device=net.device)
    with torch.inference_mode():
        int8_ms = _time_ms(lambda: fwd8(net, xt))
        f32_ms = _time_ms(lambda: net._output_pure(xt))
    row = _latency_stats(lat, wall, n_rows, snap)
    row.update({"model": "int8 serving net 512-512-512-256 f32 weights",
                "buckets": list(INT8_BUCKETS), "int8_ms_b256": int8_ms,
                "f32_ms_b256": f32_ms, "max_rel_err_vs_f32": rel,
                "k8_launches": launches})
    return net, row


# ----------------------------------------------------------------- phase 13
def cnn_cross_device_phase(gnet, mlp):
    """GoogLeNet at 224 B 2, every vertex, and the int8 forward at B 16, on
    the card (K7, K8) and on the CPU (plain versions), same weights."""
    def carry(src, dst):
        groups = src.param_dicts()
        load_jax_params(dst, [{k: v.detach().cpu().numpy()
                               for k, v in groups[n].items()}
                              for n in groups])
        return dst

    cpu = carry(gnet, googlenet(**GNET, device="cpu").init())
    x = np.random.default_rng(SEED + 17).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    k7.conv1x1_fused.launches = 0
    got = gnet.feed_forward(x)
    launches = k7.conv1x1_fused.launches
    want = cpu.feed_forward(x)
    worst = max(want, key=lambda n: _rel_to_max(got[n].cpu(), want[n]))
    rel = _rel_to_max(got[worst].cpu(), want[worst])
    if rel > 1e-4 or launches != 37:
        raise AssertionError(f"GoogLeNet vertex {worst} on the card differs "
                             f"from the CPU's: rel-to-max {rel:.3g} "
                             f"({launches} K7 launches)")
    mcpu = carry(mlp, int8_net(device="cpu").init())
    xi = np.random.default_rng(SEED + 18).standard_normal(
        (16, INT8_NET[0])).astype(np.float32)
    with torch.inference_mode():
        y_gpu = k8.int8_forward_fn(mlp)(
            mlp, torch.as_tensor(xi, device=mlp.device)).cpu()
        y_cpu = k8.int8_forward_fn(mcpu)(mcpu, torch.as_tensor(xi))
    err8 = (y_gpu - y_cpu).abs().max().item()
    if err8 > 1e-6:
        raise AssertionError(f"int8 forward on the card vs CPU: {err8:.3g}")
    return {"googlenet_worst_vertex": worst, "googlenet_rel_to_max": rel,
            "k7_launches": launches, "int8_max_abs_err": err8}


# ----------------------------------------------------------------- phase 14
def _bits_err(got, want) -> float:
    """Largest |got - want| over the entries whose bits differ (two NaNs
    count as equal); a NaN against a number, or a difference that is not
    finite, counts as infinity. 0.0 exactly when the two are bitwise equal."""
    ints = {4: torch.int32, 2: torch.int16}[got.element_size()]
    same = (got.view(ints) == want.view(ints)) | (torch.isnan(got)
                                                  & torch.isnan(want))
    diff = (got.float() - want.float()).abs()
    diff = torch.nan_to_num(diff, nan=float("inf"), posinf=float("inf"))
    diff = torch.where(same, torch.zeros_like(diff), diff)
    # +0 against -0 differs in bits and by 0.0: count the smallest subnormal
    diff = torch.where(~same & (diff == 0), torch.full_like(diff, 1e-45), diff)
    return float(diff.max())


def _residual_like(gen, n, dtype, t):
    """A residual at a gradient's scale around the threshold ``t``, with
    the values a compare can get wrong placed at its start and end."""
    r = torch.randn(n, generator=gen) * (2.0 * t if t else 1.0)
    special = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                            -float("inf"), t, -t, 1e-30, -1e-30])
    r[:9] = special
    r[-9:] = special
    return r.to(dtype).cuda()


def k9_kernel_phase(n_params):
    """K9 against its plain version, bitwise, and its time at n = 25M and
    at the data-parallel path's row (the model's parameter count)."""
    gen = torch.Generator().manual_seed(SEED + 20)
    f32, bf16 = torch.float32, torch.bfloat16
    rows, shapes, worst = [], 0, 0.0
    for dtype in (f32, bf16):
        # (n, threshold, element offset of the slice in its buffer)
        cases = [(K9_N, 1e-3, 0), (n_params, DP_THRESHOLD, 0),
                 (65_536 + 777, 1e-3, 0), (65_536 + 777, 0.0, 0),
                 (1_000_003, 1e-3, 1), (70_001, 0.0123, 3)]
        for n, t, off in cases:
            buf = _residual_like(gen, n + off, dtype, t)
            r = buf[off:]
            if off and r.data_ptr() % 16 == 0:
                raise AssertionError("the slice is aligned after all")
            signs, res = k9.threshold_encode_fused(r, t)
            torch.cuda.synchronize()
            want_s, want_r = k9.threshold_encode_plain(r, t)
            err = max(_bits_err(res, want_r),
                      float((signs.int() - want_s.int()).abs().max()))
            if err != 0.0:
                bad = int((signs != want_s).sum()
                          + (res.float() != want_r.float()).sum())
                raise AssertionError(
                    f"K9 differs from plain at n={n} t={t} offset={off} "
                    f"{dtype}: by {err:.3g}, about {bad} entries (pinned "
                    f"bitwise)")
            worst = max(worst, err)
            # the special values at the end: NaN, +0, ..., t at [-4]
            if not bool(torch.isnan(res[-9]) and signs[-9] == 0
                        and (signs[-4] == 1 or t == 0) and signs[-8] == 0):
                raise AssertionError("K9's NaN, zero or at-threshold entry "
                                     "is wrong")
            shapes += 1
            if n not in (K9_N, n_params):
                continue
            nbytes = k9.roofline_bytes(n, dtype)
            rows.append({
                "n": n, "dtype": str(dtype), "threshold": t,
                "shipped_share": float((signs != 0).float().mean()),
                "ms": _time_ms(lambda: k9.threshold_encode_fused(r, t)),
                "plain_ms": _time_ms(lambda: k9.threshold_encode_plain(r, t),
                                     iters=5, warmup=1),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None})
            del buf, r, signs, res, want_s, want_r
    log("K9 phase: max abs err", worst, "over", shapes, "shapes;", rows)
    return worst, rows


# ----------------------------------------------------------------- phase 15
def _k4_bound(BH, Tq, Tk, D, dtype, causal):
    """Least time (ms): 4*D flops a visible pair at the dtype's peak against
    q, k, v read once and acc, m, l read and written once (f32)."""
    pairs = Tq * (Tq + 1) / 2 if causal else Tq * Tk
    item = torch.finfo(dtype).bits // 8
    nbytes = (BH * (Tq + 2 * Tk) * D * item
              + 2 * 4 * BH * Tq * (D + 2))
    return _roof_ms(4.0 * D * pairs * BH, nbytes, PEAK_FLOPS[dtype])


def k4_kernel_phase():
    """K4 against its plain version from a random incoming carry and from
    the first hop's empty one; timings at the ring's block."""
    gen = torch.Generator().manual_seed(SEED + 21)
    f32, bf16 = torch.float32, torch.bfloat16
    t_ring = RING["T"] // RING["workers"]
    BH_ring = RING["B"] * RING["H"]
    # (BH, Tq, Tk, D, causal); the ring's two hops first
    shapes = [(BH_ring, t_ring, t_ring, 64, True),
              (BH_ring, t_ring, t_ring, 64, False),
              (64, 128, 128, 64, True), (64, 128, 128, 64, False),
              (16, 512, 512, 128, True), (16, 512, 512, 128, False),
              (8, 256, 384, 64, False), (8, 384, 128, 96, False),
              (4, 200, 136, 96, False), (4, 200, 200, 64, True),
              (2, 128, 256, 256, False)]
    errs = {f32: 0.0, bf16: 0.0}
    rows = []

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dtype).cuda()

    for dtype in (f32, bf16):
        for BH, Tq, Tk, D, causal in shapes:
            scale = 1.0 / math.sqrt(D)
            q, k, v = rnd(BH, Tq, D, dtype=dtype), rnd(BH, Tk, D, dtype=dtype), \
                rnd(BH, Tk, D, dtype=dtype)
            empty = (torch.zeros(BH, Tq, D, device="cuda"),
                     torch.full((BH, Tq), -1e30, device="cuda"),
                     torch.zeros(BH, Tq, device="cuda"))
            # a carry that an earlier hop over other keys left behind
            kp, vp = rnd(BH, Tk, D, dtype=dtype), rnd(BH, Tk, D, dtype=dtype)
            earlier = fa.flash_block_update_reference(*empty, q, kp, vp,
                                                      False, scale)
            for carry in (empty, earlier):
                got = fa.flash_block_update(*carry, q, k, v, causal=causal,
                                            scale=scale)
                torch.cuda.synchronize()
                want = fa.flash_block_update_reference(*carry, q, k, v,
                                                       causal, scale)
                if not all(torch.isfinite(t).all() for t in got):
                    raise AssertionError("K4 output is not finite")
                err = ((got[0] / got[2][..., None])
                       - (want[0] / want[2][..., None])).abs().max().item()
                err_m = (got[1] - want[1]).abs().max().item()
                err_l = _rel_to_max(got[2], want[2])
                if err > TOL[dtype] or err_m > 1e-3 or err_l > BWD_TOL[dtype]:
                    raise AssertionError(
                        f"K4 disagrees with plain at BH={BH} Tq={Tq} Tk={Tk} "
                        f"D={D} causal={causal} {dtype}: acc/l {err:.3g} > "
                        f"{TOL[dtype]}, m {err_m:.3g}, l rel {err_l:.3g}")
                errs[dtype] = max(errs[dtype], err)
            if (BH, Tq, D) != (BH_ring, t_ring, 64):
                continue
            bound, by = _k4_bound(BH, Tq, Tk, D, dtype, causal)
            rows.append({
                "BH": BH, "Tq": Tq, "Tk": Tk, "D": D, "dtype": str(dtype),
                "hop": "diagonal" if causal else "full",
                "ms": _time_ms(lambda: fa.flash_block_update(
                    *earlier, q, k, v, causal=causal, scale=scale), iters=10),
                "plain_ms": _time_ms(lambda: fa.flash_block_update_reference(
                    *earlier, q, k, v, causal, scale), iters=5, warmup=1),
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    log("K4 phase: max abs err of acc/l", {str(d): e for d, e in errs.items()},
        rows)
    return errs, rows


# ----------------------------------------------------------------- phase 16
def _wall_ms(fn, iters=3) -> float:
    """Host clock around ``iters`` calls that end in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def ring_phase():
    """Path B at its full width: the fused ring forward and backward
    against ``flash_attention`` on the whole sequence and against the
    plain ring, in f32 and bf16."""
    B, H, T, D, n = (RING[k] for k in ("B", "H", "T", "D", "workers"))
    mesh = make_mesh((n,), ("seq",))
    fused = ring_attention_sharded(mesh, "seq", causal=True)
    plain = ring_attention_sharded(mesh, "seq", causal=True, use_fused=False)
    whole = lambda q, k, v: fa.flash_attention(q, k, v, causal=True)
    gen = torch.Generator().manual_seed(SEED + 22)
    hops = n * (n + 1) // 2                     # 8 diagonal + 28 full
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        # half-scale inputs keep |out| under 2, where a bf16 ulp is
        # 0.0078: the plain ring carries its sums in bf16
        q, k, v, do = ((torch.randn(B, H, T, D, generator=gen) * 0.5)
                       .to(dtype).cuda() for _ in range(4))

        def run(fn):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            return out.detach(), torch.autograd.grad(out, leaves, do)

        _reset_launches()                        # the ring's own count
        o_ring, g_ring = run(fused)
        torch.cuda.synchronize()
        launches = _launches(PARALLEL_COUNTED)
        want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": hops,
                "flash_attention_bwd_dkv": hops, "flash_block_update": hops,
                "threshold_encode": 0}
        if launches != want:
            raise AssertionError(f"the ring launched {launches}, not {want}")
        if o_ring.shape != (B, H, T, D) or not torch.isfinite(
                o_ring.float()).all():
            raise AssertionError("the ring's output is not finite")
        row = {"launches": launches}
        for name, fn in (("flash_attention", whole), ("plain_ring", plain)):
            o_ref, g_ref = run(fn)
            torch.cuda.synchronize()
            err = (o_ring.float() - o_ref.float()).abs().max().item()
            rel = max(_rel_to_max(a, b) for a, b in zip(g_ring, g_ref))
            if err > TOL[dtype] or rel > BWD_TOL[dtype]:
                raise AssertionError(
                    f"the fused ring differs from {name} in {dtype}: forward "
                    f"{err:.3g} > {TOL[dtype]} or gradients rel-to-max "
                    f"{rel:.3g} > {BWD_TOL[dtype]}")
            row[f"fwd_abs_err_vs_{name}"] = err
            row[f"grad_rel_to_max_vs_{name}"] = rel
            del o_ref, g_ref
        with torch.no_grad():
            row["ring_fwd_ms"] = _wall_ms(lambda: fused(q, k, v))
            row["flash_attention_fwd_ms"] = _wall_ms(lambda: whole(q, k, v))
            row["plain_ring_fwd_ms"] = _wall_ms(lambda: plain(q, k, v))
        row["ring_fwd_bwd_ms"] = _wall_ms(lambda: run(fused))
        row["flash_attention_fwd_bwd_ms"] = _wall_ms(lambda: run(whole))
        row["plain_ring_fwd_bwd_ms"] = _wall_ms(lambda: run(plain), iters=2)
        rows[str(dtype)] = row
        del o_ring, g_ring
        torch.cuda.empty_cache()
    out = {"shape": [B, H, T, D], "workers": n, "t_local": T // n,
           "causal": True, "hops_per_ring": hops, **rows}
    log("ring phase:", out)
    return out


# ----------------------------------------------------------------- phase 17
def _tlm_f32(seed):
    return transformer_lm(**TLM, token_input=True,
                          updater=Adam(3e-4)).init(seed=seed)


def _fit_steps(fit, net, steps):
    """``steps`` calls of ``fit()``, each timed to its end; the losses the
    net's listener saw."""
    rec = _Losses()
    net.set_listeners(rec)
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return step_ms, [float(v) for v in rec.losses]


def dp_phase():
    """Path A at its full width: ``ParallelWrapper`` with an
    ``EncodedAccumulator`` on 4 logical workers, beside the plain sync path
    and a single worker's ``fit`` on the same batch."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    V, T = TLM["vocab_size"], TLM["max_length"]
    rng = np.random.default_rng(SEED + 23)
    x = torch.as_tensor(rng.integers(0, V, (TRAIN_B, T)), device="cuda")
    y = _one_hot_prev(x, V, torch.float32)
    feed = lambda: ListDataSetIterator([DataSet(x, y)])
    net = _tlm_f32(SEED + 24)
    n_params = net.num_params()
    mesh = make_mesh((DP_WORKERS,), ("data",))
    pw = ParallelWrapper(net, mesh=mesh, gradient_accumulator=
                         EncodedAccumulator(threshold=DP_THRESHOLD))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()                       # the compressed run's count
    step_ms, losses = _fit_steps(lambda: pw.fit(feed()), net, DP_STEPS)
    launches = _launches(PARALLEL_COUNTED)
    peak = torch.cuda.max_memory_allocated()
    per_worker = TLM["n_blocks"] * DP_WORKERS * DP_STEPS
    want = {"flash_attention_fwd": per_worker,
            "flash_attention_bwd_dq": per_worker,
            "flash_attention_bwd_dkv": per_worker, "flash_block_update": 0,
            "threshold_encode": DP_WORKERS * DP_STEPS}
    if launches != want:
        raise AssertionError(f"compressed training launched {launches}, not "
                             f"{want}")
    if len(losses) != DP_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"compressed training losses: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"compressed training loss did not fall: "
                             f"{losses}")
    acc = pw._acc_state
    if tuple(acc.shape) != (DP_WORKERS, n_params) or not torch.isfinite(
            acc).all():
        raise AssertionError(f"the residual carry is {tuple(acc.shape)} or "
                             f"not finite")
    row = {"model": "transformer_lm _TLM f32 Adam(3e-4)", "workers": DP_WORKERS,
           "batch": TRAIN_B, "seq_len": T, "steps": DP_STEPS,
           "threshold": DP_THRESHOLD, "num_params": n_params,
           "losses": losses, "step_ms": step_ms,
           "step_ms_p50_after_first": float(np.median(step_ms[1:])),
           "max_memory_allocated_bytes": peak, "launches": launches,
           "acc_state_bytes": acc.numel() * acc.element_size(),
           "carry_abs_max": float(acc.abs().max())}
    # the share of entries a step ships (an entry ships when its residual
    # clears the threshold): of a fresh gradient alone, as the first step
    # saw it, and of the carried residual plus a gradient, as the next would
    _, flat = pw._worker_grads(x, y, torch.Generator(device="cuda"), 0)
    q = torch.quantile(flat[0].abs()[::64].float(),
                       torch.tensor([0.5, 0.9, 0.99], device="cuda"))
    row["grad_abs_quantiles_50_90_99"] = [float(v) for v in q]
    row["shipped_share_from_zero_carry"] = float(
        (flat.abs() >= DP_THRESHOLD).float().mean())
    row["shipped_share_next_step"] = float(
        ((acc + flat).abs() >= DP_THRESHOLD).float().mean())
    del flat
    # one more compressed step under the profiler: its kernels by device time
    row["step_kernels"] = _device_kernels(lambda: pw.fit(feed()), top=12)
    del pw, net, acc
    torch.cuda.empty_cache()
    # the same batch through the plain sync path and a single worker's fit
    net2 = _tlm_f32(SEED + 24)
    pw2 = ParallelWrapper(net2, mesh=mesh)
    ms2, losses2 = _fit_steps(lambda: pw2.fit(feed()), net2, DP_STEPS)
    net3 = _tlm_f32(SEED + 24)
    ms3, losses3 = _fit_steps(lambda: net3.fit(x, y, batch_size=TRAIN_B),
                              net3, DP_STEPS)
    # the plain sync path takes the same steps as one worker on the whole
    # batch (the mean of the shards' gradients is the batch's gradient)
    if abs(losses2[-1] - losses3[-1]) > 1e-2 * abs(losses3[-1]):
        raise AssertionError(f"plain sync losses {losses2} differ from a "
                             f"single worker's {losses3}")
    row.update({"plain_sync_step_ms": ms2, "plain_sync_losses": losses2,
                "plain_sync_step_ms_p50_after_first":
                    float(np.median(ms2[1:])),
                "single_worker_step_ms": ms3, "single_worker_losses": losses3,
                "single_worker_step_ms_p50_after_first":
                    float(np.median(ms3[1:]))})
    log("data-parallel phase:", row)
    return row


# ----------------------------------------------------------------- phase 18
def parallel_cross_device_phase():
    """One fused ring forward at T 2048 on 4 workers and one
    ``EncodedAccumulator.combine`` (both encoders) on the card (K4, K9) and
    on the CPU (plain versions), from the same inputs."""
    gen = torch.Generator().manual_seed(SEED + 25)
    q, k, v = (torch.randn(1, 8, 2048, 64, generator=gen) * 0.5
               for _ in range(3))
    out = {}
    res = {}
    for dev in ("cuda", "cpu"):
        fn = ring_attention_sharded(make_mesh((4,), ("seq",), dev), "seq",
                                    causal=True, use_fused=True)
        _reset_launches()
        res[dev] = fn(q.to(dev), k.to(dev), v.to(dev)).cpu()
        if dev == "cuda":
            out["ring_k4_launches"] = fa.flash_block_update.launches
    err = (res["cuda"] - res["cpu"]).abs().max().item()
    if err > TOL[torch.float32] or out["ring_k4_launches"] != 10:
        raise AssertionError(f"ring forward on the card vs CPU: {err:.3g} "
                             f"({out['ring_k4_launches']} K4 launches)")
    out["ring_fwd_abs_err"] = err
    n, size, t = 4, 200_003, 1e-3
    grads = torch.randn(n, size, generator=gen) * 2e-3
    state = torch.randn(n, size, generator=gen) * 5e-4
    for enc in ("dense", "topk"):
        acc = EncodedAccumulator(threshold=t, encoder=enc)
        got = {}
        for dev in ("cuda", "cpu"):
            _reset_launches()
            u, s = acc.combine(grads.to(dev), state.to(dev),
                               make_mesh((n,), ("data",), dev))
            got[dev] = (u.cpu(), s.cpu())
            if dev == "cuda":
                out[f"{enc}_k9_launches"] = k9.threshold_encode_fused.launches
        if not all(torch.equal(a, b) for a, b in zip(got["cuda"],
                                                     got["cpu"])):
            raise AssertionError(f"{enc} combine on the card differs from "
                                 f"the CPU's (pinned bitwise)")
    if out["dense_k9_launches"] != n or out["topk_k9_launches"] != 0:
        raise AssertionError(f"combine launched K9 {out}")
    return out


# ------------------------------------------------------------------- main
def main() -> int:
    smi = device_phase()
    build_report = build_phase()
    errs, rows = kernel_phase()
    bwd_errs, bwd_rows, sdpa_backends, ring_hops = bwd_kernel_phase()
    slice_row = slice_phase()
    gen_row = generation_phase()
    train_row = train_phase()
    cross_row = cross_device_phase()
    lstm_errs, lstm_rows, lstm_step_us, lstm_plans = lstm_kernel_phase()
    char_serve = char_serve_phase()
    char_train = char_train_phase()
    char_cross = char_cross_device_phase()
    k7_errs, k7_rows, k7_bf16_rows = conv_kernel_phase()
    k8_rows, k8_err = int8_kernel_phase()
    gnet, gserve = googlenet_serve_phase()
    mlp, i8serve = int8_serve_phase()
    cnn_cross = cnn_cross_device_phase(gnet, mlp)
    del gnet, mlp
    torch.cuda.empty_cache()
    n_params = _tlm_f32(SEED + 24).num_params()
    k9_err, k9_rows = k9_kernel_phase(n_params)
    k4_errs, k4_rows = k4_kernel_phase()
    ring_row = ring_phase()
    dp_row = dp_phase()
    par_cross = parallel_cross_device_phase()
    k7_total = conv_device_time_phase(k7_rows)
    ring_hop_device_time_phase(ring_hops)
    k8_totals = int8_device_time_phase(k8_rows)
    k8_total = k8_totals[max(INT8_BUCKETS)]
    k4_device_time_phase(k4_rows)
    lstm_device = lstm_device_time_phase()
    top = next(r for r in rows if r["BH"] == 16 and r["T"] == 1024
               and r["dtype"] == str(torch.float32))
    serve_k1 = slice_row["flash_attention_launches"]
    gen_k1 = sum(gen_row["k1_launches"].values())
    lstm_draft_k5 = gen_row["cases"]["e_spec_lstm"]["k5_launches"]
    train_k = train_row["launches"]
    ring_dtypes = (str(torch.float32), str(torch.bfloat16))
    src = "deeplearning4j_tpu_torch/csrc/flash_attention_{}.cu"
    ref = "deeplearning4j_tpu/ops/pallas_attention.py:{}"
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src.format("fwd"), "replaces": ref.format(186),
        "launches": serve_k1 + gen_k1 + train_k["flash_attention_fwd"]
        + dp_row["launches"]["flash_attention_fwd"],
        "launches_by_path": {
            "serve": serve_k1, "serve_generation": gen_row["k1_launches"],
            "train": train_k["flash_attention_fwd"],
            "train_data_parallel": dp_row["launches"]["flash_attention_fwd"]},
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
            "name": name, "route": "cuda",
            "source": src.format("bwd" if kind == "dq" else "bwd_dkv"),
            "replaces": ref.format(line),
            "launches": train_k[name] + dp_row["launches"][name]
            + sum(ring_row[d]["launches"][name] for d in ring_dtypes),
            "launches_by_path": {
                "train": train_k[name],
                "train_data_parallel": dp_row["launches"][name],
                "ring": sum(ring_row[d]["launches"][name]
                            for d in ring_dtypes)},
            "max_abs_err": max(e[0] for e in bwd_errs[kind].values()),
            "max_rel_err_f32": bwd_errs[kind][torch.float32][1],
            "max_rel_err_bf16": bwd_errs[kind][torch.bfloat16][1],
            "shape": "BH=64 T=1024 D=64 bfloat16 causal",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    lstm_top = next(r for r in lstm_rows if r["T"] == CHAR_T
                    and r["B"] == CHAR_B)
    lsrc = "deeplearning4j_tpu_torch/csrc/lstm_{}.cu"
    lref = "deeplearning4j_tpu/ops/pallas_lstm.py:{}"
    for kind, name, line in (("fwd", "lstm_fwd", 147), ("bwd", "lstm_bwd", 282)):
        serve_n = char_serve["launches"][name]
        train_n = char_train["launches"][name]
        draft_n = lstm_draft_k5 if kind == "fwd" else 0
        by_path = {"serve": serve_n, "train": train_n}
        if kind == "fwd":
            by_path.update(
                serve_decode_graph_replays=char_serve[
                    "launches_in_replays"].get(name, 0),
                serve_lstm_draft=draft_n)
        kernels.append({
            "name": name, "route": "cuda", "source": lsrc.format(kind),
            "replaces": lref.format(line),
            "launches": serve_n + train_n + draft_n,
            "launches_by_path": by_path,
            "max_abs_err": max(lstm_errs[(kind, torch.float32)],
                               lstm_errs[(kind, torch.bfloat16)]),
            "max_abs_err_f32": lstm_errs[(kind, torch.float32)],
            "max_abs_err_bf16": lstm_errs[(kind, torch.bfloat16)],
            "shape": "T=64 B=32 H=512 float32 peepholes",
            "ms": lstm_top[f"{kind}_ms"],
            "plain_ms": lstm_top[f"{kind}_plain_ms"],
            "bound_ms": lstm_top[f"{kind}_bound_ms"],
            "bound_by": lstm_top[f"{kind}_bound_by"],
            "library_ms": lstm_top[f"{kind}_library_ms"],
            "device_ms_by_shape": {k.split("_", 1)[1]: v
                                   for k, v in lstm_device.items()
                                   if k.startswith(kind)},
            "library_device_ms": lstm_device.get(
                f"cudnn_{kind}_train_T64_B32"),
            "library_device_ms_by_shape": {
                k.split("_", 2)[2]: v for k, v in lstm_device.items()
                if k.startswith(f"cudnn_{kind}")}})
    kernels.append({
        "name": "conv1x1_bias_relu", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/conv1x1_bias_relu.cu",
        "replaces": "deeplearning4j_tpu/ops/kernels/conv.py:83",
        "launches": gserve["k7_launches"],
        "launches_by_path": {"serve_googlenet": gserve["k7_launches"]},
        "max_abs_err": k7_errs["parity_abs"],
        "max_rel_to_max_err_f32": k7_errs["f32_rel"],
        "max_rel_to_max_err_bf16": k7_errs["bf16_rel"],
        "shape": "the 37 1x1 convs of one GoogLeNet forward, B 32 f32 "
                 "(ms and library_ms: device time)",
        "ms": k7_total["ms"], "plain_ms": k7_total["plain_ms"],
        "bound_ms": k7_total["bound_ms"], "bound_by": k7_total["bound_by"],
        "library_ms": k7_total["library_ms"],
        "ms_loop": k7_total["ms_loop"],
        "library_ms_loop": k7_total["library_ms_loop"]})
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "deeplearning4j_tpu/ops/kernels/quantized.py:92",
        "launches": i8serve["k8_launches"],
        "launches_by_path": {"serve_int8": i8serve["k8_launches"]},
        "max_abs_err": k8_err,
        "shape": "the 3 products of one int8 net forward, M 256 (ms and "
                 "library_ms: device time; _loop: timed loops of calls)",
        "ms": k8_total["ms"], "plain_ms": k8_total["plain_ms"],
        "bound_ms": k8_total["bound_ms"], "bound_by": k8_total["bound_by"],
        "library_ms": k8_total["library_ms"],
        "ms_loop": k8_total["ms_loop"],
        "library_ms_loop": k8_total["library_ms_loop"],
        "per_bucket": k8_totals})
    k4_top = next(r for r in k4_rows if r["hop"] == "full"
                  and r["dtype"] == str(torch.float32))
    ring_k4 = sum(ring_row[d]["launches"]["flash_block_update"]
                  for d in ring_dtypes)
    kernels.append({
        "name": "flash_block_update", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_block_update.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:440",
        "launches": ring_k4, "launches_by_path": {"ring": ring_k4},
        "max_abs_err": k4_errs[torch.float32],
        "max_abs_err_f32": k4_errs[torch.float32],
        "max_abs_err_bf16": k4_errs[torch.bfloat16],
        "shape": "one full hop: BH=8 Tq=Tk=2048 D=64 float32 (ms: device "
                 "time; ms_loop: a timed loop)",
        "ms": k4_top["device_ms"], "ms_loop": k4_top["ms"],
        "plain_ms": k4_top["plain_ms"],
        "bound_ms": k4_top["bound_ms"], "bound_by": k4_top["bound_by"],
        "library_ms": None,
        "hops_device_ms": {f'{r["dtype"]} {r["hop"]}': r["device_ms"]
                           for r in k4_rows},
        "hops_device_ms_rounds": {f'{r["dtype"]} {r["hop"]}':
                                  r["device_ms_rounds"] for r in k4_rows}})
    k9_top = next(r for r in k9_rows if r["n"] == n_params
                  and r["dtype"] == str(torch.float32))
    kernels.append({
        "name": "threshold_encode", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/threshold_encode.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_compression.py:89",
        "launches": dp_row["launches"]["threshold_encode"],
        "launches_by_path": {
            "train_data_parallel": dp_row["launches"]["threshold_encode"]},
        "max_abs_err": k9_err,
        "shape": f"one worker's flat residual: n={n_params} float32",
        "ms": k9_top["ms"], "plain_ms": k9_top["plain_ms"],
        "bound_ms": k9_top["bound_ms"], "bound_by": k9_top["bound_by"],
        "library_ms": None})
    print(json.dumps({"kernel_shapes": rows, "bwd_kernel_shapes": bwd_rows,
                      "lstm_kernel_shapes": lstm_rows,
                      "lstm_step_us": lstm_step_us,
                      "k5_plans": lstm_plans["fwd"],
                      "k6_plans": lstm_plans["bwd"],
                      "conv1x1_shapes": k7_rows,
                      "conv1x1_bf16_shapes": k7_bf16_rows,
                      "int8_matmul_shapes": k8_rows,
                      "threshold_encode_shapes": k9_rows,
                      "flash_block_update_shapes": k4_rows,
                      "build": build_report, "software": SOFTWARE,
                      "sdpa_backward_by_backend": sdpa_backends,
                      "ring_hops_diagonal_vs_full": ring_hops,
                      "card": smi}),
          flush=True)
    print(json.dumps({"slice": slice_row, "generation": gen_row,
                      "card": smi}), flush=True)
    print(json.dumps({"train": train_row, "cross_device": cross_row,
                      "card": smi}), flush=True)
    print(json.dumps({"char_serve": char_serve, "char_train": char_train,
                      "char_cross_device": char_cross, "card": smi}),
          flush=True)
    print(json.dumps({"googlenet_serve": gserve, "int8_serve": i8serve,
                      "cnn_cross_device": cnn_cross, "card": smi}),
          flush=True)
    print(json.dumps({"ring": ring_row, "data_parallel": dp_row,
                      "parallel_cross_device": par_cross, "card": smi}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
