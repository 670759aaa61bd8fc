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
4b. The rest of the training engine: (a) the same model with float32
   master weights and bfloat16 compute (``compute_dtype`` set on the
   built configuration) and ``Adam(3e-4)`` takes 16 seeded batches of B 8
   (one-hot f32 labels, 134 MB a batch) through ``net.fit`` four times:
   per step with no prefetch; per step with the default prefetch; with
   ``steps_per_dispatch=8`` and the
   default prefetch (each window's steps replays of one captured CUDA
   graph: one capture, 15 replays); and so again with
   ``gradient_checkpointing``. The other runs' parameters must equal
   the first's (bitwise, else rel-to-max 1e-5), the loss fall, and
   K1, K2 and K3 launch 12 times a step each (K1 24 under remat), counted
   as eager launches plus the graph's captured launches times its
   replays. Reports each run's step time after the first window,
   tokens/s, peak memory, the prefetcher's wait, captures and replays,
   and the profiler's device time a step over one more window. Then one
   bf16-compute step of a 2-block model (d_model 512, T 1024, B 2) on
   the card against the CPU: loss rel and gradients rel-to-max 2e-2, the
   master gradients float32. (b) (run after phase 9) The char-RNN's
   layers as a ``ComputationGraph`` (two GravesLSTM(512), vocab 87, T 64, tBPTT 50):
   6 ``fit``s of B 32 (K5 and K6 24 each), one fit at B 8 against the
   CPU's from the same weights and RmsProp state (rel-to-max 1e-4), then
   ``rnn_time_step`` over 64 steps at B 8 against ``output`` on the whole
   sequence (1e-5; K5 2 x 64 launches).
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
   show 2 x 2 ``lstm_fwd`` kernels (none more; where every one of 8
   sessions shows fewer, the profiler lost records: one session must
   still show 3, and the capture's count of 2 a replay must give 4).
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
12b. ResNet-50 at its full width: ``resnet50(1000)`` at 224x224x3, f32,
   ``Adam(1e-3)``, 16 seeded batches of B 32 (one-hot labels) through
   ``fit`` per step, per step again, in windows of 8 (a CUDA graph of
   the step: 1 capture, 15 replays) and in windows with gradient
   checkpointing (whose recompute must not move the statistics twice)
   from one seed, with
   ``torch.backends.cudnn.deterministic`` set for these fits and restored
   after: parameters and BatchNorm running statistics must be bitwise
   the per-step run's (or, if two per-step runs already differ, within
   rel-to-max 1e-6). ``evaluate`` on 4 held-out batches must give the
   confusion matrix numpy builds from ``output``; the trained network
   through a zip (``state.bin`` holds every running statistic) answers
   bitwise as before; ``InferenceEngine`` (buckets 1, 8, 32) answers as
   ``net.output`` at atol 1e-5. One step of ``resnet50(10)`` at 64x64,
   B 4, on the card and on the CPU from the same weights: float64 loss at
   rel 1e-5, every gradient and new running statistic at rel-to-max
   1e-4; the float32 readings are reported beside the CPU's float32 vs
   float64 distance (see ``_resnet_cross_device``). Step p50 per step and
   in windows and peak memory are reported; device time a step in phase
   19.
12c. GoogLeNet transfer learning, K7's training path: ``googlenet(1000)``
   from a seed through ``TransferLearningGraph`` (frozen up to avg3, a new
   10-class xavier head, ``Adam(1e-3)``) under ``EarlyStoppingTrainer``
   (``MaxEpochsTerminationCondition(3)``,
   ``ScoreImprovementEpochTerminationCondition(1)``, a
   ``DataSetLossCalculator`` over the 8 training batches of B 32,
   ``InMemoryModelSaver``): every frozen parameter bitwise unchanged, the
   score falls, K7 launches 37 times a forward (training steps,
   validation scores and the best model's ``evaluate``, each counted from
   0), and K7 equals its plain version at all 37 1x1 convs of one
   frozen-trunk batch at rel-to-max 1e-5 (phase 10's pin at these
   shapes; the absolute error, at outputs up to ~100, is reported).
   Step p50 reported; device time a step,
   K7's share of it and the convolution-backward kernels a step (whether
   a backward runs through the frozen trunk) in phase 19.
12d. The rest of the nn engine: (a) DL4J's Word2VecSentimentRNN at its
   width, ids [B,T,1] -> ``EmbeddingLayer(30000, 300)`` (behind an
   explicit ``RnnToFeedForwardPreProcessor``) -> ``GravesLSTM(256)``
   (behind ``FeedForwardToRnnPreProcessor(256)``) ->
   ``LastTimeStepVertex(mask_input="in")`` -> a 2-class softmax, f32,
   Adam(2e-2), l2 1e-5, element-wise clipping at 1.0; 16 seeded batches
   of B 64 reviews of 32-256 steps (a [B,T] features mask) through
   ``fit`` per step and in windows of 8 (a CUDA graph: 1 capture, 15
   replays) from one seed, under ``torch.use_deterministic_algorithms``
   (set for the two fits and restored after: the embedding's backward
   adds by a sort, not by atomics): parameters bitwise equal; K5 and K6
   launch once a step in each (eager plus captured x replays), K5 once
   an evaluated batch; ``evaluate`` on 4 held-out batches gives numpy's
   confusion matrix of ``output`` (no features mask, as the reference's);
   K5 and K6 against their plain versions at T 256 B 64 H 256 with
   peepholes, unmasked and under a batch's mask (1e-5 / 3e-5), their
   plans printed; one f32 step at V 500, T 32, B 8 on the card and on the
   CPU (loss rel 1e-5, gradients rel-to-max 1e-4); ``check_gradients``
   in float64 on the card over 400 of its parameters (float64 is outside
   K5's probe: the plain recurrence). (b) ``examples/seq2seq_tbptt.py``'s
   graph (LSTM 32, T 20, tBPTT 5): 3 fits and 3 ``rnn_time_step`` steps
   on the card and on the CPU from the same weights (atol 1e-5); K5 and
   K6 24 launches in the fits, K5 6 in the steps; the first streamed step
   equals a full forward of that step. (c) One layerwise ``pretrain``
   epoch of a VAE at DL4J's VariationalAutoEncoderExample width (784 ->
   (256, 256) -> 2 -> (256, 256), Bernoulli, RMSProp(1e-2), l2 1e-4, B
   128, the same noise on both devices) and 8 LBFGS iterations of a small
   MLP, float64, card against CPU: parameters at rel-to-max 1e-9.
   Step p50, peak memory; device time in phase 19.
13. CPU against card: GoogLeNet at 224, B 2, every vertex's activation at
   rel-to-max 1e-4; the int8 forward at B 16 at atol 1e-6.
13b. Zip + HTTP: each served model goes through the port's model zip
   (``util.serialization.write_model`` into a temporary directory, then
   ``restore_model(device="cuda")``; the restored parameters must equal
   the written ones bitwise) and is served behind ``ServingHTTPServer`` on
   127.0.0.1 at an ephemeral port: (a) GoogLeNet (phase 11's, 224x224x3,
   1000 classes) behind ``InferenceEngine``, 4 POST /predict of batch 2,
   each response equal to the restored net's ``output`` at rel-to-max
   1e-5, K7 37 launches a dispatched batch; (b) the int8 net (phase 12's)
   with ``int8_forward_fn``, 4 POST /predict of batch 2 equal to the
   direct int8 forward at rel-to-max 1e-5, K8 3 launches a batch; (c)
   ``transformer_lm`` at the _TLM width, f32, behind ``GenerationEngine``
   (prefix cache off, so every request prefills), 4 prompts of 300-900
   tokens x 32 new, streamed then blocking: tokens equal the engine's
   direct greedy tokens and ``naive_generate``'s; K1 must launch; (d)
   POST /reload with a checkpoint directory of ``checkpoint_epoch1.zip``,
   ``checkpoint_epoch2.zip`` (another seed) and a truncated
   ``checkpoint_epoch3.zip``: version 2, and later streams equal the
   epoch-2 weights' ``naive_generate``; (e) the char-RNN through a zip
   and 4 streamed /generate requests of 40-160 characters x 64: tokens
   equal ``naive_generate_lstm``'s, K5's launches (eager + graph replays)
   equal 2 layers x (prefills + decode steps). The status taxonomy on the
   card: a malformed body 400, an unknown model 404, draining 503.
   Timed: ``write_model`` and ``restore_model`` seconds for GoogLeNet and
   the _TLM, /predict p50 beside ``engine.predict`` p50 at the same batch
   of 2 images, /generate time to first token p50 beside the direct
   call's.
   In phases 3, 3b, 4, 4b, 7, 8, 11, 12, 12c, 12d, 13b, 12e, 16, 17, 17b,
   17c, 17d and 22 the
   launch counts are
   set to 0 just before the path is driven and read just after; every
   kernel of the path must launch.
12e. Listeners and the resumable fit (run after phase 19, with 17b, both
   last: ahead of it they pushed phase 19's short profiler sessions ~2
   minutes later in the run, where many recorded no kernel): ``_TLM`` with f32
   masters and bf16 compute (phase 4b's), B 8, under deterministic
   algorithms, through ``fit_with_checkpointing``: per step over 16
   batches with saves every 4 (keep 2), and the same fit stopped by an
   iterator that raises after batch 10, resumed in a fresh network from
   the newest zip (step 8); then in windows of 4 over 2 epochs with
   epoch saves, stopped in epoch 2 and resumed from epoch 1. Each resumed
   run must equal the uninterrupted one bitwise (parameters, updater
   state, layer state, iteration count); K1-K3 12 launches a step (eager
   plus captured x replays; one capture a network). The windowed fit
   carries a ``PerformanceListener(frequency=4)`` (reports on window
   ends, 4.0 steps a dispatch, the prefetcher's wait) and a
   ``ProfilerListener``, whose Chrome trace must hold K1's kernel.
   ResNet-50 (phase 12b's, f32, B 32, cuDNN deterministic) over 6 batches
   with saves every 2, stopped after 4 and resumed: ``state.bin`` too.
   Times one stored checkpoint write of each model and deflate's rate
   (the reference's zips) on 64 MB of its coefficients.
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
17b. The data-parallel options at the same width (f32, 4 logical
   workers, B 8, 8 batches, under deterministic algorithms): ZeRO stages
   1 and 2 and ``overlap_sync`` (the default bucket and a 64 KB one) must
   end with the plain sync wrapper's parameters and (gathered) updater
   state bitwise; the updater state's bytes a worker, replicated against
   ZeRO; ``steps_per_dispatch=4`` on plain sync and ZeRO-2 (the wrapper's
   step captured once and replayed) bitwise their per-step runs, step ms
   in windows beside per step; an ``AsyncCheckpointWriter`` submitting
   the ZeRO state every 2 steps, a crash after step 5, the newest
   complete save (step 4) restored into a fresh wrapper and trained to
   step 8, bitwise the uninterrupted run; the save re-sharded onto 2
   workers with the same gathered state. K1-K3 must launch 12 times a
   worker a step (eager plus captured x replays). Then K-step averaging
   (``averaging_frequency=3``, ``average_updaters``) of the char-RNN
   (phase 8's width) on 4 workers over 6 whole-sequence batches, once
   with Sgd(1e-3) and once with its own RmsProp(1e-3), whose state is
   averaged: K5 and K6 96 launches each, parameters and updater state
   within rel-to-max 1e-5 (Sgd) and 1e-4 (RmsProp, phase 9's pin) of the
   CPU's plain runs from the same weights; the RmsProp case also against
   a float64 CPU run.
17c. The model axis (run after phase 19, as 12e and 17b are): (a) the
   _TLM (f32, Adam(3e-4), B 8, 8 batches, deterministic algorithms)
   through ``ParallelWrapper(mesh_shape=(2, 2))`` per step, in windows of
   4 (the wrapper's step as a CUDA graph) and with ZeRO-2 over the data
   axis, each against the ``(4,)`` plain sync run from the same start
   (losses rel 1e-5 a step; the parameters after 8 steps in float64 at
   rel-to-max 1e-4), ``(4, 1)`` bitwise ``(4,)``, the windows and ZeRO-2
   bitwise their per-step run, one rank's parameter and Adam bytes exact,
   K1-K3 24 launches a step; the same 8 batches in float32 with
   Sgd(1e-4) on ``(2, 2)`` against ``(4,)``: the parameters at rel-to-max
   1e-5 and each parameter's update at 1e-4; (b) phase
   3's 8 greedy requests through an unsharded engine and a head-sharded
   one on a ``(1, 2)`` mesh: tokens equal up to a near tie (unsharded
   top-2 margin under 1e-4 relative, where both logit rows agree at
   rel-to-max 1e-5), the pools a rank half, the decode step a CUDA graph,
   its p50 beside the unsharded one's, K1 launched; (c) phase 11's
   GoogLeNet behind ``InferenceEngine(mesh=make_mesh((4,)))``, buckets (8,
   32): responses equal ``net.output`` at atol 1e-6, K7 37 launches a
   worker a batch, a ladder with 1 refused; (d) ``pipeline_apply`` of 4
   _TLM-width blocks (B 8 in 4 microbatches, T 1024): forward and
   gradients against the blocks run one after another (rel-to-max 1e-4),
   K1-K3 16 launches each; (e) the char-RNN (phase 8's width, Sgd(1e-3))
   on ``(2, 2)`` against ``(4,)`` over 4 batches (rel-to-max 1e-5), K5/K6
   launched; (f) ``expert_parallel_apply``, top-2 over 8 experts (512 ->
   2048 -> 512) of 4096 tokens: at capacity factor 4 (no token dropped)
   against the dense top-2 evaluation, and at capacity factor 1 (experts
   overflow: tokens re-routed and dropped) against the same call on the
   CPU; output rel-to-max 1e-5, the router's gradient 1e-4.
17d. The rest of the parallel layer (run after phase 19, with 12e, 17b
   and 17c; under deterministic algorithms where it trains): (a)
   ``ElasticTrainer`` on the _TLM (f32, Adam(3e-4), 4 logical workers,
   B 8), 12 steps over an epoch of 8 batches, a save every 4 steps (the
   newest 2 kept, in a temporary directory removed after): (a1) unfaulted,
   bitwise a plain ``ParallelWrapper(prefetch_buffer=0)`` over the same 12
   steps (parameters and Adam state); (a2) a truncated newest save and a
   worker killed (rejoining) at step 9: one recovery past the truncated
   save to step 4, 12 steps done, bitwise (a1); (a3) the same in windows
   of 4 (the wrapper's step as a CUDA graph), the kill planned at step 10
   inside the window [8, 12), bitwise (a1); (a4) preempted at step 5 (the
   final save at step 5 on disk), a fresh trainer on the directory
   continues to 12, bitwise (a1); (a5) a ``(2, 2)`` trainer under
   Sgd(1e-4) loses worker 3 for good at step 6: the mesh re-forms as
   ``(3, 1)``, the model-sharded save is restored onto it and the run
   finishes within rel-to-max 1e-5 of an uninterrupted ``(4,)`` Sgd run;
   (a6) degraded mode, a 400 ms ``SlowCollective`` over steps [2, 6)
   against a 50 ms budget: the mode history is exactly averaging at step 2
   and sync at step 8, K1 launches in both modes, a second run bitwise the
   first; (a7) after a warm-up fit, a steady-state elastic fit with saves
   makes no more synchronising calls and host reads on the loop thread
   than a plain wrapper fit over the same 8 steps, both counted by
   ``telemetry.HostSyncDetector(sync_debug=True)``
   (``torch.cuda.set_sync_debug_mode("warn")``'s warnings and the
   host-read funnel, each wait once; both counts and their call sites
   printed). K1-K3 12
   launches a worker a step (eager plus captured x replays, every wrapper
   a run made); the step p50 of the elastic run beside the plain
   wrapper's, the loop thread's ms a ``submit``, the writer's ``write_ms``
   and ``last_recovery_ms``. (b) ``ParallelInference`` (batch limit 32)
   over phase 11's GoogLeNet, 8 client threads of 1-8 images: each
   response within atol 1e-5 of ``net.output`` on the request alone, no
   merged batch over the limit, K7 37 launches a merged batch, images/s
   and latency p50 beside phase 11's ``InferenceEngine``; ``shutdown``
   fails the queued requests; ``ModelServingServer``: /health, /predict
   (atol 1e-5), a 400 on malformed features, 503 while draining. (c) The
   char-RNN (phase 8's width, whole 64-step sequences) trained by
   ``net.fit(iterator=topic)`` from a ``StreamingIngestServer`` a producer
   thread POSTs 6 batches and /end to: bitwise the same batches through a
   ``ListDataSetIterator``, /stats published == consumed == 6 and closed,
   K5 and K6 12 launches each. (d) ``initialize_distributed`` with one
   process on NCCL, ``global_mesh(("data",))``: a psum of one row is that
   row, 4 _TLM steps through ``ParallelWrapper(mesh=global_mesh(...))``
   bitwise the logical ``(1,)`` wrapper's, the NCCL kernels the profiler
   saw printed, ``shutdown_distributed``.
18. CPU against card, the parallel layer: one fused ring forward at
   T 2048 on 4 workers (atol 2e-5) and one ``EncodedAccumulator.combine``
   (dense and topk) on the same gradients (bitwise); one float32 ``(2,
   2)`` step of a 2-block _TLM (Sgd; the loss at rel 1e-5 and the applied
   gradient at rel-to-max 1e-4, phase 5's pins) and one head-sharded
   decode step of it (the logits at rel-to-max 2e-5).
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
   LSTM backward; a ResNet-50 step per step and in windows (replays
   only) and a GoogLeNet transfer step with K7's share of it; the
   sentiment classifier's step in windows (replays only) with K5's and
   K6's shares, and K5, K6 and cuDNN's ``nn.LSTM(300, 256)`` forward and
   backward at its shape (T 256, B 64). Its profiler sessions come after
   every host-bound phase but 12e and 17b. A kernel that three sessions
   did not record fails the phase.
20. Telemetry (after 17d, before 21: the host-read detector both use
   wraps ``torch.Tensor``'s read methods for the rest of the process). (a) Phase 3's model and 8
   requests behind ``ServingHTTPServer`` (the prefix cache off), one at a
   time, with the registry off and then on, each with its own ``X-Trace-Id``: tokens
   equal exactly, every id echoed, ``/debug/trace`` holding the
   ``generation.prefill`` and ``generation.decode_step`` spans and each
   request's ``http.request`` event, ``/metrics/prometheus`` parsing with
   a TTFT histogram of 8, ``/metrics`` with ``slo`` and ``perf``,
   ``/debug/memprof``'s ``generation.tel.kvcache`` rows within one
   block of the pool's bytes, and a ``/debug/flightrec`` dump that
   ``tools/trace2summary.py`` reads. (b) First a probe: the detector 17d's
   (a7) uses sees one ``nonzero`` (a synchronising call) and one
   ``.item()`` (a host read) once each, and raises under
   ``action="raise"``. Then the 8 requests concurrently in 4 rounds, the
   registry on and off alternated. With it on, what the scheduler's loop
   thread waits on the card for, counted as (a7) counts it: 0 synchronising
   calls, no wait inside a ``generation.decode_step`` span, and exactly
   one host read per eager program run (each prefill's, and a draft's
   or a verify's, result ``.cpu()``: the program's one wait, by design,
   the same with the registry off). The counters see only the waits
   torch routes through its sync check: the decode graph's token read
   waits on a ``torch.cuda.Event`` (``graphs.py``), which neither sees,
   on and off alike. 0 warm runs or captures after warm-up
   (``RecompileDetector``); each round's decode step p50 (reported, not
   gated). (c) Phase 4b's step
   (bf16 compute, Adam(3e-4), B 8) over 8 batches per step and in one
   window of 8, the registry on with a ``TrainingWatch`` armed against
   off: the parameters bitwise equal, the ``fit/epoch/step`` and
   ``fit/epoch/window/dispatch`` spans, a clean watch, a NaN planted in
   batch 5's labels flagged at step 5 in both modes,
   ``PerformanceListener``'s ``mfu`` in (0, 1) against the H100's bf16
   peak, and the cost index's flops a step beside 6·N·B·T plus attention.
   (c') The step's cost of telemetry, reported, not gated: phase 4b's
   step on one net per step and in windows of 8, the registry on, off,
   and on with a ``TrainingWatch``, alternated in 3 cycles after a warm
   one (8 steps, or 3 windows, a fit); each state's step (window) p50, and the warm cycle's first steps
   (the one the cost index counts under its dispatch mode among them).
   (d) ``device0.bytes_in_use`` equal to ``torch.cuda.memory_allocated``
   read at the same point, its peak at least that. (e) Forward serving's
   cost of telemetry, reported, not gated: phase 12's int8 net and
   closed loop, the registry on and off alternated in 3 cycles after a
   warm one; each state's latency p50/p99 and rows/s.
21. The parallel layer's telemetry and the serving fleet (after phase
   20). (a) ``_TLM`` f32 on 4 logical workers into a fresh registry: ZeRO-2
   per step (2 batches), then overlap in a window of 2: the reference's
   ``fit`` / ``epoch`` / ``step`` / ``window`` / ``dispatch`` spans,
   ``train.iterations`` 4, ``train.windows`` 1 and
   ``parallel.collective_launches`` the buckets' and gathers' count, the
   ``parallel.*`` and ``zero.*`` gauges; ``ZeroUpdateEngine.profile`` and
   ``profile_schedule`` (their ms printed: the logical mesh's adds and
   views, not a wire). ``ElasticTrainer`` (``_TLM``'s width, 2 of its
   blocks) with a kill at step 3: ``elastic.recoveries`` 1 and the
   ``fault_killworker`` and ``elastic_recovery`` dumps in the phase's
   directory. A ring step (phase 5's shape, f32, forward and backward)
   and a compressed step (phase 5's) under the cost count: counted flops
   over 12·D a visible pair, and over 6·N·B·T plus attention; K9's counted
   bytes (the compressed step's kernel bytes less the plain step's) equal
   9 an element a worker. The plain sync step with the registry on and
   off, alternated in 3 cycles after a warm one (reported, not gated).
   (b) Two replica processes of ``transformer_lm`` at ``_TLM``'s width and
   12 blocks (f32, prefill batch 1, rungs 256 and 512, 4 decode slots) on
   the card behind an affinity ``FleetRouter``, a ``FleetCollector`` and
   ``FleetHTTPServer``; the second starts once the first has built K1
   into their shared kernel-library directory and must report no build.
   8 streamed greedy requests at once, each traced, must equal an
   in-process ``GenerationEngine``'s tokens from the same seed; each
   replica's served prefill programs must carry K1's counted flops, and
   each replica's own K1 count (its ``/health`` ``kernel_launches``,
   read before the requests and after the TTFT ones) must rise; that
   difference is K1's ``fleet_replicas`` launches. TTFT p50 through the
   door beside the direct call's (8 fresh prompts each).
   A kill before the first token replays on the survivor with equal
   tokens; a kill at the first token of a long stream closes it with
   ``replica_lost``; with both dead, the collector stitches a dead
   replica's request from its spool into one trace with the front door's
   events. Every figure printed with the card's name and power limit.
22. The kernel registry and the training UI (last). (a) The registry's
   names are the reference's five, ``active_impl`` is ``fused`` on the
   card and ``fallback`` on the CPU for each, every parity pin run on the
   card holds its tolerance (2e-5, 1e-5, bitwise, bitwise, 1e-5); each
   kernel's device time (profiler; CUDA events where a session records
   none) at one full-width shape the repository runs (K1 phase 3's B 1
   H 16 T 1024 D 64 f32 causal, K5 the char-RNN's T 64 B 32 H 512, K9
   ``_TLM``'s parameter count, K8 the int8 net's first product at M 256,
   K7 GoogLeNet's first 1x1 conv at B 32) goes through
   ``record_kernel_timing``, whose roofline figures are printed beside
   this script's bound for the same shape; a perf dump must render in
   ``tools/kernels_report.py`` with five ``fused`` rows and five roofline
   lines. (b) The char-RNN (vocab 87, 2 x GravesLSTM(512), tBPTT 64, B 32)
   with a ``StatsListener`` reporting every iteration (histograms,
   updates, activations of a 1-sequence sample, memory): a 2-iteration
   check whose last record must equal numpy's statistics of host copies
   of the same parameters (1e-5 of the leaf's scale, histograms exact)
   with one host read a report; then 3 interleaved rounds of 8 iterations
   each with the listener (into a JSON-lines and a SQLite storage), with
   the same listener into memory (the storages' share) and without, each
   step's time to its end. Two greedy requests to the
   trained net through a ``GenerationEngine``, its metrics published into
   the storage. Phase 12c's GoogLeNet transfer network, 4 steps at B 8
   with a ``ConvolutionalIterationListener`` at frequency 2 on one image
   (K7 37 launches a step and a listener forward). The telemetry registry
   published into the storage; both files read back with equal record
   counts. A ``TrainingUIServer`` over the SQLite file serves three pages
   (HTTP 200, the kernel table's five ``fused`` rows with (a)'s ratios,
   no "vs baseline" row, the warm-runs headline, the activation grids)
   and takes one ``POST /collect``; each page's bytes and ms printed.
23. The NLP library (``nlp/``; it runs none of the nine kernels). (a) The
   bulk skip-gram NS step at ``bench.py``'s word2vec width (V 100,000, D
   128, B 4096, 5 negatives, lr 0.025; syn0 N(0, 1) x 0.01, syn1 zeros):
   two steps on the card against the same steps on the CPU with the same
   negatives, both tables within rel-to-max 1e-5 (the card adds
   colliding rows by atomics, in no fixed order); ``bench.py``'s two
   quality gates after 200 steps of ``make_neg_sampling_step`` (probe
   loss down by 0.1, trained pairs' cosine 0.1 over random pairs'); wall
   and device ms a step, kernels a step, words/s and peak memory at V
   100,000 and V 1,000,000. (b) ``Word2Vec.fit`` on a generated topical
   corpus (13,000 sentences, ~195 k tokens, 20 topics of 150 words and
   200 fillers; layer 100, window 5): skip-gram NS, skip-gram HS and
   CBOW NS, each on the card and on the CPU from the same seed (the same
   pairs and negatives): syn0 and the output table within rel-to-max 1e-4
   after the whole fit, or syn0 within 1e-5 after the third flush if the
   whole fit drifts further (both printed); the within-topic cosine 0.1
   over the across-topic one; no host read between the first flush and
   the last (``HostSyncDetector(sync_debug=True)``); words/s, the host's
   shares (pair generation, flushes) and, for skip-gram NS, the
   profiler's device time of a second fit and that fit's distance to the
   first; whether HS at the default batch of 8,192 stays finite
   (reported). (c) ``ParagraphVectors``
   (PV-DBOW, PV-DM, PV-DBOW with HS, ``infer_vector``) on 300 generated
   documents, ``Glove`` on 2,000 sentences and ``DistributedWord2Vec`` on
   a 4-worker logical mesh (its step against the single step at atol
   2e-6 and B 8190, which 4 does not divide; a fit on (b)'s corpus with
   the topic gate), each card fit against the CPU's as in (b) (the word
   phase's third flush where the whole fit drifts); ``infer_vector`` on
   the card against the CPU's on the same tables at rel-to-max 1e-5.
   Hierarchical softmax steps 1,024 pairs at a time in (b) and (c): at
   the default 8,192 every pair's update of the tree's root row lands in
   one step and the fit diverges to NaN on this corpus. (d) The (b) skip-gram model written with
   ``write_word_vectors`` and ``write_binary_word_vectors`` and read
   back: within the text's 6 decimals, bitwise from the binary file.
24. Graphs, clustering, the data side and the pretrained models (phase
   24; K5 in (e), no other kernel of ours). (a) A planted partition with
   BlogCatalog's counts (10,312 vertices, 333,983 edges, 39 groups, 80 %
   of the edges inside a group): ``DeepWalk`` at the paper's widths
   (vector 128, window 10, walks of 40; 2 walks a vertex where the paper
   takes 80) and ``Node2Vec`` (p = q = 0.25, one walk a vertex), each
   fitted on the card from the graph: walk generation seconds, words/s,
   host reads from the first flush to the last (none;
   ``HostSyncDetector(sync_debug=True)``), flushes 100-150 under the
   profiler (the device's busy share); the same walks on the CPU to the
   third flush, syn0 within rel-to-max 1e-5 of the card's (the whole fit
   is chaotic at batch 8,192, and the CPU's takes minutes: not run); the
   within-group cosine 0.1 over the across-group one; a softmax
   ``ml.NeuralNetClassifier`` over the vectors, trained on the card on
   half the vertices, 0.5 or better on the other half (chance 1/39).
   Where the default hierarchical softmax leaves a non-finite table the
   gates run on the reference's negative sampling (reported). (b)
   ``Tsne`` with the reference's defaults (500 steps, perplexity 30) on
   3,000 points of 50 dimensions from 10 Gaussians: host P seconds; 10
   steps on the card and on the CPU from the same P and Y, within
   rel-to-max 1e-5 after the tenth; the whole fit's seconds, a step's
   device time, and the reference test's gate (clusters 3x further apart
   than their spread). (c)
   ``KMeansClustering`` (k 100) from the reference's seeded init on
   100,000 points of 128 dimensions around 100 seeded centres, as drawn:
   the whole fit on the card and on the CPU over the first 10,000 rows
   (each of the first 3 steps and the end: labels equal, centroids within
   rel-to-max 1e-5, the same iterations and purity); the fit of all the
   points on the card counted (iterations, one host read each, peak
   memory, an iteration's device time; its purity reported: a random
   init that puts two centroids in one cluster stays split). (d)
   60,000 + 1,000 MNIST-shaped images from ``_synthetic_mnist`` written
   as IDX files, read by ``load_mnist`` (no download) into
   ``MnistDataSetIterator``, exported as shards of 16 batches of 64,
   read by ``make_shard_iterator`` (the C++ reader, 4 threads; both
   native libraries must build) and by numpy's reader, a pass each (MB/s;
   the batches bitwise equal); one LeNet step (Sgd) card vs CPU (loss rel
   1e-5, parameters rel-to-max 1e-4); one LeNet epoch on the card from
   the shards as 4 fits over the shard files' interleaved partitions,
   after each of the first two a second LeNet fitting the same batches
   from memory (images/s, the prefetcher's wait); the C++ threshold codec
   bitwise ``ops/compression.py`` ``threshold_encode`` on the card at
   25 M f32 (K9's launches counted).
   (e) ``init_pretrained`` of ``tests/fixtures/pretrained_textgen_small.zip``
   into ``text_generation_lstm`` on the card: its output within atol 1e-5
   of the fixture's, K5 counted; ``digits_cnn(pretrained=True)``: the
   checksum pinned, 0.95 or better on the 400 held-out scans
   (``tests/fixtures/digits_heldout_400.npz``).
25. Report: JSON lines of per-shape kernel times, the serving and training
   metrics and the kernels, then last ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import base64
import contextlib
import gzip
import importlib
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch import clustering as tcl
from deeplearning4j_tpu_torch import graphs as tgraphs
from deeplearning4j_tpu_torch.graphs import deepwalk as tdw
from deeplearning4j_tpu_torch.graphs import node2vec as tn2v
from deeplearning4j_tpu_torch import ml as tml
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.clustering import kmeans as tkmeans
from deeplearning4j_tpu_torch.clustering import tsne as ttsne
from deeplearning4j_tpu_torch.datasets import export as texport
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
    InMemoryModelSaver, MaxEpochsTerminationCondition,
    ScoreImprovementEpochTerminationCondition)
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_opt_state,
                                                         load_jax_params)
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate,
                                                    naive_generate_lstm,
                                                    truncated_draft)
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.models import pretrained as tpre
from deeplearning4j_tpu_torch.models.zoo import resnet50
from deeplearning4j_tpu_torch.models.zoo_extra import (googlenet,
                                                       text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph.vertices import (
    DuplicateToTimeSeriesVertex, LastTimeStepVertex)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM, BernoulliReconstructionDistribution, ConvolutionLayer, DenseLayer,
    EmbeddingLayer, GravesLSTM, OutputLayer, RnnOutputLayer,
    VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.preprocessors import (
    FeedForwardToRnnPreProcessor, RnnToFeedForwardPreProcessor)
from deeplearning4j_tpu_torch.nn.tape import collect_state
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.nlp import distributed_w2v as tdist
from deeplearning4j_tpu_torch.nlp import sequence_vectors as sv
from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                  TransferLearningGraph)
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import lstm, nvcc
from deeplearning4j_tpu_torch.ops.compression import threshold_encode
from deeplearning4j_tpu_torch.ops.kernels import conv as k7
from deeplearning4j_tpu_torch.ops.kernels import quantized as k8
from deeplearning4j_tpu_torch.optimize.listeners import PerformanceListener
from deeplearning4j_tpu_torch.optimize.updaters import Adam, RmsProp, Sgd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel.accumulation import EncodedAccumulator
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    full, held_specs, host_gather, per_replica_bytes, tree_specs)
from deeplearning4j_tpu_torch.parallel.ring_attention import \
    ring_attention_sharded
from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                              ServingHTTPServer)
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
from deeplearning4j_tpu_torch.telemetry import configure_flight_recorder
from deeplearning4j_tpu_torch.util.checkpointing import (
    CheckpointListener, ProfilerListener, fit_with_checkpointing,
    latest_checkpoint, read_checkpoint_manifest)
from deeplearning4j_tpu_torch.util.gradcheck import check_gradients
from deeplearning4j_tpu_torch.util.httpjson import HTTPClient
from deeplearning4j_tpu_torch.util.serialization import (restore_model,
                                                         write_model)

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


_T0 = time.perf_counter()


def log(*a):
    """A progress line on stderr, stamped with the seconds since the
    script started (the phases' timeline)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, file=sys.stderr,
          flush=True)


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


def _behind_sleep(enqueue, cycles=SLEEP_CYCLES, tries=3):
    """Run ``enqueue(record)`` while a sleep kernel of ``cycles`` holds the
    current stream; ``record()`` records and returns a timing event.
    Returns (the host's ms for the enqueue, the sleep's cycles in the try
    that gave it). When the card woke before the host was done (the events
    would then time the host: a slow host, or a one-time initialisation
    inside the enqueue) it tries again with twice the sleep, ``tries``
    times in all, then raises."""
    for attempt in range(tries):
        torch.cuda.synchronize()
        start, woke = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        torch.cuda._sleep(cycles << attempt)
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
        if slept > host_ms:
            return host_ms, cycles << attempt
        log(f"the sleep kernel ({slept:.1f} ms) ended before the host had "
            f"enqueued ({host_ms:.1f} ms); again with twice the sleep")
    raise RuntimeError(f"the sleep kernel ({slept:.1f} ms) ended before "
                       f"the host had enqueued ({host_ms:.1f} ms), "
                       f"{tries} times")


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


def _rel_to_max_f64(got, want) -> float:
    """``_rel_to_max`` in float64, for the float64 runs' pins."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-300)).item()


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


# ----------------------------------------------------------------- phase 4b
WINDOW_BATCHES, WINDOW_K = 16, 8     # bench.py's fit(steps_per_dispatch=8)
CHAR_GRAPH_FITS, CHAR_STREAM_B = 6, 8


class _WindowClock:
    """A score callback: keeps each step's loss (a device tensor) and, at
    the end of every k-th iteration, waits for the card and notes the
    time."""

    def __init__(self, k):
        self.k, self.losses, self.t = k, [], []

    def iteration_done(self, net, iteration, loss):
        self.losses.append(loss)
        if (iteration + 1) % self.k == 0:
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())


def _tlm_window_batches():
    """16 seeded batches of B 8 token sequences with bench.py's labels (the
    one-hot of each sequence rolled by one step, f32: 134 MB a batch)."""
    V, T = TLM["vocab_size"], TLM["max_length"]
    rng = np.random.default_rng(SEED + 40)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(WINDOW_BATCHES):
        ids = rng.integers(0, V, (TRAIN_B, T))
        out.append(DataSet(ids, eye[np.roll(ids, 1, axis=1)]))
    return out


def _tlm_amp(remat=False, **kw):
    """``_TLM`` with float32 master weights and bfloat16 compute, set on the
    built configuration as a JSON configuration carries it."""
    net = transformer_lm(**TLM, token_input=True, dtype="float32",
                         updater=Adam(3e-4), **kw)
    net.conf.compute_dtype = "bfloat16"
    net.conf.gradient_checkpointing = remat
    return net


def _graph_counts(net):
    """The solver's window graphs: captures, replays and each kernel's
    launches made by replays (zeros before the first fit)."""
    solver = getattr(net, "_solver_inst", None)
    if solver is None:
        return {"captures": 0, "replays": 0, "launches_in_replays": {}}
    return solver.graph_stats()


def _counted_run(net, fit, counted):
    """``fit()`` with every count set to 0 just before it and read just
    after: each counted kernel's eager launches plus its launches in the
    window graphs' replays of this run."""
    g0 = _graph_counts(net)
    torch.cuda.synchronize()
    _reset_launches()
    fit()
    torch.cuda.synchronize()
    eager = _launches(counted)
    g1 = _graph_counts(net)
    replayed = {n: g1["launches_in_replays"].get(n, 0)
                - g0["launches_in_replays"].get(n, 0) for n in counted}
    return ({n: eager[n] + replayed[n] for n in counted},
            {"eager": eager, "in_replays": replayed,
             "captures": g1["captures"] - g0["captures"],
             "replays": g1["replays"] - g0["replays"]})


def _tlm_train_run(net, batches, what, **fit_kw):
    """One fit of ``net`` over the 16 batches, counted and timed a window
    (k steps) at a time; its losses as floats."""
    clock = _WindowClock(WINDOW_K)
    net.set_listeners(clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    launches, detail = _counted_run(
        net, lambda: net.fit(iterator=ListDataSetIterator(batches),
                             **fit_kw), COUNTED)
    peak = torch.cuda.max_memory_allocated()
    stamps = [t0] + clock.t
    window_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    losses = [float(v) for v in clock.losses]
    if len(losses) != WINDOW_BATCHES or not all(math.isfinite(v)
                                               for v in losses):
        raise AssertionError(f"{what}: losses are not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    step_ms = float(np.median(window_ms[1:])) / WINDOW_K
    pre = net._solver_inst.prefetcher
    T = TLM["max_length"]
    return {"run": what, "fit": {k: v for k, v in fit_kw.items()},
            "losses": losses, "window_ms": window_ms,
            "step_ms_p50_after_first_window": step_ms,
            "tokens_per_sec": TRAIN_B * T / (step_ms / 1e3),
            "max_memory_allocated_bytes": peak,
            "peak_above_start_bytes": peak - base,
            "prefetch_wait_ms": (None if pre is None
                                 else pre.total_wait_ms),
            "launches": launches, "launches_detail": detail}


def _params_vs(a, b):
    """(bitwise, worst rel-to-max over the parameters, its name) of two
    networks of one architecture."""
    pa = dict(a.named_parameters())
    worst, name, same = 0.0, None, True
    for n, p in b.named_parameters():
        same = same and torch.equal(p, pa[n])
        r = _rel_to_max(pa[n].float(), p.float())
        if r >= worst:
            worst, name = r, n
    return same, worst, name


def _window_device_ms(net, batches, k1=1, tries=3, **fit_kw):
    """The profiler's device time a step over one more fit of k batches
    (kernel times summed, divided by k). The profile must show K1, K2 and
    K3 ``n_blocks`` times a step each (K1 ``k1`` times that): in a window
    fit they all come from graph replays. The profiler loses a few records
    a session (``_replay_kernels``), so up to ``tries`` sessions are
    taken; none may show more."""
    blocks = TLM["n_blocks"] * WINDOW_K
    want = {"flash_fwd_bf16": k1 * blocks, "flash_dq_bf16": blocks,
            "flash_dkv_bf16": blocks}
    seen = []
    for _ in range(tries):
        prof = _device_kernels(lambda: net.fit(
            iterator=ListDataSetIterator(batches[:WINDOW_K]), **fit_kw),
            top=1000)
        got = {n: sum(r["calls"] for r in prof["top"]
                      if f"::{n}<" in r["kernel"]) for n in want}
        seen.append(got)
        if any(got[n] > want[n] for n in want):
            break
        if got == want:
            break
    if seen[-1] != want:
        raise AssertionError(f"the profiled fit of {WINDOW_K} batches "
                             f"showed {seen}, not {want}")
    return {"device_ms_per_step": prof["device_ms"] / WINDOW_K,
            "wall_ms_per_step": prof["wall_ms"] / WINDOW_K,
            "kernels_per_step": sum(r["calls"] for r in prof["top"])
            / WINDOW_K,
            "flash_kernels_seen": got, "profile_sessions": len(seen),
            "top_kernels_ms_per_step": [
                {"kernel": r["kernel"], "calls": r["calls"] / WINDOW_K,
                 "ms": r["ms"] / WINDOW_K} for r in prof["top"][:12]]}


def train_window_phase():
    """``_TLM`` with f32 master weights and bf16 compute, Adam(3e-4): 16
    seeded batches through ``net.fit`` per step with no prefetch, per step
    with the default prefetch, with ``steps_per_dispatch=8`` and the
    default prefetch (the window as a CUDA graph), then the window again
    with gradient checkpointing. All end with the per-step run's
    parameters; K1-K3 are counted with the graphs' replays."""
    batches = _tlm_window_batches()
    runs, nets = {}, {}
    for what, remat, kw in (("per_step", False,
                             dict(async_prefetch=False)),
                            ("per_step_prefetch", False, {}),
                            ("window", False,
                             dict(steps_per_dispatch=WINDOW_K)),
                            ("window_remat", True,
                             dict(steps_per_dispatch=WINDOW_K))):
        net = _tlm_amp(remat).init(seed=SEED + 41)
        runs[what] = _tlm_train_run(net, batches, what, **kw)
        runs[what]["graph"] = _graph_counts(net)
        nets[what] = net
    blocks = TLM["n_blocks"]
    for what, k1 in (("per_step", 1), ("per_step_prefetch", 1), ("window", 1),
                     ("window_remat", 2)):
        want = {"flash_attention_fwd": k1 * blocks * WINDOW_BATCHES,
                "flash_attention_bwd_dq": blocks * WINDOW_BATCHES,
                "flash_attention_bwd_dkv": blocks * WINDOW_BATCHES}
        if runs[what]["launches"] != want:
            raise AssertionError(f"{what} launched {runs[what]['launches']},"
                                 f" not {want}")
    for what in ("window", "window_remat"):
        g = runs[what]["launches_detail"]
        if (g["captures"], g["replays"]) != (1, WINDOW_BATCHES - 1):
            raise AssertionError(f"{what}: {g['captures']} captures and "
                                 f"{g['replays']} replays, not 1 and "
                                 f"{WINDOW_BATCHES - 1}")
    same = {}
    for what in ("per_step_prefetch", "window", "window_remat"):
        bitwise, rel, name = _params_vs(nets["per_step"], nets[what])
        same[what] = {"bitwise": bitwise, "param_rel_to_max": rel,
                      "worst_param": name}
        if not (bitwise or rel <= 1e-5):
            raise AssertionError(f"{what}: parameter {name} after "
                                 f"{WINDOW_BATCHES} steps differs from the "
                                 f"per-step run's: rel-to-max {rel:.3g}")
    for what, k1, kw in (("per_step", 1, dict(async_prefetch=False)),
                         ("per_step_prefetch", 1, {}),
                         ("window", 1, dict(steps_per_dispatch=WINDOW_K)),
                         ("window_remat", 2,
                          dict(steps_per_dispatch=WINDOW_K))):
        g0 = _graph_counts(nets[what])
        runs[what]["profiled"] = _window_device_ms(nets[what], batches, k1,
                                                   **kw)
        g1 = _graph_counts(nets[what])
        if what.startswith("window") and (
                g1["captures"] != g0["captures"]
                or g1["replays"] - g0["replays"]
                != WINDOW_K * runs[what]["profiled"]["profile_sessions"]):
            raise AssertionError(f"{what}: the profiled fits were not all "
                                 f"replays: {g0} -> {g1}")
    nets.clear()
    torch.cuda.empty_cache()
    return {"model": "transformer_lm _TLM f32 master, bf16 compute, "
                     "Adam(3e-4)", "batch": TRAIN_B,
            "seq_len": TLM["max_length"], "steps": WINDOW_BATCHES,
            "k": WINDOW_K, "runs": runs, "vs_per_step": same}


def _amp_readings(seed, truth=False):
    """One bf16-compute step's loss and gradients (f32 master) of a 2-block
    model at d_model 512, T 1024, B 2, on the card and on the CPU, from
    the same weights (``seed``): the loss rel and the worst gradient
    rel-to-max between them. ``truth``: also the CPU's float32 step, and
    each bf16 step's worst gradient rel-to-max from it, overall and on
    the tensor where card and CPU differ most."""
    cfg = dict(TLM, n_blocks=2)
    V, T = cfg["vocab_size"], cfg["max_length"]
    gpu = transformer_lm(**cfg, token_input=True).init(seed=seed)
    cpu = transformer_lm(**cfg, token_input=True, device="cpu").init()
    for n in (gpu, cpu):
        n.conf.compute_dtype = "bfloat16"
    load_jax_params(cpu, [{k: v.detach().cpu().numpy()
                           for k, v in gpu.vertices[n].param_dict().items()}
                          for n in gpu.vertex_names])
    ids = np.random.default_rng(seed + 1).integers(0, V, (2, T))

    def loss_and_grads(net):
        x = torch.as_tensor(ids, device=net.device)
        loss = net.loss_fn(x, _one_hot_prev(x, V, torch.float32))
        named = [(f"{n}.{k}", p) for n, pd in net.param_dicts().items()
                 for k, p in pd.items()]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        if any(g.dtype != torch.float32 for g in grads):
            raise AssertionError("a master gradient is not float32")
        return loss.item(), {name: g.cpu()
                             for (name, _), g in zip(named, grads)}

    def worst(a, b):
        name = max(a, key=lambda n: _rel_to_max(a[n], b[n]))
        return _rel_to_max(a[name], b[name]), name

    _reset_launches()
    l_gpu, g_gpu = loss_and_grads(gpu)
    launches = _launches()
    l_cpu, g_cpu = loss_and_grads(cpu)
    grad_rel, name = worst(g_gpu, g_cpu)
    row = {"seed": seed, "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
           "grad_rel_to_max": grad_rel, "worst_grad": name,
           "launches": launches}
    if truth:
        cpu.conf.compute_dtype = None
        _, g_f32 = loss_and_grads(cpu)
        row["card_bf16_vs_cpu_f32"] = worst(g_gpu, g_f32)
        row["cpu_bf16_vs_cpu_f32"] = worst(g_cpu, g_f32)
        row["on_worst_grad"] = {
            "card_bf16_vs_cpu_f32": _rel_to_max(g_gpu[name], g_f32[name]),
            "cpu_bf16_vs_cpu_f32": _rel_to_max(g_cpu[name], g_f32[name])}
    return row


def amp_cross_device_phase():
    """``_amp_readings`` on the phase's seed: loss rel 2e-2, gradients
    rel-to-max 2e-2 (bf16), K1-K3 launched once a block."""
    row = _amp_readings(SEED + 42)
    if row["launches"] != {name: 2 for name in COUNTED}:
        raise AssertionError(f"bf16-compute step launched {row['launches']}")
    if row["loss_rel"] > TOL[torch.bfloat16] \
            or row["grad_rel_to_max"] > BWD_TOL[torch.bfloat16]:
        raise AssertionError(f"bf16 compute on the card vs the CPU: loss "
                             f"rel {row['loss_rel']:.3g}, gradient "
                             f"{row['worst_grad']} rel-to-max "
                             f"{row['grad_rel_to_max']:.3g}")
    return row


def amp_seed_study(n: int):
    """``_amp_readings`` with the f32 step on ``n`` weight and input seeds,
    the first the phase's own; yields each row as it is read."""
    for i in range(n):
        yield _amp_readings(SEED + 42 + 2 * i, truth=True)


def char_graph(seed, device=None):
    """The char-RNN's layers (bench.py ``bench_lstm``'s width) as a
    ``ComputationGraph``: two GravesLSTM(512) and a softmax head, l2 1e-3,
    RmsProp(1e-3), tBPTT 50."""
    V, H, T = CHAR["vocab_size"], CHAR["hidden"], CHAR["max_length"]
    g = (NeuralNetConfiguration(seed=seed, updater=RmsProp(1e-3), l2=1e-3,
                                weight_init="xavier")
         .graph_builder().add_inputs("chars")
         .add_layer("lstm1", GravesLSTM(n_out=H, activation="tanh"), "chars")
         .add_layer("lstm2", GravesLSTM(n_out=H, activation="tanh"), "lstm1")
         .add_layer("out", RnnOutputLayer(n_out=V, activation="softmax",
                                          loss="mcxent"), "lstm2")
         .set_outputs("out").set_input_types(InputType.recurrent(V, T))
         .tbptt_length(50))
    return ComputationGraph(g.build(), device=device)


def char_graph_phase():
    """The char-RNN graph: 6 tBPTT fits of B 32 (K5 and K6 2 layers x 2
    chunks a fit), one fit on the card against the CPU from the same
    weights and RmsProp state, then ``rnn_time_step`` over 64 steps at B 8
    against ``output`` on the whole sequence (K5's pin, 1e-5)."""
    net = char_graph(SEED + 50).init()
    x_np, y_np = _char_batch(SEED + 51, CHAR_B, CHAR_T)
    x = torch.as_tensor(x_np, device=net.device)
    y = torch.as_tensor(y_np, device=net.device)
    rec = _Losses()
    net.set_listeners(rec)
    step_ms = []
    _reset_launches()
    for _ in range(CHAR_GRAPH_FITS):
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=CHAR_B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launches(LSTM_COUNTED)
    want = 2 * 2 * CHAR_GRAPH_FITS
    if launches != {name: want for name in LSTM_COUNTED}:
        raise AssertionError(f"graph tBPTT launched {launches}, not {want} "
                             f"of each")
    if net.iteration_count != 2 * CHAR_GRAPH_FITS:
        raise AssertionError(f"{net.iteration_count} tBPTT iterations")
    losses = [float(v) for v in rec.losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"graph tBPTT losses: {losses}")
    # one fit on the card against the CPU from the same weights and state
    cpu = char_graph(SEED + 50, device="cpu").init()
    load_jax_params(cpu, [{n: p.detach().cpu().numpy()
                           for n, p in pd.items()}
                          for pd in net.param_dicts().values()])
    load_jax_opt_state(cpu, [{n: {s: t.cpu().numpy() for s, t in st.items()}
                              for n, st in v.items()}
                             for v in net.opt_state.values()],
                       iteration_count=net.iteration_count)
    xb, yb = _char_batch(SEED + 52, CHAR_STREAM_B, CHAR_T)
    net.fit(xb, yb, batch_size=CHAR_STREAM_B)
    cpu.fit(xb, yb, batch_size=CHAR_STREAM_B)
    pairs = [(f"{v}.{n}", p.detach().cpu(), cpu.param_dicts()[v][n].detach())
             for v, pd in net.param_dicts().items() for n, p in pd.items()]
    worst = max(pairs, key=lambda t: _rel_to_max(t[1], t[2]))
    param_rel = _rel_to_max(worst[1], worst[2])
    if param_rel > 1e-4:
        raise AssertionError(f"graph tBPTT: parameter {worst[0]} after a fit "
                             f"differs from the CPU's: rel-to-max "
                             f"{param_rel:.3g}")
    # streaming: one step at a time equals the whole sequence
    xs = torch.as_tensor(xb, device=net.device)
    whole = net.output(xs)
    net.rnn_clear_previous_state()
    _reset_launches()
    steps = torch.stack([net.rnn_time_step(xs[:, t])
                         for t in range(CHAR_T)], dim=1)
    torch.cuda.synchronize()
    stream_launches = _launches(LSTM_COUNTED)["lstm_fwd"]
    stream_err = float((steps - whole).abs().max())
    if stream_launches != 2 * CHAR_T:
        raise AssertionError(f"rnn_time_step launched K5 {stream_launches} "
                             f"times, not {2 * CHAR_T}")
    if stream_err > LSTM_TOL[("fwd", torch.float32)]:
        raise AssertionError(f"graph rnn_time_step vs output: {stream_err}")
    p50 = float(np.median(step_ms[1:]))
    return {"model": "char-RNN layers as a ComputationGraph, vocab 87, 2 x "
                     "GravesLSTM(512), f32, RmsProp(1e-3), tBPTT 50",
            "batch": CHAR_B, "seq_len": CHAR_T, "fits": CHAR_GRAPH_FITS,
            "losses": losses, "step_ms": step_ms,
            "step_ms_p50_after_first": p50,
            "tokens_per_sec": CHAR_B * CHAR_T / (p50 / 1e3),
            "param_rel_to_max_vs_cpu": param_rel, "worst_param": worst[0],
            "rnn_time_step_max_abs_err": stream_err,
            "rnn_time_step_k5_launches": stream_launches,
            "launches": launches}


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


def _replay_kernels(rt, name, want, tries=8):
    """Two replays of the runtime's live decode graph under the profiler
    must show ``want`` kernels whose name holds ``name``. The profiler
    loses a few records a session (``_device_ms_per_call``): two whole
    runs lost one of the 4 K5 launches here in 5 sessions of 6 (PERF.md).
    So up to ``tries`` sessions are taken; none may show more. Where every
    session shows fewer (3 of 4 in all 8 in one whole run, while a fresh
    process records every launch), some session must still show all but
    one (the most a session was seen to lose), and the capture's own count
    of the kernel's launches (``DecodeGraph.launches``, what the graph
    holds) must give ``want`` for two replays (ROADMAP section C)."""
    g = rt.cohorts[-1].graph
    seen, tallies = [], []
    for _ in range(tries):
        prof = _device_kernels(lambda: (g.graph.replay(), g.graph.replay()),
                               top=1000)
        n = sum(r["calls"] for r in prof["top"] if name in r["kernel"])
        seen.append(n)
        tallies.append({r["kernel"][:60]: r["calls"] for r in prof["top"]})
        if n > want:
            break
        if n == want:
            return {"kernels": n, "sessions": seen, "counted_by": "profiler",
                    "device_ms_per_replay": prof["device_ms"] / 2,
                    "kernels_per_replay": sum(r["calls"]
                                              for r in prof["top"]) / 2}
    held = 2 * g.launches.get(name, 0)
    if want - 1 <= max(seen) < want and held == want:
        log(f"the profiler showed {seen} {name} kernels in two decode-graph "
            f"replays, not {want}; the capture holds {held // 2} a replay")
        return {"kernels": held, "sessions": seen, "counted_by": "capture",
                "kernels_per_replay": None, "device_ms_per_replay": None}
    raise AssertionError(f"two replays of the decode graph showed {seen} "
                         f"{name} kernels in the profiler, not {want}, and "
                         f"the capture holds {held // 2} a replay; the "
                         f"sessions' kernels: {json.dumps(tallies)}")


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


# the device times taken by CUDA events because no profiler session
# recorded the kernel (the profiler loses records late in a long run,
# PERF.md section 7); printed with the report
EVENT_TIMED = []


def _device_ms_per_call(fn, n=20, name=None, tries=3, per_call=1):
    """Device time of one call of ``fn`` (ms) from the profiler's kernel
    times over ``n`` calls. The profiler loses the records of a few
    launches a session (2 of 20 on an H100 under torch 2.11), so the sum is
    divided by the launches it did record: of the kernels whose name holds
    ``name`` (``per_call`` of them a call), or, with no name, of the most
    often recorded kernel (one launch of it a call). A session that records
    no such kernel is taken again, up to ``tries`` sessions; then the call
    is timed by CUDA events over ``n`` calls (``_event_ms_per_call``: from
    the first launch to the end of the last, gaps included) and noted in
    ``EVENT_TIMED``."""
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
    what = "a kernel" if name is None else name
    log(f"{tries} profiler sessions recorded no {what} in {n} calls; "
        f"timing it by CUDA events")
    EVENT_TIMED.append(what)
    return _event_ms_per_call(fn, n)


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
    kernels launched once a call (the profiler drops a few records); a
    call whose every kernel launches many times (cuDNN's LSTM at T 256,
    hundreds of launches a call) is the session over ``n``, the dropped
    records a negligible share of it."""
    rep = _device_kernels(lambda: [fn() for _ in range(n)], top=1000)
    once = [r["calls"] for r in rep["top"] if r["calls"] <= n]
    return rep["device_ms"] / (max(once) if once else n)


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
    "host_us" and "library_host_us", each beside the sleep's cycles in the
    try that gave it, "*_sleep_cycles"); then per forward at each bucket:
    the three products summed."""
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
                r[key] = r[key + "_sleep_cycles"] = None
                continue
            fn()
            host_ms, r[key + "_sleep_cycles"] = _behind_sleep(
                lambda record: [fn() for _ in range(300)])
            r[key] = host_ms / 300 * 1e3
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
        for k in ("host_us", "library_host_us"):
            t[k + "_per_call"] = [p[k] for p in prods]
            t[k + "_sleep_cycles"] = [p[k + "_sleep_cycles"] for p in prods]
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


# host time left idle at each end of a profiler session: the profiler
# keeps only the device records that fall inside its window on the host's
# clock, so work launched at its very start or ending at its very end can
# fall outside it when the device's clock and the host's disagree by a few
# microseconds
PROFILE_PAD_S = 0.01


def _device_kernels(fn, top=15):
    """One call of ``fn`` under ``torch.profiler``: the device time of each
    kernel (profiler entries with device time and no host time of their
    own), the top ``top`` by time, and their sum against the wall time.
    The call sits ``PROFILE_PAD_S`` inside each end of the session."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
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


# ----------------------------------------------------------------- phase 12b
# zoo.resnet50 at its full width: 224x224x3, 1000 classes, f32, Adam(1e-3)
RESNET = dict(n_classes=1000, height=224, width=224, channels=3)
RESNET_B, RESNET_BATCHES, RESNET_K, RESNET_EVAL = 32, 16, 8, 4
RESNET_BUCKETS, RESNET_SIZES = (1, 8, 32), (1, 3, 8, 13, 32)
# the card-vs-CPU step at a reduced size
RESNET_SMALL = dict(n_classes=10, height=64, width=64, channels=3)
RESNET_SMALL_B = 4


def _resnet_batches(n, seed, n_classes=None, size=None, b=None):
    """``n`` seeded batches of ``b`` NHWC images and one-hot labels
    (default: ResNet-50's full-width batch)."""
    n_classes = n_classes or RESNET["n_classes"]
    size, b = size or RESNET["height"], b or RESNET_B
    rng = np.random.default_rng(seed)
    eye = np.eye(n_classes, dtype=np.float32)
    return [DataSet(rng.standard_normal((b, size, size, 3),
                                        dtype=np.float32),
                    eye[rng.integers(0, n_classes, b)]) for _ in range(n)]


def _state_vs(a, b):
    """(bitwise, worst rel-to-max over the layer state, its name) of two
    networks of one architecture."""
    sa = {(g, k): t for g, sd in a.state_dicts().items()
          for k, t in sd.items()}
    worst, name, same = 0.0, None, True
    for g, sd in b.state_dicts().items():
        for k, t in sd.items():
            same = same and torch.equal(t, sa[(g, k)])
            r = _rel_to_max(sa[(g, k)], t)
            if r >= worst:
                worst, name = r, f"{g}.{k}"
    return same, worst, name


def _resnet_fit(batches, what, remat=False, **fit_kw):
    """A ResNet-50 from the phase's seed (with gradient checkpointing
    under ``remat``), fitted once over ``batches``, each step (per step)
    or window (in windows) timed to the card's end; returns (net, row)."""
    net = resnet50(**RESNET, updater=Adam(1e-3)).init(seed=SEED + 50)
    net.conf.gradient_checkpointing = remat
    k = fit_kw.get("steps_per_dispatch", 1)
    clock = _WindowClock(k)
    net.set_listeners(clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(iterator=ListDataSetIterator(batches), **fit_kw)
    peak = torch.cuda.max_memory_allocated()
    stamps = [t0] + clock.t
    ms = [(b - a) * 1e3 / k for a, b in zip(stamps, stamps[1:])]
    losses = [float(v) for v in clock.losses]
    if len(losses) != len(batches) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"resnet50 {what}: losses {losses}")
    net.set_listeners()
    return net, {"run": what, "losses": losses, "step_ms": ms,
                 "step_ms_p50_after_first": float(np.median(ms[1:])),
                 "images_per_s": RESNET_B / (float(np.median(ms[1:])) / 1e3),
                 "max_memory_allocated_bytes": peak,
                 "graph": _graph_counts(net)}


def _step_readings(net, x, y):
    """A training forward and backward of ``net`` on (x, y), nothing
    written: the loss, every parameter's gradient and the new layer
    state, as CPU float64 tensors by name."""
    with collect_state({}) as sink:
        loss = net.loss_fn(net._as_input(x), net._as_input(y), train=True)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in net.named_parameters()])
    by_layer = {id(layer): name for name, v in net.vertices.items()
                for layer in [getattr(v, "layer", None)] if layer is not None}
    state = {f"{by_layer[id(layer)]}.{k}": t.detach().double().cpu()
             for layer, st in sink.items() for k, t in st.items()}
    return (float(loss.detach()),
            {n: g.double().cpu() for n, g in zip(names, grads)},
            state)


def _readings_vs(a, b):
    """(loss rel, worst gradient rel-to-max and its name, worst state
    rel-to-max and its name) between two ``_step_readings``."""
    (la, ga, sa), (lb, gb, sb) = a, b
    g = max((_rel_to_max(ga[n], gb[n]), n) for n in gb)
    s = max((_rel_to_max(sa[n], sb[n]), n) for n in sb)
    return {"loss_rel": abs(la - lb) / abs(lb), "grad_rel_to_max": g[0],
            "worst_grad": g[1], "state_rel_to_max": s[0],
            "worst_state": s[1]}


def _resnet_cross_device():
    """One training step of ``resnet50`` at 64x64, 10 classes, B 4 on the
    card and on the CPU from the same weights. Gated in float64 (loss rel
    1e-5, every gradient and new running statistic rel-to-max 1e-4). In
    float32 the readings are reported beside the CPU's float32-vs-float64
    distance: a random-init ResNet-50's gradients grow toward the stem
    through 53 BatchNorms whose var = E[x²] - E[x]² cancels, so float32
    carries only ~1e-2 of them (both devices alike), and the max pool's
    near-ties (gaps below float32 noise) route a gradient differently on
    either."""
    x, y = (lambda ds: (ds.features, ds.labels))(_resnet_batches(
        1, SEED + 53, RESNET_SMALL["n_classes"], RESNET_SMALL["height"],
        RESNET_SMALL_B)[0])
    out = {}
    for dtype in ("float64", "float32"):
        card = resnet50(**RESNET_SMALL, dtype=dtype,
                        updater=Sgd(0.1)).init(seed=SEED + 54)
        cpu = resnet50(**RESNET_SMALL, dtype=dtype, updater=Sgd(0.1),
                       device="cpu").init(seed=SEED + 54)
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        out[dtype] = (_step_readings(card, x, y), _step_readings(cpu, x, y))
        del card, cpu
    row = {d: _readings_vs(*out[d]) for d in out}
    row["float32_cpu_vs_float64_cpu"] = _readings_vs(out["float32"][1],
                                                     out["float64"][1])
    r = row["float64"]
    if not (r["loss_rel"] <= 1e-5 and r["grad_rel_to_max"] <= 1e-4
            and r["state_rel_to_max"] <= 1e-4):
        raise AssertionError(f"resnet50 float64 step, card vs CPU: {r}")
    if not all(math.isfinite(v) for v in row["float32"].values()
               if isinstance(v, float)):
        raise AssertionError(f"resnet50 float32 step: {row['float32']}")
    return row


def resnet_phase():
    """ResNet-50 at full width: 16 seeded batches of B 32 through ``fit``
    per step twice and in windows of 8 (a CUDA graph of the step) from
    the same start, with cuDNN's deterministic algorithms for the check;
    ``evaluate`` on 4 held-out batches against numpy; a zip round trip;
    the forward ``InferenceEngine``; the card-vs-CPU step. Returns the row
    and the per-step and window networks (phase 19 profiles them)."""
    batches = _resnet_batches(RESNET_BATCHES + RESNET_EVAL, SEED + 51)
    train, held = batches[:RESNET_BATCHES], batches[RESNET_BATCHES:]
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        a, run_a = _resnet_fit(train, "per_step", async_prefetch=False)
        a2, run_a2 = _resnet_fit(train, "per_step_again",
                                 async_prefetch=False)
        w, run_w = _resnet_fit(train, "window", steps_per_dispatch=RESNET_K)
        wr, run_wr = _resnet_fit(train, "window_remat", remat=True,
                                 steps_per_dispatch=RESNET_K)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    for r in (run_w, run_wr):
        g = r["graph"]
        if (g["captures"], g["replays"]) != (1, RESNET_BATCHES - 1):
            raise AssertionError(f"resnet50 {r['run']}: {g['captures']} "
                                 f"captures and {g['replays']} replays, not "
                                 f"1 and {RESNET_BATCHES - 1}")
    vs = {}
    for what, other in (("per_step_again", a2), ("window", w),
                        ("window_remat", wr)):
        pb, pr, pn = _params_vs(a, other)
        sb, sr, sn = _state_vs(a, other)
        vs[what] = {"params_bitwise": pb, "param_rel_to_max": pr,
                    "worst_param": pn, "state_bitwise": sb,
                    "state_rel_to_max": sr, "worst_state": sn}
    run_to_run = vs["per_step_again"]
    for what in ("window", "window_remat"):
        win = vs[what]
        if run_to_run["params_bitwise"] and run_to_run["state_bitwise"]:
            if not (win["params_bitwise"] and win["state_bitwise"]):
                raise AssertionError(f"resnet50 {what} of {RESNET_K} is not "
                                     f"bitwise the per-step fit: {win}")
        elif max(win["param_rel_to_max"], win["state_rel_to_max"]) > 1e-6:
            raise AssertionError(f"resnet50 {what} vs per step {win} (two "
                                 f"per-step runs: {run_to_run})")
    del a2, wr
    # evaluate: its confusion matrix against numpy's of output(train=False)
    ev = w.evaluate(ListDataSetIterator(held))
    want = np.zeros((RESNET["n_classes"],) * 2, np.int64)
    for ds in held:
        out = w.output(ds.features).float().cpu().numpy()
        np.add.at(want, (ds.labels.argmax(1), out.argmax(1)), 1)
    if not np.array_equal(ev.confusion, want) or \
            ev.confusion.sum() != RESNET_EVAL * RESNET_B:
        raise AssertionError("resnet50 evaluate's confusion matrix differs "
                             "from numpy's")
    x = held[0].features
    # the zip: state.bin holds every running mean and variance
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "resnet50.zip")
        back, zrow = _zip_round_trip(w, path, "resnet50")
        with zipfile.ZipFile(path) as z:
            n_state = len(z.read("state.bin")) // 4
        want_state = sum(t.numel() for sd in w.state_dicts().values()
                         for t in sd.values())
        if n_state != want_state or n_state == 0:
            raise AssertionError(f"resnet50 zip: state.bin holds {n_state} "
                                 f"values, the network {want_state}")
        if not torch.equal(back.output(x), w.output(x)):
            raise AssertionError("resnet50 restored from its zip answers "
                                 "otherwise")
        zrow["state_values"] = n_state
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # served by the forward engine
    fwd = lambda n, xx: n._output_pure(xx)[0]     # the graph's one output
    t0 = time.perf_counter()
    eng = InferenceEngine(w, feature_shape=(RESNET["height"],
                                            RESNET["width"],
                                            RESNET["channels"]),
                          buckets=RESNET_BUCKETS, forward_fn=fwd)
    warm_s = time.perf_counter() - t0
    pool = np.concatenate([ds.features for ds in held])
    try:
        lat, wall = _serve_closed_loop(eng, pool, RESNET_SIZES, 4, 4)
        snap = eng.metrics()["default"]
        got = eng.predict(pool[:5])
    finally:
        eng.stop()
    serve_err = float((torch.as_tensor(got) - w.output(pool[:5]).cpu())
                      .abs().max())
    if serve_err > 1e-5:
        raise AssertionError(f"resnet50 served response vs net.output: "
                             f"{serve_err:.3g}")
    serve = _latency_stats(lat, wall, sum(
        RESNET_SIZES[(c + i) % len(RESNET_SIZES)] for c in range(4)
        for i in range(4)), snap)
    serve.update({"buckets": list(RESNET_BUCKETS), "warm_s": warm_s,
                  "response_max_abs_err": serve_err})
    row = {"model": "resnet50 1000 classes 224x224x3 f32, Adam(1e-3)",
           "batch": RESNET_B, "steps": RESNET_BATCHES, "k": RESNET_K,
           "cudnn_deterministic_for_the_check": True,
           "runs": {r["run"]: r for r in (run_a, run_a2, run_w, run_wr)},
           "vs_per_step": vs, "evaluate_examples": int(ev.confusion.sum()),
           "zip": zrow, "serve": serve,
           "cross_device": _resnet_cross_device()}
    return row, {"per_step": a, "window": w, "batches": train[:RESNET_K]}


# ----------------------------------------------------------------- phase 12c
# GoogLeNet (phase 11's width) fine-tuned on 10 new classes, its trunk up
# to avg3 frozen; 8 seeded batches of B 32 train and score
TRANSFER_CLASSES, TRANSFER_BATCHES, TRANSFER_B = 10, 8, 32


def googlenet_transfer_phase():
    """``TransferLearningGraph`` over a GoogLeNet from a seed (frozen up to
    avg3, a new 10-class head, Adam(1e-3)) under ``EarlyStoppingTrainer``
    (at most 3 epochs, patience 1, a ``DataSetLossCalculator`` over the
    training batches, the best model kept in memory): the frozen
    parameters bitwise unchanged, K7 launched 37 times a forward (training
    steps, validation scores, the best model's ``evaluate``), K7 against
    its plain version at every 1x1 conv of one frozen-trunk batch. Returns
    the row and the trained network (phase 19 profiles its step)."""
    src = googlenet(**GNET).init(seed=SEED + 60)
    net = (TransferLearningGraph(src).set_feature_extractor("avg3")
           .n_out_replace("output", TRANSFER_CLASSES, weight_init="xavier")
           .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-3)))
           .build())
    del src
    batches = _resnet_batches(TRANSFER_BATCHES, SEED + 61, TRANSFER_CLASSES,
                              GNET["height"], TRANSFER_B)
    frozen = {n: {k: p.detach().clone() for k, p in pd.items()}
              for n, pd in net.param_dicts().items()
              if getattr(getattr(net.vertices[n], "layer", None), "frozen",
                         False)}
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(ListDataSetIterator(batches)),
        model_saver=InMemoryModelSaver(),
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(3),
            ScoreImprovementEpochTerminationCondition(1)])
    clock = _WindowClock(1)
    net.set_listeners(clock)
    torch.cuda.synchronize()
    k7.conv1x1_fused.launches = 0
    t0 = time.perf_counter()
    res = EarlyStoppingTrainer(cfg, net,
                               ListDataSetIterator(batches)).fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = k7.conv1x1_fused.launches
    steps = net.iteration_count
    scored = len(res.score_vs_epoch) * TRANSFER_BATCHES
    if fit_launches != 37 * (steps + scored) or steps == 0:
        raise AssertionError(f"K7 launched {fit_launches} times for {steps} "
                             f"steps and {scored} scored batches (37 each)")
    bad = [f"{n}.{k}" for n, pd in frozen.items() for k, p in pd.items()
           if not torch.equal(net.param_dicts()[n][k], p)]
    if bad or not frozen:
        raise AssertionError(f"frozen parameters moved: {bad[:4]}")
    k7.conv1x1_fused.launches = 0
    ev = res.best_model.evaluate(ListDataSetIterator(batches))
    eval_launches = k7.conv1x1_fused.launches
    if eval_launches != 37 * TRANSFER_BATCHES or \
            ev.confusion.sum() != TRANSFER_BATCHES * TRANSFER_B:
        raise AssertionError(f"the best model's evaluate: {eval_launches} "
                             f"K7 launches, {ev.confusion.sum()} examples")
    scores = list(res.score_vs_epoch.values())
    if not all(map(math.isfinite, scores)) or not min(scores) < scores[0]:
        raise AssertionError(f"transfer scores did not fall: "
                             f"{res.score_vs_epoch}")
    # K7 against its plain version at each 1x1 conv of one trunk batch
    # (these launches are not the path's): rel-to-max 1e-5, as phase 10
    # holds it at GoogLeNet's shapes (the outputs reach ~100 here, where
    # 1e-5 is an ulp); the absolute error is reported
    with torch.inference_mode():
        acts = net.feed_forward(batches[0].features)
        err, rel, n_convs = 0.0, 0.0, 0
        for name in net.vertex_names:
            layer = getattr(net.vertices[name], "layer", None)
            if not isinstance(layer, ConvolutionLayer) or \
                    tuple(layer.kernel_size) != (1, 1):
                continue
            xin = acts[net.conf.vertex_inputs[name][0]]
            xm = xin.reshape(-1, xin.shape[-1]).contiguous()
            wm = layer.W.reshape(layer.W.shape[-2], -1).contiguous()
            got = k7.conv1x1_fused(xm, wm, layer.b)
            want = k7._conv1x1_plain(xm, wm, layer.b)
            err = max(err, float((got - want).abs().max()))
            rel = max(rel, _rel_to_max(got, want))
            n_convs += 1
    if n_convs != 37 or rel > 1e-5:
        raise AssertionError(f"K7 vs plain on the frozen trunk: rel-to-max "
                             f"{rel:.3g} over {n_convs} convs")
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + clock.t, clock.t)]
    net.set_listeners()
    row = {"model": "googlenet 224x224x3 f32, trunk frozen to avg3, "
                    "10-class head, Adam(1e-3)",
           "batch": TRANSFER_B, "batches": TRANSFER_BATCHES,
           "score_vs_epoch": res.score_vs_epoch,
           "best_model_epoch": res.best_model_epoch,
           "termination": [res.termination_reason,
                           res.termination_details],
           "total_epochs": res.total_epochs, "steps": steps,
           "fit_s": fit_s, "step_ms": step_ms,
           "step_ms_p50_after_first": float(np.median(step_ms[1:])),
           "k7_launches_fit": fit_launches,
           "k7_launches_evaluate": eval_launches,
           "k7_launches": fit_launches + eval_launches,
           "forwards": steps + scored + TRANSFER_BATCHES,
           "k7_vs_plain_max_abs_err": err,
           "k7_vs_plain_rel_to_max": rel, "frozen_parameters_checked":
               sum(len(pd) for pd in frozen.values()),
           "evaluate_accuracy": ev.accuracy()}
    return row, {"net": net, "batches": batches[:4]}


def cnn_train_device_time_phase(rctx, gctx):
    """Phase 19 for the CNN training paths: the profiler's device time a
    step of ResNet-50 per step and in windows (replays only) and of the
    GoogLeNet transfer step, K7's share of it and the convolution
    backward kernels it ran (none, if no backward runs through the frozen
    trunk)."""
    out = {}
    for what, net, kw in (("resnet50_per_step", rctx["per_step"],
                           dict(async_prefetch=False)),
                          ("resnet50_window", rctx["window"],
                           dict(steps_per_dispatch=RESNET_K))):
        g0 = _graph_counts(net)
        prof = _device_kernels(lambda: net.fit(
            iterator=ListDataSetIterator(rctx["batches"]), **kw), top=1000)
        g1 = _graph_counts(net)
        if what == "resnet50_window" and (
                g1["captures"] != g0["captures"]
                or g1["replays"] - g0["replays"] != RESNET_K):
            raise AssertionError(f"the profiled resnet50 windows were not "
                                 f"all replays: {g0} -> {g1}")
        out[what] = {"device_ms_per_step": prof["device_ms"] / RESNET_K,
                     "wall_ms_per_step": prof["wall_ms"] / RESNET_K,
                     "top_kernels_ms_per_step": [
                         {"kernel": r["kernel"], "calls": r["calls"]
                          / RESNET_K, "ms": r["ms"] / RESNET_K}
                         for r in prof["top"][:10]]}
    net, bs = gctx["net"], gctx["batches"]
    prof = _device_kernels(lambda: net.fit(
        iterator=ListDataSetIterator(bs), async_prefetch=False), top=1000)
    n = len(bs)
    if prof["device_ms"] <= 0:
        raise AssertionError("the profiler recorded no device time for the "
                             "GoogLeNet transfer steps")
    k7_ms = sum(r["ms"] for r in prof["top"] if "conv1x1" in r["kernel"])
    backward = re.compile(r"dgrad|wgrad|max_pool.*backward|"
                          r"conv.*backward|col2im", re.I)
    out["googlenet_transfer"] = {
        "device_ms_per_step": prof["device_ms"] / n,
        "wall_ms_per_step": prof["wall_ms"] / n,
        "k7_ms_per_step": k7_ms / n,
        "k7_share_of_device_time": k7_ms / prof["device_ms"],
        "trunk_backward_kernels_per_step": sum(
            r["calls"] for r in prof["top"] if backward.search(r["kernel"]))
        / n,
        "top_kernels_ms_per_step": [
            {"kernel": r["kernel"], "calls": r["calls"] / n,
             "ms": r["ms"] / n} for r in prof["top"][:10]]}
    return out


# ----------------------------------------------------------------- phase 12d
# DL4J's Word2VecSentimentRNN example at its width (dl4j-examples,
# recurrent/word2vecsentiment): 300-wide word vectors, GravesLSTM(256,
# tanh), a 2-class softmax with MCXENT, reviews cut to 256 steps, batches
# of 64, Adam(2e-2), l2 1e-5, xavier, element-wise clipping at 1.0; an
# EmbeddingLayer of a 30,000-word vocabulary from a seed stands in for the
# pretrained GoogleNews vectors
SENT = dict(vocab=30000, embed=300, hidden=256, T=256)
SENT_B, SENT_BATCHES, SENT_K, SENT_EVAL = 64, 16, 8, 4
SENT_MIN_LEN = 32
SENT_SMALL = dict(vocab=500, embed=300, hidden=256, T=32)   # card vs CPU
SENT_SMALL_B, SENT_GRADCHECK_SUBSET = 8, 400
# DL4J's VariationalAutoEncoderExample: 784 -> (256, 256) -> 2 -> (256,
# 256), Bernoulli reconstruction, RMSProp(1e-2), l2 1e-4, B 128
VAE = dict(n_in=784, n_out=2, encoder_layer_sizes=(256, 256),
           decoder_layer_sizes=(256, 256))
VAE_B, VAE_BATCHES = 128, 4


def sentiment_graph(seed, vocab, embed, hidden, T, device=None,
                    dtype="float32"):
    """The sentiment classifier: [B,T,1] float ids -> EmbeddingLayer
    (behind an explicit ``RnnToFeedForwardPreProcessor``) -> GravesLSTM
    (behind ``FeedForwardToRnnPreProcessor(T)``) ->
    ``LastTimeStepVertex(mask_input="in")`` -> a 2-class softmax."""
    g = (NeuralNetConfiguration(
            seed=seed, updater=Adam(2e-2), l2=1e-5, weight_init="xavier",
            dtype=dtype,
            gradient_normalization="clipelementwiseabsolutevalue",
            gradient_normalization_threshold=1.0)
         .graph_builder().add_inputs("in")
         .add_layer("emb", EmbeddingLayer(n_in=vocab, n_out=embed,
                                          activation="identity"), "in",
                    preprocessor=RnnToFeedForwardPreProcessor())
         .add_layer("lstm", GravesLSTM(n_out=hidden, activation="tanh"),
                    "emb", preprocessor=FeedForwardToRnnPreProcessor(
                        timestep_length=T))
         .add_vertex("last", LastTimeStepVertex(mask_input="in"), "lstm")
         .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                       loss="mcxent"), "last")
         .set_outputs("out").set_input_types(InputType.recurrent(1, T)))
    return ComputationGraph(g.build(), device=device)


def _sentiment_batches(n, seed, vocab, T, b, min_len):
    """``n`` seeded batches of ``b`` reviews: ids [b,T,1], each review's
    length drawn from min_len..T as a [b,T] features mask, a one-hot
    sentiment [b,2]."""
    rng = np.random.default_rng(seed)
    eye = np.eye(2, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, T, 1)).astype(np.float32)
        lens = rng.integers(min_len, T + 1, b)
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        out.append(DataSet(ids, eye[rng.integers(0, 2, b)],
                           features_mask=mask))
    return out


@contextlib.contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, restored
    after (the embedding's backward then adds by a sort, not by atomics;
    cuBLAS takes the workspace that mode asks for)."""
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _sentiment_fit(batches, what, **fit_kw):
    """The classifier from the phase's seed, fitted once over ``batches``,
    counted (K5, K6) and timed a step (per step) or a window; returns (net,
    row)."""
    net = sentiment_graph(SEED + 70, **SENT).init()
    k = fit_kw.get("steps_per_dispatch", 1)
    clock = _WindowClock(k)
    net.set_listeners(clock)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, detail = _counted_run(
        net, lambda: net.fit(iterator=ListDataSetIterator(batches), **fit_kw),
        LSTM_COUNTED)
    peak = torch.cuda.max_memory_allocated()
    stamps = [t0] + clock.t
    ms = [(b - a) * 1e3 / k for a, b in zip(stamps, stamps[1:])]
    losses = [float(v) for v in clock.losses]
    if len(losses) != len(batches) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"sentiment {what}: losses {losses}")
    want = {"lstm_fwd": len(batches), "lstm_bwd": len(batches)}
    if launches != want:
        raise AssertionError(f"sentiment {what} launched {launches} "
                             f"({detail}), not {want}")
    net.set_listeners()
    p50 = float(np.median(ms[1:]))
    return net, {"run": what, "losses": losses, "step_ms": ms,
                 "step_ms_p50_after_first": p50,
                 "reviews_per_s": SENT_B / (p50 / 1e3),
                 "max_memory_allocated_bytes": peak, "launches": launches,
                 "launches_detail": detail, "graph": _graph_counts(net)}


def _sentiment_kernels(mask_bt):
    """K5 and K6 against their plain versions at the classifier's shape (T
    256, B 64, H 256, f32, peepholes), unmasked as the classifier runs
    them and under a batch's [B,T] mask; K6 from the plain forward's
    residuals. Times each beside its plain version and the bound."""
    gen = torch.Generator().manual_seed(SEED + 72)
    T, B, H = SENT["T"], SENT_B, SENT["hidden"]
    out, index = {}, torch.cuda.current_device()
    for masked in (False, True):
        fwd, _, peeps, (dhs, dhT, dcT) = _lstm_case(gen, T, B, H,
                                                    torch.float32, True,
                                                    False)
        mask = (torch.as_tensor(mask_bt).t().contiguous().cuda()
                if masked else None)
        got = lstm.fused_lstm_fwd(*fwd, mask, peeps)
        want = lstm.lstm_fwd_reference(*fwd, mask, peeps)
        bargs = (*want[1:5], dhs, fwd[3], dhT, dcT, mask, peeps)
        got_b = lstm.fused_lstm_bwd(*bargs)
        want_b = lstm.lstm_bwd_reference(*bargs)
        torch.cuda.synchronize()
        tag = "masked" if masked else "unmasked"
        for kind, g, w in (("fwd", got, want), ("bwd", got_b, want_b)):
            err = _max_err(g, w)
            if not all(torch.isfinite(t.float()).all() for t in g) or \
                    err > LSTM_TOL[(kind, torch.float32)]:
                raise AssertionError(
                    f"lstm {kind} kernel at the classifier's shape ({tag}): "
                    f"{err:.3g} > {LSTM_TOL[(kind, torch.float32)]}")
            out[f"{kind}_max_abs_err_{tag}"] = err
        if masked:
            continue
        out["fwd_plan"] = lstm._fwd_plan(index, H, B, torch.float32)[0]._asdict()
        out["bwd_plan"] = lstm._bwd_plan(index, H, B, torch.float32)[0]._asdict()
        out["fwd_ms"] = _time_ms(lambda: lstm.fused_lstm_fwd(*fwd, None,
                                                             peeps))
        out["bwd_ms"] = _time_ms(lambda: lstm.fused_lstm_bwd(*bargs))
        out["fwd_plain_ms"] = _time_ms(lambda: lstm.lstm_fwd_reference(
            *fwd, None, peeps), iters=3, warmup=1)
        out["bwd_plain_ms"] = _time_ms(lambda: lstm.lstm_bwd_reference(
            *bargs), iters=3, warmup=1)
        for kind in ("fwd", "bwd"):
            out[f"{kind}_bound_ms"], out[f"{kind}_bound_by"] = _lstm_bound(
                kind, T, B, H, torch.float32, True, False)
    log("K5/K6 at the classifier's shape:", out)
    return out


def _sentiment_readings(net, ds):
    """A training forward and backward of ``net`` on a masked batch,
    nothing written: the loss and every parameter's gradient (CPU
    float64)."""
    x, y, m = (torch.as_tensor(v, device=net.device)
               for v in (ds.features, ds.labels, ds.features_mask))
    loss = net.loss_fn([x], [y], train=True, features_mask=[m])
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in net.named_parameters()])
    return float(loss.detach()), {n: g.double().cpu()
                                  for n, g in zip(names, grads)}


def _sentiment_cross_device():
    """One f32 step of the classifier at V 500, T 32, B 8 (E 300, H 256) on
    the card (K5, K6) and on the CPU (the plain recurrence) from the same
    weights: loss rel 1e-5, every gradient rel-to-max 1e-4; then
    ``check_gradients`` in float64 on the card (the GravesLSTM takes its
    plain recurrence there: float64 is outside K5's probe) over the
    reference's random subset of parameters."""
    ds = _sentiment_batches(1, SEED + 73, SENT_SMALL["vocab"],
                            SENT_SMALL["T"], SENT_SMALL_B, 4)[0]
    card = sentiment_graph(SEED + 74, **SENT_SMALL).init()
    cpu = sentiment_graph(SEED + 74, **SENT_SMALL, device="cpu").init()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    _reset_launches()
    (lc, gc), (lp, gp) = _sentiment_readings(card, ds), \
        _sentiment_readings(cpu, ds)
    launches = _launches(LSTM_COUNTED)
    worst = max((_rel_to_max(gc[n], gp[n]), n) for n in gp)
    row = {"loss_rel": abs(lc - lp) / abs(lp), "grad_rel_to_max": worst[0],
           "worst_grad": worst[1], "launches": launches}
    if row["loss_rel"] > 1e-5 or worst[0] > 1e-4 or \
            launches != {"lstm_fwd": 1, "lstm_bwd": 1}:
        raise AssertionError(f"sentiment step, card vs CPU: {row}")
    net64 = sentiment_graph(SEED + 74, **SENT_SMALL, dtype="float64").init()
    _reset_launches()
    t0 = time.perf_counter()
    ok = check_gradients(net64, [ds.features], [ds.labels],
                         features_mask=[ds.features_mask],
                         subset=SENT_GRADCHECK_SUBSET, seed=1)
    row["gradcheck_float64_s"] = time.perf_counter() - t0
    row["gradcheck_params"] = [SENT_GRADCHECK_SUBSET, net64.num_params()]
    if not ok or _launches(LSTM_COUNTED) != {"lstm_fwd": 0, "lstm_bwd": 0}:
        raise AssertionError("check_gradients failed on the card (float64)")
    return row


def sentiment_phase():
    """Phase 12d, part 1: the sentiment classifier at DL4J's example width,
    16 masked batches of B 64 per step and in windows of 8 (a CUDA graph
    of the step) from one seed, bitwise, under deterministic algorithms;
    ``evaluate`` on 4 held-out batches against numpy; K5 and K6 against
    their plain versions at this shape; the card-vs-CPU step and the
    float64 gradient check. Returns the row and what phase 19 profiles."""
    batches = _sentiment_batches(SENT_BATCHES + SENT_EVAL, SEED + 71,
                                 SENT["vocab"], SENT["T"], SENT_B,
                                 SENT_MIN_LEN)
    train, held = batches[:SENT_BATCHES], batches[SENT_BATCHES:]
    with _deterministic_algorithms():
        a, run_a = _sentiment_fit(train, "per_step", async_prefetch=False)
        w, run_w = _sentiment_fit(train, "window",
                                  steps_per_dispatch=SENT_K)
    g = run_w["graph"]
    if (g["captures"], g["replays"]) != (1, SENT_BATCHES - 1):
        raise AssertionError(f"sentiment windows: {g['captures']} captures "
                             f"and {g['replays']} replays")
    same, rel, name = _params_vs(a, w)
    if not same:
        raise AssertionError(f"sentiment windows of {SENT_K} are not bitwise "
                             f"the per-step fit: {name} rel-to-max {rel:.3g}")
    del a
    # evaluate: the reference's takes no features mask, so the last step
    # is each padded sequence's literal last one, in ``output`` as here
    _reset_launches()
    ev = w.evaluate(ListDataSetIterator(held))
    eval_launches = _launches(LSTM_COUNTED)
    want = np.zeros((2, 2), np.int64)
    for ds in held:
        out = w.output(ds.features).cpu().numpy()
        np.add.at(want, (ds.labels.argmax(1), out.argmax(1)), 1)
    if not np.array_equal(ev.confusion, want) or \
            eval_launches != {"lstm_fwd": SENT_EVAL, "lstm_bwd": 0}:
        raise AssertionError(f"sentiment evaluate: {ev.confusion} against "
                             f"{want}, launches {eval_launches}")
    row = {"model": "Word2VecSentimentRNN width: Embedding(30000, 300) -> "
                    "GravesLSTM(256) -> LastTimeStepVertex -> softmax(2), "
                    "f32, Adam(2e-2), l2 1e-5, clip 1.0",
           "batch": SENT_B, "seq_len": SENT["T"], "steps": SENT_BATCHES,
           "k": SENT_K, "deterministic_algorithms_for_the_check": True,
           "runs": {"per_step": run_a, "window": run_w},
           "window_params_bitwise": same,
           "evaluate_confusion": ev.confusion.tolist(),
           "evaluate_launches": eval_launches,
           "kernels": _sentiment_kernels(train[0].features_mask),
           "cross_device": _sentiment_cross_device()}
    return row, {"window": w, "batches": train[:SENT_K]}


def seq2seq_graph(device=None):
    """``examples/seq2seq_tbptt.py``'s graph as the example builds it:
    encoder LSTM(32) -> LastTimeStepVertex -> DuplicateToTimeSeriesVertex
    -> decoder LSTM(32) -> a 3-class softmax, T 20, tBPTT 5, Adam(5e-3)."""
    g = (NeuralNetConfiguration(seed=5, updater=Adam(5e-3)).graph_builder()
         .add_inputs("in")
         .add_layer("enc", LSTM(n_out=32, activation="tanh"), "in")
         .add_vertex("last", LastTimeStepVertex(mask_input="in"), "enc")
         .add_vertex("dup", DuplicateToTimeSeriesVertex(
             reference_input="in"), "last")
         .add_layer("dec", LSTM(n_out=32, activation="tanh"), "dup")
         .add_layer("out", RnnOutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "dec")
         .set_outputs("out").set_input_types(InputType.recurrent(4, 20))
         .tbptt_length(5))
    return ComputationGraph(g.build(), device=device)


def seq2seq_phase():
    """Phase 12d, part 2: the example's graph on its data (32 sequences of
    20 steps), 3 tBPTT fits and 3 ``rnn_time_step`` steps on the card and
    on the CPU from the same weights (atol 1e-5). K5 and K6 launch 2
    layers x 4 chunks a fit; K5 2 a streamed step. A streamed first step
    equals a full forward of that one step; later ones cannot (a full
    forward repeats the encoder's last step over the whole sequence, a
    stream feeds the decoder each step's), so they are held against the
    CPU's stream."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 20, 4)).astype(np.float32)
    csum = np.cumsum(x.sum(-1), 1)
    y = np.eye(3, dtype=np.float32)[(csum > 0).astype(int)
                                    + (csum > 3).astype(int)]
    card, cpu = seq2seq_graph().init(), seq2seq_graph(device="cpu").init()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    _reset_launches()
    for _ in range(3):
        card.fit(x, y, batch_size=32)
    fit_launches = _launches(LSTM_COUNTED)
    for _ in range(3):
        cpu.fit(x, y, batch_size=32)
    out_err = float((card.output(x).cpu() - cpu.output(x)).abs().max())
    card.rnn_clear_previous_state()
    cpu.rnn_clear_previous_state()
    _reset_launches()
    steps = [card.rnn_time_step(x[:2, t]).cpu() for t in range(3)]
    stream_launches = _launches(LSTM_COUNTED)["lstm_fwd"]
    cpu_steps = [cpu.rnn_time_step(x[:2, t]) for t in range(3)]
    stream_err = max(float((a - b).abs().max())
                     for a, b in zip(steps, cpu_steps))
    first_err = float((steps[0] - card.output(x[:2, :1])[:, -1].cpu())
                      .abs().max())
    row = {"fit_launches": fit_launches, "stream_k5_launches": stream_launches,
           "output_max_abs_err_vs_cpu": out_err,
           "stream_max_abs_err_vs_cpu": stream_err,
           "first_step_vs_full_forward": first_err,
           "iterations": card.iteration_count}
    if fit_launches != {"lstm_fwd": 24, "lstm_bwd": 24} or \
            stream_launches != 6 or card.iteration_count != 12 or \
            max(out_err, stream_err, first_err) > 1e-5:
        raise AssertionError(f"seq2seq on the card: {row}")
    return row


class _NoiseFrom:
    """A layer's ``pretrain_noise`` drawn from a CPU generator seeded by
    the call count and moved to the input's device: one noise for the
    card's and the CPU's run."""

    def __init__(self, draw, seed):
        self.draw, self.seed, self.calls = draw, seed, 0

    def __call__(self, x, gen):
        cpu = torch.Generator().manual_seed(self.seed + self.calls)
        self.calls += 1
        return self.draw(x.cpu(), cpu).to(x.device)


def _vae_net(device=None):
    conf = NeuralNetConfiguration(
        seed=SEED + 75, updater=RmsProp(1e-2), l2=1e-4, weight_init="xavier",
        activation="leakyrelu", dtype="float64").list(VariationalAutoencoder(
            **VAE, reconstruction_distribution=(
                BernoulliReconstructionDistribution()))).build()
    return MultiLayerNetwork(conf, device=device)


def _lbfgs_net(device=None):
    conf = (NeuralNetConfiguration(seed=SEED + 76, updater=Sgd(0.1),
                                   dtype="float64",
                                   optimization_algorithm="lbfgs",
                                   max_num_line_search_iterations=8)
            .list(DenseLayer(n_in=4, n_out=12, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device)


def nn_engine_cross_device_phase():
    """Phase 12d, part 3: one layerwise ``pretrain`` epoch of a VAE at
    DL4J's example width (float64, the same noise on both devices) and
    eight LBFGS outer iterations of a small MLP (float64), each on the card
    and on the CPU from the same weights: parameters at rel-to-max 1e-9."""
    rng = np.random.default_rng(SEED + 77)
    x = (rng.random((VAE_B * VAE_BATCHES, VAE["n_in"])) > 0.7).astype(
        np.float64)
    out = {}
    nets = {"cuda": _vae_net().init(), "cpu": _vae_net(device="cpu").init()}
    nets["cpu"].load_state_dict({k: v.cpu() for k, v in
                                 nets["cuda"].state_dict().items()})
    start = nets["cpu"].params_flat().clone()
    for dev, net in nets.items():
        layer = net.layers[0]
        layer.pretrain_noise = _NoiseFrom(layer.pretrain_noise, SEED + 78)
        t0 = time.perf_counter()
        net.pretrain(ListDataSetIterator(features=x, labels=x,
                                         batch_size=VAE_B))
        torch.cuda.synchronize()
        out[f"vae_pretrain_s_{dev}"] = time.perf_counter() - t0
    out["vae_param_rel_to_max"] = _rel_to_max_f64(
        nets["cuda"].params_flat().cpu(), nets["cpu"].params_flat())
    out["vae_params"] = nets["cpu"].num_params()
    moved = _rel_to_max_f64(nets["cpu"].params_flat(), start)
    xy = np.random.default_rng(SEED + 79).normal(size=(120, 4))
    yi = (xy[:, 0] + xy[:, 1] > 0).astype(int) + (xy[:, 2] > 0.5).astype(int)
    y = np.eye(3)[yi]
    lb = {"cuda": _lbfgs_net().init(), "cpu": _lbfgs_net(device="cpu").init()}
    lb["cpu"].load_state_dict({k: v.cpu() for k, v in
                               lb["cuda"].state_dict().items()})
    for net in lb.values():
        net.fit(xy, y, epochs=8, batch_size=120)
    out["lbfgs_param_rel_to_max"] = _rel_to_max_f64(
        lb["cuda"].params_flat().cpu(), lb["cpu"].params_flat())
    out["lbfgs_score"] = [lb[d].score(xy, y) for d in ("cuda", "cpu")]
    if out["vae_param_rel_to_max"] > 1e-9 or moved == 0 or \
            out["lbfgs_param_rel_to_max"] > 1e-9:
        raise AssertionError(f"pretrain / LBFGS, card vs CPU: {out}")
    return out


def sentiment_device_time_phase(sctx):
    """Phase 19 for the classifier: the profiler's device time a step over
    one window of 8 (replays only) with K5's and K6's shares, and K5, K6
    and cuDNN's ``nn.LSTM(300, 256)`` forward and backward by device time
    at the classifier's shape (T 256, B 64)."""
    net, bs = sctx["window"], sctx["batches"]
    g0 = _graph_counts(net)
    prof = _device_kernels(lambda: net.fit(
        iterator=ListDataSetIterator(bs), steps_per_dispatch=SENT_K),
        top=1000)
    g1 = _graph_counts(net)
    if g1["captures"] != g0["captures"] or \
            g1["replays"] - g0["replays"] != SENT_K:
        raise AssertionError(f"the profiled sentiment window was not all "
                             f"replays: {g0} -> {g1}")
    k = len(bs)
    share = lambda n: sum(r["ms"] for r in prof["top"] if n in r["kernel"])
    out = {"device_ms_per_step": prof["device_ms"] / k,
           "wall_ms_per_step": prof["wall_ms"] / k,
           "k5_ms_per_step": share("lstm_fwd_kernel") / k,
           "k6_ms_per_step": share("lstm_bwd_kernel") / k,
           "top_kernels_ms_per_step": [
               {"kernel": r["kernel"], "calls": r["calls"] / k,
                "ms": r["ms"] / k} for r in prof["top"][:10]]}
    for n in ("k5", "k6"):
        out[f"{n}_share_of_device_time"] = out[f"{n}_ms_per_step"] / \
            out["device_ms_per_step"]
    gen = torch.Generator().manual_seed(SEED + 80)
    T, B, H = SENT["T"], SENT_B, SENT["hidden"]
    fwd, _, peeps, (dhs, dhT, dcT) = _lstm_case(gen, T, B, H, torch.float32,
                                                True, False)
    res = lstm.lstm_fwd_reference(*fwd, None, peeps)[1:5]
    bargs = (*res, dhs, fwd[3], dhT, dcT, None, peeps)
    out["k5_device_ms"] = _device_ms_per_call(
        lambda: lstm.fused_lstm_fwd(*fwd, None, peeps), name="lstm_fwd")
    out["k6_device_ms"] = _device_ms_per_call(
        lambda: lstm.fused_lstm_bwd(*bargs), name="lstm_bwd")
    cud = torch.nn.LSTM(SENT["embed"], H).cuda()
    xin = torch.randn(T, B, SENT["embed"], generator=gen).cuda()
    with torch.no_grad():
        out["cudnn_fwd_device_ms"] = _library_device_ms(lambda: cud(xin))
    xin.requires_grad_(True)
    o, _ = cud(xin)
    dout = torch.randn(T, B, H, generator=gen).cuda()
    leaves = [xin, *cud.parameters()]
    out["cudnn_bwd_device_ms"] = _library_device_ms(
        lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True))
    log("sentiment by device time:", out)
    return out


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


# ----------------------------------------------------------------- phase 13b
ZIP_HTTP_REQUESTS, ZIP_HTTP_B = 4, 2        # POST /predict of batch 2
ZIP_TLM_PROMPTS = 4                         # 300-900 tokens x 32 new


def _bitwise_same_params(a, b, what):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if sorted(pa) != sorted(pb):
        raise AssertionError(f"{what}: restored parameters {sorted(pb)[:4]} "
                             f"... differ in name from the written ones")
    bad = [n for n in pa if pa[n].dtype != pb[n].dtype
           or pa[n].device != pb[n].device or not torch.equal(pa[n], pb[n])]
    if bad:
        raise AssertionError(f"{what}: restored parameters differ from the "
                             f"written ones: {bad[:4]}")


def _zip_round_trip(net, path, what):
    """write_model then restore_model(device="cuda"): the seconds of each,
    the zip's bytes, and the restored network (bitwise the written one)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_model(net, path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = restore_model(path, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _bitwise_same_params(net, back, what)
    return back, {"write_s": write_s, "restore_s": restore_s,
                  "zip_bytes": os.path.getsize(path),
                  "params": net.num_params()}


def _expect_status(client, method, url, want, what, body=None, **kw):
    """One request (a JSON ``payload``, or raw ``body`` bytes) that must
    answer ``want``; returns the parsed answer."""
    if body is None:
        status, body = client.request_json(method, url, **kw)
    else:
        status, _, data = client.request(
            method, url, body=body,
            headers={"Content-Type": "application/json"}, **kw)
        body = json.loads(data)
    if status != want:
        raise AssertionError(f"{what}: HTTP {status} (want {want}): {body}")
    return body


def _predict_over_http(client, base, xs, what):
    """POST /predict of each batch in ``xs`` (bodies encoded up front, so
    the time is the round trip: the server's parse, the engine, the
    response); returns the outputs and the per-request milliseconds."""
    bodies = [json.dumps({"features": x.tolist()}).encode() for x in xs]
    outs, ms = [], []
    for body in bodies:
        t0 = time.perf_counter()
        status, _, data = client.request(
            "POST", base + "/predict", body=body,
            headers={"Content-Type": "application/json"}, timeout=120)
        ms.append((time.perf_counter() - t0) * 1e3)
        if status != 200:
            raise AssertionError(f"{what}: /predict answered {status}: "
                                 f"{data[:200]!r}")
        outs.append(np.asarray(json.loads(data)["output"], np.float32))
    return outs, ms


def _stream_over_http(client, base, prompt, max_tokens):
    """POST /generate streamed: the tokens, the done line and the
    milliseconds to the first token line."""
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode()
    t0 = time.perf_counter()
    toks, done, ttft = [], None, None
    with client.stream("POST", base + "/generate", body=body,
                       headers={"Content-Type": "application/json"},
                       timeout=300) as resp:
        if resp.status != 200:
            raise AssertionError(f"/generate answered {resp.status}")
        for line in resp:
            if not line.strip():
                continue
            obj = json.loads(line)
            if "token" in obj:
                if ttft is None:
                    ttft = (time.perf_counter() - t0) * 1e3
                toks.append(obj["token"])
            else:
                done = obj
    if done is None or not done.get("done") or done["tokens"] != len(toks):
        raise AssertionError(f"/generate stream ended without a done line "
                             f"for its {len(toks)} tokens: {done}")
    return toks, done, ttft


def _direct_ttft(eng, prompt, max_tokens):
    t0 = time.perf_counter()
    ts = eng.generate(prompt, max_tokens=max_tokens, stream=True)
    toks, ttft = [], None
    for tok in ts:
        if ttft is None:
            ttft = (time.perf_counter() - t0) * 1e3
        toks.append(int(tok))
    return toks, ttft


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _zip_http_forward(gnet, mlp, tmp, client):
    """(a) GoogLeNet and (b) the int8 net: zip, restore, /predict."""
    fwd = lambda n, x: n._output_pure(x)[0]      # the graph's one output
    rg, gzip = _zip_round_trip(gnet, f"{tmp}/googlenet.zip", "googlenet")
    del gnet
    eng = InferenceEngine(rg, feature_shape=(224, 224, 3),
                          buckets=GNET_BUCKETS, forward_fn=fwd)
    srv = ServingHTTPServer(eng)
    base = f"http://127.0.0.1:{srv.start()}"
    rng = np.random.default_rng(SEED + 40)
    xs = [rng.standard_normal((ZIP_HTTP_B, 224, 224, 3)).astype(np.float32)
          for _ in range(ZIP_HTTP_REQUESTS)]
    try:
        b0 = eng.metrics()["default"]["batches"]
        k7.conv1x1_fused.launches = 0            # the HTTP path's count
        outs, http_ms = _predict_over_http(client, base, xs, "googlenet")
        k7_n = k7.conv1x1_fused.launches
        batches = eng.metrics()["default"]["batches"] - b0
        direct_ms = []
        for x in xs:
            t0 = time.perf_counter()
            eng.predict(x, timeout=120)
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        _expect_status(client, "POST", base + "/predict", 400,
                       "googlenet malformed body", payload={"rows": [1]})
        _expect_status(client, "POST", base + "/predict/ghost", 404,
                       "googlenet unknown model",
                       payload={"features": xs[0][:1].tolist()})
    finally:
        srv.stop()
    if k7_n != 37 * batches or k7_n == 0:
        raise AssertionError(f"K7 launched {k7_n} times over HTTP for "
                             f"{batches} batches (37 each)")
    errs = [_rel_to_max(torch.as_tensor(o), rg.output(x).cpu())
            for o, x in zip(outs, xs)]
    if max(errs) > 1e-5:
        raise AssertionError(f"GoogLeNet over HTTP differs from the restored "
                             f"net's output: rel-to-max {max(errs):.3g}")
    del rg, eng
    torch.cuda.empty_cache()
    gzip.update({"model": "googlenet 1000 classes 224x224x3 f32",
                 "requests": len(xs), "batch": ZIP_HTTP_B,
                 "batches": batches, "k7_launches": k7_n,
                 "max_rel_to_max": max(errs),
                 "request_body_bytes": len(json.dumps(
                     {"features": xs[0].tolist()})),
                 "predict_http_ms": http_ms,
                 "predict_http_ms_p50": float(np.median(http_ms)),
                 "predict_direct_ms": direct_ms,
                 "predict_direct_ms_p50": float(np.median(direct_ms))})

    rm, izip = _zip_round_trip(mlp, f"{tmp}/int8.zip", "int8 net")
    fwd8 = k8.int8_forward_fn(rm)
    eng = InferenceEngine(rm, feature_shape=(INT8_NET[0],),
                          buckets=INT8_BUCKETS, forward_fn=fwd8)
    srv = ServingHTTPServer(eng)
    base = f"http://127.0.0.1:{srv.start()}"
    xi = [rng.standard_normal((ZIP_HTTP_B, INT8_NET[0])).astype(np.float32)
          for _ in range(ZIP_HTTP_REQUESTS)]
    try:
        b0 = eng.metrics()["default"]["batches"]
        k8.int8_matmul_fused.launches = 0        # the HTTP path's count
        outs, http_ms = _predict_over_http(client, base, xi, "int8")
        k8_n = k8.int8_matmul_fused.launches
        batches = eng.metrics()["default"]["batches"] - b0
        eng.stop(drain=True)
        _expect_status(client, "POST", base + "/predict", 503,
                       "int8 draining", payload={"features": xi[0].tolist()})
        _expect_status(client, "GET", base + "/health", 503,
                       "int8 draining health")
    finally:
        srv.stop()
    if k8_n != 3 * batches or k8_n == 0:
        raise AssertionError(f"K8 launched {k8_n} times over HTTP for "
                             f"{batches} batches (3 each)")
    with torch.inference_mode():
        errs = [_rel_to_max(torch.as_tensor(o), fwd8(
            rm, torch.as_tensor(x, device=rm.device)).cpu())
            for o, x in zip(outs, xi)]
    if max(errs) > 1e-5:
        raise AssertionError(f"the int8 net over HTTP differs from its direct "
                             f"forward: rel-to-max {max(errs):.3g}")
    izip.update({"requests": len(xi), "batches": batches,
                 "k8_launches": k8_n, "max_rel_to_max": max(errs),
                 "predict_http_ms_p50": float(np.median(http_ms))})
    return gzip, izip


def _zip_http_tlm(tmp, client):
    """(c) the _TLM through a zip and /generate; (d) /reload from a
    checkpoint directory with a truncated newest zip."""
    cap = ENGINE["max_seq_len"]
    ck = f"{tmp}/checkpoints"
    os.makedirs(ck)
    net1 = transformer_lm(**TLM, token_input=True).init(seed=SEED + 41)
    rnet, tzip = _zip_round_trip(net1, f"{ck}/checkpoint_epoch1.zip",
                                 "_TLM")
    rng = np.random.default_rng(SEED + 42)
    lens = rng.integers(300, 901, size=ZIP_TLM_PROMPTS)
    prompts = [rng.integers(1, TLM["vocab_size"], size=int(n)).tolist()
               for n in lens]
    # prefix cache off: every request prefills, so the streamed, blocking
    # and direct runs of one prompt are alike and their TTFTs comparable
    eng = GenerationEngine(rnet, prefix_cache=False, **ENGINE)
    srv = ServingHTTPServer(generation=eng)
    base = f"http://127.0.0.1:{srv.start()}"
    row = dict(tzip, model="transformer_lm _TLM f32",
               prompt_lens=[int(n) for n in lens], max_tokens=MAX_TOKENS)
    try:
        fa.flash_attention.launches = 0          # the HTTP path's count
        p0 = eng.metrics()["default"]["prefills"]
        streamed, ttft_http = [], []
        for p in prompts:
            toks, done, ttft = _stream_over_http(client, base, p, MAX_TOKENS)
            if done["reason"] != "length":
                raise AssertionError(f"_TLM stream ended {done}")
            streamed.append(toks)
            ttft_http.append(ttft)
        blocking = [_expect_status(
            client, "POST", base + "/generate", 200, "_TLM blocking",
            payload={"prompt": p, "max_tokens": MAX_TOKENS,
                     "stream": False})["tokens"] for p in prompts]
        k1_n = fa.flash_attention.launches
        prefills = eng.metrics()["default"]["prefills"] - p0
        direct, ttft_direct = [], []
        for p in prompts:
            toks, ttft = _direct_ttft(eng, p, MAX_TOKENS)
            direct.append(toks)
            ttft_direct.append(ttft)
        _expect_status(client, "POST", base + "/generate", 400,
                       "_TLM malformed body", body=b"{not json")
        _expect_status(client, "POST", base + "/generate/ghost", 404,
                       "_TLM unknown model", payload={"prompt": [1]})
        want = [naive_generate(net1, p, MAX_TOKENS, pad_to=cap)
                for p in prompts]
        for i in range(len(prompts)):
            for what, got in (("streamed", streamed[i]),
                              ("blocking", blocking[i]),
                              ("direct", direct[i])):
                if got != want[i]:
                    raise AssertionError(
                        f"_TLM prompt {i} {what} over HTTP differs from "
                        f"naive_generate at step "
                        f"{_first_diff(got, want[i])}")
        if k1_n < TLM["n_blocks"] * prefills or k1_n == 0:
            raise AssertionError(f"K1 launched {k1_n} times over HTTP for "
                                 f"{prefills} prefill batches of "
                                 f"{TLM['n_blocks']} blocks")
        # (d): epoch 2 is another seed, epoch 3 a truncated copy
        del rnet
        net2 = transformer_lm(**TLM, token_input=True).init(seed=SEED + 43)
        write_model(net2, f"{ck}/checkpoint_epoch2.zip")
        with open(f"{ck}/checkpoint_epoch2.zip", "rb") as f:
            head = f.read(40)
        with open(f"{ck}/checkpoint_epoch3.zip", "wb") as f:
            f.write(head)
        t0 = time.perf_counter()
        body = _expect_status(client, "POST", base + "/reload", 200,
                              "_TLM reload",
                              payload={"model": "default", "path": ck},
                              timeout=300)
        reload_s = time.perf_counter() - t0
        if body.get("version") != 2:
            raise AssertionError(f"/reload answered {body}, want version 2")
        fa.flash_attention.launches = 0
        after = [_stream_over_http(client, base, p, MAX_TOKENS)[0]
                 for p in prompts[:2]]
        k1_n += fa.flash_attention.launches
        for i, got in enumerate(after):
            ref = naive_generate(net2, prompts[i], MAX_TOKENS, pad_to=cap)
            if got != ref:
                raise AssertionError(
                    f"after /reload, prompt {i} differs from the epoch-2 "
                    f"weights' naive_generate at step {_first_diff(got, ref)}")
        eng.stop(drain=True)
        _expect_status(client, "POST", base + "/generate", 503,
                       "_TLM draining", payload={"prompt": [1, 2],
                                                 "max_tokens": 2})
    finally:
        srv.stop()
    del net1, net2, eng
    torch.cuda.empty_cache()
    row.update({"k1_launches": k1_n, "prefill_batches": prefills,
                "ttft_http_ms": ttft_http, "ttft_direct_ms": ttft_direct,
                "ttft_http_ms_p50": float(np.median(ttft_http)),
                "ttft_direct_ms_p50": float(np.median(ttft_direct)),
                "reload_s": reload_s, "reload_version": 2})
    return row


def _zip_http_char(tmp, client):
    """(e) the char-RNN through a zip and /generate (K5)."""
    net = text_generation_lstm(**CHAR).init(seed=SEED + 44)
    rnet, czip = _zip_round_trip(net, f"{tmp}/char.zip", "char-RNN")
    n_layers = sum(hasattr(l, "apply_with_final_state") for l in rnet.layers)
    eng = GenerationEngine(rnet, **CHAR_ENGINE)
    srv = ServingHTTPServer(generation=eng)
    base = f"http://127.0.0.1:{srv.start()}"
    rng = np.random.default_rng(SEED + 45)
    V = CHAR["vocab_size"]
    prompts = [rng.integers(0, V, size=int(n)).tolist()
               for n in rng.integers(40, 161, size=4)]
    rt = eng.runtime()
    try:
        m0 = eng.metrics()["default"]
        g0 = rt.graph_stats()["kernel_runs"].get("lstm_fwd", 0)
        _reset_launches()                        # the HTTP path's count
        got = [_stream_over_http(client, base, p, CHAR_MAX_TOKENS)[0]
               for p in prompts]
        if not rt.wait_idle(60):
            raise AssertionError("char HTTP: the runtime did not go idle")
        eager = lstm.fused_lstm_fwd.launches
        m1 = eng.metrics()["default"]
        replays = rt.graph_stats()["kernel_runs"].get("lstm_fwd", 0) - g0
    finally:
        srv.stop()
    steps = (m1["prefills"] - m0["prefills"]) + \
        (m1["decode_steps"] - m0["decode_steps"])
    k5_n = eager + replays
    if k5_n != n_layers * steps or eager == 0:
        raise AssertionError(f"K5 launched {eager} eagerly and {replays} in "
                             f"graph replays over HTTP for {steps} prefill "
                             f"batches and decode steps of {n_layers} layers")
    for i, p in enumerate(prompts):
        ref = naive_generate_lstm(net, p, CHAR_MAX_TOKENS)
        if got[i] != ref:
            raise AssertionError(f"char prompt {i} over HTTP differs from "
                                 f"naive_generate_lstm at step "
                                 f"{_first_diff(got[i], ref)}")
    czip.update({"requests": len(prompts), "k5_launches": k5_n,
                 "k5_launches_eager": eager, "k5_launches_in_replays":
                     replays})
    return czip


def zip_http_phase(gnet, mlp):
    tmp = tempfile.mkdtemp(prefix="dl4j_zip_http_")
    client = HTTPClient(timeout=300)
    try:
        gzip, izip = _zip_http_forward(gnet, mlp, tmp, client)
        tlm = _zip_http_tlm(tmp, client)
        char = _zip_http_char(tmp, client)
    finally:
        client.close()
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"googlenet": gzip, "int8": izip, "tlm": tlm, "char": char,
           "launches": {"conv1x1_bias_relu": gzip["k7_launches"],
                        "int8_matmul": izip["k8_launches"],
                        "flash_attention_fwd": tlm["k1_launches"],
                        "lstm_fwd": char["k5_launches"]}}
    log("zip + http phase:", {k: v for k, v in row.items()
                              if k == "launches"},
        "predict p50 http/direct ms", gzip["predict_http_ms_p50"],
        gzip["predict_direct_ms_p50"], "ttft p50 http/direct ms",
        tlm["ttft_http_ms_p50"], tlm["ttft_direct_ms_p50"])
    return row


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
    pw._at(0)
    _, rows, _ = pw._worker_grads(x, y)
    flat = torch.cat([r.reshape(DP_WORKERS, -1) for r in rows], dim=1)
    del rows
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


# ----------------------------------------------------------------- phase 12e
RESUME_EVERY, RESUME_STOP, RESUME_K = 4, 10, 4
RESNET_RESUME_BATCHES, RESNET_RESUME_EVERY, RESNET_RESUME_STOP = 6, 2, 4


class _StopAfter:
    """The batches of a list, pass after pass (``reset`` starts the next),
    raising ``Crash`` when batch ``n`` of pass ``epoch`` is asked for: a
    fit that dies after its first ``n`` batches of that epoch."""

    class Crash(RuntimeError):
        pass

    def __init__(self, batches, n, epoch=0):
        self.batches, self.n, self.epoch, self.passes = batches, n, epoch, 0

    def __iter__(self):
        for i, ds in enumerate(self.batches):
            if self.passes == self.epoch and i == self.n:
                raise self.Crash(f"stopped before batch {i} of pass "
                                 f"{self.passes}")
            yield ds

    def reset(self):
        self.passes += 1


def _opt_tensors(net):
    """The updater state's tensors, in either format."""
    from deeplearning4j_tpu_torch.util.distributed_checkpoint import \
        tree_flatten
    return tree_flatten(net.opt_state)[0]


def _run_vs(a, b):
    """What a resumed run must equal bitwise: parameters, updater state,
    layer state and the iteration count, each (bitwise, worst rel-to-max
    or count)."""
    p_same, p_rel, p_name = _params_vs(a, b)
    oa, ob = _opt_tensors(a), _opt_tensors(b)
    o_same = len(oa) == len(ob) and all(torch.equal(u, v)
                                        for u, v in zip(oa, ob))
    o_rel = max((_rel_to_max(u.float(), v.float()) for u, v in zip(oa, ob)),
                default=0.0)
    s_same, s_rel, _ = _state_vs(a, b)
    return {"params_bitwise": p_same, "params_rel_to_max": p_rel,
            "worst_param": p_name, "updater_bitwise": o_same,
            "updater_rel_to_max": o_rel, "state_bitwise": s_same,
            "state_rel_to_max": s_rel,
            "iterations": [a.iteration_count, b.iteration_count]}


def _resume_case(make, batches, what, epochs, stop_n, stop_epoch=0,
                 counted=COUNTED, listeners=(), **kw):
    """Three fits of ``make()`` through ``fit_with_checkpointing``: one
    uninterrupted (with ``listeners``), one that dies after batch
    ``stop_n`` of epoch ``stop_epoch``, then a fresh network resumed from
    the newest checkpoint the second wrote. The resumed run must equal the
    uninterrupted one bitwise. Returns (row, the uninterrupted net)."""
    tmp = tempfile.mkdtemp(prefix="dl4j_resume_")
    row = {"run": what, "fit": dict(kw, epochs=epochs)}
    try:
        a = make()
        a.set_listeners(*listeners)
        t0 = time.perf_counter()
        row["launches_uninterrupted"], row["graph_uninterrupted"] = \
            _counted_run(a, lambda: fit_with_checkpointing(
                a, ListDataSetIterator(batches), epochs=epochs,
                checkpoint_dir=os.path.join(tmp, "a"), keep_last=2, **kw),
                counted)
        row["uninterrupted_s"] = time.perf_counter() - t0
        row["uninterrupted_kept"] = sorted(os.listdir(os.path.join(tmp,
                                                                   "a")))
        a.set_listeners()
        b = make()
        try:
            fit_with_checkpointing(b, _StopAfter(batches, stop_n, stop_epoch),
                                   epochs=epochs, keep_last=2,
                                   checkpoint_dir=os.path.join(tmp, "b"),
                                   **kw)
        except _StopAfter.Crash:
            pass
        else:
            raise AssertionError(f"{what}: the stopped fit ran to its end")
        row["stopped_at_iteration"] = b.iteration_count
        newest = latest_checkpoint(os.path.join(tmp, "b"))
        row["resumed_from"] = os.path.basename(newest)
        row["resumed_from_manifest"] = {
            k: v for k, v in read_checkpoint_manifest(newest).items()
            if k in ("epochs_done", "step_within_epoch", "iterations_done")}
        del b
        torch.cuda.empty_cache()
        c = make()
        t0 = time.perf_counter()
        row["launches_resumed"], row["graph_resumed"] = _counted_run(
            c, lambda: fit_with_checkpointing(
                c, ListDataSetIterator(batches), epochs=epochs,
                checkpoint_dir=os.path.join(tmp, "b"), keep_last=2, **kw),
            counted)
        row["resumed_s"] = time.perf_counter() - t0
        row["vs_uninterrupted"] = cmp = _run_vs(a, c)
        if not (cmp["params_bitwise"] and cmp["updater_bitwise"]
                and cmp["state_bitwise"]
                and a.iteration_count == c.iteration_count):
            raise AssertionError(f"{what}: the resumed fit differs from the "
                                 f"uninterrupted one: {cmp}")
        # one checkpoint write of the final network by a listener (a
        # stored zip), and deflate's rate on the first 64 MB of its
        # coefficients (the reference's setting)
        timed = CheckpointListener(os.path.join(tmp, "timed"))
        torch.cuda.synchronize()
        timed.on_epoch_end(a)
        path = latest_checkpoint(timed.directory)
        row["checkpoint_write_s"] = timed.write_s[-1]
        row["checkpoint_bytes"] = os.path.getsize(path)
        with zipfile.ZipFile(path) as z:
            raw = z.read("coefficients.bin")[:64 << 20]
        t0 = time.perf_counter()
        import zlib
        zlib.compress(raw, 6)
        row["deflate_mb_per_s"] = len(raw) / 1e6 / (time.perf_counter() - t0)
        del c
        return row, a
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _want_flash(steps, k1=1):
    blocks = TLM["n_blocks"]
    return {"flash_attention_fwd": k1 * blocks * steps,
            "flash_attention_bwd_dq": blocks * steps,
            "flash_attention_bwd_dkv": blocks * steps}


def listeners_resume_phase():
    """Phase 12e: training listeners and the resumable fit at full width.
    ``_TLM`` (f32 masters, bf16 compute, Adam(3e-4), B 8) through
    ``fit_with_checkpointing``: per step with saves every 4 batches over
    16, stopped after batch 10 and resumed from step 8; in windows of 4
    over 2 epochs with epoch saves, stopped in epoch 2 and resumed; a
    ``PerformanceListener`` and a ``ProfilerListener`` on the windowed
    fit. ResNet-50 (phase 12b's, f32, B 32) over 6 batches with saves
    every 2, stopped after 4 and resumed: its ``state.bin`` too. Every
    resumed run is bitwise the uninterrupted one (deterministic
    algorithms; cuDNN's for ResNet-50)."""
    batches = _tlm_window_batches()
    make = lambda: _tlm_amp().init(seed=SEED + 41)
    out = {}
    with _deterministic_algorithms():
        perf1 = PerformanceListener(frequency=RESUME_EVERY)
        row, _ = _resume_case(make, batches, "tlm_per_step", 1, RESUME_STOP,
                              listeners=(perf1,),
                              every_n_iterations=RESUME_EVERY)
        # each report's interval holds the save of the step before it
        row["performance_records"] = perf1.history
        steps = {"launches_uninterrupted": WINDOW_BATCHES,
                 "launches_resumed": WINDOW_BATCHES - 2 * RESUME_EVERY}
        for key, n in steps.items():
            if row[key] != _want_flash(n):
                raise AssertionError(f"tlm_per_step {key}: {row[key]}, not "
                                     f"{_want_flash(n)}")
        if row["resumed_from"] != "checkpoint_epoch0_step8.zip":
            raise AssertionError(f"resumed from {row['resumed_from']}")
        out["tlm_per_step"] = row
        perf = PerformanceListener(frequency=RESUME_K)
        trace_dir = tempfile.mkdtemp(prefix="dl4j_trace_")
        prof = ProfilerListener(trace_dir, start_iteration=RESUME_K,
                                n_iterations=RESUME_K)
        try:
            row, a = _resume_case(make, batches, "tlm_windows", 2, 6,
                                  stop_epoch=1, listeners=(perf, prof),
                                  steps_per_dispatch=RESUME_K)
            for key, n in (("launches_uninterrupted", 2 * WINDOW_BATCHES),
                           ("launches_resumed", WINDOW_BATCHES)):
                if row[key] != _want_flash(n):
                    raise AssertionError(f"tlm_windows {key}: {row[key]}, "
                                         f"not {_want_flash(n)}")
                g = row[key.replace("launches", "graph")]
                if (g["captures"], g["replays"]) != (1, n - 1):
                    raise AssertionError(f"tlm_windows {key}: {g}")
            if row["resumed_from"] != "checkpoint_epoch1.zip":
                raise AssertionError(f"resumed from {row['resumed_from']}")
            pre = a._solver_inst.prefetcher
            row["performance_records"] = perf.history
            row["prefetch_total_wait_ms_last_epoch"] = pre.total_wait_ms
            row["prefetch_etl_wait_ms_per_batch"] = \
                pre.etl_wait_ms_per_batch()
            its = [r["iteration"] for r in perf.history]
            if not perf.history or any(i % RESUME_K != RESUME_K - 1
                                       for i in its) or any(
                    r["steps_per_dispatch"] != float(RESUME_K)
                    for r in perf.history) or not all(
                    math.isfinite(r["etl_wait_ms_per_iteration"])
                    and r["etl_wait_ms_per_iteration"] >= 0
                    for r in perf.history):
                raise AssertionError(f"performance records: {perf.history}")
            if prof.trace_path is None:
                raise AssertionError("the ProfilerListener wrote no trace")
            with open(prof.trace_path) as f:
                events = json.load(f).get("traceEvents", [])
            flash = [e for e in events if "flash_fwd" in str(e.get("name"))]
            row["profiler_trace_events"] = len(events)
            row["profiler_flash_fwd_events"] = len(flash)
            row["profiler_trace_bytes"] = os.path.getsize(prof.trace_path)
            if not flash:
                raise AssertionError("the ProfilerListener's trace holds no "
                                     "flash_attention_fwd kernel")
            del a
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        out["tlm_windows"] = row
    torch.cuda.empty_cache()
    rbatches = _resnet_batches(RESNET_RESUME_BATCHES, SEED + 80)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        row, _ = _resume_case(
            lambda: resnet50(**RESNET, updater=Adam(1e-3)).init(
                seed=SEED + 50), rbatches, "resnet50", 1, RESNET_RESUME_STOP,
            counted={}, every_n_iterations=RESNET_RESUME_EVERY)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    if row["resumed_from"] != "checkpoint_epoch0_step4.zip":
        raise AssertionError(f"resnet50 resumed from {row['resumed_from']}")
    out["resnet50"] = row
    torch.cuda.empty_cache()
    out["launches"] = {n: sum(out[r][k][n] for r in ("tlm_per_step",
                                                     "tlm_windows")
                              for k in ("launches_uninterrupted",
                                        "launches_resumed"))
                       for n in COUNTED}
    for r in (out["tlm_per_step"], out["tlm_windows"]):
        r["ms_a_step_by_report"] = [
            (h["iteration"], 1e3 / h["batches_per_sec"],
             h["etl_wait_ms_per_iteration"], h["steps_per_dispatch"])
            for h in r["performance_records"]]
    log("listeners + resume phase:", {
        k: {m: v for m, v in r.items() if m != "performance_records"}
        for k, r in out.items() if isinstance(r, dict) and "run" in r})
    return out


# ----------------------------------------------------------------- phase 17b
DP_OPT_BATCHES, DP_OPT_K, DP_SMALL_BUCKET = 8, 4, 1 << 16
AVG_WORKERS, AVG_FREQ, AVG_BATCHES = 4, 3, 6
# the averaging run is held to the CPU twice: with Sgd(1e-3), which has no
# updater state, at 1e-5; and with the char-RNN's own RmsProp(1e-3), whose
# state average_updaters averages, at phase 9's pin for the same model and
# updater, 1e-4. RmsProp divides a gradient by its running rms, so an
# element whose gradient is float noise moves by ~lr in the noise's
# direction (the first card-vs-CPU reading was 2.41e-5, on a peephole
# vector); a float64 CPU run of that case shows how far each float32 run
# is from it
AVG_LR, AVG_TOL, AVG_RMS_TOL = 1e-3, 1e-5, 1e-4


def _dp_batches(n, seed):
    """``n`` seeded batches of B 8 token sequences on the card with
    bench.py's labels."""
    V, T = TLM["vocab_size"], TLM["max_length"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randint(0, V, (TRAIN_B, T), device="cuda", generator=gen)
        out.append(DataSet(x, _one_hot_prev(x, V, torch.float32)))
    return out


def _dp_run(batches, what, net=None, skip=0, shape=None, **kw):
    """``_TLM`` f32 (phase 17's) on ``DP_WORKERS`` logical workers (or a
    ``mesh_shape``, ``shape``) through ``ParallelWrapper(**kw).fit`` over
    ``batches``, counted (eager launches plus captured x replays) and
    timed a dispatch; returns (net, wrapper, row)."""
    net = net if net is not None else _tlm_f32(SEED + 24)
    pw = ParallelWrapper(net, mesh_shape=shape, **kw) if shape else \
        ParallelWrapper(net, mesh=make_mesh((DP_WORKERS,), ("data",)), **kw)
    k = kw.get("steps_per_dispatch", 1)
    clock = _WindowClock(k)
    net.set_listeners(clock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g0 = pw.graph_stats()
    _reset_launches()
    pw.fit(ListDataSetIterator(batches), skip_first_batches=skip)
    torch.cuda.synchronize()
    eager, g1 = _launches(), pw.graph_stats()
    launches = {n: eager[n] + g1["launches_in_replays"].get(n, 0)
                - g0["launches_in_replays"].get(n, 0) for n in COUNTED}
    stamps = [t0] + clock.t
    ms = [(b - a) * 1e3 / k for a, b in zip(stamps, stamps[1:])]
    net.set_listeners()
    losses = [float(v) for v in clock.losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return net, pw, {"run": what, "options": {k: v for k, v in kw.items()
                                              if k != "step_callback"},
                     "losses": losses, "step_ms": ms,
                     "step_ms_p50": float(np.median(ms[1:] or ms)),
                     "launches": launches, "graph": g1}


def _want_dp(steps):
    n = TLM["n_blocks"] * DP_WORKERS * steps
    return {name: n for name in COUNTED}


def _zero_tree(net):
    return {"params": net.param_dicts(), "state": net.state_dicts(),
            "opt": net.opt_state}


def _avg_char_run(device, batches, updater, weights=None,
                  dtype="float32"):
    """The char-RNN (phase 8's width) with ``updater`` under K-step
    averaging on ``AVG_WORKERS`` logical workers on ``device``, from
    ``weights`` (the card's seeded init when None); returns the net, the
    losses the listener saw and the starting weights."""
    net = text_generation_lstm(**CHAR, device=device, updater=updater,
                               dtype=dtype).init(seed=SEED + 90)
    if weights is not None:
        load_jax_params(net, weights)
    weights = [{n: p.detach().cpu().clone().numpy() for n, p in pd.items()}
               for pd in net.param_dicts().values()]
    pw = ParallelWrapper(net, mesh=make_mesh((AVG_WORKERS,), ("data",),
                                             device),
                         training_mode="averaging",
                         averaging_frequency=AVG_FREQ, average_updaters=True)
    rec = _Losses()
    net.set_listeners(rec)
    pw.fit(ListDataSetIterator(batches))
    net.set_listeners()
    return net, [float(v) for v in rec.losses], weights


def dp_options_phase():
    """Phase 17b: the data-parallel options at ``_TLM``'s width (f32,
    Adam(3e-4), 4 logical workers, B 8): ZeRO stages 1 and 2 and
    ``overlap_sync`` (the default bucket and a 64 KB one) bitwise the plain
    sync wrapper over 8 batches, parameters and gathered updater state;
    the updater state's bytes a worker; ``steps_per_dispatch=4`` (the
    wrapper's step as a CUDA graph) on plain sync and ZeRO-2 bitwise their
    per-step runs; an ``AsyncCheckpointWriter`` submitting the ZeRO state
    every 2 steps, a crash after step 5, the newest complete save restored
    into a fresh wrapper and trained to step 8, bitwise the uninterrupted
    ZeRO-2 run; that save re-sharded onto 2 workers (``make_zero_resharder``)
    with the same gathered state. Then K-step averaging (K 3) of the
    char-RNN on 4 workers over 6 batches (K5, K6), with Sgd and with
    RmsProp, against the CPU's plain versions from the same weights."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        flat_opt_state_order
    from deeplearning4j_tpu_torch.parallel.zero import (ZeroUpdateEngine,
                                                        make_zero_resharder)
    from deeplearning4j_tpu_torch.util.async_checkpoint import \
        AsyncCheckpointWriter
    from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
        latest_sharded_step, restore_latest_sharded_checkpoint,
        tree_flatten)
    batches = _dp_batches(DP_OPT_BATCHES, SEED + 60)
    out, runs = {}, {}

    def snap(net):
        return ([p.detach().clone() for p in net.parameters()],
                [t.clone() for *_, t in flat_opt_state_order(net)])

    def same(got, want):
        return len(got) == len(want) and all(torch.equal(u, v)
                                             for u, v in zip(got, want))

    with _deterministic_algorithms():
        net, _, runs["plain_sync"] = _dp_run(batches, "plain_sync")
        plain = snap(net)
        del net
        for what, kw in (("zero1", dict(zero_stage=1)),
                         ("zero2", dict(zero_stage=2)),
                         ("overlap", dict(overlap_sync=True)),
                         ("overlap_64k", dict(overlap_sync=True,
                                              bucket_bytes=DP_SMALL_BUCKET))):
            net, pw, row = _dp_run(batches, what, **kw)
            if kw.get("zero_stage"):
                eng = pw._zero()
                row["updater_bytes_a_worker"] = {
                    "replicated": eng.replicated_state_bytes,
                    "zero": eng.shard_state_bytes,
                    "ratio": eng.replicated_state_bytes
                    / eng.shard_state_bytes}
                row["groups"], row["buckets"] = (len(eng.groups),
                                                 eng.num_reduce_launches)
                if what == "zero2":
                    zero2 = ([p.detach().clone() for p in net.parameters()],
                             [t.clone() for t in _opt_tensors(net)])
                pw.gather_opt_state()
            else:
                row["buckets"] = len(pw._grad_schedule())
            got = snap(net)
            row["params_bitwise_plain"] = same(got[0], plain[0])
            row["updater_bitwise_plain"] = same(got[1], plain[1])
            runs[what] = row
            if not (row["params_bitwise_plain"]
                    and row["updater_bitwise_plain"]):
                raise AssertionError(f"{what} differs from plain sync: "
                                     f"{row}")
            del net, pw
            torch.cuda.empty_cache()
        ratio = runs["zero2"]["updater_bytes_a_worker"]["ratio"]
        if not 0.9 * DP_WORKERS <= ratio <= DP_WORKERS:
            raise AssertionError(f"ZeRO's updater bytes a worker: {ratio}x")
        for what, kw, want in (
                ("plain_sync_windows", dict(steps_per_dispatch=DP_OPT_K),
                 plain),
                ("zero2_windows", dict(zero_stage=2,
                                       steps_per_dispatch=DP_OPT_K), None)):
            net, pw, row = _dp_run(batches, what, **kw)
            g = row["graph"]
            if (g["captures"], g["replays"]) != (1, DP_OPT_BATCHES - 1):
                raise AssertionError(f"{what}: graphs {g}")
            if want is None:
                row["params_bitwise_per_step"] = same(
                    [p.detach() for p in net.parameters()], zero2[0])
                row["updater_bitwise_per_step"] = same(
                    _opt_tensors(net), zero2[1])
            else:
                got = snap(net)
                row["params_bitwise_per_step"] = same(got[0], want[0])
                row["updater_bitwise_per_step"] = same(got[1], want[1])
            runs[what] = row
            if not (row["params_bitwise_per_step"]
                    and row["updater_bitwise_per_step"]):
                raise AssertionError(f"{what} differs from its per-step run")
            del net, pw
            torch.cuda.empty_cache()
        for what, row in runs.items():
            if row["launches"] != _want_dp(DP_OPT_BATCHES):
                raise AssertionError(f"{what} launched {row['launches']}, "
                                     f"not {_want_dp(DP_OPT_BATCHES)}")
        # asynchronous checkpoints of the ZeRO-2 run and a crash
        tmp = tempfile.mkdtemp(prefix="dl4j_async_")
        try:
            writer = AsyncCheckpointWriter(tmp, keep_last=2)
            submitted = []

            def callback(net, k):
                if net.iteration_count % 2 == 0:
                    eng = cb_pw._zero()
                    submitted.append((net.iteration_count, writer.submit(
                        net.iteration_count, _zero_tree(net),
                        extra={"iterations_done": net.iteration_count},
                        sharding=eng.sharding_meta())))
                if net.iteration_count == 5:
                    raise _StopAfter.Crash("stopped after step 5")

            b = _tlm_f32(SEED + 24)
            cb_pw = ParallelWrapper(b, mesh=make_mesh((DP_WORKERS,),
                                                      ("data",)),
                                    zero_stage=2, step_callback=callback)
            _reset_launches()
            try:
                cb_pw.fit(ListDataSetIterator(batches))
            except _StopAfter.Crash:
                pass
            else:
                raise AssertionError("the ZeRO fit did not stop")
            torch.cuda.synchronize()
            stopped = _launches()
            t0 = time.perf_counter()
            writer.flush()
            flush_s = time.perf_counter() - t0
            writer.close()
            if writer.last_error is not None:
                raise AssertionError(f"async write: {writer.last_error}")
            step = latest_sharded_step(tmp)
            del b, cb_pw
            torch.cuda.empty_cache()
            c = _tlm_f32(SEED + 99)
            pw_c = ParallelWrapper(c, mesh=make_mesh((DP_WORKERS,),
                                                     ("data",)),
                                   zero_stage=2)
            c.opt_state = pw_c._zero().init_opt_state()
            got_step, tree, extra = restore_latest_sharded_checkpoint(
                tmp, _zero_tree(c))
            with torch.no_grad():
                for u, v in zip(tree_flatten(_zero_tree(c))[0],
                                tree_flatten(tree)[0]):
                    u.copy_(v)
            c.iteration_count = int(extra["iterations_done"])
            _, _, row = _dp_run(batches, "zero2_async_resumed", net=c,
                                skip=c.iteration_count, zero_stage=2)
            row.update({"submitted": submitted, "newest_complete": step,
                        "restored_step": got_step,
                        "write_ms": writer.write_ms, "flush_s": flush_s,
                        "stopped_run_launches": stopped,
                        "save_bytes": sum(
                            os.path.getsize(os.path.join(tmp, f))
                            for f in os.listdir(tmp)
                            if f.startswith(f"ckpt_step{step}_"))})
            row["params_bitwise_uninterrupted"] = same(
                [p.detach() for p in c.parameters()], zero2[0])
            row["updater_bitwise_uninterrupted"] = same(_opt_tensors(c),
                                                        zero2[1])
            if not (row["params_bitwise_uninterrupted"]
                    and row["updater_bitwise_uninterrupted"]
                    and got_step == step == 4 and c.iteration_count
                    == DP_OPT_BATCHES
                    and row["launches"] == _want_dp(DP_OPT_BATCHES - 4)
                    and stopped == _want_dp(5)):
                raise AssertionError(f"async checkpoint resume: {row}")
            # the same save re-sharded onto 2 workers
            eng4 = pw_c._zero()
            _, tree4, _ = restore_latest_sharded_checkpoint(
                tmp, dict(_zero_tree(c), opt=eng4.init_opt_state()))
            eng2 = ZeroUpdateEngine.from_net(c, make_mesh((2,), ("data",)),
                                             stage=2)
            step2, tree2, _ = restore_latest_sharded_checkpoint(
                tmp, dict(_zero_tree(c), opt=eng2.init_opt_state()),
                resharder=make_zero_resharder(eng2))
            eng2.check_state(tree2["opt"])
            a4 = tree_flatten(eng4.unshard_opt_state(tree4["opt"]))[0]
            a2 = tree_flatten(eng2.unshard_opt_state(tree2["opt"]))[0]
            row["reshard_to_2_bitwise"] = same(a2, a4)
            if not row["reshard_to_2_bitwise"] or step2 != 4:
                raise AssertionError("the 2-worker reshard differs")
            runs["zero2_async_resumed"] = row
            del c, pw_c, tree, tree4, tree2
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    # K-step averaging of the char-RNN, card (K5, K6) against the CPU,
    # with Sgd and with RmsProp
    cbatches = [DataSet(*_char_batch(SEED + 91 + i, CHAR_B, CHAR_T))
                for i in range(AVG_BATCHES)]
    updaters = {"sgd": lambda: Sgd(AVG_LR), "rmsprop": lambda: RmsProp(AVG_LR)}
    _reset_launches()
    gpu = {k: _avg_char_run("cuda", cbatches, u()) for k, u in
           updaters.items()}
    torch.cuda.synchronize()
    avg_launches = _launches(LSTM_COUNTED)
    want_lstm = 2 * AVG_WORKERS * AVG_BATCHES * len(updaters)
    out["averaging"] = {
        "model": "text_generation_lstm vocab 87 hidden 512 f32, 4 workers, "
                 "averaging_frequency 3, average_updaters",
        "batches": AVG_BATCHES, "batch": CHAR_B, "seq_len": CHAR_T,
        "launches": avg_launches}
    named = lambda net: {f"{i}.{n}": p.detach().cpu()
                         for i, pd in net.param_dicts().items()
                         for n, p in pd.items()}
    bad = avg_launches != {n: want_lstm for n in LSTM_COUNTED}
    for key, make in updaters.items():
        g_net, gl, weights = gpu[key]
        t0 = time.perf_counter()
        c_net, cl, _ = _avg_char_run("cpu", cbatches, make(), weights)
        cpu_s = time.perf_counter() - t0
        g, c = named(g_net), named(c_net)
        worst = max(g, key=lambda n: _rel_to_max(g[n], c[n]))
        opt = [(u.cpu(), v) for (*_, u), (*_, v) in zip(
            flat_opt_state_order(g_net), flat_opt_state_order(c_net))]
        row = {"updater": f"{type(make()).__name__}({AVG_LR})",
               "losses_card": gl, "losses_cpu": cl, "cpu_s": cpu_s,
               "param_rel_to_max": _rel_to_max(g[worst], c[worst]),
               "worst_param": worst,
               "updater_state_rel_to_max": max(
                   (_rel_to_max(u, v) for u, v in opt), default=0.0),
               "iterations": g_net.iteration_count}
        tol = AVG_TOL if key == "sgd" else AVG_RMS_TOL
        row["tolerance"] = tol
        if key == "rmsprop":
            # the cause of the gap: the float64 run, and the element that
            # differs most, from its start
            t0 = time.perf_counter()
            d_net, _, _ = _avg_char_run("cpu", cbatches, make(), weights,
                                        dtype="float64")
            row["cpu_f64_s"] = time.perf_counter() - t0
            d = named(d_net)
            row["card_vs_f64_rel_to_max"] = max(
                _rel_to_max_f64(g[n], d[n]) for n in g)
            row["cpu_vs_f64_rel_to_max"] = max(
                _rel_to_max_f64(c[n], d[n]) for n in g)
            w = weights[int(worst.split(".")[0])][worst.split(".")[1]]
            k = int((g[worst] - c[worst]).abs().argmax())
            row["worst_element"] = {
                "index": k, "start": float(w.reshape(-1)[k]),
                "card": float(g[worst].reshape(-1)[k]),
                "cpu": float(c[worst].reshape(-1)[k]),
                "cpu_f64": float(d[worst].reshape(-1)[k])}
            del d_net
        out["averaging"][key] = row
        bad = bad or (row["param_rel_to_max"] > tol
                      or row["updater_state_rel_to_max"] > tol
                      or row["iterations"] != AVG_BATCHES)
        del g_net, c_net
    if bad:
        raise AssertionError(f"K-step averaging: {out['averaging']}")
    del gpu
    out["runs"] = runs
    out["launches"] = {n: sum(r["launches"][n] for r in runs.values())
                       + runs["zero2_async_resumed"][
                           "stopped_run_launches"][n] for n in COUNTED}
    log("data-parallel options phase:", {
        k: {m: v for m, v in r.items() if m not in ("losses", "step_ms")}
        for k, r in runs.items()}, out["averaging"])
    return out


# ----------------------------------------------------------------- phase 17c
# the model axis at _TLM's width: (2, 2) against (4,) plain sync, 8 batches
TP_BATCHES, TP_K = 8, 4
# what one rank holds at _TLM on (2, 2): 37,773,312 of the 42,533,888
# parameters fall under the rules, so a rank holds 23,647,232 of them
TP_PARAM_BYTES = 4 * (42_533_888 - 37_773_312 // 2)
TP_ADAM_BYTES = 2 * TP_PARAM_BYTES
TP_LOSS_TOL, TP_PARAM_TOL = 1e-5, 1e-4
# the parameters after 8 Adam steps are gated in float64: in float32 the
# (2, 2) run's GEMMs round other than (4,)'s and the two runs' Adam
# parameters part by 5.16e-3 rel-to-max on the card (the float32 distance
# is reported beside the float64 one). The float32 kernel path is held
# under a parameter gate by Sgd, whose update is -lr times the summed
# gradients: the same 8 batches, parameters at 1e-5 and each parameter's
# summed applied gradient at 1e-4
TP_SGD_LR, TP_SGD_PARAM_TOL, TP_SGD_UPDATE_TOL = 1e-4, 1e-5, 1e-4
# head-sharded generation: phase 3's net and requests on a (1, 2) mesh;
# a step whose unsharded top-2 margin is under 1e-4 relative is a tie
TP_TIE, TP_LOGIT_TOL = 1e-4, 1e-5
# GoogLeNet (phase 11's) served on 4 data workers
TP_SERVE_BUCKETS, TP_SERVE_SIZES = (8, 32), (3, 8, 20, 32)
# GPipe: 4 _TLM-width blocks, B 8 in 4 microbatches of 2 at T 1024
PIPE_STAGES, PIPE_MICRO, PIPE_TOL = 4, 4, 1e-4
# the char-RNN (phase 8's width) on a model axis, 4 batches, Sgd
TP_CHAR_BATCHES, TP_CHAR_TOL = 4, 1e-5
# experts: top-2 over 8 experts of width 512/2048 on 4096 tokens; at a
# capacity factor of 4 (4096 slots an expert) no token is dropped, at 1
# (1024 slots, the mean load) the experts overflow
EXPERTS = dict(n=8, d=512, d_ff=2048, tokens=4096, top_k=2,
               capacity_factor=4.0)
EXPERT_TIGHT_CAPACITY = 1.0
EXPERT_TOL, EXPERT_GRAD_TOL = 1e-5, 1e-4


def _tp_flat(net):
    """Every parameter as its global tensor on the host, in
    ``flat_param_order``."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        flat_param_order
    tree = net.param_dicts()
    whole = host_gather(tree, tree_specs(net, tree))
    return [whole[g][k] for g, k, _ in flat_param_order(net)]


def _tp_opt(net):
    """Every updater-state leaf as its global tensor on the host, in
    ``flat_opt_state_order`` (after a ZeRO state was gathered)."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        flat_opt_state_order
    whole = host_gather(net.opt_state, tree_specs(net, net.opt_state))
    return [whole[g][k][sk] for g, k, sk, _ in flat_opt_state_order(net)]


def _tp_rows(net):
    """How many of ``net``'s parameters are held as a model axis' rows."""
    return sum(bool(s) for sd in held_specs(net).values()
               for s in sd.values())


def _tp_vs(got, want, rel=None):
    """The worst parameter's rel-to-max between two ``_tp_flat`` lists."""
    return max((rel or _rel_to_max)(a, b) for a, b in zip(got, want))


def _tp_names(net):
    """``group.name`` of every parameter, in ``flat_param_order``."""
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        flat_param_order
    return [f"{g}.{k}" for g, k, _ in flat_param_order(net)]


def _tp_worst(got, want, names):
    """(rel-to-max, name) of the parameter where two ``_tp_flat`` lists
    differ most."""
    return max((_rel_to_max(a, b), n) for a, b, n in zip(got, want, names))


def _tp_train(batches):
    """(a) ``_TLM`` f32 through ``ParallelWrapper(mesh_shape=(2, 2))``: per
    step, in windows of 4 (the wrapper's step as a CUDA graph) and with
    ZeRO-2 over the data axis, each against the ``(4,)`` plain sync run
    from the same start; ``(4, 1)`` bitwise ``(4,)``; the windows bitwise
    their per-step ``(2, 2)`` run; one rank's bytes of the parameters and
    of the Adam state."""
    runs = {}

    def same(got, want):
        return len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
    with _deterministic_algorithms():
        net, _, runs["plain_4"] = _dp_run(batches, "plain_4", shape=(4,))
        base = _tp_flat(net)
        del net
        net, _, runs["mesh_4x1"] = _dp_run(batches, "mesh_4x1",
                                           shape=(4, 1))
        runs["mesh_4x1"]["bitwise_plain_4"] = same(_tp_flat(net), base)
        del net
        net, _, row = _dp_run(batches, "mesh_2x2", shape=(2, 2))
        per_step = (_tp_flat(net), _tp_opt(net))
        params, opt = net.param_dicts(), net.opt_state
        row["param_bytes_a_rank"] = per_replica_bytes(
            params, tree_specs(net, params))
        row["adam_bytes_a_rank"] = per_replica_bytes(
            opt, tree_specs(net, opt))
        row["sharded_leaves"] = _tp_rows(net)
        runs["mesh_2x2"] = row
        del net, params, opt
        net, _, row = _dp_run(batches, "mesh_2x2_windows", shape=(2, 2),
                              steps_per_dispatch=TP_K)
        row["bitwise_per_step"] = same(_tp_flat(net), per_step[0]) \
            and same(_tp_opt(net), per_step[1])
        runs["mesh_2x2_windows"] = row
        del net
        net, pw, row = _dp_run(batches, "mesh_2x2_zero2", shape=(2, 2),
                               zero_stage=2)
        pw.gather_opt_state()
        zero = _tp_flat(net)
        row["bitwise_per_step"] = same(zero, per_step[0]) \
            and same(_tp_opt(net), per_step[1])
        runs["mesh_2x2_zero2"] = row
        names = _tp_names(net)
        runs["mesh_2x2"]["worst_param_float32"] = _tp_worst(per_step[0],
                                                            base, names)
        del net, pw
        # float32 Sgd, whose update is -lr times the summed gradients:
        # (2, 2) against (4,), the parameters and each parameter's summed
        # applied gradient (the update without the parameters' rounding)
        sgd = {}
        for what, shape in (("sgd_4", (4,)), ("sgd_2x2", (2, 2))):
            net = transformer_lm(**TLM, token_input=True,
                                 updater=Sgd(TP_SGD_LR)).init(seed=SEED + 24)
            summed, apply = {}, net.updater.update

            def update(grads, opt_state, params, it, apply=apply,
                       summed=summed, net=net):
                held = held_specs(net)
                for g, gd in grads.items():
                    for k, v in gd.items():
                        t = full(v, held[g][k]).detach()
                        key = f"{g}.{k}"
                        summed[key] = summed[key] + t if key in summed \
                            else t.clone()
                return apply(grads, opt_state, params, it)
            net.updater.update = update
            net, _, runs[what] = _dp_run(batches, what, net=net, shape=shape)
            net.updater.update = apply
            sgd[what] = (_tp_flat(net), summed)
            del net, update
        # the same 8 steps in float64, (2, 2) against (4,)
        f64 = {}
        for shape in ((4,), (2, 2)):
            net = transformer_lm(**TLM, token_input=True, dtype="float64",
                                 updater=Adam(3e-4)).init(seed=SEED + 24)
            ParallelWrapper(net, mesh_shape=shape).fit(
                ListDataSetIterator(batches))
            f64[shape] = _tp_flat(net)
            del net
    torch.cuda.empty_cache()
    want = {n: TLM["n_blocks"] * 2 * TP_BATCHES for n in COUNTED}
    bad = []
    pairs = [(w, "plain_4") for w in ("mesh_2x2", "mesh_2x2_windows",
                                      "mesh_2x2_zero2")]
    for what, ref in pairs + [("sgd_2x2", "sgd_4")]:
        r = runs[what]
        r["loss_rel_" + ref] = max(
            abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                runs[ref]["losses"]))
        if r["launches"] != want:
            bad.append(f"{what} launched {r['launches']}, not {want}")
        if r["loss_rel_" + ref] > TP_LOSS_TOL:
            bad.append(f"{what}: losses rel {r['loss_rel_' + ref]:.3g}")
    for what, got in (("mesh_2x2", per_step[0]), ("mesh_2x2_zero2", zero)):
        runs[what]["param_rel_to_max_plain_4_float32"] = _tp_vs(got, base)
    runs["float64"] = {"param_rel_to_max_2x2_vs_4": _tp_vs(
        f64[(2, 2)], f64[(4,)], _rel_to_max_f64), "tolerance": TP_PARAM_TOL}
    if runs["float64"]["param_rel_to_max_2x2_vs_4"] > TP_PARAM_TOL:
        bad.append(f"float64 parameters: {runs['float64']}")
    r = runs["sgd_2x2"]
    r["param_rel_to_max_sgd_4"] = _tp_vs(sgd["sgd_2x2"][0], sgd["sgd_4"][0])
    keys = sorted(sgd["sgd_4"][1])
    r["update_worst_sgd_4"] = _tp_worst(
        [sgd["sgd_2x2"][1][k] for k in keys],
        [sgd["sgd_4"][1][k] for k in keys], keys)
    r["tolerance"] = {"param": TP_SGD_PARAM_TOL,
                      "update": TP_SGD_UPDATE_TOL}
    if r["param_rel_to_max_sgd_4"] > TP_SGD_PARAM_TOL or \
            r["update_worst_sgd_4"][0] > TP_SGD_UPDATE_TOL:
        bad.append(f"float32 Sgd (2, 2) vs (4,): parameters "
                   f"{r['param_rel_to_max_sgd_4']:.3g}, update "
                   f"{r['update_worst_sgd_4']}")
    del sgd
    g = runs["mesh_2x2_windows"]["graph"]
    if (g["captures"], g["replays"]) != (1, TP_BATCHES - 1):
        bad.append(f"windows: graphs {g}")
    if not runs["mesh_4x1"]["bitwise_plain_4"]:
        bad.append("(4, 1) is not bitwise (4,)")
    for what in ("mesh_2x2_windows", "mesh_2x2_zero2"):
        if not runs[what]["bitwise_per_step"]:
            bad.append(f"{what} is not bitwise its per-step (2, 2) run")
    r = runs["mesh_2x2"]
    if (r["param_bytes_a_rank"], r["adam_bytes_a_rank"]) != (
            TP_PARAM_BYTES, TP_ADAM_BYTES):
        bad.append(f"bytes a rank {r['param_bytes_a_rank']}, "
                   f"{r['adam_bytes_a_rank']}")
    if bad:
        raise AssertionError(f"tensor-parallel training: {bad}")
    return runs


def _tp_generation():
    """(b) phase 3's ``_TLM`` (f32) and 8 greedy requests through an
    unsharded engine and a head-sharded one on a (1, 2) mesh: tokens equal
    up to a near tie (and there the two logit rows agree), the pools a
    rank half, the decode step a CUDA graph in both."""
    net = transformer_lm(**TLM, token_input=True).init(seed=SEED)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(300, 901, size=N_REQUESTS)
    prompts = [rng.integers(1, TLM["vocab_size"], size=int(n)).tolist()
               for n in lens]
    out = {}
    for what, mesh in (("unsharded", None),
                       ("head_sharded", make_mesh((1, 2),
                                                  ("data", "model")))):
        eng = GenerationEngine(net, **ENGINE, mesh=mesh)
        rt = eng.runtime()
        try:
            fa.flash_attention.launches = 0
            toks = _drive(eng, prompts)
            k1 = fa.flash_attention.launches
            if not rt.wait_idle(60):
                raise AssertionError(f"{what}: the runtime did not go idle")
            snap = eng.metrics()["default"]
            graphs = rt.graph_stats()
            ps = rt.active_ps
            out[what] = {"tokens": toks, "k1_launches": k1,
                         "kv_pool_chip_bytes": ps.kv_pool_chip_bytes,
                         "model_shards": ps.model_shards,
                         "decode_steps": snap["decode_steps"],
                         "decode_step_ms_p50":
                             snap["decode_step_ms"]["p50"],
                         "decode_step_ms_p99":
                             snap["decode_step_ms"]["p99"],
                         "ttft_ms_p50": snap["ttft_ms"]["p50"],
                         "graph": graphs}
            served = ps.served
        finally:
            eng.stop()
        if graphs["replays"] != snap["decode_steps"] or \
                graphs["captures"] != 1:
            raise AssertionError(f"{what}: {graphs} for "
                                 f"{snap['decode_steps']} decode steps")
    sh, un = out["head_sharded"], out["unsharded"]
    ties = []
    cap = ENGINE["max_seq_len"]
    for i, (p, a, b) in enumerate(zip(prompts, sh["tokens"], un["tokens"])):
        if a == b:
            continue
        step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = list(p) + list(b[:step])
        buf = torch.zeros((1, cap), dtype=torch.long, device="cuda")
        buf[0, :len(seq)] = torch.as_tensor(seq)
        with torch.inference_mode():
            lu = net.output(buf)[0, len(seq) - 1].double().log()
            ls = served.output(buf)[0, len(seq) - 1].double().log()
        top = torch.topk(lu, 2).values
        margin = float((top[0] - top[1]) / top[0].abs())
        rel = _rel_to_max_f64(ls, lu)
        ties.append({"request": i, "step": step, "margin_rel": margin,
                     "logits_rel_to_max": rel})
        if margin >= TP_TIE or rel > TP_LOGIT_TOL:
            raise AssertionError(f"head-sharded request {i} differs at step "
                                 f"{step}: {ties[-1]}")
    if sh["kv_pool_chip_bytes"] * 2 != un["kv_pool_chip_bytes"]:
        raise AssertionError(f"pool bytes a rank {sh['kv_pool_chip_bytes']} "
                             f"vs {un['kv_pool_chip_bytes']}")
    if sh["k1_launches"] == 0 or sh["model_shards"] != 2:
        raise AssertionError(f"head-sharded generation: {sh}")
    for r in out.values():
        r["tokens_equal"] = r is un or not ties
        del r["tokens"]
    out["ties"] = ties
    return out


def _tp_serve():
    """(c) phase 11's GoogLeNet served on a mesh of 4 data workers: each
    response equals ``net.output`` of its rows at atol 1e-6, K7 launched
    37 times a worker a batch; a ladder with a rung of 1 refused."""
    net = googlenet(**GNET).init(seed=SEED + 13)
    fwd = lambda n, x: n._output_pure(x)[0]
    mesh = make_mesh((4,), ("data",))
    refused = False
    try:
        InferenceEngine(net, feature_shape=(224, 224, 3),
                        buckets=(1,) + TP_SERVE_BUCKETS, forward_fn=fwd,
                        mesh=mesh)
    except ValueError as e:
        refused = "not divisible" in str(e)
    if not refused:
        raise AssertionError("a ladder with a rung of 1 was not refused on "
                             "a mesh of 4")
    pool = np.random.default_rng(SEED + 14).standard_normal(
        (32, 224, 224, 3)).astype(np.float32)
    eng = InferenceEngine(net, feature_shape=(224, 224, 3),
                          buckets=TP_SERVE_BUCKETS, forward_fn=fwd, mesh=mesh)
    errs = []
    try:
        k7.conv1x1_fused.launches = 0
        t0 = time.perf_counter()
        got = [eng.predict(pool[:n]) for n in TP_SERVE_SIZES]
        wall_s = time.perf_counter() - t0
        launches = k7.conv1x1_fused.launches
        batches = eng.metrics()["default"]["batches"]
    finally:
        eng.stop()
    for n, g in zip(TP_SERVE_SIZES, got):
        want = net.output(pool[:n]).cpu()
        errs.append(float((torch.as_tensor(g) - want).abs().max()))
    if max(errs) > 1e-6 or launches != 37 * 4 * batches or launches == 0:
        raise AssertionError(f"mesh-sharded serving: errors {errs}, K7 "
                             f"{launches} for {batches} batches")
    return {"sizes": list(TP_SERVE_SIZES), "abs_err": errs,
            "k7_launches": launches, "batches": batches, "wall_s": wall_s,
            "ladder_with_1_refused": refused}


def _pipe_block(p, x):
    """One ``_TLM``-width pre-norm block (causal attention through the
    flash kernels, a gelu MLP) as a function of its parameters."""
    d, H = TLM["d_model"], TLM["n_heads"]
    B, T, _ = x.shape
    heads = lambda y: y.view(B, T, H, d // H).transpose(1, 2)
    h = F.layer_norm(x, (d,), p["g1"], p["c1"])
    o = fa.flash_attention(heads(h @ p["Wq"]), heads(h @ p["Wk"]),
                           heads(h @ p["Wv"]), causal=True)
    x = x + o.transpose(1, 2).reshape(B, T, d) @ p["Wo"] + p["bo"]
    h = F.layer_norm(x, (d,), p["g2"], p["c2"])
    return x + F.gelu(h @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"]


def _tp_pipeline():
    """(d) 4 blocks through ``pipeline_apply`` on a mesh of 4 stages (B 8
    in 4 microbatches, T 1024): forward and gradients against the same
    blocks run one after another, rel-to-max 1e-4; K1-K3 launched."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        pipeline_apply, stack_stage_params)
    d, T = TLM["d_model"], TLM["max_length"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=gen,
                                       device="cuda") * sc
    stages = [{"Wq": r(d, d, sc=d ** -0.5), "Wk": r(d, d, sc=d ** -0.5),
               "Wv": r(d, d, sc=d ** -0.5), "Wo": r(d, d, sc=d ** -0.5),
               "bo": r(d, sc=0.02), "g1": 1 + r(d, sc=0.1),
               "c1": r(d, sc=0.1), "g2": 1 + r(d, sc=0.1),
               "c2": r(d, sc=0.1), "W1": r(d, 4 * d, sc=d ** -0.5),
               "b1": r(4 * d, sc=0.02), "W2": r(4 * d, d, sc=(4 * d) ** -0.5),
               "b2": r(d, sc=0.02)} for _ in range(PIPE_STAGES)]
    for st in stages:
        for t in st.values():
            t.requires_grad_(True)
    x = r(PIPE_MICRO, TRAIN_B // PIPE_MICRO, T, d)
    fn = pipeline_apply(_pipe_block, make_mesh((PIPE_STAGES,), ("pipe",)),
                        "pipe")
    leaves = [t for st in stages for t in st.values()]

    def piped():
        y = fn(stack_stage_params(stages), x)
        return y, torch.autograd.grad((y ** 2).mean(), leaves)

    def sequential():
        y = x.reshape(TRAIN_B, T, d)
        for st in stages:
            y = _pipe_block(st, y)
        y = y.reshape(x.shape)
        return y, torch.autograd.grad((y ** 2).mean(), leaves)

    _reset_launches()
    y_p, g_p = piped()
    torch.cuda.synchronize()
    launches = _launches()
    y_s, g_s = sequential()
    out_rel = _rel_to_max(y_p, y_s)
    grad_rel = max(_rel_to_max(a, b) for a, b in zip(g_p, g_s))
    ms = [_time_ms(piped, iters=3, warmup=1), _time_ms(sequential, iters=3,
                                                       warmup=1)]
    want = {n: PIPE_STAGES * PIPE_MICRO for n in COUNTED}
    if out_rel > PIPE_TOL or grad_rel > PIPE_TOL or launches != want:
        raise AssertionError(f"pipeline: out {out_rel:.3g}, gradients "
                             f"{grad_rel:.3g}, launches {launches}")
    return {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
            "micro_batch": TRAIN_B // PIPE_MICRO, "seq_len": T,
            "out_rel_to_max": out_rel, "grad_rel_to_max": grad_rel,
            "launches": launches, "fwd_bwd_ms": ms[0],
            "sequential_fwd_bwd_ms": ms[1]}


def _tp_char():
    """(e) the char-RNN (phase 8's width) with Sgd(1e-3) on (2, 2) against
    (4,), 4 whole-sequence batches: its W/R/b rows are joined before K5
    and K6 run (whole gate blocks cut no unit), so the two runs differ
    only in the data axis' sum; rel-to-max 1e-5."""
    cb = [DataSet(*_char_batch(SEED + 95 + i, CHAR_B, CHAR_T))
          for i in range(TP_CHAR_BATCHES)]
    nets, launches = {}, {}
    for shape in ((4,), (2, 2)):
        net = text_generation_lstm(**CHAR, updater=Sgd(1e-3)).init(
            seed=SEED + 96)
        _reset_launches()
        ParallelWrapper(net, mesh_shape=shape).fit(ListDataSetIterator(cb))
        torch.cuda.synchronize()
        launches[str(shape)] = _launches(LSTM_COUNTED)
        nets[shape] = net
    rel = _tp_vs(_tp_flat(nets[(2, 2)]), _tp_flat(nets[(4,)]))
    rows = _tp_rows(nets[(2, 2)])
    if rel > TP_CHAR_TOL or not all(v > 0 for v in launches["(2, 2)"]
                                    .values()) or rows == 0:
        raise AssertionError(f"char-RNN on (2, 2): rel-to-max {rel:.3g}, "
                             f"launches {launches}, rows leaves {rows}")
    return {"param_rel_to_max": rel, "launches": launches,
            "rows_leaves": rows, "batches": TP_CHAR_BATCHES}


def _tp_experts():
    """(f) top-2 routing over 8 experts (512 -> 2048 -> 512, gelu) of 4096
    tokens through ``expert_parallel_apply``: with room for every token,
    against every token's two experts run densely with the same weights;
    at capacity factor 1, where experts overflow (first choices re-routed
    to their second, tokens dropped), against the same call on the CPU.
    The output and the router's gradient each time."""
    from deeplearning4j_tpu_torch.parallel.expert_parallel import (
        expert_parallel_apply, load_balancing_loss)
    E, d, f, N = (EXPERTS[k] for k in ("n", "d", "d_ff", "tokens"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=gen,
                                       device="cuda") * sc
    stacked = {"W1": r(E, d, f, sc=d ** -0.5), "b1": r(E, f, sc=0.02),
               "W2": r(E, f, d, sc=f ** -0.5), "b2": r(E, d, sc=0.02)}
    tokens, logits = r(N, d), r(N, E)
    expert = lambda p, x: F.gelu(x @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"]
    fn = expert_parallel_apply(expert, make_mesh((E,), ("expert",)),
                               "expert",
                               capacity_factor=EXPERTS["capacity_factor"],
                               top_k=EXPERTS["top_k"])

    def dense(lg):
        probs = torch.softmax(lg, -1)
        top_p, top_e = torch.topk(probs, EXPERTS["top_k"], -1)
        w = top_p / top_p.sum(-1, keepdim=True)
        every = torch.stack([expert({k: v[e] for k, v in stacked.items()},
                                    tokens) for e in range(E)])  # [E, N, d]
        rows = torch.arange(N, device="cuda")
        return sum(every[top_e[:, c], rows] * w[:, c:c + 1]
                   for c in range(EXPERTS["top_k"]))

    got = {}
    for what, run in (("expert_parallel", lambda lg: fn(stacked, tokens, lg)),
                      ("dense", dense)):
        lg = logits.clone().requires_grad_(True)
        t0 = time.perf_counter()
        y = run(lg)
        g, = torch.autograd.grad((y ** 2).mean(), lg)
        torch.cuda.synchronize()
        got[what] = (y.detach(), g, (time.perf_counter() - t0) * 1e3)
    out_rel = _rel_to_max(got["expert_parallel"][0], got["dense"][0])
    grad_rel = _rel_to_max(got["expert_parallel"][1], got["dense"][1])
    if out_rel > EXPERT_TOL or grad_rel > EXPERT_GRAD_TOL or not float(
            got["expert_parallel"][1].abs().max()) > 0:
        raise AssertionError(f"experts: out {out_rel:.3g}, router gradient "
                             f"{grad_rel:.3g}")
    tight = _tp_experts_tight(expert, stacked, tokens, logits)
    return {"config": EXPERTS, "out_rel_to_max": out_rel,
            "router_grad_rel_to_max": grad_rel,
            "fwd_bwd_ms_first": got["expert_parallel"][2],
            "dense_fwd_bwd_ms_first": got["dense"][2],
            "load_balancing_loss": float(load_balancing_loss(
                logits, EXPERTS["top_k"])), "tight_capacity": tight}


def _tp_experts_tight(expert, stacked, tokens, logits):
    """(f) at ``EXPERT_TIGHT_CAPACITY``: the card's ``expert_parallel_apply``
    against the CPU's on the same inputs (the routing's overflow, re-route
    and drop branches run on both); how many choices overflowed, counted
    apart from the routing code (an expert's choices beyond its slots)."""
    from deeplearning4j_tpu_torch.parallel.expert_parallel import \
        expert_parallel_apply
    E, N, k = EXPERTS["n"], EXPERTS["tokens"], EXPERTS["top_k"]
    cap = math.ceil(EXPERT_TIGHT_CAPACITY * k * N / E)
    top_e = torch.topk(logits, k, -1).indices          # softmax is monotone
    per_expert = torch.bincount(top_e.flatten(), minlength=E)
    overflow = int((per_expert - cap).clamp_min(0).sum())
    got = {}
    for dev in ("cuda", "cpu"):
        fn = expert_parallel_apply(
            expert, make_mesh((E,), ("expert",), dev), "expert",
            capacity_factor=EXPERT_TIGHT_CAPACITY, top_k=k)
        lg = logits.to(dev).clone().requires_grad_(True)
        t0 = time.perf_counter()
        y = fn({n: v.to(dev) for n, v in stacked.items()}, tokens.to(dev),
               lg)
        g, = torch.autograd.grad((y ** 2).mean(), lg)
        if dev == "cuda":
            torch.cuda.synchronize()
        got[dev] = (y.detach().cpu(), g.cpu(),
                    (time.perf_counter() - t0) * 1e3)
    out_rel = _rel_to_max(got["cuda"][0], got["cpu"][0])
    grad_rel = _rel_to_max(got["cuda"][1], got["cpu"][1])
    zero_rows = int((got["cuda"][0].abs().amax(-1) == 0).sum())
    row = {"capacity_factor": EXPERT_TIGHT_CAPACITY, "slots": cap,
           "choices_over_capacity": overflow, "tokens_dropped": zero_rows,
           "out_rel_to_max_cpu": out_rel,
           "router_grad_rel_to_max_cpu": grad_rel,
           "fwd_bwd_ms_first": got["cuda"][2],
           "cpu_fwd_bwd_ms": got["cpu"][2]}
    if out_rel > EXPERT_TOL or grad_rel > EXPERT_GRAD_TOL or overflow == 0:
        raise AssertionError(f"experts at a tight capacity: {row}")
    return row


def model_axis_phase():
    """Phase 17c: the model axis on the card (a) to (f) (see the module
    docstring); returns every part's row and the launches on its paths."""
    out = {}
    for part, run in (
            ("train", lambda: _tp_train(_dp_batches(TP_BATCHES, SEED + 61))),
            ("generation", _tp_generation), ("serve", _tp_serve),
            ("pipeline", _tp_pipeline), ("char", _tp_char),
            ("experts", _tp_experts)):
        t0 = time.perf_counter()
        out[part] = run()
        out[part + "_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    tr = out["train"]
    out["launches"] = {
        n: sum(r["launches"][n] for r in tr.values() if "launches" in r)
        + out["pipeline"]["launches"][n] for n in COUNTED}
    out["launches"]["flash_attention_fwd"] += \
        out["generation"]["head_sharded"]["k1_launches"] \
        + out["generation"]["unsharded"]["k1_launches"]
    out["launches"].update({n: sum(v[n] for v in
                                   out["char"]["launches"].values())
                            for n in LSTM_COUNTED})
    out["launches"]["conv1x1_bias_relu"] = out["serve"]["k7_launches"]
    log("model axis phase:", {
        "train": {w: {k: v for k, v in r.items()
                      if k not in ("losses", "step_ms", "graph")}
                  for w, r in tr.items()},
        **{k: v for k, v in out.items() if k != "train"}})
    return out


# ---------------------------------------------------------------- phase 17d
# the elastic trainer on _TLM (f32, Adam(3e-4), 4 logical workers, B 8):
# 12 steps over an epoch of 8 batches, a save every 4 steps, the newest 2
# kept; the (2, 2) shrink under Sgd at 17c's float32 pin
EL_BATCHES, EL_STEPS, EL_EVERY, EL_KEEP, EL_K = 8, 12, 4, 2, 4
EL_KILL, EL_WINDOW_KILL, EL_PREEMPT, EL_SHRINK_KILL = 9, 10, 5, 6
EL_SGD_TOL = 1e-5
# degraded mode: a 400 ms collective over steps [2, 6) against a 50 ms
# budget; with a latency window of 2, averaging windows of 4 and an exit
# patience of 2 the loop enters averaging at step 2 and leaves it at step 8
# (the window [2, 6) ends at 6, the epoch's rest [6, 8) at 8)
EL_SLOW = dict(step=2, until_step=6, delay_ms=400.0)
EL_DEGRADED = dict(sync_latency_budget_ms=50.0, latency_window=2,
                   degraded_averaging_window=4, degraded_exit_patience=2)
EL_MODES = [(2, "averaging"), (8, "sync")]
EL_SYNC_STEPS = 8
# ParallelInference and the legacy model server over phase 11's GoogLeNet
PI_LIMIT, PI_RESP_TOL = 32, 1e-5
# the streamed char-RNN: phase 8's width, whole 64-step sequences (one
# tBPTT chunk each), 6 batches
STREAM_BATCHES = 6
DIST_STEPS = 4


def _elastic_trainer(net, d, **kw):
    """An ``ElasticTrainer`` over 4 workers that records every wrapper it
    makes (a recovery drops them; their graphs' launches still count)."""
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    tr = ElasticTrainer(net, checkpoint_dir=d, devices=[0, 1, 2, 3],
                        checkpoint_every_n_steps=EL_EVERY,
                        keep_last=EL_KEEP, **kw)
    tr.made = []
    make = tr._wrapper

    def wrapper():
        pw = make()
        if all(pw is not w for w in tr.made):
            tr.made.append(pw)
        return pw
    tr._wrapper = wrapper
    return tr


def _elastic_run(trainer, batches, what, steps=EL_STEPS, clock_k=None):
    """``trainer.fit`` over ``batches`` to ``steps``, counted: each counted
    kernel's eager launches plus its launches in the replays of every
    wrapper the trainer made; the steps the network ran (a listener's
    losses: recovered steps run twice) and their ms."""
    net = trainer.net
    clock = _WindowClock(clock_k) if clock_k else _Losses()
    net.set_listeners(clock)
    g0 = {id(pw): pw.graph_stats() for pw in trainer.made}
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    trainer.fit(ListDataSetIterator(batches), num_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eager = _launches()
    replayed = {n: 0 for n in COUNTED}
    for pw in trainer.made:
        g = pw.graph_stats()["launches_in_replays"]
        before = g0.get(id(pw), {"launches_in_replays": {}})
        for n in COUNTED:
            replayed[n] += g.get(n, 0) - before[
                "launches_in_replays"].get(n, 0)
    net.set_listeners()
    losses = [float(v) for v in clock.losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses {losses}")
    row = {"run": what, "steps_run": len(losses),
           "steps_done": trainer.steps_done,
           "recoveries": trainer.recoveries,
           "mode_history": trainer.mode_history,
           "preempted": trainer.preempted,
           "last_recovery_ms": trainer.last_recovery_ms,
           "workers": len(trainer._devices),
           "mesh": list(trainer._mesh.axis_sizes), "wall_s": wall,
           "launches": {n: eager[n] + replayed[n] for n in COUNTED},
           "losses": losses}
    if clock_k:
        stamps = [t0] + clock.t
        ms = [(b - a) * 1e3 / clock_k for a, b in zip(stamps, stamps[1:])]
        row.update(step_ms=ms, step_ms_p50=float(np.median(ms[1:] or ms)))
    return row


def _el_state(net):
    """Parameters and updater state on the host, for bitwise checks."""
    return ([p.detach().cpu().clone() for p in net.parameters()],
            [t.detach().cpu().clone() for t in _opt_tensors(net)])


def _el_same(a, b):
    return all(len(x) == len(y) and all(torch.equal(u, v)
                                        for u, v in zip(x, y))
               for x, y in zip(a, b))


def _sync_watch(thread=None):
    """``telemetry.HostSyncDetector(sync_debug=True)``, counting: the
    synchronising calls (``torch.cuda.set_sync_debug_mode("warn")``) and
    host reads that ``thread`` (default: this one, the loop's) makes; a
    writer thread's are its design and are not counted. Earlier runs'
    garbage (a dropped wrapper's CUDA graph) is freed now, not by a
    collection inside the counted block."""
    import gc
    from deeplearning4j_tpu_torch import telemetry as tel
    gc.collect()
    torch.cuda.synchronize()
    return tel.HostSyncDetector(action="count", sync_debug=True,
                                thread=thread)


def _sync_sites(det):
    """{call site or read: count} of a ``_sync_watch``'s events."""
    out = {}
    for e in det.events:
        site = e.get("source") or f"read {e['shape']}"
        site = f"{e['span_path'] or '-'}: {site}"
        out[site] = out.get(site, 0) + 1
    return out


def _elastic_tlm():
    """(a) ``ElasticTrainer`` on ``_TLM`` at full width (see the module
    docstring): (a1)-(a7), with each run's launches."""
    from deeplearning4j_tpu_torch.parallel import (
        CorruptCheckpoint, FaultInjector, FaultPlan, KillWorker, PreemptAt,
        SlowCollective)
    from deeplearning4j_tpu_torch.util import async_checkpoint as ac
    from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
        latest_sharded_step, read_manifest)
    batches = _dp_batches(EL_BATCHES, SEED + 71)
    runs, bad = {}, []
    submit_ms, writers = [], []
    submit = ac.AsyncCheckpointWriter.submit

    def timed_submit(self, *a, **kw):
        if all(self is not w for w in writers):
            writers.append(self)
        t0 = time.perf_counter()
        out = submit(self, *a, **kw)
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    ac.AsyncCheckpointWriter.submit = timed_submit
    root = tempfile.mkdtemp(prefix="elastic-")

    def fresh_dir(name):
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        return d

    def want(steps):
        return {n: TLM["n_blocks"] * DP_WORKERS * steps for n in COUNTED}

    base_net = _tlm_f32(SEED + 24)
    fresh = base_net.clone            # every run starts from these weights
    try:
        with _deterministic_algorithms():
            # (a1) plain wrapper, then the unfaulted trainer
            net = fresh()
            clock = _WindowClock(1)
            net.set_listeners(clock)
            pw = ParallelWrapper(net, mesh=make_mesh((DP_WORKERS,),
                                                     ("data",)),
                                 prefetch_buffer=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pw.fit(ListDataSetIterator(batches))
            pw.fit(ListDataSetIterator(batches[:EL_STEPS - EL_BATCHES]))
            torch.cuda.synchronize()
            ms = [(b - a) * 1e3 for a, b in zip([t0] + clock.t, clock.t)]
            runs["plain"] = {"step_ms": ms,
                             "step_ms_p50": float(np.median(ms[1:]))}
            net.set_listeners()
            base = _el_state(net)
            plain_pw = pw                 # (a7) continues it
            del net, pw
            tr = _elastic_trainer(fresh(), fresh_dir("a1"))
            runs["a1"] = _elastic_run(tr, batches, "a1_unfaulted", clock_k=1)
            runs["a1"]["bitwise_plain"] = _el_same(_el_state(tr.net), base)
            runs["a1"]["write_ms"] = list(writers[-1].write_ms)
            runs["a1"]["newest_save"] = latest_sharded_step(
                os.path.join(root, "a1"))
            # (a7) sync freedom: the warm a1 trainer and plain wrapper go
            # on from step 12 over the same 8 batches (the epoch's second
            # half, then its first), the trainer with its saves at 16 and
            # 20 (no synchronous final save)
            rest = batches[EL_STEPS - EL_BATCHES:] + \
                batches[:EL_STEPS - EL_BATCHES]
            with _sync_watch() as plain:
                plain_pw.fit(ListDataSetIterator(rest))
            del plain_pw
            tr.final_checkpoint = False
            n_sub = len(submit_ms)
            with _sync_watch() as el:
                tr.fit(ListDataSetIterator(batches),
                       num_steps=EL_STEPS + EL_SYNC_STEPS)
            runs["a7"] = {"plain_syncs": plain.count,
                          "plain_sites": _sync_sites(plain),
                          "elastic_syncs": el.count,
                          "elastic_sites": _sync_sites(el),
                          "submits_counted": len(submit_ms) - n_sub,
                          "steps": EL_SYNC_STEPS,
                          "steps_done": tr.steps_done}
            del tr
            torch.cuda.empty_cache()
            # (a2) a truncated newest save and a kill at step 9, rejoining
            plan = FaultPlan(CorruptCheckpoint(step=EL_KILL, mode="truncate"),
                             KillWorker(step=EL_KILL, worker=1, rejoin=True))
            tr = _elastic_trainer(fresh(), fresh_dir("a2"),
                                  fault_injector=FaultInjector(plan))
            runs["a2"] = _elastic_run(tr, batches, "a2_kill_truncate")
            runs["a2"]["bitwise_a1"] = _el_same(_el_state(tr.net), base)
            del tr
            torch.cuda.empty_cache()
            # (a3) the same plan in windows of 4 (a CUDA graph), the kill
            # planned inside the window [8, 12)
            plan = FaultPlan(
                CorruptCheckpoint(step=EL_WINDOW_KILL, mode="truncate"),
                KillWorker(step=EL_WINDOW_KILL, worker=2, rejoin=True))
            tr = _elastic_trainer(fresh(), fresh_dir("a3"),
                                  steps_per_dispatch=EL_K,
                                  fault_injector=FaultInjector(plan))
            runs["a3"] = _elastic_run(tr, batches, "a3_windows_kill")
            runs["a3"]["bitwise_a1"] = _el_same(_el_state(tr.net), base)
            runs["a3"]["graphs"] = [pw.graph_stats() for pw in tr.made]
            del tr
            torch.cuda.empty_cache()
            # (a4) preempted at step 5, resumed by a fresh trainer
            d4 = fresh_dir("a4")
            tr = _elastic_trainer(fresh(), d4,
                                  fault_injector=FaultInjector(
                                      FaultPlan(PreemptAt(step=EL_PREEMPT))))
            first = _elastic_run(tr, batches, "a4_preempted")
            first["newest_save"] = latest_sharded_step(d4)
            first["step_in_epoch"] = read_manifest(
                d4, first["newest_save"])["extra"]["step_in_epoch"]
            del tr
            torch.cuda.empty_cache()
            tr = _elastic_trainer(fresh(), d4)
            runs["a4"] = _elastic_run(tr, batches, "a4_resumed")
            runs["a4"]["preempted_run"] = first
            runs["a4"]["bitwise_a1"] = _el_same(_el_state(tr.net), base)
            del tr, base
            torch.cuda.empty_cache()
            # (a5) (2, 2) under Sgd loses worker 3 for good: (3, 1)
            ref = transformer_lm(**TLM, token_input=True,
                                 updater=Sgd(TP_SGD_LR)).init(seed=SEED + 24)
            pw = ParallelWrapper(ref, mesh=make_mesh((DP_WORKERS,),
                                                     ("data",)),
                                 prefetch_buffer=0)
            pw.fit(ListDataSetIterator(batches))
            pw.fit(ListDataSetIterator(batches[:EL_STEPS - EL_BATCHES]))
            want_flat = _tp_flat(ref)
            names = _tp_names(ref)
            del ref, pw
            torch.cuda.empty_cache()
            net = transformer_lm(**TLM, token_input=True,
                                 updater=Sgd(TP_SGD_LR)).init(seed=SEED + 24)
            tr = _elastic_trainer(net, fresh_dir("a5"), mesh_shape=(2, 2),
                                  fault_injector=FaultInjector(FaultPlan(
                                      KillWorker(step=EL_SHRINK_KILL,
                                                 worker=3))))
            runs["a5"] = _elastic_run(tr, batches, "a5_2x2_shrink_sgd")
            runs["a5"]["param_rel_to_max_sgd_4"] = _tp_worst(
                _tp_flat(net), want_flat, names)
            runs["a5"]["rows_leaves_after"] = _tp_rows(net)
            del tr, net, want_flat
            torch.cuda.empty_cache()
            # (a6) degraded mode, twice
            states = []
            for rep in (0, 1):
                tr = _elastic_trainer(
                    fresh(), None,
                    fault_injector=FaultInjector(FaultPlan(
                        SlowCollective(**EL_SLOW))), **EL_DEGRADED)
                by_mode = {"sync": 0, "averaging": 0}
                on_item, mark = tr._on_item, [0]

                def item(net, k, tr=tr, on_item=on_item, by_mode=by_mode,
                         mark=mark):
                    n = fa.flash_attention.launches
                    by_mode[tr.mode] += n - mark[0]
                    mark[0] = n
                    on_item(net, k)
                tr._on_item = item
                row = _elastic_run(tr, batches, f"a6_degraded_{rep}")
                row["k1_eager_launches_by_mode"] = by_mode
                runs[f"a6_{rep}"] = row
                states.append(_el_state(tr.net))
                del tr
                torch.cuda.empty_cache()
            runs["a6_0"]["bitwise_rerun"] = _el_same(states[0], states[1])
            del states
    finally:
        ac.AsyncCheckpointWriter.submit = submit
        shutil.rmtree(root, ignore_errors=True)
        del base_net, fresh
    # the gates
    for what in ("a1", "a2", "a3", "a4", "a5", "a6_0", "a6_1"):
        r = runs[what]
        if r["steps_done"] != EL_STEPS:
            bad.append(f"{what}: {r['steps_done']} steps done")
        # (a5): 2 data workers a step on (2, 2) to the kill, then the
        # whole batch (8 does not tile 3 workers) from the restored step
        want_n = ({n: TLM["n_blocks"] * (2 * EL_SHRINK_KILL + EL_STEPS
                                         - EL_EVERY) for n in COUNTED}
                  if what == "a5" else want(r["steps_run"]))
        if r["launches"] != want_n:
            bad.append(f"{what}: launched {r['launches']} for "
                       f"{r['steps_run']} steps, not {want_n}")
    for what in ("a1", "a2", "a3", "a4"):
        key = "bitwise_plain" if what == "a1" else "bitwise_a1"
        if not runs[what][key]:
            bad.append(f"{what} is not bitwise {key[8:]}")
    if runs["a1"]["recoveries"] or runs["a1"]["newest_save"] != EL_STEPS:
        bad.append(f"a1: {runs['a1']['recoveries']} recoveries, newest "
                   f"save {runs['a1']['newest_save']}")
    for what, ran in (("a2", EL_STEPS + EL_KILL - EL_EVERY),
                      ("a3", EL_STEPS + EL_STEPS - EL_EVERY)):
        r = runs[what]
        if r["recoveries"] != 1 or r["steps_run"] != ran:
            bad.append(f"{what}: {r['recoveries']} recoveries, "
                       f"{r['steps_run']} steps run (want {ran})")
    if sum(g["captures"] for g in runs["a3"]["graphs"]) < 2:
        bad.append(f"a3: graphs {runs['a3']['graphs']}")
    p = runs["a4"]["preempted_run"]
    if not (p["preempted"] and p["steps_done"] == EL_PREEMPT
            and p["newest_save"] == EL_PREEMPT
            and p["step_in_epoch"] == EL_PREEMPT
            and runs["a4"]["steps_run"] == EL_STEPS - EL_PREEMPT):
        bad.append(f"a4: {p}, then {runs['a4']['steps_run']} steps")
    r = runs["a5"]
    if r["recoveries"] != 1 or r["mesh"] != [3, 1] or \
            r["rows_leaves_after"] != 0 or \
            r["param_rel_to_max_sgd_4"][0] > EL_SGD_TOL:
        bad.append(f"a5: {r['recoveries']} recoveries on {r['mesh']}, "
                   f"{r['rows_leaves_after']} rows leaves, parameters "
                   f"{r['param_rel_to_max_sgd_4']}")
    for what in ("a6_0", "a6_1"):
        r = runs[what]
        if [tuple(m) for m in r["mode_history"]] != EL_MODES or \
                min(r["k1_eager_launches_by_mode"].values()) == 0:
            bad.append(f"{what}: modes {r['mode_history']}, K1 by mode "
                       f"{r['k1_eager_launches_by_mode']}")
    if not runs["a6_0"]["bitwise_rerun"]:
        bad.append("a6: the rerun is not bitwise the first run")
    r = runs["a7"]
    if r["elastic_syncs"] > r["plain_syncs"] or r["submits_counted"] < 1:
        bad.append(f"a7: {r}")
    runs["submit_ms"] = submit_ms
    runs["submit_ms_p50"] = float(np.median(submit_ms)) if submit_ms \
        else None
    runs["supervision_step_ms_p50"] = {
        "elastic": runs["a1"]["step_ms_p50"],
        "plain": runs["plain"]["step_ms_p50"]}
    if bad:
        raise AssertionError(f"elastic training: {bad}")
    for r in runs.values():
        if isinstance(r, dict):
            r.pop("losses", None)
    runs["launches"] = {n: sum(r["launches"][n] for r in runs.values()
                               if isinstance(r, dict) and "launches" in r)
                        + runs["a4"]["preempted_run"]["launches"][n]
                        for n in COUNTED}
    return runs


class _Recording:
    """A network proxy for ``ParallelInference``: the merged batch sizes
    that reached ``output``; ``gate`` (an Event) holds each call until
    set."""

    def __init__(self, net, gate=None):
        self.net, self.sizes, self.gate = net, [], gate

    def output(self, x):
        if self.gate is not None:
            self.gate.wait(60)
        self.sizes.append(int(x.shape[0]))
        return self.net.output(x)


def _parallel_inference(gserve):
    """(b) ``ParallelInference`` and ``ModelServingServer`` over phase 11's
    GoogLeNet (batch limit 32, 8 client threads of requests of 1-8
    images)."""
    import threading
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.parallel.model_server import \
        ModelServingServer
    net = googlenet(**GNET).init(seed=SEED + 13)
    pool = np.random.default_rng(SEED + 14).standard_normal(
        (16, GNET["height"], GNET["width"], GNET["channels"])).astype(
        np.float32)
    rec = _Recording(net)
    pi = ParallelInference(rec, batch_limit=PI_LIMIT)
    pi.output(pool[:2])                             # first touch
    rec.sizes.clear()
    results, lat = {}, []

    def client(c):
        for i in range(GNET_PER_CLIENT):
            n = GNET_SIZES[(c + i) % len(GNET_SIZES)]
            x = pool[c % (len(pool) - n + 1):][:n]
            t0 = time.perf_counter()
            results[(c, i)] = (x, pi.output(x))
            lat.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.synchronize()
    k7.conv1x1_fused.launches = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(GNET_CLIENTS) as ex:
        for f in [ex.submit(client, c) for c in range(GNET_CLIENTS)]:
            f.result()
    wall = time.perf_counter() - t0
    launches = k7.conv1x1_fused.launches
    pi.shutdown()
    sizes = list(rec.sizes)
    n_rows = sum(x.shape[0] for x, _ in results.values())
    worst = 0.0
    for x, got in results.values():
        want = net.output(x).cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()))
    # shutdown fails the queued requests: the first request's batch holds
    # the dispatcher (its gate closed) past shutdown's 2 s join, while
    # three more wait in the queue
    gate = threading.Event()
    blocked = ParallelInference(_Recording(net, gate), batch_limit=PI_LIMIT,
                                max_wait_ms=1.0)
    outcomes = []

    def call():
        try:
            outcomes.append(("ok", blocked.output(pool[:1]).shape))
        except RuntimeError as e:
            outcomes.append(("failed", str(e)))
    threads = [threading.Thread(target=call) for _ in range(4)]
    threads[0].start()
    time.sleep(0.2)
    for t in threads[1:]:
        t.start()
    time.sleep(0.1)
    blocked.shutdown()
    gate.set()
    for t in threads:
        t.join(30)
    refused = False
    try:
        blocked.output(pool[:1])
    except RuntimeError:
        refused = True
    # the legacy HTTP route
    srv = ModelServingServer(net, batched=True, max_batch=PI_LIMIT)
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    client = HTTPClient(timeout=300)
    try:
        health = _expect_status(client, "GET", base + "/health", 200,
                                "model server /health")
        outs, http_ms = _predict_over_http(client, base, [pool[:2]],
                                           "model server")
        http_err = float(np.abs(outs[0] - net.output(pool[:2]).cpu()
                                .numpy()).max())
        _expect_status(client, "POST", base + "/predict", 400,
                       "malformed features",
                       body=json.dumps({"features": [["x"]]}).encode())
        srv._draining = True
        _expect_status(client, "GET", base + "/health", 503,
                       "draining /health")
        # a small body: the draining server answers before it reads one
        _expect_status(client, "POST", base + "/predict", 503,
                       "draining /predict",
                       body=json.dumps({"features": [[0.0]]}).encode())
        srv._draining = False
    finally:
        client.close()
        srv.stop()
    row = {"model": "googlenet 1000 classes 224x224x3 f32",
           "batch_limit": PI_LIMIT, "requests": len(lat), "rows": n_rows,
           "images_per_s": n_rows / wall,
           "latency_ms_p50": float(np.percentile(lat, 50)),
           "latency_ms_p99": float(np.percentile(lat, 99)),
           "inference_engine_images_per_s": gserve["images_per_s"],
           "inference_engine_latency_ms_p50": gserve["latency_ms_p50"],
           "merged_batches": len(sizes), "merged_sizes": sizes,
           "worst_abs_err": worst, "k7_launches": launches,
           "shutdown_outcomes": outcomes, "refused_after_shutdown": refused,
           "http_health": health, "http_predict_ms": http_ms,
           "http_abs_err": http_err}
    if worst > PI_RESP_TOL or http_err > PI_RESP_TOL or not sizes or \
            max(sizes) > PI_LIMIT or sum(sizes) != n_rows or \
            launches != 37 * len(sizes) or not refused or \
            sorted(o[0] for o in outcomes) != ["failed"] * 3 + ["ok"]:
        raise AssertionError(f"ParallelInference: {row}")
    del net
    torch.cuda.empty_cache()
    return row


def _streaming():
    """(c) The char-RNN trained from a ``StreamingIngestServer``: a
    producer thread POSTs 6 batches and /end while ``net.fit`` consumes the
    topic; bitwise the same batches through a ``ListDataSetIterator``."""
    import threading
    from deeplearning4j_tpu_torch.parallel.streaming import (
        StreamingDataSetIterator, StreamingIngestServer)
    data = [_char_batch(SEED + 80 + i, CHAR_B, CHAR_T)
            for i in range(STREAM_BATCHES)]
    nets = [text_generation_lstm(**CHAR, tbptt_length=CHAR_T)
            .init(seed=SEED) for _ in range(2)]
    topic = StreamingDataSetIterator(capacity=2)
    srv = StreamingIngestServer(topic).start()
    base = f"http://127.0.0.1:{srv.port}"
    client = HTTPClient(timeout=300)
    bodies = [json.dumps({"features": x.tolist(), "labels": y.tolist()})
              .encode() for x, y in data]
    refused = [0]

    def producer():
        for body in bodies:
            while True:
                status, _, _ = client.request(
                    "POST", base + "/publish", body=body,
                    headers={"Content-Type": "application/json"})
                if status == 200:
                    break
                refused[0] += 1            # full: back-pressure
                time.sleep(0.01)
        client.request_json("POST", base + "/end", payload={})

    try:
        t = threading.Thread(target=producer)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        t.start()
        nets[0].fit(iterator=topic)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches(LSTM_COUNTED)
        t.join(60)
        status, stats = client.request_json("GET", base + "/stats")
    finally:
        client.close()
        srv.stop()
    nets[1].fit(iterator=ListDataSetIterator(
        [DataSet(x, y) for x, y in data]))
    same = all(torch.equal(a, b) for a, b in zip(nets[0].parameters(),
                                                 nets[1].parameters()))
    want = {n: 2 * STREAM_BATCHES for n in LSTM_COUNTED}
    row = {"model": "text_generation_lstm vocab 87 hidden 512 f32 "
                    "RmsProp(1e-3), T 64 in one chunk",
           "batch": CHAR_B, "seq_len": CHAR_T, "batches": STREAM_BATCHES,
           "stats": stats, "fit_s": fit_s, "publish_refused": refused[0],
           "bitwise_list_iterator": same, "launches": launches}
    if status != 200 or not same or launches != want or \
            stats["published"] != STREAM_BATCHES or \
            stats["consumed"] != STREAM_BATCHES or not stats["closed"]:
        raise AssertionError(f"streaming: {row}")
    return row


def _distributed():
    """(d) One process on NCCL: ``global_mesh(("data",))``, a psum of one
    row, 4 ``_TLM`` steps through ``ParallelWrapper(mesh=global_mesh)``
    bitwise the logical ``(1,)`` wrapper's, whether the profiler saw NCCL
    kernels."""
    import socket
    from deeplearning4j_tpu_torch.parallel import distributed
    from deeplearning4j_tpu_torch.parallel.mesh import psum
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    batches = _dp_batches(DIST_STEPS, SEED + 73)
    distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = distributed.global_mesh(("data",))
        row_in = torch.arange(6.0, device="cuda").reshape(1, 6)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = psum(row_in, mesh, "data")
            torch.cuda.synchronize()
        nccl = sorted({e.key for e in prof.key_averages()
                       if "nccl" in e.key.lower()})
        psum_ok = torch.equal(got, row_in)
        states, launches = [], {}
        with _deterministic_algorithms():
            for what, m in (("process_group", mesh),
                            ("logical", make_mesh((1,), ("data",)))):
                net = _tlm_f32(SEED + 24)
                torch.cuda.synchronize()
                _reset_launches()
                ParallelWrapper(net, mesh=m, prefetch_buffer=0).fit(
                    ListDataSetIterator(batches))
                torch.cuda.synchronize()
                launches[what] = _launches()
                states.append(_el_state(net))
                del net
                torch.cuda.empty_cache()
    finally:
        distributed.shutdown_distributed()
    want = {n: TLM["n_blocks"] * DIST_STEPS for n in COUNTED}
    row = {"backend": "nccl", "processes": 1, "psum_one_row": psum_ok,
           "bitwise_logical_1": _el_same(states[0], states[1]),
           "steps": DIST_STEPS, "nccl_kernels_seen": nccl,
           "launches": {n: launches["process_group"][n]
                        + launches["logical"][n] for n in COUNTED},
           "launches_by_run": launches}
    if not (psum_ok and row["bitwise_logical_1"]) or any(
            v != want for v in launches.values()):
        raise AssertionError(f"distributed: {row}")
    return row


def elastic_phase(gserve):
    """Phase 17d: the rest of the parallel layer on the card (a) to (d)
    (see the module docstring); returns every part's row and the launches
    on its paths."""
    out = {}
    t_phase = time.perf_counter()
    for part, run in (("elastic", _elastic_tlm),
                      ("parallel_inference",
                       lambda: _parallel_inference(gserve)),
                      ("streaming", _streaming),
                      ("distributed", _distributed)):
        t0 = time.perf_counter()
        out[part] = run()
        out[part + "_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = {
        n: out["elastic"]["launches"][n] + out["distributed"]["launches"][n]
        for n in COUNTED}
    out["launches"].update(out["streaming"]["launches"])
    out["launches"]["conv1x1_bias_relu"] = \
        out["parallel_inference"]["k7_launches"]
    log("elastic phase:", out)
    return out


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
    out.update(_tp_cross_device())
    return out


def _tp_cross_device():
    """One float32 ``(2, 2)`` step of a 2-block ``_TLM`` (Sgd) and one
    head-sharded decode step of it, on the card and on the CPU from the
    same weights: the step's loss and applied gradient (what the updater
    is handed, joined from its rows) at phase 5's pins, the decode step's
    logits at rel-to-max 2e-5."""
    from deeplearning4j_tpu_torch.serving.generation.kvcache import \
        PagedStore
    from deeplearning4j_tpu_torch.serving.generation.programs import (
        GenerationConfig, GenerationProgramSet)
    cfg = dict(TLM, n_blocks=2)
    V, T = cfg["vocab_size"], cfg["max_length"]
    gpu = transformer_lm(**cfg, token_input=True,
                         updater=Sgd(1e-3)).init(seed=SEED + 26)
    cpu = transformer_lm(**cfg, token_input=True, updater=Sgd(1e-3),
                         device="cpu").init()
    load_jax_params(cpu, [{k: v.detach().cpu().numpy()
                           for k, v in gpu.vertices[n].param_dict().items()}
                          for n in gpu.vertex_names])
    ids = np.random.default_rng(SEED + 27).integers(0, V, (4, T))
    step = {}
    for net in (gpu, cpu):
        seen, apply = [], net.updater.update

        def update(grads, opt_state, params, it, apply=apply, seen=seen,
                   net=net):
            held = held_specs(net)
            seen.append({f"{g}.{k}": full(v, held[g][k]).detach().cpu()
                         for g, gd in grads.items() for k, v in gd.items()})
            return apply(grads, opt_state, params, it)
        net.updater.update = update
        rec = _Losses()
        net.set_listeners(rec)
        x = torch.as_tensor(ids, device=net.device)
        ParallelWrapper(net, mesh_shape=(2, 2)).fit(ListDataSetIterator(
            [DataSet(x, _one_hot_prev(x, V, torch.float32))]))
        net.set_listeners()
        step[net.device.type] = (float(rec.losses[0]), seen[0])
    (l_gpu, g_gpu), (l_cpu, g_cpu) = step["cuda"], step["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = max(g_gpu, key=lambda n: _rel_to_max(g_gpu[n], g_cpu[n]))
    grad_rel = _rel_to_max(g_gpu[worst], g_cpu[worst])
    if loss_rel > 1e-5 or grad_rel > 1e-4 or not all(
            float(g_gpu[f"b{b}_attn.{w}"].abs().max()) > 0
            for b in range(2) for w in ("Wq", "Wk", "Wv")):
        raise AssertionError(f"(2, 2) step on the card vs CPU: loss rel "
                             f"{loss_rel:.3g}, {worst} rel-to-max "
                             f"{grad_rel:.3g}")
    out = {"tp_step_loss_rel": loss_rel, "tp_step_grad_rel_to_max": grad_rel,
           "tp_step_worst_grad": worst}
    logits = {}
    conf = GenerationConfig(block_len=16, max_seq_len=256, decode_slots=2,
                            prefill_batches=(1,), prompt_rungs=(256,))
    prompt = np.zeros((1, 256), np.int64)
    prompt[0, :200] = ids[0, :200]
    tables = np.arange(1, 17, dtype=np.int64)[None, :].repeat(2, 0)
    tables[1] = 0
    for net in (gpu, cpu):
        dev = net.device
        ps = GenerationProgramSet(net, config=conf, mesh=make_mesh(
            (1, 2), ("data", "model"), dev)).warm()
        cache, g = ps.make_cache(), ps.fresh_generator()
        first = ps.run_prefill(cache, prompt, np.array([200]), tables[:1],
                               np.array([0]), g, np.zeros(1, np.float32),
                               np.zeros(1, np.int64))
        t = lambda a: torch.as_tensor(a, device=dev)
        tok, pos = t([int(first[0]), 0]), t([200, 0])
        act, tab = t([True, False]), t(tables)
        with torch.inference_mode():
            logits[dev.type] = ps.spec.decode_step(tok, pos, ps._stores(
                lambda k, v: PagedStore(k, v, tab, pos, act, 16),
                cache))[0].cpu()
    out["head_sharded_decode_logits_rel_to_max"] = _rel_to_max(
        logits["cuda"], logits["cpu"])
    if out["head_sharded_decode_logits_rel_to_max"] > 2e-5:
        raise AssertionError(f"head-sharded decode step on the card vs CPU: "
                             f"{out}")
    return out


# ------------------------------------------------------------------- main


# ------------------------------------------------------------------ phase 20
TEL_TRAIN_BATCHES, TEL_NAN_AT = 8, 5   # one window of 8; the NaN's batch
TEL_ROUNDS = 4                          # (b): registry on/off alternated


def _http(base, method, path, body=None, trace_id=None):
    """(status, headers, body bytes) of one request to the port's server."""
    import urllib.error
    import urllib.request
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["X-Trace-Id"] = trace_id
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_PROM_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                        r'[-+0-9.eEinfINFaN]+$')


def _parse_prometheus(text):
    """{sample name with labels: value} of a Prometheus text dump; raises
    on a line that is neither a comment nor a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not _PROM_LINE.match(line):
            raise AssertionError(f"telemetry: not a Prometheus sample: "
                                 f"{line!r}")
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def _tel_prompts():
    rng = np.random.default_rng(SEED)        # phase 3's requests
    lens = rng.integers(300, 901, size=N_REQUESTS)
    return [rng.integers(1, TLM["vocab_size"], size=int(n)).tolist()
            for n in lens]


def _tel_serve(net, tmp):
    """(a) phase 3's requests through ``ServingHTTPServer`` (the prefix
    cache off), registry off then on (one request at a time, so every
    prefill batch is the same on both), each with its own X-Trace-Id;
    then the telemetry routes."""
    from deeplearning4j_tpu_torch import telemetry as tel
    from deeplearning4j_tpu_torch.serving import ServingHTTPServer
    from deeplearning4j_tpu_torch.telemetry import memprof
    reg = tel.get_registry()
    prompts = _tel_prompts()
    # no prefix cache: the second run's requests must prefill again (a hit
    # replays its prompt through decode steps instead)
    # and a model name of its own, so the memory profile's pool rows
    # (owner generation.tel.kvcache) are this engine's alone
    eng = GenerationEngine(net, **ENGINE, prefix_cache=False,
                           model_name="tel")
    srv = ServingHTTPServer(generation=eng)
    base = f"http://127.0.0.1:{srv.start()}"
    prev_wd = tel.set_slo_watchdog(tel.SLOWatchdog([tel.LatencySLO(
        "ttft", "generation.tel.ttft_ms", 1000.0, 0.99)]))
    prev_fr = tel.set_flight_recorder(tel.FlightRecorder(
        os.path.join(tmp, "flightrec")))
    out = {}
    try:
        def serve(traced):
            toks, ids = [], []
            for i, p in enumerate(prompts):
                tid = f"{i + 1:08x}" + "c0ffee" * 4 if traced else None
                st, hd, body = _http(base, "POST", "/generate",
                                     {"prompt": p, "max_tokens": MAX_TOKENS,
                                      "stream": False}, tid)
                if st != 200:
                    raise AssertionError(f"telemetry: /generate {st}: "
                                         f"{body[:200]!r}")
                toks.append(json.loads(body)["tokens"])
                ids.append((tid, hd.get("X-Trace-Id")))
            return toks, ids

        reg.enabled = False
        off_tokens, _ = serve(False)
        reg.enabled = True
        reg.reset()
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0          # the traced run's count
        on_tokens, ids = serve(True)
        out["k1_launches"] = fa.flash_attention.launches
        if on_tokens != off_tokens:
            bad = next(i for i, (a, b) in enumerate(zip(on_tokens,
                                                        off_tokens)) if a != b)
            raise AssertionError(f"telemetry: request {bad}'s tokens differ "
                                 f"with the registry on")
        for tid, echoed in ids:
            if echoed != tid:
                raise AssertionError(f"telemetry: X-Trace-Id {tid} came back "
                                     f"as {echoed}")
        # /debug/trace: the spans and each request's http.request event
        st, hd, body = _http(base, "GET", "/debug/trace")
        events = [json.loads(line) for line in body.splitlines() if line]
        names = {e["name"] for e in events if e.get("cat") == "span"}
        for want in ("generation.prefill", "generation.decode_step"):
            if want not in names:
                raise AssertionError(f"telemetry: no {want} span in "
                                     f"/debug/trace ({sorted(names)})")
        http_ids = {e["args"].get("trace_id") for e in events
                    if e["name"] == "http.request"}
        missing = [t for t, _ in ids if t not in http_ids]
        if st != 200 or missing:
            raise AssertionError(f"telemetry: /debug/trace {st}, no "
                                 f"http.request event for {missing}")
        # /metrics/prometheus parses; its TTFT histogram counts 8
        st, _, body = _http(base, "GET", "/metrics/prometheus")
        samples = _parse_prometheus(body.decode())
        ttft = samples.get("dl4j_tpu_generation_tel_ttft_ms_count")
        if st != 200 or ttft != N_REQUESTS:
            raise AssertionError(f"telemetry: /metrics/prometheus {st}, "
                                 f"TTFT count {ttft}")
        # /metrics has slo and perf
        st, _, body = _http(base, "GET", "/metrics")
        metrics = json.loads(body)
        if st != 200 or not {"slo", "perf", "generation"} <= set(metrics):
            raise AssertionError(f"telemetry: /metrics keys {sorted(metrics)}")
        # /debug/memprof: the pool's bytes within one block of kvcache's
        # (earlier phases' pools, freed with their engines, collected first)
        import gc
        gc.collect()
        st, _, body = _http(base, "POST", "/debug/memprof", {"top_k": 100})
        prof = json.loads(body)
        pool_rows = [r for r in prof["top"]
                     if r["owner"] == "generation.tel.kvcache"]
        ps = eng.runtime().active_ps
        pool = ps.kv_pool_chip_bytes
        block = int(ps.kv_bytes_per_token() * ENGINE["block_len"])
        got = sum(r["total_bytes"] for r in pool_rows)
        if st != 200 or abs(got - pool) > block:
            raise AssertionError(f"telemetry: /debug/memprof's pool rows "
                                 f"hold {got} bytes, kvcache counts {pool}")
        # /debug/flightrec: a dump tools/trace2summary.py reads
        st, _, body = _http(base, "POST", "/debug/flightrec",
                            {"note": "chip_smoke"})
        dump = json.loads(body).get("dumped")
        summ = subprocess.run([sys.executable, "tools/trace2summary.py",
                               dump, "--json"], capture_output=True,
                              text=True, timeout=60)
        if st != 200 or summ.returncode != 0:
            raise AssertionError(f"telemetry: /debug/flightrec {st}, "
                                 f"trace2summary: {summ.stderr[-300:]}")
        out.update({
            "tokens_equal_registry_off": True, "trace_ids_echoed": len(ids),
            "trace_events": len(events), "span_names": sorted(names),
            "prometheus_samples": len(samples),
            "ttft_histogram_count": ttft,
            "slo": metrics["slo"].get("objectives", {}),
            "perf_programs": [r["path"] for r in
                              metrics["perf"].get("programs", [])],
            "memprof_pool_bytes": got, "kvcache_pool_bytes": pool,
            "block_bytes": block,
            "flightrec_summary_rows": len(json.loads(summ.stdout or "[]"))})
        return out, eng, srv
    except BaseException:
        srv.stop()
        raise
    finally:
        tel.set_slo_watchdog(prev_wd)
        tel.set_flight_recorder(prev_fr)


# the eager generation programs that end in one result read (``.cpu()``)
_READ_PROGRAMS = ("prefill", "decode", "propose", "verify")


def _sync_probe():
    """The detector ``_sync_watch`` gives sees what it gates on: a size read
    inside an op (``nonzero``: the sync debug mode's) and a host read
    (``.item()``: the funnel's, its own sync warning not counted again),
    one each; under ``action="raise"`` the op's sync raises."""
    from deeplearning4j_tpu_torch import telemetry as tel
    x = torch.arange(8.0, device="cuda")
    with _sync_watch() as det:
        torch.nonzero(x)
        x.sum().item()
    kinds = [e["shape"] is None for e in det.events]
    if det.count != 2 or kinds != [True, False]:
        raise AssertionError(f"telemetry: the sync probe saw {det.events}")
    try:
        with tel.HostSyncDetector(action="raise", sync_debug=True):
            torch.nonzero(x)
    except tel.HostSyncError:
        pass
    else:
        raise AssertionError("telemetry: a synchronising call under "
                             "action='raise' did not raise")
    return {"sync_calls": 1, "host_reads": 1, "raise": True,
            "sites": _sync_sites(det)}


def _tel_decode_cost(eng):
    """(b) phase 3's 8 concurrent requests in ``TEL_ROUNDS`` rounds,
    registry on and off alternated: with it on, what the scheduler's loop
    thread waited on the card for (``_sync_watch``: synchronising calls
    and host reads) against the eager programs' result reads, warm runs
    and captures after warm-up, and each round's decode step p50
    (graph)."""
    from collections import Counter
    from deeplearning4j_tpu_torch import telemetry as tel
    reg = tel.get_registry()
    rt = eng.runtime()
    prompts = _tel_prompts()
    m = rt.metrics
    rounds = []
    counted = {"sync_calls": 0, "host_reads": 0, "program_reads": 0,
               "in_decode_step": 0}
    sites = {}
    probe = _sync_probe()
    with tel.RecompileDetector(allowed=0, warn=False) as det:
        for r in range(TEL_ROUNDS):
            on = r % 2 == 0
            reg.enabled = on
            n0 = m.decode_steps
            runs0 = Counter(rt.active_ps.runs)
            with contextlib.ExitStack() as stack:
                if on:
                    hs = stack.enter_context(_sync_watch(rt._thread.ident))
                # after the detector's set-up (a collection, a synchronise)
                t0 = time.perf_counter()
                streams = [eng.generate(p, max_tokens=MAX_TOKENS,
                                        stream=True) for p in prompts]
                for s in streams:
                    s.result()
                if not rt.wait_idle(60):
                    raise AssertionError("telemetry: the runtime did not "
                                         "go idle")
            wall = time.perf_counter() - t0
            steps = list(m._step_ms)[-(m.decode_steps - n0):]
            ran = Counter(rt.active_ps.runs) - runs0
            rounds.append({"registry": on, "decode_steps": len(steps),
                           "decode_step_ms_p50": float(np.median(steps)),
                           "program_runs": dict(ran), "wall_s": wall})
            if on:
                counted["program_reads"] += sum(ran[k]
                                                for k in _READ_PROGRAMS)
                for e in hs.events:
                    kind = "sync_calls" if e["shape"] is None \
                        else "host_reads"
                    counted[kind] += 1
                    counted["in_decode_step"] += \
                        "generation.decode_step" in (e["span_path"] or "")
                for k, v in _sync_sites(hs).items():
                    sites[k] = sites.get(k, 0) + v
    reg.enabled = True
    # each eager program waits once, on its result read; a decode step (a
    # graph replay) waits on an event, which no counter sees, with the
    # registry on and off alike; telemetry adds no wait
    if counted["sync_calls"] or counted["in_decode_step"] or \
            counted["host_reads"] != counted["program_reads"]:
        raise AssertionError(f"telemetry: the decode loop waited on the "
                             f"card beyond its programs' result reads "
                             f"with the registry on: {counted} {sites}")
    if det.count or m.decode_recompiles:
        raise AssertionError(f"telemetry: {det.count} warm runs or captures "
                             f"after warm-up ({det.events})")
    on = [x["decode_step_ms_p50"] for x in rounds if x["registry"]]
    off = [x["decode_step_ms_p50"] for x in rounds if not x["registry"]]
    return {"rounds": rounds, "probe": probe,
            "loop_sync_calls": counted["sync_calls"],
            "loop_host_reads": counted["host_reads"],
            "loop_program_result_reads": counted["program_reads"],
            "loop_waits_in_decode_step": counted["in_decode_step"],
            "loop_sites": sites,
            "warm_runs_or_captures_after_warmup": det.count,
            "decode_step_ms_p50_on": float(np.median(on)),
            "decode_step_ms_p50_off": float(np.median(off)),
            "on_over_off": float(np.median(on) / np.median(off))}


def _tel_batches(nan_at=None):
    """Phase 4b's batches (the first ``TEL_TRAIN_BATCHES``); with
    ``nan_at`` a NaN in that batch's labels (its features are token ids,
    which hold no NaN)."""
    V, T = TLM["vocab_size"], TLM["max_length"]
    rng = np.random.default_rng(SEED + 40)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for i in range(TEL_TRAIN_BATCHES):
        ids = rng.integers(0, V, (TRAIN_B, T))
        y = eye[np.roll(ids, 1, axis=1)]
        if i == nan_at:
            y = y.copy()
            y[0, 0, 0] = np.nan
        out.append(DataSet(ids, y))
    return out


def _tel_fit(batches, k, on, perf=None):
    """One fit of a fresh ``_TLM`` (phase 4b's bf16-compute step) over
    ``batches``: with the registry on, a ``TrainingWatch`` armed (and
    ``perf`` as its listener), or with it off. Returns (net, watch, the
    run's K1-K3 launches)."""
    from deeplearning4j_tpu_torch import telemetry as tel
    reg = tel.get_registry()
    net = _tlm_amp().init(seed=SEED + 40)
    watch = tel.TrainingWatch(window=TEL_TRAIN_BATCHES) if on else None
    prev = tel.set_training_watch(watch)
    reg.enabled = on
    try:
        net.set_listeners(*([perf] if perf is not None else []))
        launches, _ = _counted_run(
            net, lambda: net.fit(iterator=ListDataSetIterator(batches),
                                 steps_per_dispatch=k), COUNTED)
    finally:
        reg.enabled = True
        tel.set_training_watch(prev)
    if watch is not None:
        if not watch.drain(60):
            raise AssertionError("telemetry: the training watch did not "
                                 "drain")
        watch.close()
    return net, watch, launches


def _tel_train():
    """(c) phase 4b's step per step and in a window of 8, the registry on
    with the watch armed against off: the parameters bitwise equal, the
    span tree, the watch clean and then flagging a planted NaN at its
    step in both modes, and ``PerformanceListener``'s MFU."""
    from deeplearning4j_tpu_torch import telemetry as tel
    reg = tel.get_registry()
    reg.reset()
    clean = _tel_batches()
    perf = PerformanceListener(frequency=1)
    launches = {n: 0 for n in COUNTED}
    out = {"modes": {}}
    for k, mode in ((1, "per_step"), (TEL_TRAIN_BATCHES, "window")):
        on_net, watch, n_on = _tel_fit(clean, k, True,
                                       perf if k == 1 else None)
        off_net, _, n_off = _tel_fit(clean, k, False)
        n_params = on_net.num_params()
        same, worst, name = _params_vs(on_net, off_net)
        if not same:
            raise AssertionError(f"telemetry: {mode}: parameters with the "
                                 f"registry on differ from off ({name}: "
                                 f"{worst})")
        if list(watch.unhealthy):
            raise AssertionError(f"telemetry: {mode}: the watch flagged a "
                                 f"clean run: {list(watch.unhealthy)}")
        del on_net, off_net
        _, nan_watch, n_nan = _tel_fit(_tel_batches(TEL_NAN_AT), k, True)
        flagged = [(r["iteration"], r["reason"])
                   for r in nan_watch.unhealthy]
        if not flagged or flagged[0] != (TEL_NAN_AT, "nonfinite"):
            raise AssertionError(f"telemetry: {mode}: the planted NaN at "
                                 f"step {TEL_NAN_AT} was flagged as "
                                 f"{flagged}")
        for n in COUNTED:
            launches[n] += n_on[n] + n_off[n] + n_nan[n]
        out["modes"][mode] = {"bitwise_registry_off": True,
                              "watch_first_flag": flagged[0],
                              "watch_flags": len(flagged),
                              "launches_on": n_on}
        torch.cuda.empty_cache()
    paths = {e["args"]["path"] for e in reg.trace_events()
             if e.get("cat") == "span"}
    for want in ("fit/epoch/window/dispatch", "fit/epoch/step"):
        if want not in paths:
            raise AssertionError(f"telemetry: no {want} span "
                                 f"({sorted(paths)})")
    mfus = [r.get("mfu") for r in perf.history]
    if not mfus or not all(v is not None and 0 < v < 1 for v in mfus):
        raise AssertionError(f"telemetry: PerformanceListener's mfu {mfus}")
    cost = tel.get_cost_index().train_cost()
    N = n_params
    T, H, L = TLM["max_length"], TLM["n_heads"], TLM["n_blocks"]
    Dh = TLM["d_model"] // H
    pairs = T * (T + 1) / 2
    analytic = 6.0 * N * TRAIN_B * T + 12.0 * L * TRAIN_B * H * Dh * pairs
    out.update({
        "span_paths": sorted(paths),
        "mfu": mfus, "achieved_tflops": [r["achieved_tflops"]
                                         for r in perf.history],
        "cost_path": cost.path, "cost_dtype": cost.dtype,
        "flops_per_step_counted": cost.flops_per_step,
        "kernel_flops_per_step": cost.kernel_flops_per_step,
        "flops_per_step_analytic_6NBT_plus_attention": analytic,
        "counted_over_analytic": cost.flops_per_step / analytic,
        "peak_tflops": tel.perf.peak_tflops(dtype=cost.dtype,
                                            device=cost.device),
        "launches": launches})
    return out


# (c') the step's cost of telemetry: one warm cycle, then measured ones
TEL_TIMING_CYCLES = 3
TEL_STATES = ("on", "off", "on_watch")     # registry on; off; on + watch


def _tel_step_times():
    """(c') phase 4b's step on one net per step and in windows of 8, the
    registry on, off and on with a ``TrainingWatch`` armed, alternated in
    cycles after a warm one (each state's first step and each window
    graph run there): each state's step p50 (per step) or window p50 over
    8 steps, on the card's clock (``_WindowClock`` waits at each end).
    The warm cycle's first step is the one the cost index counts under
    its dispatch mode; it is reported beside the off state's first."""
    from deeplearning4j_tpu_torch import telemetry as tel
    reg = tel.get_registry()
    batches = _tel_batches()
    out = {}
    launches = {n: 0 for n in COUNTED}
    for k, mode, feed in ((1, "per_step", batches),
                          (TEL_TRAIN_BATCHES, "window", batches * 3)):
        net = _tlm_amp().init(seed=SEED + 41)
        ms = {st: [] for st in TEL_STATES}
        first = {}
        for cycle in range(1 + TEL_TIMING_CYCLES):
            for st in TEL_STATES:
                watch = tel.TrainingWatch(window=TEL_TRAIN_BATCHES) \
                    if st == "on_watch" else None
                prev = tel.set_training_watch(watch)
                reg.enabled = st != "off"
                clock = _WindowClock(k)
                net.set_listeners(clock)
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    n, _ = _counted_run(
                        net, lambda: net.fit(
                            iterator=ListDataSetIterator(feed),
                            steps_per_dispatch=k), COUNTED)
                finally:
                    reg.enabled = True
                    tel.set_training_watch(prev)
                    net.set_listeners()
                if watch is not None:
                    watch.drain(60)
                    watch.close()
                for name in COUNTED:
                    launches[name] += n[name]
                dt = [(b - a) * 1e3 for a, b in zip([t0] + clock.t, clock.t)]
                if cycle == 0:
                    first[st] = dt[0]
                else:
                    ms[st] += dt
        p50 = {st: float(np.median(v)) for st, v in ms.items()}
        out[mode] = {"ms_p50": p50, "ms": ms,
                     "on_over_off": p50["on"] / p50["off"],
                     "on_watch_over_off": p50["on_watch"] / p50["off"],
                     "first_ms": first,
                     "unit": "a step" if k == 1 else f"a window of {k}"}
        del net
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def _tel_forward_cost():
    """(e) forward serving (phase 12's int8 net and closed loop, 8 clients
    of 16 requests), the registry on and off alternated over
    ``TEL_TIMING_CYCLES`` cycles after a warm one: each state's latency
    p50 and p99 and rows/s, and the run's K8 launches."""
    from deeplearning4j_tpu_torch import telemetry as tel
    reg = tel.get_registry()
    net = int8_net().init(seed=SEED + 15)
    eng = InferenceEngine(net, feature_shape=(INT8_NET[0],),
                          buckets=INT8_BUCKETS,
                          forward_fn=k8.int8_forward_fn(net))
    pool = np.random.default_rng(SEED + 16).standard_normal(
        (64, INT8_NET[0])).astype(np.float32)
    n_rows = sum(INT8_SIZES[(c + i) % len(INT8_SIZES)]
                 for c in range(INT8_CLIENTS) for i in range(INT8_PER_CLIENT))
    lat = {"on": [], "off": []}
    rows_s = {"on": [], "off": []}
    try:
        k8.int8_matmul_fused.launches = 0
        for cycle in range(1 + TEL_TIMING_CYCLES):
            for st in ("on", "off"):
                reg.enabled = st == "on"
                try:
                    got, wall = _serve_closed_loop(
                        eng, pool, INT8_SIZES, INT8_CLIENTS, INT8_PER_CLIENT)
                finally:
                    reg.enabled = True
                if cycle:
                    lat[st] += got
                    rows_s[st].append(n_rows / wall)
        launches = k8.int8_matmul_fused.launches
    finally:
        eng.stop()
    p50 = {st: float(np.percentile(v, 50)) for st, v in lat.items()}
    return {"latency_ms_p50": p50,
            "latency_ms_p99": {st: float(np.percentile(v, 99))
                               for st, v in lat.items()},
            "rows_per_s": {st: float(np.median(v))
                           for st, v in rows_s.items()},
            "p50_on_over_off": p50["on"] / p50["off"],
            "requests_per_state": len(lat["on"]), "k8_launches": launches}


def _tel_memory():
    """(d) ``device0.bytes_in_use`` against ``torch.cuda.memory_allocated``
    taken at the same point; the peak gauge at least that."""
    from deeplearning4j_tpu_torch import telemetry as tel
    torch.cuda.synchronize()
    vals = tel.device_memory_gauges()
    alloc = torch.cuda.memory_allocated(0)
    used, peak = vals.get("device0.bytes_in_use"), \
        vals.get("device0.peak_bytes_in_use")
    if used != alloc or peak is None or peak < used:
        raise AssertionError(f"telemetry: device0 gauges {vals}, "
                             f"memory_allocated {alloc}")
    return {"bytes_in_use": used, "peak_bytes_in_use": peak,
            "memory_allocated": alloc,
            "bytes_limit": vals.get("device0.bytes_limit")}


def telemetry_phase():
    """Phase 20 (see the module docstring): (a) serving with the telemetry
    routes, (b) telemetry's waits and cost on the decode loop, (c)
    training with the watch, spans and accounting, (c') its step cost,
    (d) the memory gauges, (e) forward serving's cost."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tel_")
    net = transformer_lm(**TLM, token_input=True).init(seed=SEED)
    try:
        serve, eng, srv = _tel_serve(net, tmp)
        try:
            decode = _tel_decode_cost(eng)
        finally:
            srv.stop()
        del eng, srv, net
        torch.cuda.empty_cache()
        train = _tel_train()
        step_times = _tel_step_times()
        memory = _tel_memory()
        forward = _tel_forward_cost()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"serve": serve, "decode_cost": decode, "train": train,
           "step_cost": step_times, "forward_cost": forward,
           "memory": memory, "seconds": time.perf_counter() - t0}
    log(f"telemetry: {row['seconds']:.1f} s, decode step p50 on/off "
        f"{decode['on_over_off']:.4f}, train mfu {train['mfu']}, step p50 "
        f"on/off {step_times['per_step']['on_over_off']:.4f} (window "
        f"{step_times['window']['on_over_off']:.4f}), int8 serving p50 "
        f"on/off {forward['p50_on_over_off']:.4f}")
    return row


# ----------------------------------------------------------------- phase 21
# (a) the parallel layer's telemetry at _TLM on 4 logical workers; the
# reference's names (deeplearning4j_tpu/parallel/{data_parallel,zero,
# overlap,elastic}.py, util/async_checkpoint.py), checked by name here
PT_SPANS = {"fit", "epoch", "window", "dispatch", "step"}
PT_COUNTERS = {"train.iterations", "train.windows",
               "parallel.collective_launches"}
PT_GAUGES = {"parallel.bucket_count", "zero.shard_bytes",
             "zero.gathered_bytes", "zero.groups", "zero.reduce_scatter_ms",
             "zero.allgather_ms", "parallel.collective_ms"}
PT_PROFILE_SPANS = {"reduce_scatter", "all_gather", "zero.allgather",
                    "bucket_psum"}
PT_ONOFF_CYCLES, PT_ONOFF_STEPS = 3, 3
# (b) the fleet: _TLM's width and 12 blocks behind two replica processes
FLEET_GEN = dict(block_len=16, max_seq_len=512, decode_slots=4,
                 prefill_batches=(1,), prompt_rungs=(256, 512))
FLEET_REQUESTS, FLEET_MAX_TOKENS = 8, 16


def _pt_batches(n, seed):
    V, T = TLM["vocab_size"], TLM["max_length"]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = torch.as_tensor(rng.integers(0, V, (TRAIN_B, T)), device="cuda")
        out.append(DataSet(x, _one_hot_prev(x, V, torch.float32)))
    return out


def _pt_wrapper(tel, batches):
    """(a1) ZeRO-2 per step, then overlap in a window of 2, into a fresh
    registry: the reference's spans, counters and gauges, and
    ``train.iterations`` = the steps run; then (a2) the two profiles."""
    from deeplearning4j_tpu_torch.parallel.overlap import profile_schedule
    reg = tel.MetricsRegistry(enabled=True)
    prev = tel.set_registry(reg)
    try:
        net = _tlm_f32(SEED + 60)
        mesh = make_mesh((DP_WORKERS,), ("data",))
        _reset_launches()
        zero = ParallelWrapper(net, mesh=mesh, zero_stage=2,
                               prefetch_buffer=0)
        zero.fit(ListDataSetIterator(batches[:2]))
        torch.cuda.synchronize()
        launches = _launches(PARALLEL_COUNTED)
        zero.gather_opt_state()
        _reset_launches()
        over = ParallelWrapper(net, mesh=mesh, overlap_sync=True,
                               steps_per_dispatch=2, prefetch_buffer=0)
        over.fit(ListDataSetIterator(batches[2:4]))
        torch.cuda.synchronize()
        replays = over.graph_stats()["launches_in_replays"]
        window = {n: c + replays.get(n, 0)
                  for n, c in _launches(PARALLEL_COUNTED).items()}
        eng = zero._zero()
        zp = eng.profile(mesh, repeats=3)
        sp = profile_schedule(mesh, over._grad_schedule(), repeats=3)
        snap = reg.snapshot()
        events = reg.trace_events()
    finally:
        tel.set_registry(prev)
    spans = {e["name"] for e in events if e.get("cat") == "span"}
    coll = {e["name"] for e in events if e.get("cat") == "collective"}
    paths = {e["args"]["path"] for e in events if e.get("cat") == "span"}
    for want, have, what in ((PT_SPANS, spans, "spans"),
                             (PT_PROFILE_SPANS, spans | coll,
                              "profile spans"),
                             (PT_COUNTERS, set(snap["counters"]),
                              "counters"),
                             (PT_GAUGES, set(snap["gauges"]), "gauges")):
        if not want <= have:
            raise AssertionError(f"phase 21 (a): {what} lack "
                                 f"{sorted(want - have)}")
    for want in ("fit/epoch/step", "fit/epoch/window/dispatch"):
        if want not in paths:
            raise AssertionError(f"phase 21 (a): no {want} span")
    c = snap["counters"]
    n_coll = (eng.collectives_per_step + 1) * 2 \
        + (len(over._grad_schedule()) + 1) * 2
    if (c["train.iterations"], c["train.windows"],
            c["parallel.collective_launches"]) != (4, 1, n_coll):
        raise AssertionError(f"phase 21 (a): counters {c}, not 4 steps, 1 "
                             f"window and {n_coll} collectives")
    per_step = TLM["n_blocks"] * DP_WORKERS * 2
    if any(launches[n] != per_step for n in COUNTED):
        raise AssertionError(f"phase 21 (a): ZeRO steps launched "
                             f"{launches}, not {per_step} of K1-K3")
    g = snap["gauges"]
    return {"spans": sorted(spans), "span_paths": sorted(paths),
            "counters": {k: c[k] for k in sorted(PT_COUNTERS)},
            "gauges": {k: g[k]["value"] for k in sorted(PT_GAUGES)},
            "zero_launches": launches, "window_launches": window,
            "window_graph": over.graph_stats(),
            "zero_profile_ms": {"reduce_scatter": zp["reduce_scatter_ms"],
                                "allgather": zp["allgather_ms"],
                                "buckets": len(zp["reduce_scatter"]),
                                "groups": len(zp["all_gather"])},
            "schedule_profile_ms": sp["collective_ms"],
            "schedule_buckets": len(sp["buckets"])}


def _pt_elastic(tel, batches, tmp):
    """(a3) ``ElasticTrainer`` at _TLM's width (2 of its 12 blocks) with
    one injected kill: ``elastic.recoveries`` 1 and the black boxes in
    this phase's directory."""
    from deeplearning4j_tpu_torch.parallel import (ElasticTrainer,
                                                   FaultInjector, FaultPlan,
                                                   KillWorker)
    rec_dir = os.path.join(tmp, "flightrec")
    prev_fr = tel.set_flight_recorder(tel.FlightRecorder(rec_dir))
    reg = tel.MetricsRegistry(enabled=True)
    try:
        net = transformer_lm(**dict(TLM, n_blocks=2), token_input=True,
                             updater=Adam(3e-4)).init(seed=SEED + 61)
        tr = ElasticTrainer(
            net, checkpoint_dir=os.path.join(tmp, "elastic"),
            devices=list(range(DP_WORKERS)), checkpoint_every_n_steps=2,
            fault_injector=FaultInjector(FaultPlan(
                KillWorker(step=3, worker=1, rejoin=True))), registry=reg)
        _reset_launches()
        t0 = time.perf_counter()
        tr.fit(ListDataSetIterator(batches[:2]), num_steps=6)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches(PARALLEL_COUNTED)
    finally:
        tel.set_flight_recorder(prev_fr)
    c = reg.snapshot()["counters"]
    dumps = sorted(os.listdir(rec_dir))
    found = {t: [d for d in dumps if d.endswith(f"_{t}.json")]
             for t in ("fault_killworker", "elastic_recovery")}
    if tr.recoveries != 1 or c.get("elastic.recoveries") != 1 or \
            tr.steps_done != 6 or not all(found.values()):
        raise AssertionError(f"phase 21 (a): elastic recoveries "
                             f"{tr.recoveries} / {c}, steps "
                             f"{tr.steps_done}, dumps {dumps}")
    return {"recoveries": c["elastic.recoveries"], "launches": launches,
            "checkpoints_written": c.get("elastic.checkpoint.written"),
            "last_recovery_ms": tr.last_recovery_ms, "seconds": seconds,
            "dumps": dumps}


def _pt_ring_cost(tel):
    """(a4) a ring step's counted cost (K4 forward, K2/K3 backward)
    against 12·D model flops a visible pair."""
    B, H, T, D, n = (RING[k] for k in ("B", "H", "T", "D", "workers"))
    fused = ring_attention_sharded(make_mesh((n,), ("seq",)), "seq",
                                   causal=True)
    gen = torch.Generator().manual_seed(SEED + 63)
    q, k, v, do = ((torch.randn(B, H, T, D, generator=gen) * 0.5).cuda()
                   for _ in range(4))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    _reset_launches()
    with tel.count_cost() as cost:
        torch.autograd.grad(fused(*leaves), leaves, do)
    torch.cuda.synchronize()
    launches = _launches(PARALLEL_COUNTED)
    analytic = 12.0 * D * T * (T + 1) / 2 * B * H
    hops = n * (n + 1) // 2
    if launches["flash_block_update"] != hops:
        raise AssertionError(f"phase 21 (a): the ring launched {launches}")
    return {"shape": [B, H, T, D], "workers": n, "launches": launches,
            "kernel_flops_counted": cost.kernel_flops,
            "flops_counted": cost.total_flops,
            "flops_analytic_12D_pairs": analytic,
            "kernel_over_analytic": cost.kernel_flops / analytic,
            "counted_over_analytic": cost.total_flops / analytic}


def _pt_compressed_cost(tel, batches):
    """(a5) a compressed data-parallel step's counted cost against 6·N·B·T
    plus attention, and K9's counted bytes (the compressed step's kernel
    bytes less the plain step's on the same batch) against 9 an element a
    worker."""
    net = _tlm_f32(SEED + 64)
    mesh = make_mesh((DP_WORKERS,), ("data",))
    N = net.num_params()
    out = {}
    for name, acc in (("plain", None),
                      ("compressed", EncodedAccumulator(
                          threshold=DP_THRESHOLD))):
        pw = ParallelWrapper(net, mesh=mesh, gradient_accumulator=acc,
                             prefetch_buffer=0)
        _reset_launches()
        with tel.count_cost() as cost:
            pw.fit(ListDataSetIterator(batches[:1]))
        torch.cuda.synchronize()
        out[name] = {"launches": _launches(PARALLEL_COUNTED),
                     "flops": cost.total_flops,
                     "kernel_flops": cost.kernel_flops,
                     "kernel_bytes": cost.kernel_bytes}
    T, H, L = TLM["max_length"], TLM["n_heads"], TLM["n_blocks"]
    Dh = TLM["d_model"] // H
    analytic = 6.0 * N * TRAIN_B * T \
        + 12.0 * L * TRAIN_B * H * Dh * T * (T + 1) / 2
    k9_analytic = 9.0 * N * DP_WORKERS
    k9_counted = out["compressed"]["kernel_bytes"] \
        - out["plain"]["kernel_bytes"]
    if out["compressed"]["launches"]["threshold_encode"] != DP_WORKERS:
        raise AssertionError(f"phase 21 (a): the compressed step launched "
                             f"{out['compressed']['launches']}")
    if abs(k9_counted / k9_analytic - 1.0) > 1e-9:
        raise AssertionError(f"phase 21 (a): K9's counted bytes "
                             f"{k9_counted} are not 9 an element a worker "
                             f"({k9_analytic})")
    out.update({"num_params": N, "flops_analytic": analytic,
                "counted_over_analytic":
                    out["compressed"]["flops"] / analytic,
                "k9_bytes_counted": k9_counted,
                "k9_bytes_analytic": k9_analytic,
                "k9_counted_over_analytic": k9_counted / k9_analytic})
    return out


def _pt_on_off(tel, batches):
    """(a6) the plain sync step at _TLM on 4 workers with the registry on
    and off, alternated (reported, not gated)."""
    net = _tlm_f32(SEED + 65)
    pw = ParallelWrapper(net, mesh=make_mesh((DP_WORKERS,), ("data",)),
                         prefetch_buffer=0)
    reg = tel.get_registry()
    was = reg.enabled
    times = {"on": [], "off": []}
    _reset_launches()
    try:
        for cycle in range(PT_ONOFF_CYCLES + 1):
            for state in ("on", "off"):
                reg.enabled = state == "on"
                for b in batches[:PT_ONOFF_STEPS]:
                    t0 = time.perf_counter()
                    pw.fit(ListDataSetIterator([b]))
                    torch.cuda.synchronize()
                    if cycle:                     # the first is the warm one
                        times[state].append(
                            (time.perf_counter() - t0) * 1e3)
    finally:
        reg.enabled = was
    launches = _launches(PARALLEL_COUNTED)
    q = {s: [float(v) for v in np.percentile(t, [25, 50, 75])]
         for s, t in times.items()}
    return {"step_ms": times, "p25_p50_p75": q, "launches": launches,
            "on_over_off": q["on"][1] / q["off"][1]}


def _fleet_prompts(n, seed, lo=64, hi=400):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TLM["vocab_size"], size=int(k)).tolist()
            for k in rng.integers(lo, hi, size=n)]


def _fleet_stream(client, base, payload, trace_id=None, on_line=None):
    """One streamed /generate through the front door: its lines and the
    first token's arrival (ms after the request)."""
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["X-Trace-Id"] = trace_id
    lines, ttft = [], None
    t0 = time.perf_counter()
    with client.stream("POST", base + "/generate",
                       body=json.dumps(payload).encode(), headers=headers,
                       timeout=300.0) as resp:
        if resp.status != 200:
            raise AssertionError(f"phase 21 (b): /generate {resp.status}")
        for raw in resp:
            if not raw.strip():
                continue
            obj = json.loads(raw)
            if "token" in obj and ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            lines.append(obj)
            if on_line is not None:
                on_line(obj)
    return lines, ttft


def _fleet_k1_launches(client, url):
    """A replica's K1 launches since it turned ready: its own wrapper's
    count, served in the ``replica`` block of its ``/health``."""
    st, h = client.request_json("GET", url + "/health", timeout=60.0)
    if st != 200:
        raise AssertionError(f"phase 21 (b): {url}/health {st}")
    return h["replica"]["kernel_launches"]["flash_attention_fwd"]


def _fleet_k1(client, url, n_blocks):
    """K1 on a replica, read from what it serves: its prefill programs'
    counted kernel flops (K1's ``note_kernel``, 4·Dh a visible pair a
    head and block) and its served prefills."""
    st, m = client.request_json("GET", url + "/metrics", timeout=60.0)
    if st != 200:
        raise AssertionError(f"phase 21 (b): {url}/metrics {st}")
    H = TLM["n_heads"]
    Dh = TLM["d_model"] // H
    rows = []
    for p in m["perf"]["programs"]:
        if ".prefill." not in p["path"]:
            continue
        P, L = (int(s[1:]) for s in p["path"].rsplit(".", 1)[1].split("x"))
        want = n_blocks * 4.0 * Dh * L * (L + 1) / 2 * H * P
        rows.append({"path": p["path"],
                     "kernel_flops": p["kernel_flops_per_step"],
                     "k1_analytic": want})
        if p["kernel_flops_per_step"] != want:
            raise AssertionError(f"phase 21 (b): {url}'s {p['path']} "
                                 f"counted {p['kernel_flops_per_step']} "
                                 f"kernel flops, not K1's {want}")
    prefills = m["generation"]["lm"]["prefills"]
    if not rows or not prefills:
        raise AssertionError(f"phase 21 (b): {url} served no K1 prefill")
    return {"prefill_programs": rows, "prefills_served": prefills,
            "k1_launches_if_one_a_block": prefills * n_blocks}


def _fleet(tel, tmp):
    """(b) two replica processes of _TLM behind the router, the collector
    and the front door: 8 streamed greedy requests equal to an in-process
    engine's; K1 on each replica; a kill before the first token replays
    on the survivor; a kill after it closes the stream with
    ``replica_lost``; the dead replicas' spools stitch into the traces;
    the second replica joins the warm library directory with no build."""
    from deeplearning4j_tpu_torch.serving.fleet import (FleetCollector,
                                                        FleetHTTPServer,
                                                        FleetRouter,
                                                        ReplicaProcess)
    dumps = os.path.join(tmp, "fleet_flightrec")
    prev_fr = tel.set_flight_recorder(tel.FlightRecorder(dumps))
    # the front door's own events and the collector's stitching share one
    # fresh registry
    prev_reg = tel.set_registry(tel.MetricsRegistry(enabled=True))
    kw = dict(TLM, seed=SEED + 66, dtype="float32", token_input=True)
    spec = {"model": {"zoo": "transformer_lm", "kwargs": kw},
            "model_name": "lm", "generation": FLEET_GEN, "device": "cuda",
            "compile_cache": os.path.join(tmp, "fleet_kernels"),
            "spool_period_s": 0.1}
    env = {"DL4J_TPU_FLIGHTREC_DIR": dumps}
    router = FleetRouter(policy="affinity", health_period_s=0.1).start()
    col = FleetCollector(router)
    front = FleetHTTPServer(router, collector=col)
    client = HTTPClient(max_per_host=FLEET_REQUESTS, timeout=300.0)
    procs, direct = {}, None
    try:
        ready = {}
        for rid in ("r0", "r1"):     # the second starts on a warm directory
            procs[rid] = ReplicaProcess(spec, rid, workdir=tmp, env=env)
            t0 = time.perf_counter()
            router.add_process(procs[rid], wait_ready=True, timeout=600.0)
            ready[rid] = dict(procs[rid].ready_info,
                              wall_s=time.perf_counter() - t0)
        if ready["r0"]["fresh_compiles"] < 1 or \
                ready["r1"]["fresh_compiles"] != 0 or \
                ready["r1"]["cache_hits"] < 1:
            raise AssertionError(f"phase 21 (b): cold starts {ready}")
        base = f"http://127.0.0.1:{front.start()}"
        net = transformer_lm(**kw).init()
        _reset_launches()                       # the direct engine's K1
        direct = GenerationEngine(net, model_name="lm", **FLEET_GEN)

        def want(p, n=FLEET_MAX_TOKENS):
            return direct.generate(p, max_tokens=n)[0]

        # each replica's own K1 count, read before and after the requests
        k1_before = {rid: _fleet_k1_launches(client, r.base_url)
                     for rid, r in procs.items()}
        # 8 streamed greedy requests at once, each traced
        prompts = _fleet_prompts(FLEET_REQUESTS, SEED + 67)
        tids = [f"{i + 1:08x}" + "f1ee7" * 4 for i in range(len(prompts))]
        with ThreadPoolExecutor(len(prompts)) as ex:
            got = list(ex.map(lambda a: _fleet_stream(
                client, base, {"prompt": a[0],
                               "max_tokens": FLEET_MAX_TOKENS}, a[1]),
                zip(prompts, tids)))
        served_by = {}
        for i, (p, (lines, _)) in enumerate(zip(prompts, got)):
            toks = [l["token"] for l in lines if "token" in l]
            if toks != want(p) or lines[-1].get("reason") != "length":
                raise AssertionError(f"phase 21 (b): request {i}'s tokens "
                                     f"differ from the direct engine's")
            served_by[tids[i]] = lines[-1]["replica"]
        if set(served_by.values()) != {"r0", "r1"}:
            raise AssertionError(f"phase 21 (b): one replica served all "
                                 f"({served_by})")
        # TTFT through the door beside the direct call's, fresh prompts
        ttft = {"front_door": [], "direct": []}
        for p in _fleet_prompts(FLEET_REQUESTS, SEED + 68):
            ttft["front_door"].append(_fleet_stream(
                client, base, {"prompt": p, "max_tokens": 4})[1])
        for p in _fleet_prompts(FLEET_REQUESTS, SEED + 69):
            t0 = time.perf_counter()
            toks = iter(direct.generate(p, max_tokens=4, stream=True))
            next(toks)
            ttft["direct"].append((time.perf_counter() - t0) * 1e3)
            list(toks)
        k1 = {rid: _fleet_k1(client, r.base_url, TLM["n_blocks"])
              for rid, r in procs.items()}
        for rid, r in procs.items():
            k1[rid]["k1_launches"] = \
                _fleet_k1_launches(client, r.base_url) - k1_before[rid]
            if k1[rid]["k1_launches"] < 1:
                raise AssertionError(f"phase 21 (b): replica {rid} "
                                     f"launched no K1 ({k1[rid]})")
        # a kill before the first token: the replay on the survivor
        p_replay = _fleet_prompts(1, SEED + 70)[0]
        victim = router.candidates(p_replay)[0][0]
        survivor = "r1" if victim == "r0" else "r0"
        router.stop()                          # the victim stays READY
        procs[victim].kill()
        lines = list(router.stream_generate({"prompt": p_replay,
                                             "max_tokens": FLEET_MAX_TOKENS}))
        toks = [l["token"] for l in lines if "token" in l]
        done = lines[-1]
        if toks != want(p_replay) or done.get("replica") != survivor or \
                not done.get("retries"):
            raise AssertionError(f"phase 21 (b): the replay {done}")
        router.start()
        deadline = time.monotonic() + 30
        while {r["id"]: r["state"] for r in router.replicas()}[victim] \
                != "dead":
            if time.monotonic() > deadline:
                raise AssertionError("phase 21 (b): the victim never dead")
            time.sleep(0.05)
        # a kill after the first token: the stream closes, replica_lost
        killed = []

        def kill_at_first_token(obj):
            if "token" in obj and not killed:
                killed.append(True)
                router.kill_replica(survivor)

        lost, _ = _fleet_stream(client, base,
                                {"prompt": _fleet_prompts(1, SEED + 71,
                                                          64, 200)[0],
                                 "max_tokens": 256},
                                on_line=kill_at_first_token)
        n_lost = sum(1 for l in lost if "token" in l)
        if lost[-1].get("reason") != "replica_lost" or \
                lost[-1].get("replica") != survivor or n_lost >= 256:
            raise AssertionError(f"phase 21 (b): the lost stream ended "
                                 f"{lost[-1]}")
        # both replicas dead: the collector reads only their spools
        deadline = time.monotonic() + 30
        while any(r["state"] != "dead" for r in router.replicas()):
            if time.monotonic() > deadline:
                raise AssertionError("phase 21 (b): replicas not dead")
            time.sleep(0.05)
        col.pull_once()
        tid = next(t for t, r in served_by.items() if r == victim)
        events = col.events_for_trace(tid)
        where = {e["args"]["replica"] for e in events}
        if col.spools_recovered < 2 or not {"front", victim} <= where or \
                not any(e["name"].startswith("generation.")
                        and e["args"]["replica"] == victim
                        for e in events):
            raise AssertionError(f"phase 21 (b): trace {tid} stitched "
                                 f"from {where} ({col.snapshot()})")
        lost_dumps = [d for d in os.listdir(dumps)
                      if d.endswith("_fleet_replica_lost.json")]
        if len(lost_dumps) < 2:
            raise AssertionError(f"phase 21 (b): dumps {os.listdir(dumps)}")
        direct_k1 = fa.flash_attention.launches
    finally:
        tel.set_flight_recorder(prev_fr)
        tel.set_registry(prev_reg)
        client.close()
        front.stop(close_router=True)
        col.stop()
        for p in procs.values():
            p.kill()
        if direct is not None:
            direct.stop(drain=False)
    p50 = lambda v: float(np.median(v))
    return {"n_blocks": TLM["n_blocks"], "requests": FLEET_REQUESTS,
            "max_tokens": FLEET_MAX_TOKENS, "generation": FLEET_GEN,
            "ready": ready, "served_by": served_by,
            "ttft_ms": ttft, "ttft_p50_front_door": p50(ttft["front_door"]),
            "ttft_p50_direct": p50(ttft["direct"]), "k1": k1,
            "k1_launches": {"replicas": sum(
                r["k1_launches"] for r in k1.values()),
                "direct_engine": direct_k1},
            "replay": {"victim": victim, "survivor": survivor,
                       "retries": done["retries"]},
            "lost_stream_tokens": n_lost,
            "stitched_events": len(events),
            "spools_recovered": col.spools_recovered,
            "replica_lost_dumps": len(lost_dumps)}


def parallel_fleet_phase():
    """Phase 21 (see the module docstring): (a) the parallel layer's
    telemetry, (b) the serving fleet."""
    from deeplearning4j_tpu_torch import telemetry as tel
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="p21_")
    try:
        batches = _pt_batches(4, SEED + 59)
        wrapper = _pt_wrapper(tel, batches)
        torch.cuda.empty_cache()
        elastic = _pt_elastic(tel, batches, tmp)
        torch.cuda.empty_cache()
        ring = _pt_ring_cost(tel)
        torch.cuda.empty_cache()
        compressed = _pt_compressed_cost(tel, batches)
        torch.cuda.empty_cache()
        on_off = _pt_on_off(tel, batches)
        del batches
        torch.cuda.empty_cache()
        t_b = time.perf_counter()
        fleet = _fleet(tel, tmp)
        fleet["seconds"] = time.perf_counter() - t_b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_path = {
        "parallel_telemetry_zero": wrapper["zero_launches"],
        "parallel_telemetry_window": wrapper["window_launches"],
        "parallel_telemetry_elastic": elastic["launches"],
        "parallel_telemetry_ring": ring["launches"],
        "parallel_telemetry_compressed": {
            n: compressed["plain"]["launches"][n]
            + compressed["compressed"]["launches"][n]
            for n in PARALLEL_COUNTED},
        "parallel_telemetry_on_off": on_off["launches"],
        "fleet_direct": {n: 0 for n in PARALLEL_COUNTED},
        "fleet_replicas": {n: 0 for n in PARALLEL_COUNTED}}
    by_path["fleet_direct"]["flash_attention_fwd"] = \
        fleet["k1_launches"]["direct_engine"]
    by_path["fleet_replicas"]["flash_attention_fwd"] = \
        fleet["k1_launches"]["replicas"]
    row = {"wrapper": wrapper, "elastic": elastic, "ring_cost": ring,
           "compressed_cost": compressed, "registry_on_off": on_off,
           "fleet": fleet, "launches_by_path": by_path,
           "launches": {n: sum(p[n] for p in by_path.values())
                        for n in PARALLEL_COUNTED},
           "seconds": time.perf_counter() - t0}
    log(f"phase 21: {row['seconds']:.1f} s (fleet {fleet['seconds']:.1f}); "
        f"ring counted/analytic {ring['counted_over_analytic']:.4f}, "
        f"compressed {compressed['counted_over_analytic']:.4f}, K9 bytes "
        f"{compressed['k9_counted_over_analytic']:.4f}; step p50 on/off "
        f"{on_off['on_over_off']:.4f}; ready "
        f"{[round(r['wall_s'], 1) for r in fleet['ready'].values()]} s; "
        f"TTFT p50 door/direct {fleet['ttft_p50_front_door']:.1f}/"
        f"{fleet['ttft_p50_direct']:.1f} ms")
    return row


# ----------------------------------------------------------------- phase 22
REGISTRY_NAMES = ["attention", "conv1x1_bias_relu", "int8_matmul", "lstm",
                  "threshold_encode"]
UI_ROUNDS, UI_ITERS, UI_BINS = 3, 8, 20     # (b): rounds of 8 iterations
UI_COUNTED = dict(LSTM_COUNTED, conv1x1_bias_relu=k7.conv1x1_fused)
UI_GNET_STEPS, UI_GNET_B = 4, 8
UI_GEN = dict(block_len=16, max_seq_len=128, decode_slots=2,
              prefill_batches=(1,), prompt_rungs=(64,))


def _ui_reset():
    for fn in UI_COUNTED.values():
        fn.launches = 0


def _ui_launches():
    return {n: fn.launches for n, fn in UI_COUNTED.items()}


def _event_ms_per_call(fn, n=50):
    """Device time of one call by CUDA events over ``n`` calls (after a
    warm call): where the profiler records no kernel late in a run."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _kernel_device_ms(fn, name):
    """(ms, source): the device time of one call, and whether the profiler
    or CUDA events gave it."""
    k = len(EVENT_TIMED)
    ms = _device_ms_per_call(fn, name=name)
    return ms, "profiler" if len(EVENT_TIMED) == k else "cuda_events"


def _registry_timings(kreg, n_params):
    """Each registered kernel's device time at one full-width shape the
    repository runs, folded in by ``record_kernel_timing``, beside
    PERF.md's bound for the same shape (``_bound``, ``_lstm_bound``,
    ``_roof_ms``)."""
    gen = torch.Generator().manual_seed(SEED + 80)
    f32 = torch.float32
    cases = {}
    q, k, v, _ = _case(gen, 16, 1024, 64, f32, True, False)
    cases["attention"] = (
        "1x16x1024x64", "flash_fwd", lambda: fa.flash_attention_fwd(
            q, k, v, causal=True, scale=0.125),
        _bound("fwd", 16, 1024, 64, f32, True),
        "phase 3's serve shape, causal; the registry's formula counts the "
        "full T^2 square and q/k/v/o only")
    H = CHAR["hidden"]
    fwd, _, peeps, _ = _lstm_case(gen, CHAR_T, CHAR_B, H, f32, True, False)
    cases["lstm"] = (
        f"{CHAR_T}x{CHAR_B}x{H}", "lstm_fwd",
        lambda: lstm.fused_lstm_fwd(*fwd, None, peeps),
        _lstm_bound("fwd", CHAR_T, CHAR_B, H, f32, True, False),
        "the char-RNN's, Graves peepholes; the registry's bytes leave out "
        "gates, cs and the carries K5 writes")
    r = _residual_like(gen, n_params, f32, DP_THRESHOLD)
    cases["threshold_encode"] = (
        str(n_params), "threshold_encode",
        lambda: k9.threshold_encode_fused(r, DP_THRESHOLD),
        (k9.roofline_bytes(n_params, f32) / HBM_BYTES_PER_S * 1e3, "bytes"),
        "_TLM's parameter count, f32; the same 9 bytes an element")
    M, K, N = int8_products(max(INT8_BUCKETS))[0]
    xq, xs = k8.quantize_rows(torch.randn(M, K, generator=gen).cuda())
    wq, ws = k8.quantize_weights(torch.randn(K, N, generator=gen).cuda())
    xq, wq = xq.contiguous(), wq.contiguous()
    cases["int8_matmul"] = (
        f"{M}x{K}x{N}", "int8", lambda: k8.int8_matmul_fused(xq, wq, xs, ws),
        _roof_ms(*k8.roofline(M, K, N), PEAK_INT8_OPS),
        "the int8 net's first product at M 256; the same formula")
    vertex, M, C, Fo = googlenet_1x1_shapes(TRANSFER_B)[0]
    x = torch.randn(M, C, generator=gen).cuda()
    w = (torch.randn(C, Fo, generator=gen) * (2.0 / C) ** 0.5).cuda()
    b = (torch.randn(Fo, generator=gen) * 0.1 + 0.2).cuda()
    cases["conv1x1_bias_relu"] = (
        f"{M}x{C}x{Fo}", "conv1x1", lambda: k7.conv1x1_fused(x, w, b),
        _roof_ms(*k7.roofline(M, C, Fo), PEAK_FLOPS[f32]),
        f"GoogLeNet's {vertex} at B {TRANSFER_B}; the same formula")
    rows = {}
    for name in REGISTRY_NAMES:
        sig, kernel, call, (bound, by), note = cases[name]
        ms, source = _kernel_device_ms(call, kernel)
        got = kreg.record_kernel_timing(name, sig, ms / 1e3)
        if got is None:
            raise AssertionError(f"record_kernel_timing({name!r}) set no "
                                 f"gauge on {torch.cuda.get_device_name()}")
        rows[name] = {"sig": sig, "device_ms": ms, "timed_by": source,
                      "registry": got, "perf_md_bound_ms": bound,
                      "perf_md_bound_by": by,
                      "ms_over_perf_md_bound": ms / bound, "bound_note": note}
    return rows


def _registry_phase(n_params, tmp):
    """(a): the registry on the card: names, implementations, every pin
    on the card within its tolerance, the five timings and a perf dump
    that ``tools/kernels_report.py`` renders."""
    from deeplearning4j_tpu_torch import telemetry as tel
    from deeplearning4j_tpu_torch.ops import kernels as kreg
    names = kreg.names()
    if names != REGISTRY_NAMES:
        raise AssertionError(f"registered kernels {names}")
    impls = {n: [kreg.active_impl(n, "cuda"), kreg.active_impl(n, "cpu")]
             for n in names}
    if any(v != ["fused", "fallback"] for v in impls.values()):
        raise AssertionError(f"active implementations {impls}")
    pins = {}
    for n in names:
        spec = kreg.get(n)
        got, plain = spec.parity.run(SEED, "cuda")
        torch.cuda.synchronize()
        if not all(t.is_cuda for t in got + plain):
            raise AssertionError(f"the {n} pin did not run on the card")
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, plain))
        if not err <= spec.parity.tol:
            raise AssertionError(f"the {n} pin on the card: max abs error "
                                 f"{err:.3g} over its tolerance "
                                 f"{spec.parity.tol}")
        pins[n] = {"max_abs_err": err, "tol": spec.parity.tol}
    timings = _registry_timings(kreg, n_params)
    snap = kreg.kernels_snapshot()
    if any(snap[n]["impl"] != "fused" for n in names):
        raise AssertionError(f"snapshot rows {snap}")
    dump = tel.write_perf_dump(os.path.join(tmp, "perf_dump.json"))
    rep = subprocess.run([sys.executable, "tools/kernels_report.py", dump],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, DL4J_TPU_AUTOTUNE_CACHE=
                                  os.path.join(tmp, "autotune.json")))
    lines = rep.stdout.splitlines()
    table = [ln.split() for ln in lines if ln.split()[:1]
             and ln.split()[0] in names and "measured" not in ln]
    roof = [ln.split()[0] for ln in lines if "measured" in ln
            and "roofline" in ln]
    if rep.returncode != 0 or [t[:2] for t in table] != \
            [[n, "fused"] for n in names] or sorted(roof) != names:
        raise AssertionError(f"kernels_report.py: rc {rep.returncode}, "
                             f"{rep.stdout[-2000:]} {rep.stderr[-2000:]}")
    return {"names": names, "active_impl": impls, "pins": pins,
            "timings": timings, "report_lines": lines}


class _TeeStorage:
    """One listener's records into two storages (its reads from the
    first)."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def put_static_info(self, sid, wid, info):
        self.first.put_static_info(sid, wid, info)
        self.second.put_static_info(sid, wid, info)

    def put_update(self, sid, wid, update):
        self.first.put_update(sid, wid, update)
        self.second.put_update(sid, wid, update)


class _ReadsCounted:
    """Runs a listener's ``iteration_done`` under a
    ``telemetry.HostSyncDetector``: the host reads a report makes."""

    def __init__(self, inner):
        self.inner, self.reads = inner, []

    def iteration_done(self, net, iteration, loss):
        from deeplearning4j_tpu_torch import telemetry as tel
        with tel.HostSyncDetector(action="count") as det:
            self.inner.iteration_done(net, iteration, loss)
        self.reads.append(det.count)


class _HostCopies:
    """Host copies of every parameter and of the sample's activations at
    each iteration (after the listener before it in the list)."""

    def __init__(self, sample):
        self.sample, self.params, self.acts = sample, [], []

    def iteration_done(self, net, iteration, loss):
        from deeplearning4j_tpu_torch.ui.stats import named_leaves
        self.params.append({n: p.detach().float().cpu().clone().numpy()
                            for n, p in named_leaves(net.param_dicts())})
        with torch.no_grad():
            acts = net.feed_forward(self.sample)[1:]
        self.acts.append([a.float().cpu().numpy() for a in acts])


def _np_edges(lo, hi, bins):
    """``jnp.histogram``'s float32 edges as XLA computes them (the
    listener's rule), in numpy float64 where the products are exact."""
    f32 = np.float32
    r = float(f32(1.0) / f32(bins))
    i = np.arange(bins, dtype=np.float64)
    a = float(lo) * (1.0 - (i * r).astype(f32)).astype(f32).astype(
        np.float64)
    br = float(f32(float(hi) * r))
    e = i * br + a.astype(f32).astype(np.float64)
    e[1] = a[1] + br
    return np.concatenate([e.astype(f32), [f32(hi)]])


def _np_stats(x, bins):
    """A leaf's record in numpy (float64 moments of the float32 values)."""
    x = x.reshape(-1)
    x64 = x.astype(np.float64)
    mn, mx = x.min(), x.max()
    lo, hi = (mn - np.float32(0.5), mx + np.float32(0.5)) if mn == mx \
        else (mn, mx)
    edges = _np_edges(lo, hi, bins)
    idx = np.searchsorted(edges, x, side="right")
    idx[x == edges[-1]] = bins
    counts = np.bincount(idx, minlength=bins + 1)[1:]
    return {"max": float(mx), "mean": x64.mean(),
            "meanmag": np.abs(x64).mean(), "min": float(mn),
            "stdev": x64.std(), "histogram": {
                "counts": [float(c) for c in counts], "lo": float(lo),
                "hi": float(hi)}}


def _rel(got, want, scale):
    return abs(got - want) / max(abs(want), scale, 1e-30)


def _stats_vs_numpy(rec, copies):
    """The largest relative error of each statistic of the last record
    against numpy on host copies of the same parameters (moments relative
    to the leaf's largest magnitude, update moments to their mean
    magnitude); histogram counts and ranges must be equal."""
    now, prev = copies.params[-1], copies.params[-2]
    errs = {}
    for n, x in now.items():
        want = _np_stats(x, UI_BINS)
        got = rec["params"][n]
        scale = max(abs(want["min"]), abs(want["max"]))
        for k in ("max", "mean", "meanmag", "min", "stdev"):
            errs[f"params.{k}"] = max(errs.get(f"params.{k}", 0.0),
                                      _rel(got[k], want[k], scale))
        if got["histogram"] != want["histogram"]:
            raise AssertionError(f"{n}: histogram {got['histogram']} vs "
                                 f"numpy's {want['histogram']}")
        d = (x - prev[n]).astype(np.float64)
        up = {"mean": d.mean(), "meanmag": np.abs(d).mean(),
              "stdev": d.std()}
        for k, v in up.items():
            errs[f"updates.{k}"] = max(errs.get(f"updates.{k}", 0.0),
                                       _rel(rec["updates"][n][k], v,
                                            up["meanmag"]))
    for i, a in enumerate(copies.acts[-1]):
        errs["activations"] = max(errs.get("activations", 0.0), _rel(
            rec["activations"][f"layer_{i}"],
            np.abs(a.astype(np.float64)).mean(), 0.0))
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"listener statistics against numpy: {errs}")
    return errs


def _quartiles(ms):
    q = np.percentile(ms, [25, 50, 75])
    return {"p25": float(q[0]), "p50": float(q[1]), "p75": float(q[2])}


def _ui_char(tee, ui_mod):
    """(b1): the char-RNN with a ``StatsListener`` (every iteration:
    histograms, updates, activations of a 1-sequence sample, memory)
    into ``tee``: a check run against numpy with its host reads counted,
    then 3 interleaved rounds of 8 iterations with it, with it into
    memory and without."""
    net = text_generation_lstm(**CHAR, tbptt_length=CHAR_T).init(
        seed=SEED + 81)
    xs, ys = _char_batch(SEED + 82, CHAR_B * UI_ITERS, CHAR_T)
    x, y = (torch.as_tensor(a, device=net.device) for a in (xs, ys))
    sample = xs[:1]
    cfg = ui_mod.StatsUpdateConfiguration(
        report_frequency=1, collect_histograms=True, histogram_bins=UI_BINS,
        collect_activation_stats=True)
    launches = {n: 0 for n in UI_COUNTED}

    def counted(fit):
        torch.cuda.synchronize()
        _ui_reset()
        fit()
        torch.cuda.synchronize()
        for n, c in _ui_launches().items():
            launches[n] += c

    check = ui_mod.StatsListener(ui_mod.InMemoryStatsStorage(), config=cfg,
                                 session_id="p22_check",
                                 activation_sample=sample)
    reads, copies = _ReadsCounted(check), _HostCopies(sample)
    net.set_listeners(reads, copies)
    counted(lambda: net.fit(x[:2 * CHAR_B], y[:2 * CHAR_B],
                            batch_size=CHAR_B))
    rec = check.storage.get_latest_update("p22_check", "worker_0")
    errs = _stats_vs_numpy(rec, copies)
    if reads.reads != [1, 1]:
        raise AssertionError(f"host reads a report: {reads.reads}")
    # the listener into the two files; the same listener's work into
    # memory (the storages' share); no listener
    listeners = {
        "with": ui_mod.StatsListener(tee, config=cfg, session_id="p22_char",
                                     activation_sample=sample),
        "with_memory": ui_mod.StatsListener(
            ui_mod.InMemoryStatsStorage(), config=cfg,
            session_id="p22_memory", activation_sample=sample),
        "without": None}
    modes = list(listeners)
    step_ms = {m: [] for m in modes}
    for rnd in range(UI_ROUNDS):
        for mode in modes[rnd:] + modes[:rnd]:
            clock = _WindowClock(1)
            lst = listeners[mode]
            net.set_listeners(*([lst, clock] if lst else [clock]))
            t0 = time.perf_counter()
            counted(lambda: net.fit(x, y, batch_size=CHAR_B))
            step_ms[mode] += [(b - a) * 1e3 for a, b in
                              zip([t0] + clock.t, clock.t)]
    net.set_listeners()
    # 2 layers a step, a listener's forward and the check's own forward
    steps = 2 + len(modes) * UI_ROUNDS * UI_ITERS
    reports = 2 + 2 * UI_ROUNDS * UI_ITERS
    want = {"lstm_fwd": 2 * (steps + reports + 2), "lstm_bwd": 2 * steps,
            "conv1x1_bias_relu": 0}
    if launches != want:
        raise AssertionError(f"char-RNN fits launched {launches}, not "
                             f"{want}")
    q = {m: _quartiles(v[1:]) for m, v in step_ms.items()}
    base = q["without"]["p50"]
    return net, {
        "model": f"text_generation_lstm vocab {CHAR['vocab_size']} hidden "
                 f"{CHAR['hidden']} f32 RmsProp(1e-3) tBPTT {CHAR_T}, "
                 f"B {CHAR_B}",
        "reports": UI_ROUNDS * UI_ITERS, "check_reports": 2,
        "host_reads_per_report": reads.reads,
        "max_rel_err_vs_numpy": errs,
        "step_ms": step_ms, "step_ms_quartiles": q,
        "with_over_without_p50": q["with"]["p50"] / base,
        "with_memory_over_without_p50": q["with_memory"]["p50"] / base,
        "launches": launches}


def _ui_googlenet(tee, ui_mod):
    """(b2): phase 12c's transfer network, 4 steps at B 8 with a
    ``ConvolutionalIterationListener`` at frequency 2 on a 1-image
    sample."""
    src = googlenet(**GNET).init(seed=SEED + 83)
    net = (TransferLearningGraph(src).set_feature_extractor("avg3")
           .n_out_replace("output", TRANSFER_CLASSES, weight_init="xavier")
           .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-3)))
           .build())
    del src
    batches = _resnet_batches(UI_GNET_STEPS, SEED + 84, TRANSFER_CLASSES,
                              GNET["height"], UI_GNET_B)
    lst = ui_mod.ConvolutionalIterationListener(
        batches[0].features[:1], storage=tee, frequency=2,
        session_id="p22_googlenet")
    net.set_listeners(lst)
    torch.cuda.synchronize()
    _ui_reset()
    t0 = time.perf_counter()
    net.fit(iterator=ListDataSetIterator(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _ui_launches()
    net.set_listeners()
    forwards = UI_GNET_STEPS + UI_GNET_STEPS // 2
    if launches["conv1x1_bias_relu"] != 37 * forwards:
        raise AssertionError(f"K7 launched {launches} for {UI_GNET_STEPS} "
                             f"steps and {UI_GNET_STEPS // 2} listener "
                             f"forwards (37 each)")
    grids = [base64.b64decode(png) for u in
             tee.first.get_updates("p22_googlenet", "worker_0")
             for png in u["conv_activations"].values()]
    if len(grids) != (UI_GNET_STEPS // 2) * lst.max_layers or \
            not all(g[:8] == b"\x89PNG\r\n\x1a\n" for g in grids):
        raise AssertionError(f"{len(grids)} activation grids")
    return net, {"steps": UI_GNET_STEPS, "batch": UI_GNET_B,
                 "listener_forwards": UI_GNET_STEPS // 2, "fit_s": fit_s,
                 "grids": len(grids), "png_bytes": sum(map(len, grids)),
                 "launches": launches}


def _ui_generation(net, tee):
    """(b3): two greedy requests to the trained char-RNN through a small
    ``GenerationEngine``; its metrics published into the storage."""
    eng = GenerationEngine(net, **UI_GEN)
    rt = eng.runtime()
    rng = np.random.default_rng(SEED + 85)
    prompts = [rng.integers(0, CHAR["vocab_size"], size=40).tolist()
               for _ in range(2)]
    try:
        _ui_reset()
        results = [eng.generate(p, max_tokens=16) for p in prompts]
        if not rt.wait_idle(60):
            raise AssertionError("the runtime did not go idle")
        eager = _ui_launches()
        graphs = rt.graph_stats()
        eng.publish_metrics(tee)
    finally:
        eng.stop()
    if any(len(t) != 16 for t, _ in results):
        raise AssertionError(f"generation results {results}")
    k5 = eager["lstm_fwd"] + graphs["kernel_runs"].get("lstm_fwd", 0)
    return {"requests": 2, "tokens": [t for t, _ in results],
            "launches": dict(eager, lstm_fwd=k5),
            "graph_replays": graphs["replays"]}


def _ui_server(ui_mod, reader, timings):
    """(b4): ``TrainingUIServer`` on an ephemeral port over ``reader``:
    three pages and one POST; the Performance card's kernel table, no
    baseline row, the warm-runs headline."""
    server = ui_mod.TrainingUIServer()
    server.attach(reader)
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    pages = {}
    try:
        for what, path in (("overview", "/"),
                           ("char_model_page", "/?session=p22_char"),
                           ("googlenet_session", "/?session=p22_googlenet")):
            t0 = time.perf_counter()
            status, _, body = _http(base, "GET", path)
            ms = (time.perf_counter() - t0) * 1e3
            pages[what] = {"status": status, "bytes": len(body), "ms": ms}
            page = body.decode()
            if status != 200:
                raise AssertionError(f"GET {path}: {status}")
            table = page[page.index("<h3>Kernels (impl"):]
            rows = table[:table.index("</table>")].split("<tr>")[2:]
            got = {r.split("<td>")[1].split("<")[0]: r for r in rows}
            if sorted(got) != REGISTRY_NAMES:
                raise AssertionError(f"GET {path}: kernel rows {sorted(got)}")
            for n, r in got.items():
                ratio = timings[n]["registry"]["vs_roofline"]
                if "<td>fused</td>" not in r or \
                        f"{ratio:.2f}x bound" not in r:
                    raise AssertionError(f"GET {path}: row {r}")
            if "vs baseline" in page:
                raise AssertionError(f"GET {path}: a baseline row")
            if not re.search(r"<tr><th>warm runs</th><td>\d+</td></tr>",
                             page):
                raise AssertionError(f"GET {path}: no warm-runs headline")
        if "Convolutional activations" not in \
                _http(base, "GET", "/?session=p22_googlenet")[2].decode():
            raise AssertionError("no activation grids on the page")
        char_page = _http(base, "GET", "/?session=p22_char")[2].decode()
        if not all(k in char_page for k in ("Model graph", "GravesLSTM",
                                            "Parameter histograms")):
            raise AssertionError("the char session's page lacks its model "
                                 "graph or histograms")
        status, _, body = _http(base, "POST", "/collect", {
            "kind": "update", "session_id": "p22_remote",
            "worker_id": "w0", "data": {"iteration": 1, "score": 0.5}})
        if status != 200 or json.loads(body) != {"ok": True} or \
                reader.get_latest_update("p22_remote", "w0")["score"] != 0.5:
            raise AssertionError(f"POST /collect: {status} {body!r}")
        pages["post_collect"] = {"status": status}
    finally:
        server.stop()
    return pages


def ui_phase(n_params):
    """Phase 22 (see the module docstring): (a) the kernel registry on the
    card, (b) the training UI on a listener-instrumented fit."""
    from deeplearning4j_tpu_torch import telemetry as tel
    from deeplearning4j_tpu_torch import ui as ui_mod
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="p22_")
    try:
        registry = _registry_phase(n_params, tmp)
        torch.cuda.empty_cache()
        t_b = time.perf_counter()
        jsonl, db = os.path.join(tmp, "stats.jsonl"), os.path.join(tmp,
                                                                   "stats.db")
        files = ui_mod.FileStatsStorage(jsonl)
        sqlite = ui_mod.SqliteStatsStorage(db)
        tee = _TeeStorage(files, sqlite)
        char_net, char = _ui_char(tee, ui_mod)
        gen = _ui_generation(char_net, tee)
        del char_net
        torch.cuda.empty_cache()
        gnet, gnet_row = _ui_googlenet(tee, ui_mod)
        del gnet
        torch.cuda.empty_cache()
        tel.get_registry().publish(tee)
        readers = {"jsonl": ui_mod.FileStatsStorage(jsonl),
                   "sqlite": ui_mod.SqliteStatsStorage(db)}
        records = {k: {s: sum(len(r.get_updates(s, w))
                              for w in r.list_worker_ids(s))
                       for s in r.list_session_ids()}
                   for k, r in readers.items()}
        if records["jsonl"] != records["sqlite"] or \
                records["jsonl"].get("p22_char") != char["reports"] or \
                records["jsonl"].get("p22_googlenet") != \
                gnet_row["listener_forwards"] or \
                "telemetry" not in records["jsonl"] or \
                "generation" not in records["jsonl"]:
            raise AssertionError(f"records read back: {records}")
        pages = _ui_server(ui_mod, readers["sqlite"], registry["timings"])
        for s in (sqlite, readers["sqlite"]):
            s.close()
        ui_s = time.perf_counter() - t_b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths = {"ui_listener_fit": char["launches"],
             "ui_conv_listener": gnet_row["launches"],
             "ui_generation": gen["launches"]}
    row = {"registry": registry, "char": char, "googlenet": gnet_row,
           "generation": gen, "records_read_back": records, "pages": pages,
           "launches_by_path": paths,
           "launches": {n: sum(p.get(n, 0) for p in paths.values())
                        for n in UI_COUNTED},
           "ui_seconds": ui_s, "seconds": time.perf_counter() - t0}
    t = registry["timings"]
    log(f"phase 22: {row['seconds']:.1f} s (UI {ui_s:.1f}); pins "
        f"{ {n: p['max_abs_err'] for n, p in registry['pins'].items()} }; "
        f"vs roofline "
        f"{ {n: round(r['registry']['vs_roofline'], 3) for n, r in t.items()} }"
        f"; step p50 with/without {char['with_over_without_p50']:.3f} "
        f"(into memory {char['with_memory_over_without_p50']:.3f}); grids "
        f"{gnet_row['grids']} ({gnet_row['png_bytes']} bytes); "
        f"pages {[(k, p.get('bytes')) for k, p in pages.items()]}")
    return row


# ------------------------------------------------------------------ phase 23
# (a) bench.py:1932's word2vec width, and a vocabulary ten times larger
W2V_V, W2V_D, W2V_B, W2V_NEG, W2V_LR = 100_000, 128, 4096, 5, 0.025
W2V_V_LARGE, W2V_STEPS = 1_000_000, 200
# (b) a generated topical corpus of ~200 k tokens: 20 topics of 150 words
# and 200 shared fillers; sentences of 10-20 tokens
NLP_TOPICS, NLP_TOPIC_WORDS, NLP_FILLER = 20, 150, 200
NLP_SENTENCES, NLP_LAYER, NLP_WINDOW = 13_000, 100, 5
NLP_FIT_REL, NLP_FLUSH_REL, NLP_GAP = 1e-4, 1e-5, 0.1


def _nlp_corpus(n, seed, lo=10, hi=21):
    """``n`` sentences of ``lo``..``hi - 1`` tokens. Each picks a topic and
    draws 70 % of its tokens from the topic's words, 30 % from the shared
    fillers, both by Zipf-like ranks (1/r). Returns (sentences, the topic
    of each, each topic's words)."""
    r = np.random.default_rng(seed)
    topic_words = [[f"t{t}w{i}" for i in range(NLP_TOPIC_WORDS)]
                   for t in range(NLP_TOPICS)]
    filler = [f"f{i}" for i in range(NLP_FILLER)]

    def zipf(m):
        p = 1.0 / np.arange(1, m + 1)
        return p / p.sum()
    pw, pf = zipf(NLP_TOPIC_WORDS), zipf(NLP_FILLER)
    topics = r.integers(0, NLP_TOPICS, n)
    out = []
    for t, m in zip(topics, r.integers(lo, hi, n)):
        own = r.random(m) < 0.7
        tw, fw = r.choice(NLP_TOPIC_WORDS, m, p=pw), r.choice(NLP_FILLER, m,
                                                              p=pf)
        out.append(" ".join(topic_words[t][a] if k else filler[b]
                            for k, a, b in zip(own, tw, fw)))
    return out, topics, topic_words


def _topic_gap(model, topic_words, top=20):
    """(within, across): the mean cosine of word pairs within a topic's
    ``top`` most frequent words, and between consecutive topics' words."""
    def rows(t):
        v = np.stack([model.get_word_vector(w) for w in topic_words[t][:top]
                      if model.has_word(w)])
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    within, across = [], []
    for t in range(len(topic_words)):
        a, b = rows(t), rows((t + 1) % len(topic_words))
        s = a @ a.T
        within.append((s.sum() - np.trace(s)) / (len(a) * (len(a) - 1)))
        across.append(float((a @ b.T).mean()))
    return float(np.mean(within)), float(np.mean(across))


def _sgns_cross_device():
    """(a) Two steps of ``sv_step`` from bench.py's start (syn0 N(0, 1) x
    0.01, syn1 zeros; the second step moves syn0 too) on the card and on
    the CPU with the same indices and negatives: rel-to-max of both
    tables after each step. The card's ``index_add_`` adds colliding rows
    by atomics, in no fixed order: a tolerance, not bitwise."""
    r = np.random.default_rng(SEED + 50)
    s0 = (r.normal(size=(W2V_V, W2V_D)) * 0.01).astype(np.float32)
    tabs = {d: [torch.from_numpy(s0).to(d),
                torch.zeros(W2V_V, W2V_D, device=d)] for d in ("cuda", "cpu")}
    errs = []
    for _ in range(2):
        idx = [r.integers(0, W2V_V, W2V_B), r.integers(0, W2V_V, W2V_B),
               r.integers(0, W2V_V, (W2V_B, W2V_NEG))]
        for d, (syn0, syn1) in tabs.items():
            c, x, n = (torch.from_numpy(a).to(d) for a in idx)
            sv.sv_step(syn0, syn1, c, x, W2V_LR, negs=n)
        errs.append([_rel_to_max(tabs["cuda"][i].cpu(), tabs["cpu"][i])
                     for i in range(2)])
    worst = max(max(e) for e in errs)
    if not worst <= NLP_FLUSH_REL:
        raise AssertionError(f"phase 23 (a): the SGNS step card vs CPU "
                             f"{errs} (rel-to-max; pin {NLP_FLUSH_REL})")
    return {"rel_to_max_by_step": [{"syn0": e[0], "syn1": e[1]}
                                   for e in errs], "pin": NLP_FLUSH_REL}


def _sgns_quality():
    """(a) bench.py:1965-1996's two gates on the port: 200 steps of
    ``make_neg_sampling_step`` from scratch on one fixed batch must cut
    the probe loss (fixed negatives) by >= 0.1, and the trained pairs'
    mean cosine (syn0[center], syn1[context]) must exceed random pairs' by
    >= 0.1."""
    r = np.random.default_rng(SEED + 51)
    syn0 = torch.from_numpy((r.normal(size=(W2V_V, W2V_D)) * 0.01
                             ).astype(np.float32)).cuda()
    syn1 = torch.zeros(W2V_V, W2V_D, device="cuda")
    centers, contexts, ra, rb = (
        torch.from_numpy(r.integers(0, W2V_V, W2V_B)).cuda()
        for _ in range(4))
    probe_negs = torch.randint(0, W2V_V, (W2V_B, W2V_NEG), device="cuda",
                               generator=torch.Generator("cuda")
                               .manual_seed(123))

    def probe():
        *_, loss_row = sv._sgns_grads(syn0[centers], syn1[contexts],
                                      syn1[probe_negs])
        return float(loss_row.sum() / W2V_B)

    def pair_cos(a, b):
        va, vb = syn0[a], syn1[b]
        return float(((va * vb).sum(1) / ((va.norm(dim=1) + 1e-9)
                                          * (vb.norm(dim=1) + 1e-9))).mean())
    before = probe()
    step = sv.make_neg_sampling_step(lr=W2V_LR, negative=W2V_NEG)
    gen = torch.Generator("cuda").manual_seed(7)
    for _ in range(W2V_STEPS):
        step(syn0, syn1, centers, contexts, gen)
    after = probe()
    trained, rand = pair_cos(centers, contexts), pair_cos(ra, rb)
    row = {"probe_loss_before": before, "probe_loss_after": after,
           "trained_pair_cosine": trained, "random_pair_cosine": rand,
           "steps": W2V_STEPS}
    if not after < before - 0.1:
        raise AssertionError(f"phase 23 (a): word2vec quality gate: probe "
                             f"loss {before:.4f} -> {after:.4f}")
    if not trained > rand + 0.1:
        raise AssertionError(f"phase 23 (a): word2vec similarity gate: "
                             f"{trained:.3f} vs random {rand:.3f}")
    return row


def _sgns_timing(V):
    """(a) The bulk step at vocabulary ``V`` (D 128, B 4096, 5 negatives
    drawn on the card): wall ms a step over 200 steps (ended by a
    synchronise), the profiler's device time and kernels over 50 steps
    (CUDA events over 50 steps where a session records none), words/s,
    peak memory over what the process held before. Tables from the card's
    own generator."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator("cuda").manual_seed(SEED + 52)
    syn0 = torch.randn(V, W2V_D, device="cuda", generator=gen) * 0.01
    syn1 = torch.zeros(V, W2V_D, device="cuda")
    centers, contexts = (torch.randint(0, V, (W2V_B,), device="cuda",
                                       generator=gen) for _ in range(2))
    step = sv.make_neg_sampling_step(lr=W2V_LR, negative=W2V_NEG)

    def one():
        step(syn0, syn1, centers, contexts, gen)
    for _ in range(10):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(W2V_STEPS):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / W2V_STEPS
    n = 50
    prof = _device_kernels(lambda: [one() for _ in range(n)], top=1000)
    if prof["device_ms"] > 0:
        dev_ms, by = prof["device_ms"] / n, "profiler"
        kernels = sum(r["calls"] for r in prof["top"]) / n
    else:
        dev_ms, by, kernels = _event_ms_per_call(one, n), "cuda_events", None
    peak = torch.cuda.max_memory_allocated() - held
    return {"V": V, "D": W2V_D, "B": W2V_B, "negative": W2V_NEG,
            "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
            "timed_by": by, "kernels_per_step": kernels,
            "top_kernels": prof["top"][:8],
            "words_per_s_wall": W2V_B / wall_ms * 1e3,
            "words_per_s_device": W2V_B / dev_ms * 1e3,
            "table_bytes": 2 * V * W2V_D * 4, "peak_memory_bytes": peak}


class _FitProbe:
    """Wraps one model's ``_pairs_for_sentence`` and ``_flush`` (instance
    attributes over the class's methods): host seconds in pair generation
    and in the flushes (drawing negatives, uploads, launching the step),
    the host-read detector's count at the first flush and after the last,
    and a device copy of ``syn0`` after flush ``snap_at``."""

    def __init__(self, model, det=None, snap_at=3):
        self.pair_s = self.flush_s = 0.0
        self.flushes, self.reads_first, self.reads_last = 0, None, None
        self.snap = None
        pairs, flush = model._pairs_for_sentence, model._flush

        def timed_pairs(*a):
            t = time.perf_counter()
            out = pairs(*a)
            self.pair_s += time.perf_counter() - t
            return out

        def timed_flush(*a):
            if det is not None and self.flushes == 0:
                self.reads_first = det.count
            t = time.perf_counter()
            syn0, syn1 = flush(*a)
            self.flush_s += time.perf_counter() - t
            self.flushes += 1
            if det is not None:
                self.reads_last = det.count
            if self.flushes == snap_at:
                self.snap = syn0.clone()
            return syn0, syn1
        model._pairs_for_sentence = timed_pairs
        model._flush = timed_flush


# HS steps 1,024 pairs at a time: at the default 8,192 every pair's update
# of the tree's root row lands in one step, and the fit diverges to NaN on
# this corpus (reported in (b); ROADMAP section C)
W2V_VARIANTS = {"skipgram_ns": {},
                "skipgram_hs": {"use_hierarchical_softmax": True,
                                "batch_size": 1024},
                "cbow_ns": {"learning_algorithm": "cbow"}}


def _w2v_fits(sentences, topic_words):
    """(b) ``Word2Vec.fit`` on the corpus, each variant on the card (host
    reads counted between the first flush and the last) and on the CPU
    from the same seed; the card's tables against the CPU's after the
    whole fit and after the third flush; the topic gap; words/s and the
    host's shares. The skip-gram NS fit runs once more under the profiler
    for its device time."""
    tokens = sum(len(s.split()) for s in sentences)
    rows, models = {}, {}
    for name, extra in W2V_VARIANTS.items():
        kw = dict(layer_size=NLP_LAYER, window=NLP_WINDOW, seed=SEED + 53,
                  **extra)
        card = tnlp.Word2Vec(device="cuda", **kw)
        with _sync_watch() as det:
            probe = _FitProbe(card, det)
            t0 = time.perf_counter()
            card.fit(sentences)
            fit_s = time.perf_counter() - t0
        cpu = tnlp.Word2Vec(device="cpu", **kw)
        cprobe = _FitProbe(cpu)
        t1 = time.perf_counter()
        cpu.fit(sentences)
        cpu_s = time.perf_counter() - t1
        out = "syn1" if extra.get("use_hierarchical_softmax") else "syn1neg"
        whole = _rel_to_max(torch.from_numpy(card.syn0),
                            torch.from_numpy(cpu.syn0))
        whole_out = _rel_to_max(torch.from_numpy(getattr(card, out)),
                                torch.from_numpy(getattr(cpu, out)))
        three = _rel_to_max(probe.snap.cpu(), cprobe.snap)
        within, across = _topic_gap(card, topic_words)
        loop_reads = probe.reads_last - probe.reads_first
        row = {"tokens": tokens, "vocab": len(card.vocab),
               "flushes": probe.flushes, "fit_s": fit_s, "cpu_fit_s": cpu_s,
               "words_per_s": tokens / fit_s,
               "cpu_words_per_s": tokens / cpu_s,
               "pair_generation_share": probe.pair_s / fit_s,
               "flush_host_share": probe.flush_s / fit_s,
               "host_reads_in_loop": loop_reads,
               "host_reads_whole_fit": det.count,
               "host_read_sites": _sync_sites(det),
               "syn0_rel_to_max_whole_fit": whole,
               f"{out}_rel_to_max_whole_fit": whole_out,
               "syn0_rel_to_max_after_3_flushes": three,
               "within_topic_cosine": within, "across_topic_cosine": across}
        row["gate"] = _drift_gate(f"(b) {name}", {"syn0": whole,
                                                    out: whole_out}, three)
        if loop_reads != 0:
            raise AssertionError(f"phase 23 (b) {name}: {loop_reads} host "
                                 f"reads in the fit's loop: "
                                 f"{_sync_sites(det)}")
        if not within > across + NLP_GAP:
            raise AssertionError(f"phase 23 (b) {name}: within-topic cosine "
                                 f"{within:.3f}, across {across:.3f}")
        rows[name], models[name] = row, card
    prof_model = tnlp.Word2Vec(device="cuda", layer_size=NLP_LAYER,
                               window=NLP_WINDOW, seed=SEED + 53)
    prof = _device_kernels(lambda: prof_model.fit(sentences), top=6)
    # a second card fit of the same seed: how far the card's own
    # unordered adds carry the whole fit
    rows["skipgram_ns"].update(
        profiled_fit_wall_ms=prof["wall_ms"],
        profiled_fit_device_ms=prof["device_ms"],
        device_busy_share=prof["device_ms"] / prof["wall_ms"],
        top_kernels=prof["top"],
        card_vs_card_syn0_rel_to_max=_rel_to_max(
            torch.from_numpy(prof_model.syn0),
            torch.from_numpy(models["skipgram_ns"].syn0)))
    # why HS steps 1,024 pairs: the default batch, reported, not gated
    hs = tnlp.Word2Vec(device="cuda", layer_size=NLP_LAYER, window=NLP_WINDOW,
                       seed=SEED + 53, use_hierarchical_softmax=True)
    rows["skipgram_hs"]["batch_8192_syn0_finite"] = bool(
        np.isfinite(hs.fit(sentences).syn0).all())
    return rows, models["skipgram_ns"]


def _drift_gate(what, whole, three):
    """The card-vs-CPU gate of a fit: every table's rel-to-max after the
    whole fit within ``NLP_FIT_REL``; where the card's unordered adds
    carry the whole fit past it, syn0 after the third flush (``three``,
    None for a trainer without flushes) within ``NLP_FLUSH_REL``."""
    if max(whole.values()) <= NLP_FIT_REL:
        return f"whole fit <= {NLP_FIT_REL}"
    if three is not None and three <= NLP_FLUSH_REL:
        return (f"first 3 flushes <= {NLP_FLUSH_REL} (the whole fit "
                f"drifted past {NLP_FIT_REL})")
    raise AssertionError(f"phase 23 {what}: card vs CPU {whole} (whole "
                         f"fit), {three} (syn0 after 3 flushes)")


def _card_vs_cpu(make, fit_arg, tables, what):
    """One trainer fitted on the card and on the CPU from the same seed:
    rel-to-max of each named table and of syn0 after the third flush
    (where the trainer flushes: the word phase of ParagraphVectors),
    gated by ``_drift_gate``."""
    models, probes = {}, {}
    for d in ("cuda", "cpu"):
        models[d] = make(d)
        probes[d] = _FitProbe(models[d])
        t0 = time.perf_counter()
        models[d].fit(fit_arg)
        if d == "cuda":
            card_s = time.perf_counter() - t0
    card, cpu = models["cuda"], models["cpu"]
    errs = {t: _rel_to_max(torch.from_numpy(getattr(card, t)),
                           torch.from_numpy(getattr(cpu, t)))
            for t in tables}
    snaps = [probes[d].snap for d in ("cuda", "cpu")]
    three = None if snaps[0] is None else _rel_to_max(snaps[0].cpu(),
                                                      snaps[1])
    return card, cpu, {"rel_to_max": errs, "syn0_rel_to_max_after_3_flushes":
                       three, "gate": _drift_gate(f"(c) {what}", errs, three),
                       "card_fit_s": card_s}


def _other_trainers(sentences, topics, topic_words):
    """(c) ParagraphVectors (PV-DBOW, PV-DM, PV-DBOW with HS, and
    ``infer_vector``) on 300 generated documents, GloVe on 2,000 of (b)'s
    sentences, and DistributedWord2Vec on a 4-worker logical mesh: its
    step against the single-device step (atol 2e-6) and a fit on (b)'s
    corpus, each against the CPU."""
    docs_s, docs_t, _ = _nlp_corpus(300, SEED + 54, lo=40, hi=81)
    docs = [(f"doc{i}", s) for i, s in enumerate(docs_s)]
    out = {}
    for name, extra in (("pv_dbow", {}), ("pv_dm", {"dm": True}),
                        ("pv_dbow_hs", {"use_hierarchical_softmax": True,
                                        "batch_size": 1024})):
        hs = extra.get("use_hierarchical_softmax", False)
        card, cpu, row = _card_vs_cpu(
            lambda d: tnlp.ParagraphVectors(
                device=d, layer_size=NLP_LAYER, window=NLP_WINDOW, epochs=5,
                seed=SEED + 55, **extra),
            docs, ("doc_vectors", "syn0", "syn1" if hs else "syn1neg"), name)
        # inference on the same tables on both devices (the fits differ
        # by the card's unordered adds)
        cpu.syn0, cpu.syn1neg, cpu.syn1 = card.syn0, card.syn1neg, card.syn1
        text = docs_s[0]
        inferred = _rel_to_max(torch.from_numpy(card.infer_vector(text)),
                               torch.from_numpy(cpu.infer_vector(text)))
        if not inferred <= NLP_FLUSH_REL:
            raise AssertionError(f"phase 23 (c) {name}: infer_vector card "
                                 f"vs CPU {inferred:.3g}")
        row["infer_vector_rel_to_max"] = inferred
        out[name] = row
    _, _, out["glove"] = _card_vs_cpu(
        lambda d: tnlp.Glove(device=d, layer_size=50, window=NLP_WINDOW,
                             epochs=10, seed=SEED + 56),
        [s.split() for s in sentences[:2000]], ("syn0",), "glove")
    # DistributedWord2Vec: the sharded step against the single step
    r = np.random.default_rng(SEED + 57)
    V, B = 10_000, 8190                      # 4 does not divide B: padded
    s0, s1 = ((r.normal(size=(V, NLP_LAYER)) * 0.1).astype(np.float32)
              for _ in range(2))
    idx = [torch.from_numpy(a).cuda() for a in
           (r.integers(0, V, B), r.integers(0, V, B),
            r.integers(0, V, (B, W2V_NEG)))]
    mesh = make_mesh((4,), ("data",))
    dist = tdist.DistributedWord2Vec(layer_size=NLP_LAYER, mesh=mesh)
    a0, a1 = torch.from_numpy(s0).cuda(), torch.from_numpy(s1).cuda()
    b0, b1 = a0.clone(), a1.clone()
    _, _, dloss = dist._build_step()(a0, a1, *idx, W2V_LR)
    sloss = sv.sv_step(b0, b1, idx[0], idx[1], W2V_LR, negs=idx[2])
    step_err = max((a0 - b0).abs().max().item(), (a1 - b1).abs().max().item())
    loss_rel = abs(float(dloss) - float(sloss)) / float(sloss)
    if not (step_err <= 2e-6 and loss_rel <= 1e-5):
        raise AssertionError(f"phase 23 (c): the 4-worker step vs the "
                             f"single step: abs {step_err:.3g}, loss rel "
                             f"{loss_rel:.3g}")
    card, _, row = _card_vs_cpu(
        lambda d: tdist.DistributedWord2Vec(
            device=d, mesh=make_mesh((4,), ("data",), d),
            layer_size=NLP_LAYER, window=NLP_WINDOW, seed=SEED + 58),
        [s.split() for s in sentences], ("syn0", "syn1neg"),
        "distributed_w2v")
    within, across = _topic_gap(card, topic_words)
    if not within > across + NLP_GAP:
        raise AssertionError(f"phase 23 (c) distributed: within-topic "
                             f"{within:.3f}, across {across:.3f}")
    row.update(step_abs_err=step_err, step_loss_rel=loss_rel, workers=4,
               batch=B, within_topic_cosine=within,
               across_topic_cosine=across)
    out["distributed_w2v"] = row
    return out


def _serde_round_trip(model, tmp):
    """(d) The card-trained model written in both formats and read back:
    the text file within its 6 decimals, the binary one bitwise."""
    txt, binp = os.path.join(tmp, "vecs.txt"), os.path.join(tmp, "vecs.bin")
    tnlp.write_word_vectors(model, txt)
    tnlp.write_binary_word_vectors(model, binp)
    a, b = tnlp.read_word_vectors(txt), tnlp.read_binary_word_vectors(binp)
    words = [model.vocab.word_at(i) for i in range(len(model.vocab))]
    text_err = float(np.abs(a.syn0 - model.syn0).max())
    ok = (words == [a.vocab.word_at(i) for i in range(len(a.vocab))]
          == [b.vocab.word_at(i) for i in range(len(b.vocab))]
          and text_err <= 5e-7 + 1e-7 and np.array_equal(b.syn0, model.syn0))
    if not ok:
        raise AssertionError(f"phase 23 (d): the vectors files read back "
                             f"wrong (text max abs {text_err:.3g})")
    return {"text_max_abs_err": text_err, "binary_bitwise": True,
            "text_bytes": os.path.getsize(txt),
            "binary_bytes": os.path.getsize(binp)}


def nlp_phase():
    """Phase 23 (see the module docstring): the NLP library on the card."""
    t0 = time.perf_counter()
    cross = _sgns_cross_device()
    quality = _sgns_quality()
    timing = [_sgns_timing(V) for V in (W2V_V, W2V_V_LARGE)]
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    sentences, topics, topic_words = _nlp_corpus(NLP_SENTENCES, SEED + 59)
    fits, ns_model = _w2v_fits(sentences, topic_words)
    t_c = time.perf_counter()
    others = _other_trainers(sentences, topics, topic_words)
    tmp = tempfile.mkdtemp(prefix="p23_")
    try:
        serde = _serde_round_trip(ns_model, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"sgns_step_card_vs_cpu": cross, "sgns_quality": quality,
           "sgns_step_timing": timing, "word2vec_fits": fits,
           "other_trainers": others, "serde": serde,
           "seconds_a": t_b - t0, "seconds_b": t_c - t_b,
           "seconds": time.perf_counter() - t0}
    rates = [(n, round(f["words_per_s"]), f["gate"]) for n, f in fits.items()]
    log(f"phase 23: {row['seconds']:.1f} s; step card-vs-CPU "
        f"{cross['rel_to_max_by_step']}; probe loss "
        f"{quality['probe_loss_before']:.4f} -> "
        f"{quality['probe_loss_after']:.4f}; step device ms "
        f"{[(t['V'], round(t['device_ms_per_step'], 4)) for t in timing]}; "
        f"fits {rates}")
    return row


# ------------------------------------------------------------------ phase 24
# (a) BlogCatalog (Perozzi et al., KDD 2014, section 5): 10,312 vertices,
# 333,983 edges, 39 groups, as a planted partition with 80 % of the edges
# inside a group; DeepWalk at the paper's widths (d 128, w 10, t 40) with 2
# walks a vertex where the paper takes 80 (the cut, for the time limit)
BC_V, BC_E, BC_GROUPS, BC_INSIDE = 10_312, 333_983, 39, 0.8
DW_KW = dict(vector_size=128, window_size=10, walk_length=40,
             walks_per_vertex=2, seed=SEED + 60)
N2V_KW = dict(DW_KW, walks_per_vertex=1, p=0.25, q=0.25, seed=SEED + 61)
GRAPH_FLUSH_REL, GRAPH_GAP, GRAPH_ACC = 1e-5, 0.1, 0.5
GRAPH_PROFILE = (100, 150)      # the flushes a fit runs under the profiler
# (b) exact t-SNE with the reference's defaults on 3,000 points of 50
# dimensions; (c) k-means at phase 23 (a)'s vocabulary and width
TSNE_N, TSNE_D, TSNE_CLUSTERS, TSNE_REL, TSNE_STEPS = 3000, 50, 10, 1e-5, 10
KM_N, KM_D, KM_K, KM_SEED, KM_REL, KM_STEPS = 100_000, 128, 100, 4, 1e-5, 3
KM_SLICE = 10_000                 # the rows of the card-vs-CPU fits
# (d) MNIST-shaped data through the shards; the threshold codec at K9_N
MNIST_TRAIN, MNIST_TEST, MNIST_B, MNIST_SHARD = 60_000, 1_000, 64, 16
MNIST_PARTS, MNIST_PAIRED = 4, 2   # the epoch's fits; those with a memory twin
CODEC_THRESHOLD, CODEC_CAPACITY = 2.0, 1 << 20
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")
TEXTGEN_CHECKSUM = 530652660       # tests/test_zoo_datasets.py's pin


class _StopFit(Exception):
    """Ends a reference fit after the flushes a comparison needs."""


class _SvProbe:
    """Wraps ``SequenceVectors._pairs_for_sentence`` and ``_flush`` at class
    level while active (a DeepWalk builds its engine inside ``fit``): host
    seconds in pair generation and in the flushes, the clock and the read
    detector's count at the first flush and after the last, a copy of
    ``syn0`` after
    flush ``snap_at`` (then ``_StopFit`` if ``stop``), and, with
    ``window=(a, b)``, flushes a..b under ``torch.profiler``: their wall
    and device ms; the detector's reads and the seconds spent while the
    profiler starts and stops are counted apart."""

    def __init__(self, det=None, snap_at=3, stop=False, window=None):
        self.det, self.snap_at, self.stop, self.window = (det, snap_at, stop,
                                                          window)
        self.pair_s = self.flush_s = 0.0
        self.flushes, self.reads_first, self.reads_last = 0, None, None
        self.t_first = self.t_last = None
        self.profiler_reads, self.snap, self.profiled = 0, None, None
        self.profiler_s, self._prof = 0.0, None

    def _reads(self):
        return 0 if self.det is None else self.det.count

    def _profile(self, start):
        from torch.profiler import ProfilerActivity, profile
        before, t_in = self._reads(), time.perf_counter()
        if start:
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        else:
            torch.cuda.synchronize()
            t_in = time.perf_counter()      # the window ends; its stop
            wall = (t_in - self._t0) * 1e3
            self._prof.__exit__(None, None, None)
            dev = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) / 1e3
                      for e in self._prof.key_averages()
                      if e.self_cpu_time_total == 0)
            self.profiled = {"flushes": self.window, "wall_ms": wall,
                             "device_ms": dev, "busy_share": dev / wall}
        self.profiler_reads += self._reads() - before
        self.profiler_s += time.perf_counter() - t_in

    def __enter__(self):
        pairs, flush = sv.SequenceVectors._pairs_for_sentence, \
            sv.SequenceVectors._flush
        self._orig = (pairs, flush)
        probe = self

        def timed_pairs(model, *a):
            t = time.perf_counter()
            out = pairs(model, *a)
            probe.pair_s += time.perf_counter() - t
            return out

        def timed_flush(model, *a):
            if probe.flushes == 0:
                probe.reads_first = probe._reads()
                probe.t_first = time.perf_counter()
            if probe.window and probe.flushes == probe.window[0]:
                probe._profile(True)
            t = time.perf_counter()
            syn0, syn1 = flush(model, *a)
            probe.flush_s += time.perf_counter() - t
            probe.flushes += 1
            if probe.window and probe.flushes == probe.window[1]:
                probe._profile(False)
            probe.reads_last = probe._reads()
            probe.t_last = time.perf_counter()
            if probe.flushes == probe.snap_at:
                probe.snap = syn0.clone()
                if probe.stop:
                    raise _StopFit
            return syn0, syn1
        sv.SequenceVectors._pairs_for_sentence = timed_pairs
        sv.SequenceVectors._flush = timed_flush
        return self

    def __exit__(self, *exc):
        (sv.SequenceVectors._pairs_for_sentence,
         sv.SequenceVectors._flush) = self._orig
        return exc[0] is _StopFit


class _TimedWalks:
    """Stands in for a walk iterator class in its module while a fit runs:
    each iterator's walks are generated in full, timed and kept."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.cls = getattr(module, name)
        self.seconds, self.walks = 0.0, []

    def __enter__(self):
        probe = self

        class Timed:
            def __init__(self, *a, **kw):
                self.it = probe.cls(*a, **kw)

            def __iter__(self):
                t = time.perf_counter()
                walks = list(self.it)
                probe.seconds += time.perf_counter() - t
                probe.walks.extend(walks)
                return iter(walks)
        setattr(self.module, self.name, Timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.cls)


def _planted_partition(seed):
    """BlogCatalog's counts as a planted partition: each vertex in one of
    39 groups (sizes within one of each other), ``BC_INSIDE`` of the
    distinct undirected edges inside a group, the rest across; no self
    loops. Returns (group of each vertex, edges [E, 2])."""
    r = np.random.default_rng(seed)
    group = r.permutation(BC_V) % BC_GROUPS
    members = [np.flatnonzero(group == g) for g in range(BC_GROUPS)]
    sizes = np.array([len(m) for m in members])
    need_in = int(round(BC_INSIDE * BC_E))
    keys = []
    for need, inside in ((need_in, True), (BC_E - need_in, False)):
        got = np.empty(0, np.int64)
        while len(got) < need:
            a = r.integers(0, BC_V, need)
            if inside:
                g = group[a]
                pick = (r.random(need) * sizes[g]).astype(np.int64)
                b = np.array([members[gi][k] for gi, k in zip(g, pick)])
            else:
                b = r.integers(0, BC_V, need)
                bad = group[b] == group[a]
                while bad.any():
                    b[bad] = r.integers(0, BC_V, int(bad.sum()))
                    bad = group[b] == group[a]
            ok = a != b
            got = np.unique(np.concatenate([
                got, np.minimum(a, b)[ok] * BC_V + np.maximum(a, b)[ok]]))
        keys.append(r.permutation(got)[:need])
    keys = np.concatenate(keys)
    return group, np.stack([keys // BC_V, keys % BC_V], 1)


def _group_gap(table, group):
    """(within, across): the mean cosine of vertex pairs in one group and
    of pairs in two groups, over every pair (group sums, float64)."""
    u = table.astype(np.float64)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sums = np.zeros((BC_GROUPS, u.shape[1]))
    np.add.at(sums, group, u)
    cnt = np.bincount(group, minlength=BC_GROUPS)
    n = len(u)
    within = (sums ** 2).sum() - n
    within_pairs = float((cnt * (cnt - 1)).sum())
    total = u.sum(0)
    every = total @ total - n
    return (within / within_pairs,
            (every - within) / (n * (n - 1) - within_pairs))


def _classify(table, group, dev):
    """The paper's evaluation: a softmax over the vectors
    (``ml.NeuralNetClassifier``, one ``OutputLayer``) trained on half the
    vertices, its accuracy on the other half."""
    order = np.random.default_rng(SEED + 62).permutation(len(table))
    train, test = order[:len(order) // 2], order[len(order) // 2:]
    conf = NeuralNetConfiguration(seed=SEED + 63, updater=Adam(1e-2)).list(
        OutputLayer(n_in=table.shape[1], n_out=BC_GROUPS,
                    activation="softmax", loss="mcxent")).build()
    clf = tml.NeuralNetClassifier(conf, epochs=20, batch_size=512,
                                  device=dev)
    t0 = time.perf_counter()
    clf.fit(table[train], group[train])
    fit_s = time.perf_counter() - t0
    if clf.net.device.type != torch.device(dev).type:
        raise AssertionError(f"the classifier ran on {clf.net.device}")
    return {"accuracy": clf.score(table[test], group[test]),
            "train_vertices": len(train), "fit_s": fit_s}


def _graph_fit(what, cls, mod, walk_cls, kw, graph, group, dev):
    """(a) One embedding: the fit on ``dev`` from the graph (walks timed,
    host reads counted from the first flush to the last, flushes
    ``GRAPH_PROFILE`` under the profiler), the same walks on the CPU to
    the third flush, the group gap and the classifier. Where the default
    hierarchical softmax leaves a non-finite table, the gates run on the
    reference's ``use_hierarchical_softmax=False`` (reported)."""
    with _TimedWalks(mod, walk_cls) as walks, _sync_watch() as det, \
            _SvProbe(det, window=GRAPH_PROFILE) as probe:
        t0 = time.perf_counter()
        model = cls(device=dev, **kw).fit(graph)
        t_end = time.perf_counter()
    fit_s = t_end - t0
    tokens = sum(len(w) for w in walks.walks)
    table = model.lookup_table
    row = {"walks": len(walks.walks), "tokens": tokens,
           "walk_generation_s": walks.seconds, "fit_s": fit_s,
           "profiler_start_stop_s": probe.profiler_s,
           "words_per_s": tokens / (fit_s - walks.seconds
                                    - probe.profiler_s),
           "pair_generation_s": probe.pair_s, "flush_host_s": probe.flush_s,
           "before_first_flush_s": probe.t_first - t0 - walks.seconds,
           "first_to_last_flush_s": probe.t_last - probe.t_first,
           "after_last_flush_s": t_end - probe.t_last,
           "flushes": probe.flushes, "vocab": len(model._sv.vocab),
           "hierarchical_softmax": model.use_hierarchical_softmax,
           "profiled": probe.profiled,
           "host_reads_in_loop": probe.reads_last - probe.reads_first
           - probe.profiler_reads,
           "host_reads_whole_fit": det.count,
           "profiler_reads": probe.profiler_reads,
           "host_read_sites": _sync_sites(det),
           "table_finite": bool(np.isfinite(table).all())}
    if row["host_reads_in_loop"] != 0:
        raise AssertionError(f"phase 24 (a) {what}: "
                             f"{row['host_reads_in_loop']} host reads in "
                             f"the fit's loop: {row['host_read_sites']}")
    snap = probe.snap
    if not row["table_finite"]:
        # the reference's other objective, on the same walks
        kw = dict(kw, use_hierarchical_softmax=False)
        with _SvProbe() as probe:
            model = cls(device=dev, **kw).fit(walks.walks)
        table, snap = model.lookup_table, probe.snap
        row["gated_on"] = "negative sampling (the default HS fit is not " \
                          "finite)"
    with _SvProbe(stop=True) as cprobe:
        cls(device="cpu", **kw).fit(walks.walks)
    row["syn0_rel_to_max_after_3_flushes"] = three = _rel_to_max(
        snap.cpu(), cprobe.snap)
    row["cpu_whole_fit"] = ("not run: the CPU's whole fit of these walks "
                            "takes minutes (ROADMAP section C)")
    if not three <= GRAPH_FLUSH_REL:
        raise AssertionError(f"phase 24 (a) {what}: card vs CPU after 3 "
                             f"flushes {three:.3g}")
    within, across = _group_gap(table, group)
    row.update(within_group_cosine=within, across_group_cosine=across,
               classification=_classify(table, group, dev))
    if not within > across + GRAPH_GAP:
        raise AssertionError(f"phase 24 (a) {what}: within-group cosine "
                             f"{within:.3f}, across {across:.3f}")
    if not row["classification"]["accuracy"] >= GRAPH_ACC:
        raise AssertionError(f"phase 24 (a) {what}: held-out accuracy "
                             f"{row['classification']['accuracy']:.3f}")
    return row


def _graphs(dev):
    """(a) DeepWalk and node2vec at BlogCatalog's scale."""
    t0 = time.perf_counter()
    group, edges = _planted_partition(SEED + 64)
    graph = tgraphs.Graph(BC_V).add_edges(edges.tolist())
    row = {"graph": {"vertices": BC_V, "edges": len(edges),
                     "groups": BC_GROUPS,
                     "inside_share": float(np.mean(group[edges[:, 0]]
                                                   == group[edges[:, 1]])),
                     "build_s": time.perf_counter() - t0}}
    row["deepwalk"] = _graph_fit("DeepWalk", tgraphs.DeepWalk, tdw,
                                 "RandomWalkIterator", DW_KW, graph, group,
                                 dev)
    row["node2vec"] = _graph_fit("Node2Vec", tgraphs.Node2Vec, tn2v,
                                 "Node2VecWalkIterator", N2V_KW, graph,
                                 group, dev)
    return row


def _tsne(dev):
    """(b) ``Tsne`` with the reference's defaults on a mixture of 10
    Gaussians: P on the host (timed once; the fit reuses it), 10 steps on
    the card and on the CPU from the same P and Y, the whole fit, a step's
    device time and the reference test's separation gate."""
    r = np.random.default_rng(SEED + 65)
    centres = r.normal(size=(TSNE_CLUSTERS, TSNE_D)) * 3.0
    label = r.integers(0, TSNE_CLUSTERS, TSNE_N)
    X = centres[label] + r.normal(size=(TSNE_N, TSNE_D))
    model = tcl.Tsne(device=dev)
    t0 = time.perf_counter()
    P = model._affinities(X)
    p_s = time.perf_counter() - t0
    lr = max(TSNE_N / model.early_exaggeration / 4.0, 10.0)
    y0 = torch.from_numpy(np.random.default_rng(model.seed).normal(
        0, 1e-4, (TSNE_N, model.n_components)).astype(np.float32))
    Ph = torch.from_numpy(P.astype(np.float32)) * model.early_exaggeration
    Pd = Ph.to(dev)
    host = (y0, torch.zeros_like(y0), torch.ones_like(y0))
    card = tuple(t.to(dev) for t in host)
    free, cpu_s = [], 0.0
    for _ in range(TSNE_STEPS):
        card = ttsne.tsne_step(*card, Pd, lr, 0.5)
        t1 = time.perf_counter()
        host = ttsne.tsne_step(*host, Ph, lr, 0.5)
        cpu_s += time.perf_counter() - t1
        free.append(_rel_to_max(card[0].cpu(), host[0]))
    if not free[-1] <= TSNE_REL:
        raise AssertionError(f"phase 24 (b): t-SNE card vs CPU {free} "
                             f"(after {TSNE_STEPS} steps, not <= {TSNE_REL})")
    model._affinities = lambda _: P          # the P timed above
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y = model.fit_transform(X)
    fit_s = time.perf_counter() - t0
    Yd = torch.from_numpy(Y).to(dev)
    state = (Yd, torch.zeros_like(Yd), torch.ones_like(Yd))
    Pd = Pd / model.early_exaggeration
    step = lambda: ttsne.tsne_step(*state, Pd, lr, model.momentum)
    prof = _device_kernels(lambda: [step() for _ in range(10)], top=8)
    if prof["device_ms"] > 0:
        step_ms, by = prof["device_ms"] / 10, "profiler"
    else:
        step_ms, by = _event_ms_per_call(step, 10), "cuda_events"
    means = np.stack([Y[label == c].mean(0) for c in range(TSNE_CLUSTERS)])
    within = float(np.mean([np.linalg.norm(Y[label == c] - means[c],
                                           axis=1).mean()
                            for c in range(TSNE_CLUSTERS)]))
    d = np.linalg.norm(means[:, None] - means[None], axis=-1)
    across = float(d[np.triu_indices(TSNE_CLUSTERS, 1)].mean())
    row = {"n": TSNE_N, "dims": TSNE_D, "iterations": model.n_iter,
           "perplexity": model.perplexity, "host_p_s": p_s,
           "fit_s_without_p": fit_s, "device_ms_per_step": step_ms,
           "timed_by": by, "top_kernels": prof["top"],
           "card_vs_cpu_by_step": free,
           "cpu_ms_per_step": cpu_s * 1e3 / TSNE_STEPS,
           "whole_fit_card_vs_cpu": "not run: the CPU's 500 steps at this "
                                    "N (cpu_ms_per_step x 500)",
           "within_cluster_distance": within,
           "across_cluster_distance": across,
           "finite": bool(np.isfinite(Y).all())}
    if not (row["finite"] and across > 3 * within):
        raise AssertionError(f"phase 24 (b): t-SNE separation across "
                             f"{across:.3f} vs within {within:.3f}")
    return row


def _kmeans_data():
    """100,000 points around 100 seeded centres (D 128), with the cluster
    each was drawn from."""
    r = np.random.default_rng(SEED + 66)
    centres = r.normal(size=(KM_K, KM_D))
    label = r.integers(0, KM_K, KM_N)
    noise = r.normal(size=(KM_N, KM_D)) * 0.1
    return (centres[label] + noise).astype(np.float32), label


def _purity(assign, label):
    """(the smallest share of a true cluster in its most common found
    cluster, tests/test_clustering.py's gate; the standard purity)."""
    share = min(float((assign[label == c] == np.bincount(
        assign[label == c]).argmax()).mean()) for c in np.unique(label))
    pure = sum(np.bincount(label[assign == k]).max()
               for k in np.unique(assign)) / len(label)
    return share, float(pure)


class _KmSteps:
    """Stands in for ``kmeans.kmeans_step`` while a fit runs: counts the
    iterations with the read detector's count at each (``det``), and keeps
    host copies of the first ``keep`` steps' centroids and labels."""

    def __init__(self, det=None, keep=0):
        self.det, self.keep, self.step = det, keep, tkmeans.kmeans_step
        self.reads, self.kept = [], []

    def __enter__(self):
        def counted(*a):
            self.reads.append(0 if self.det is None else self.det.count)
            out = self.step(*a)
            if len(self.kept) < self.keep:
                self.kept.append((out[0].cpu(), out[1].cpu()))
            return out
        tkmeans.kmeans_step = counted
        return self

    def __exit__(self, *exc):
        tkmeans.kmeans_step = self.step


def _kmeans(dev):
    """(c) ``KMeansClustering`` from the reference's seeded init on the
    points as drawn: the whole fit on the card and on the CPU over the
    first ``KM_SLICE`` rows (each of the first 3 steps, then the end:
    labels equal, centroids within rel-to-max ``KM_REL``, the same
    purity); the fit of all the points on the card (iterations, one host
    read each, peak memory, purity reported), an iteration's device
    time."""
    pts, label = _kmeans_data()
    fits, compare_s = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        with _KmSteps(keep=KM_STEPS) as steps:
            model = tcl.KMeansClustering(k=KM_K, seed=KM_SEED,
                                         device=d).fit(pts[:KM_SLICE])
        compare_s[d] = time.perf_counter() - t0
        fits[d] = (model, steps)
    (card, cs), (host, hs) = fits[dev], fits["cpu"]
    labels_equal = [bool(torch.equal(a[1], b[1]))
                    for a, b in zip(cs.kept, hs.kept)]
    rels = [_rel_to_max(a[0], b[0]) for a, b in zip(cs.kept, hs.kept)]
    end_rel = _rel_to_max(torch.from_numpy(card.centroids),
                          torch.from_numpy(host.centroids))
    purity = {"card": _purity(card.labels_, label[:KM_SLICE]),
              "cpu": _purity(host.labels_, label[:KM_SLICE])}
    row = {"n": KM_N, "d": KM_D, "k": KM_K, "card_vs_cpu": {
        "rows": KM_SLICE, "labels_equal_by_step": labels_equal,
        "centroids_rel_to_max_by_step": rels,
        "iterations": {"card": len(cs.reads), "cpu": len(hs.reads)},
        "labels_equal_at_end": bool(np.array_equal(card.labels_,
                                                   host.labels_)),
        "centroids_rel_to_max_at_end": end_rel,
        "purity_smallest_share_and_standard": purity,
        "seconds": compare_s}}
    c = row["card_vs_cpu"]
    if not (len(rels) == KM_STEPS and all(labels_equal)
            and max(rels) <= KM_REL and c["labels_equal_at_end"]
            and end_rel <= KM_REL and len(cs.reads) == len(hs.reads)
            and purity["card"] == purity["cpu"]):
        raise AssertionError(f"phase 24 (c): k-means card vs CPU {c}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with _sync_watch() as det, _KmSteps(det) as steps:
        t0 = time.perf_counter()
        model = tcl.KMeansClustering(k=KM_K, seed=KM_SEED,
                                     device=dev).fit(pts)
        fit_s = time.perf_counter() - t0
    share, pure = _purity(model.labels_, label)
    reads = steps.reads
    row["fit"] = {"iterations": len(reads), "fit_s": fit_s,
                  "host_reads_in_loop": reads[-1] - reads[0],
                  "host_reads_whole_fit": det.count,
                  "peak_memory_bytes": torch.cuda.max_memory_allocated()
                  - held, "smallest_cluster_share": share,
                  "purity": pure}
    if reads[-1] - reads[0] != len(reads) - 1:
        raise AssertionError(f"phase 24 (c): {reads[-1] - reads[0]} host "
                             f"reads in {len(reads)} iterations (one each)")
    # an iteration is ~80 launches of ms-long kernels back to back, so
    # CUDA events read its device time (late in a whole run the profiler
    # records only some of a session's kernels)
    card_pts = torch.from_numpy(pts).to(dev)
    cents = torch.from_numpy(model.centroids).to(dev)
    row["device_ms_per_iteration"] = _event_ms_per_call(
        lambda: tkmeans.kmeans_step(card_pts, cents, KM_K), 5)
    row["timed_by"] = "cuda_events"
    return row


def _write_idx(cache, arrays):
    """The four MNIST IDX files (gzip) in ``cache``, so ``load_mnist``
    reads them and tries no download."""
    names = ("train_images", "train_labels", "test_images", "test_labels")
    for name, arr in zip(names, arrays):
        head = (struct.pack(">IIII", 2051, *arr.shape) if arr.ndim == 3
                else struct.pack(">II", 2049, arr.shape[0]))
        with gzip.open(os.path.join(cache, name + ".gz"), "wb",
                       compresslevel=0) as f:
            f.write(head + arr.tobytes())


def _read_pass(make):
    """One pass over every shard: (seconds, bytes of the members read, the
    batches)."""
    t0 = time.perf_counter()
    n, batches = 0, []
    for ds in make():
        batches.append(ds)
        for v in (ds.features, ds.labels):
            n += v.nbytes if isinstance(v, np.ndarray) else \
                v.numel() * v.element_size()
    return time.perf_counter() - t0, n, batches


def _lenet_rounds(shards, held, dev):
    """One LeNet epoch from the shards through the prefetcher, as
    ``MNIST_PARTS`` fits over the interleaved partitions of the shard
    files (``num_shards``, the multi-host split); after each of the first
    ``MNIST_PAIRED``, a second LeNet fits the same batches from memory
    (``held``, in the export's order). Images/s of the whole shard epoch
    and of the paired partitions from each source; the prefetchers'
    wait."""
    nets = {w: tlenet.lenet(device=dev).init(seed=SEED + 67)
            for w in ("shards", "memory")}
    out = {w: {"fits": 0, "images": 0, "fit_s": 0.0, "paired_images": 0,
               "paired_s": 0.0, "prefetcher_wait_ms": 0.0,
               "prefetcher_batches": 0} for w in nets}
    for q in range(MNIST_PARTS):
        part = [b for i, b in enumerate(held)
                if (i // MNIST_SHARD) % MNIST_PARTS == q]
        images = sum(len(b.features) for b in part)
        its = {"shards": texport.make_shard_iterator(
            shards, reader_threads=4, shard_index=q, num_shards=MNIST_PARTS)}
        if q < MNIST_PAIRED:
            its["memory"] = ListDataSetIterator(part)
        for w, it in its.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nets[w].fit(iterator=it)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            pf, o = nets[w]._solver_inst.prefetcher, out[w]
            o["fits"] += 1
            o["images"] += images
            o["fit_s"] += sec
            o["prefetcher_wait_ms"] += pf.total_wait_ms
            o["prefetcher_batches"] += pf.batches
            o["prefetcher"] = type(pf).__name__
            if q < MNIST_PAIRED:
                o["paired_images"] += images
                o["paired_s"] += sec
    for o in out.values():
        o["images_per_s"] = o["images"] / o["fit_s"]
        o["paired_images_per_s"] = o["paired_images"] / o["paired_s"]
    if out["shards"]["images"] != MNIST_TRAIN:
        raise AssertionError(f"phase 24 (d): the shard epoch took "
                             f"{out['shards']['images']} images")
    return out


def _data(dev, tmp):
    """(d) MNIST-shaped IDX files, ``load_mnist``, the export, the native
    reader (against numpy's: bitwise, MB/s a pass each), one LeNet step
    card vs CPU, one LeNet epoch from the shards through the prefetcher
    with part of it from memory interleaved, and the native codec against
    ``threshold_encode`` on the card."""
    if not (tnative.available() and tnative.shard_reader_available()):
        raise AssertionError("phase 24 (d): the native helpers did not "
                             "build (g++)")
    t0 = time.perf_counter()
    arrays = tmnist._synthetic_mnist(MNIST_TRAIN, MNIST_TEST)
    cache = os.path.join(tmp, "mnist")
    os.makedirs(cache)
    _write_idx(cache, arrays)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mem_it = tmnist.MnistDataSetIterator(MNIST_B, cache_dir=cache)
    load_s = time.perf_counter() - t0
    if mem_it.synthetic:
        raise AssertionError("phase 24 (d): load_mnist did not read the "
                             "IDX files")
    shards = os.path.join(tmp, "shards")
    t0 = time.perf_counter()
    manifest = texport.export_dataset_iterator(mem_it, shards,
                                               batches_per_shard=MNIST_SHARD)
    export_s = time.perf_counter() - t0
    native_it = lambda: texport.make_shard_iterator(shards, reader_threads=4)
    numpy_it = lambda: texport.ShardedFileDataSetIterator(shards,
                                                          reader_threads=4)
    if type(native_it()) is not texport.NativeShardedFileDataSetIterator:
        raise AssertionError("phase 24 (d): make_shard_iterator did not "
                             "take the native reader")
    reads, got = {}, {}
    for name, make in (("native", native_it), ("numpy", numpy_it)):
        sec, nbytes, got[name] = _read_pass(make)
        reads[name] = nbytes / sec / 1e6
    if len(got["native"]) != len(got["numpy"]) or not all(
            np.array_equal(a.features, b.features)
            and np.array_equal(a.labels, b.labels)
            for a, b in zip(got["native"], got["numpy"])):
        raise AssertionError("phase 24 (d): the native reader's batches "
                             "differ from numpy's")
    n_batches, held = len(got["numpy"]), got.pop("numpy")
    del got
    # one step on the card and on the CPU from the same weights and batch
    # (first, so the epoch's fits start warm)
    ds = held[0]
    step = {}
    for d in (dev, "cpu"):
        # Sgd: Adam's first step is lr x sign(g), which turns the rounding
        # of a near-zero gradient into an lr-sized difference
        net = tlenet.lenet(updater=Sgd(0.05), device=d).init(seed=SEED + 68)
        loss = net.score(ds.features, ds.labels)
        net.fit(ds.features, ds.labels, batch_size=MNIST_B)
        step[d] = (loss, net.params_flat().cpu())
    loss_rel = abs(step[dev][0] - step["cpu"][0]) / abs(step["cpu"][0])
    param_rel = _rel_to_max(step[dev][1], step["cpu"][1])
    if not (loss_rel <= 1e-5 and param_rel <= 1e-4):
        raise AssertionError(f"phase 24 (d): a LeNet step card vs CPU: loss "
                             f"{loss_rel:.3g}, parameters {param_rel:.3g}")
    fits = _lenet_rounds(shards, held, dev)
    del held
    # the host codec against the port's encode on the card (25 M f32)
    res = np.random.default_rng(SEED + 69).standard_normal(
        K9_N, dtype=np.float32)
    k9.threshold_encode_fused.launches = 0
    t0 = time.perf_counter()
    payload, new_res = threshold_encode(torch.from_numpy(res).to(dev),
                                        CODEC_THRESHOLD, CODEC_CAPACITY)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    k9_launches = k9.threshold_encode_fused.launches
    t0 = time.perf_counter()
    idx, signs, count, nat_res = tnative.native_threshold_encode(
        res, CODEC_THRESHOLD, CODEC_CAPACITY)
    native_s = time.perf_counter() - t0
    codec_equal = (np.array_equal(idx, payload.indices.cpu().numpy())
                   and np.array_equal(signs, payload.signs.cpu().numpy())
                   and count == int(payload.count)
                   and np.array_equal(nat_res, new_res.cpu().numpy()))
    if not codec_equal:
        raise AssertionError("phase 24 (d): the native codec differs from "
                             "threshold_encode on the card")
    return {"images": MNIST_TRAIN, "test_images": MNIST_TEST,
            "generate_and_write_idx_s": gen_s, "load_mnist_s": load_s,
            "export_s": export_s, "shards": manifest["num_shards"],
            "batches": manifest["num_batches"],
            "shard_bytes": sum(os.path.getsize(os.path.join(shards, f))
                               for f in os.listdir(shards)),
            "native_equals_numpy_batches": n_batches,
            "read_mb_per_s": reads, "lenet_epoch_rounds": fits,
            "lenet_step_card_vs_cpu": {"loss_rel": loss_rel,
                                       "params_rel_to_max": param_rel},
            "codec": {"n": K9_N, "threshold": CODEC_THRESHOLD,
                      "capacity": CODEC_CAPACITY, "count": count,
                      "bitwise_equal": True, "card_encode_s": card_s,
                      "native_encode_s": native_s,
                      "k9_launches": k9_launches}}


def _pretrained(dev, tmp):
    """(e) The textgen fixture restored into ``text_generation_lstm`` on
    the card (its output against the fixture's, K5 counted) and
    ``digits_cnn(pretrained=True)`` on the held-out scans."""
    expected = np.load(os.path.join(FIXTURES,
                                    "pretrained_textgen_small_expected.npz"))
    net = text_generation_lstm(vocab_size=12, hidden=16, max_length=8,
                               seed=99, device=dev)
    tpre.init_pretrained(net, os.path.join(FIXTURES,
                                           "pretrained_textgen_small.zip"),
                         checksum=TEXTGEN_CHECKSUM,
                         cache_dir=os.path.join(tmp, "models"))
    lstm.fused_lstm_fwd.launches = 0
    out = net.output(expected["x"]).cpu().numpy()
    k5 = lstm.fused_lstm_fwd.launches
    err = float(np.abs(out - expected["out"]).max())
    if not (err <= 1e-5 and k5 > 0):
        raise AssertionError(f"phase 24 (e): textgen restored on the card "
                             f"{err:.3g} from its expected outputs, {k5} K5 "
                             f"launches")
    z = np.load(os.path.join(FIXTURES, "digits_heldout_400.npz"))
    x = (z["images"] / 16.0).astype(np.float32)[..., None]
    checksum = tpre.adler32_of(tlenet.DIGITS_CNN_ARTIFACT)
    digits = tlenet.digits_cnn(pretrained=True, device=dev)
    acc = float(np.mean(digits.output(x).cpu().numpy().argmax(1)
                        == z["labels"]))
    if not (checksum == tlenet.DIGITS_CNN_CHECKSUM and acc >= 0.95):
        raise AssertionError(f"phase 24 (e): digits_cnn checksum {checksum},"
                             f" held-out accuracy {acc:.4f}")
    return {"textgen_max_abs_err": err, "textgen_k5_launches": k5,
            "digits_checksum": checksum, "digits_heldout_accuracy": acc}


def graphs_clustering_data_phase(dev="cuda"):
    """Phase 24 (see the module docstring): graphs, clustering, the data
    side and the pretrained models on the card."""
    t0 = time.perf_counter()
    row, marks = {}, {}
    tmp = tempfile.mkdtemp(prefix="p24_")
    try:
        for part, fn in (("graphs", lambda: _graphs(dev)),
                         ("tsne", lambda: _tsne(dev)),
                         ("kmeans", lambda: _kmeans(dev)),
                         ("data", lambda: _data(dev, tmp)),
                         ("pretrained", lambda: _pretrained(dev, tmp))):
            t1 = time.perf_counter()
            row[part] = fn()
            marks[part] = time.perf_counter() - t1
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row.update(seconds_by_part=marks, seconds=time.perf_counter() - t0,
               launches={"lstm_fwd": row["pretrained"]["textgen_k5_launches"],
                         "threshold_encode":
                             row["data"]["codec"]["k9_launches"]})
    g = row["graphs"]
    log(f"phase 24: {row['seconds']:.1f} s {marks}; DeepWalk "
        f"{g['deepwalk']['words_per_s']:.0f} words/s, accuracy "
        f"{g['deepwalk']['classification']['accuracy']:.3f}; node2vec "
        f"{g['node2vec']['classification']['accuracy']:.3f}; t-SNE "
        f"{row['tsne']['card_vs_cpu_by_step'][-1]:.3g}; k-means "
        f"{row['kmeans']['fit']}")
    return row


def main() -> int:
    smi = device_phase()
    build_report = build_phase()
    errs, rows = kernel_phase()
    bwd_errs, bwd_rows, sdpa_backends, ring_hops = bwd_kernel_phase()
    slice_row = slice_phase()
    gen_row = generation_phase()
    train_row = train_phase()
    window_row = train_window_phase()
    amp_cross = amp_cross_device_phase()
    cross_row = cross_device_phase()
    lstm_errs, lstm_rows, lstm_step_us, lstm_plans = lstm_kernel_phase()
    char_serve = char_serve_phase()
    char_train = char_train_phase()
    char_cross = char_cross_device_phase()
    char_graph_row = char_graph_phase()
    k7_errs, k7_rows, k7_bf16_rows = conv_kernel_phase()
    k8_rows, k8_err = int8_kernel_phase()
    gnet, gserve = googlenet_serve_phase()
    mlp, i8serve = int8_serve_phase()
    resnet_row, resnet_ctx = resnet_phase()
    transfer_row, transfer_ctx = googlenet_transfer_phase()
    sent_row, sent_ctx = sentiment_phase()
    s2s_row = seq2seq_phase()
    nn_cross = nn_engine_cross_device_phase()
    cnn_cross = cnn_cross_device_phase(gnet, mlp)
    zip_http = zip_http_phase(gnet, mlp)
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
    cnn_train_device = cnn_train_device_time_phase(resnet_ctx, transfer_ctx)
    sent_device = sentiment_device_time_phase(sent_ctx)
    del resnet_ctx, transfer_ctx, sent_ctx
    torch.cuda.empty_cache()
    # after phase 19: with these two before it, many of its short profiler
    # sessions recorded no kernel at all, later in a longer run
    resume = listeners_resume_phase()
    dp_opt = dp_options_phase()
    model_axis = model_axis_phase()
    tp_n = model_axis["launches"]
    elastic = elastic_phase(gserve)
    el_n = elastic["launches"]
    # last, after elastic_phase: the host-read detector both use wraps
    # torch.Tensor's read methods for the rest of the process
    tel_row = telemetry_phase()
    tel_serve = tel_row["serve"]["k1_launches"]
    # (c) and (c')'s fits: the phase's training path
    tel_train = {n: tel_row["train"]["launches"][n]
                 + tel_row["step_cost"]["launches"][n] for n in COUNTED}
    tel_i8 = tel_row["forward_cost"]["k8_launches"]
    # phase 21 after phase 20: its fleet's replicas are processes of their
    # own, and its parallel paths each count their launches
    p21 = parallel_fleet_phase()
    p21_n = p21["launches"]
    # phase 22 last: the registry's timings and the UI over the fits
    p22 = ui_phase(n_params)
    # phase 23 after phase 22: the NLP library (no kernel of ours on it)
    p23 = nlp_phase()
    # phase 24 last: graphs, clustering, the data side, pretrained models
    p24 = graphs_clustering_data_phase()
    p22_paths = lambda name: {path: n[name] for path, n in
                              p22["launches_by_path"].items() if n[name]}
    p21_paths = lambda name: {path: n[name] for path, n in
                              p21["launches_by_path"].items() if n[name]}
    top = next(r for r in rows if r["BH"] == 16 and r["T"] == 1024
               and r["dtype"] == str(torch.float32))
    serve_k1 = slice_row["flash_attention_launches"]
    gen_k1 = sum(gen_row["k1_launches"].values())
    lstm_draft_k5 = gen_row["cases"]["e_spec_lstm"]["k5_launches"]
    train_k = train_row["launches"]
    win = {what: window_row["runs"][what]["launches"]
           for what in ("per_step", "per_step_prefetch", "window",
                        "window_remat")}
    win_sum = {n: sum(w[n] for w in win.values()) for n in COUNTED}
    amp_step = {n: win["per_step"][n] + win["per_step_prefetch"][n]
                for n in COUNTED}
    ring_dtypes = (str(torch.float32), str(torch.bfloat16))
    src = "deeplearning4j_tpu_torch/csrc/flash_attention_{}.cu"
    ref = "deeplearning4j_tpu/ops/pallas_attention.py:{}"
    http_n = zip_http["launches"]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": src.format("fwd"), "replaces": ref.format(186),
        "launches": serve_k1 + gen_k1 + train_k["flash_attention_fwd"]
        + win_sum["flash_attention_fwd"]
        + dp_row["launches"]["flash_attention_fwd"]
        + http_n["flash_attention_fwd"]
        + resume["launches"]["flash_attention_fwd"]
        + dp_opt["launches"]["flash_attention_fwd"]
        + tp_n["flash_attention_fwd"] + el_n["flash_attention_fwd"]
        + tel_serve + tel_train["flash_attention_fwd"]
        + p21_n["flash_attention_fwd"],
        "launches_by_path": {
            "serve": serve_k1, "serve_generation": gen_row["k1_launches"],
            "train": train_k["flash_attention_fwd"],
            "train_amp": amp_step["flash_attention_fwd"],
            "train_window": win["window"]["flash_attention_fwd"],
            "train_remat": win["window_remat"]["flash_attention_fwd"],
            "train_data_parallel": dp_row["launches"]["flash_attention_fwd"],
            "http": http_n["flash_attention_fwd"],
            "train_resume": resume["launches"]["flash_attention_fwd"],
            "train_dp_options": dp_opt["launches"]["flash_attention_fwd"],
            "model_axis": tp_n["flash_attention_fwd"],
            "elastic_distributed": el_n["flash_attention_fwd"],
            "telemetry_serve": tel_serve,
            "telemetry_train": tel_train["flash_attention_fwd"],
            **p21_paths("flash_attention_fwd")},
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
            "launches": train_k[name] + win_sum[name]
            + dp_row["launches"][name] + resume["launches"][name]
            + dp_opt["launches"][name] + tp_n[name] + el_n[name]
            + tel_train[name] + p21_n[name]
            + sum(ring_row[d]["launches"][name] for d in ring_dtypes),
            "launches_by_path": {
                "train": train_k[name],
                "train_amp": amp_step[name],
                "train_window": win["window"][name],
                "train_remat": win["window_remat"][name],
                "train_data_parallel": dp_row["launches"][name],
                "train_resume": resume["launches"][name],
                "train_dp_options": dp_opt["launches"][name],
                "model_axis": tp_n[name],
                "elastic_distributed": el_n[name],
                "telemetry_train": tel_train[name],
                "ring": sum(ring_row[d]["launches"][name]
                            for d in ring_dtypes), **p21_paths(name)},
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
        graph_n = char_graph_row["launches"][name]
        stream_n = (char_graph_row["rnn_time_step_k5_launches"]
                    if kind == "fwd" else 0)
        draft_n = lstm_draft_k5 if kind == "fwd" else 0
        http_k5 = http_n["lstm_fwd"] if kind == "fwd" else 0
        runs = sent_row["runs"]
        sent_n = (runs["per_step"]["launches"][name]
                  + runs["window"]["launches"][name]
                  + sent_row["evaluate_launches"][name])
        s2s_n = s2s_row["fit_launches"][name] + (
            s2s_row["stream_k5_launches"] if kind == "fwd" else 0)
        avg_n = dp_opt["averaging"]["launches"][name]
        tp_lstm = tp_n[name]
        stream_fit = el_n[name]
        by_path = {"serve": serve_n, "train": train_n,
                   "char_graph_tbptt": graph_n, "seq_classifier": sent_n,
                   "seq2seq": s2s_n, "train_averaging": avg_n,
                   "train_model_axis": tp_lstm,
                   "train_streaming": stream_fit}
        if kind == "fwd":
            by_path["char_graph_rnn_time_step"] = stream_n
        if kind == "fwd":
            by_path.update(
                serve_decode_graph_replays=char_serve[
                    "launches_in_replays"].get(name, 0),
                serve_lstm_draft=draft_n, http=http_k5)
        by_path.update(p22_paths(name))
        p24_n = p24["launches"].get(name, 0)
        if p24_n:
            by_path["pretrained_textgen"] = p24_n
        kernels.append({
            "name": name, "route": "cuda", "source": lsrc.format(kind),
            "replaces": lref.format(line),
            "launches": serve_n + train_n + graph_n + stream_n + draft_n
            + http_k5 + sent_n + s2s_n + avg_n + tp_lstm + stream_fit
            + p22["launches"][name] + p24_n,
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
                if k.startswith(f"cudnn_{kind}")},
            "seq_classifier_shape": {
                "shape": "T=256 B=64 H=256 float32 peepholes (ms and "
                         "library_ms: device time; library: cuDNN "
                         "nn.LSTM(300, 256))",
                "ms": sent_device[f"k{5 if kind == 'fwd' else 6}_device_ms"],
                "ms_loop": sent_row["kernels"][f"{kind}_ms"],
                "plain_ms": sent_row["kernels"][f"{kind}_plain_ms"],
                "bound_ms": sent_row["kernels"][f"{kind}_bound_ms"],
                "bound_by": sent_row["kernels"][f"{kind}_bound_by"],
                "library_ms": sent_device[f"cudnn_{kind}_device_ms"],
                "max_abs_err_unmasked":
                    sent_row["kernels"][f"{kind}_max_abs_err_unmasked"],
                "max_abs_err_masked":
                    sent_row["kernels"][f"{kind}_max_abs_err_masked"],
                "plan": sent_row["kernels"][f"{kind}_plan"]}})
    kernels.append({
        "name": "conv1x1_bias_relu", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/conv1x1_bias_relu.cu",
        "replaces": "deeplearning4j_tpu/ops/kernels/conv.py:83",
        "launches": gserve["k7_launches"] + http_n["conv1x1_bias_relu"]
        + transfer_row["k7_launches"] + tp_n["conv1x1_bias_relu"]
        + el_n["conv1x1_bias_relu"] + p22["launches"]["conv1x1_bias_relu"],
        "launches_by_path": {"serve_googlenet": gserve["k7_launches"],
                             "http": http_n["conv1x1_bias_relu"],
                             "transfer_googlenet":
                                 transfer_row["k7_launches"],
                             "serve_googlenet_mesh":
                                 tp_n["conv1x1_bias_relu"],
                             "parallel_inference":
                                 el_n["conv1x1_bias_relu"],
                             **p22_paths("conv1x1_bias_relu")},
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
        "launches": i8serve["k8_launches"] + http_n["int8_matmul"]
        + tel_i8,
        "launches_by_path": {"serve_int8": i8serve["k8_launches"],
                             "http": http_n["int8_matmul"],
                             "telemetry_serve_int8": tel_i8},
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
        "launches": ring_k4 + p21_n["flash_block_update"],
        "launches_by_path": {"ring": ring_k4,
                             **p21_paths("flash_block_update")},
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
        "launches": dp_row["launches"]["threshold_encode"]
        + p21_n["threshold_encode"] + p24["launches"]["threshold_encode"],
        "launches_by_path": {
            "train_data_parallel": dp_row["launches"]["threshold_encode"],
            **p21_paths("threshold_encode"),
            **({"native_codec": p24["launches"]["threshold_encode"]}
               if p24["launches"]["threshold_encode"] else {})},
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
                      "device_times_by_cuda_events": EVENT_TIMED,
                      "card": smi}),
          flush=True)
    print(json.dumps({"slice": slice_row, "generation": gen_row,
                      "card": smi}), flush=True)
    print(json.dumps({"train": train_row, "cross_device": cross_row,
                      "train_window": window_row,
                      "amp_cross_device": amp_cross,
                      "char_graph": char_graph_row, "card": smi}),
          flush=True)
    print(json.dumps({"char_serve": char_serve, "char_train": char_train,
                      "char_cross_device": char_cross, "card": smi}),
          flush=True)
    print(json.dumps({"googlenet_serve": gserve, "int8_serve": i8serve,
                      "cnn_cross_device": cnn_cross, "card": smi}),
          flush=True)
    print(json.dumps({"zip_http": zip_http, "card": smi}), flush=True)
    print(json.dumps({"resnet50": resnet_row,
                      "googlenet_transfer": transfer_row,
                      "cnn_train_device_time": cnn_train_device,
                      "card": smi}, default=str), flush=True)
    print(json.dumps({"sentiment": sent_row, "seq2seq": s2s_row,
                      "nn_engine_cross_device": nn_cross,
                      "sentiment_device_time": sent_device, "card": smi},
                     default=str), flush=True)
    print(json.dumps({"ring": ring_row, "data_parallel": dp_row,
                      "parallel_cross_device": par_cross, "card": smi}),
          flush=True)
    print(json.dumps({"listeners_resume": resume,
                      "data_parallel_options": dp_opt, "card": smi},
                     default=str), flush=True)
    print(json.dumps({"model_axis": model_axis, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"elastic_phase": elastic, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"telemetry": tel_row, "card": smi}, default=str),
          flush=True)
    print(json.dumps({"parallel_telemetry_and_fleet": p21, "card": smi},
                     default=str), flush=True)
    print(json.dumps({"kernel_registry_and_ui": p22, "card": smi},
                     default=str), flush=True)
    print(json.dumps({"nlp": p23, "card": smi}, default=str), flush=True)
    print(json.dumps({"graphs_clustering_data": p24, "card": smi},
                     default=str), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--amp-seeds"]:
        # the bf16-compute card-vs-CPU check on several seeds (PERF.md)
        device_phase()
        for row in amp_seed_study(int(sys.argv[2])):
            print(json.dumps(row, default=str), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--phase-24"]:
        # phase 24 alone, after the card's check (PERF.md's r-runs)
        smi = device_phase()
        print(json.dumps({"card": smi, "graphs_clustering_data":
                          graphs_clustering_data_phase()}, default=str),
              flush=True)
        sys.exit(0)
    # every phase's flight-recorder dumps (17d's kills and recoveries
    # among them) go to a directory of this run, never into the checkout
    dumps = tempfile.mkdtemp(prefix="chip_smoke_flightrec_")
    configure_flight_recorder(directory=dumps)
    try:
        rc = main()
    finally:
        shutil.rmtree(dumps, ignore_errors=True)
    sys.exit(rc)
