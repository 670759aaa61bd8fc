"""The port's generation serving parts on the CPU: the block allocator, the
capacity plan against the JAX GenerationConfig, sampling, and the
scheduler's admission checks, stream lifecycle and continuous batching
(greedy streams through the engine equal the port's naive reference)."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.generation import GenerationConfig as JConfig
from deeplearning4j_tpu_torch.models.decode import naive_generate
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.serving.errors import (BlockPoolExhaustedError,
                                                     DrainingError,
                                                     ShapeMismatchError)
from deeplearning4j_tpu_torch.serving.generation import (BlockAllocator,
                                                         GenerationConfig,
                                                         GenerationEngine)
from deeplearning4j_tpu_torch.serving.generation.kvcache import (
    PagedStore, make_pools, prefill_scatter)
from deeplearning4j_tpu_torch.serving.generation.sampling import sample_tokens

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lm():
    return transformer_lm(vocab_size=53, d_model=32, n_heads=2, n_blocks=2,
                          max_length=64, token_input=True, seed=7,
                          device="cpu").init()


def _engine(lm, **kw):
    cfg = dict(device="cpu", block_len=8, max_seq_len=64, decode_slots=3,
               prefill_batches=(1, 2), prompt_rungs=(32, 64))
    cfg.update(kw)
    return GenerationEngine(lm, **cfg)


def test_block_allocator():
    a = BlockAllocator(5)              # ids 1..4 usable, 0 is trash
    assert a.total_usable == 4 and a.free_blocks == 4
    got = a.alloc(3)
    assert sorted(got) == [1, 2, 3] and a.free_blocks == 1
    with pytest.raises(BlockPoolExhaustedError):
        a.alloc(2)
    a.free(got[:1])
    with pytest.raises(ValueError, match="unallocated"):
        a.free(got[:1])                # double free
    with pytest.raises(ValueError, match="invalid"):
        a.free([0])                    # the trash block
    a.free(got[1:])
    assert a.free_blocks == 4
    with pytest.raises(ValueError):
        BlockAllocator(1)


@pytest.mark.parametrize("kw", [
    dict(block_len=16, max_seq_len=100, decode_slots=4),
    dict(block_len=8, max_seq_len=64, prompt_rungs=(20, 64, 300),
         prefill_batches=(4, 1, 2, 2)),
    dict(block_len=16, max_seq_len=1024, decode_slots=8,
         prefill_batches=(1, 2), prompt_rungs=(512, 1024))])
def test_capacity_plan_matches_jax(kw):
    ours, ref = GenerationConfig(**kw), JConfig(**kw)
    for field in ("capacity", "blocks_per_seq", "prefill_batches",
                  "prompt_rungs", "num_blocks", "max_prompt_len"):
        assert getattr(ours, field) == getattr(ref, field), field
    for n in (1, 3, 5):
        assert ours.prefill_rung(n) == ref.prefill_rung(n)
    assert ours.blocks_needed(17, 9) == ref.blocks_needed(17, 9)


def test_config_rejects_bad_plans():
    with pytest.raises(ValueError):
        GenerationConfig(block_len=0)
    with pytest.raises(ValueError):
        GenerationConfig(prefill_batches=(0,))
    with pytest.raises(ValueError):
        GenerationConfig(num_blocks=1)
    with pytest.raises(ValueError, match="rung"):
        GenerationConfig(max_seq_len=64).prompt_rung(65)


def test_sampling_greedy_top_k_and_seeding():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]] * 4)
    temp = torch.tensor([0.0, 1.0, 1.0, 5.0])
    topk = torch.tensor([0, 1, 2, 0])
    for _ in range(20):
        tok = sample_tokens(logits, g, temp, topk)
        assert tok[0] == 1 and tok[1] == 1          # greedy; top-1
        assert int(tok[2]) in (1, 3)                # top-2 support
    a = sample_tokens(logits, torch.Generator().manual_seed(3), temp, topk)
    b = sample_tokens(logits, torch.Generator().manual_seed(3), temp, topk)
    assert torch.equal(a, b)
    all_greedy = sample_tokens(logits, g, torch.zeros(4), torch.zeros(4))
    assert torch.equal(all_greedy, torch.ones(4, dtype=torch.long))


def test_paged_store_idle_slots_write_to_trash():
    k, v = make_pools(1, 4, 2, 1, 2, torch.float32, CPU)
    tables = torch.tensor([[1, 2], [3, 0]])
    prefill_scatter(k, [torch.ones(2, 4, 1, 2)], tables)
    assert torch.all(k[0, 1:3] == 1) and torch.all(k[0, 3] == 1)
    store = PagedStore(k, v, tables, torch.tensor([2, 1]),
                       torch.tensor([True, False]), 2)
    K, V, mask = store.put_get(0, torch.full((2, 1, 2), 7.0),
                               torch.full((2, 1, 2), 9.0))
    assert k[0, 2, 0, 0, 0] == 7.0          # slot 0: position 2 -> block 2
    assert k[0, 0, 0, 0, 0] == 7.0          # idle slot 1 -> trash block 0
    assert K.shape == (2, 1, 4, 2)
    assert mask.tolist() == [[True, True, True, False],
                             [True, True, False, False]]


def test_submit_rejects_what_the_plan_cannot_hold(lm):
    eng = _engine(lm, num_blocks=5)
    try:
        with pytest.raises(ShapeMismatchError, match="empty"):
            eng.generate([], max_tokens=2)
        with pytest.raises(ShapeMismatchError, match="max_tokens"):
            eng.generate([1], max_tokens=0)
        with pytest.raises(ShapeMismatchError, match="capacity"):
            eng.generate([1] * 60, max_tokens=10)
        with pytest.raises(BlockPoolExhaustedError) as ei:
            eng.generate([1] * 30, max_tokens=10)    # 5 blocks > 4 usable
        assert ei.value.retryable is False
    finally:
        eng.stop()
    with pytest.raises(DrainingError):
        eng.generate([1], max_tokens=1)


def test_continuous_batching_matches_naive_and_stop_tokens(lm):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 53, size=n).tolist()
               for n in (3, 12, 30, 7, 40)]
    refs = [naive_generate(lm, p, 6, pad_to=64, device="cpu")
            for p in prompts]
    eng = _engine(lm)
    try:
        streams = [eng.generate(p, max_tokens=6, stream=True)
                   for p in prompts]
        got = [list(s) for s in streams]
        assert got == refs
        assert all(s.finish_reason == "length" for s in streams)
        # a stop token ends the stream before it would be emitted
        toks, reason = eng.generate(prompts[0], max_tokens=6,
                                    stop=[refs[0][2]])
        assert reason == "stop" and toks == refs[0][:refs[0].index(
            refs[0][2])]
        snap = eng.metrics()["default"]
        assert snap["requests"] == 6 and snap["prefills"] >= 3
        assert snap["tokens_out"] == 30 + len(toks)
        assert snap["finished"] == {"length": 5, "stop": 1}
        assert snap["decode_tokens_per_sec"] > 0
    finally:
        eng.stop()


def test_stop_without_drain_finishes_every_stream(lm):
    eng = _engine(lm, decode_slots=1)
    streams = [eng.generate([1, 2, 3], max_tokens=40, stream=True)
               for _ in range(3)]
    eng.stop(drain=False, timeout=5.0)
    for s in streams:
        toks, reason = s.result(raise_on_error=False)
        assert s.done and reason in ("shutdown", "length")
    assert any(s.finish_reason == "shutdown" for s in streams)


def test_engine_requires_the_nets_device(lm):
    with pytest.raises(ValueError, match="lives on"):
        GenerationEngine(lm, device="meta")
