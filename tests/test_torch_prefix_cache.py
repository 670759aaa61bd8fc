"""The port's prefix cache against the JAX package's: the chain hashes, one
sequence of cache operations, the allocator's refcounts, and the engine's
greedy streams on a prefix hit and a miss (weights carried across with
``load_jax_params``), copy-on-write under concurrent admission, eviction
under pool pressure, the opt-out, no sharing across a hot-swap cohort and
the ``prefix_cache=None`` default. f32 on the CPU; tokens token for token,
with the JAX forward's top-1/top-2 margin at every compared step above
1e-4 so that no match rests on a tie."""
import _torch_threads  # noqa: F401
import threading

import numpy as np
import pytest

from deeplearning4j_tpu.models.decode import naive_generate as jnaive
from deeplearning4j_tpu.models.zoo_extra import (
    text_generation_lstm as jtext_generation_lstm,
    transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.serving.generation import GenerationEngine as JEngine
from deeplearning4j_tpu.serving.generation.kvcache import \
    BlockAllocator as JAllocator
from deeplearning4j_tpu.serving.generation.prefix import \
    PrefixCache as JPrefixCache
from deeplearning4j_tpu.serving.generation.prefix import \
    _block_hashes as jblock_hashes
from deeplearning4j_tpu.serving.generation.programs import (
    GenerationConfig as JConfig, GenerationProgramSet as JProgramSet)
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.decode import naive_generate
from deeplearning4j_tpu_torch.models.zoo_extra import (text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.serving.errors import BlockPoolExhaustedError
from deeplearning4j_tpu_torch.serving.generation import (BlockAllocator,
                                                         GenerationConfig,
                                                         GenerationEngine,
                                                         PrefixCache)
from deeplearning4j_tpu_torch.serving.generation.prefix import _block_hashes
from deeplearning4j_tpu_torch.serving.generation.programs import \
    GenerationProgramSet
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_blocks=2, max_length=64,
           token_input=True)
ENG = dict(block_len=8, max_seq_len=64, decode_slots=4,
           prefill_batches=(1, 2), prompt_rungs=(32, 64))
CAP = 64


def _np(params):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in params]


def _pair(seed):
    jnet = jtransformer_lm(**CFG, seed=seed).init()
    pnet = transformer_lm(**CFG, device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


@pytest.fixture(scope="module")
def nets():
    return _pair(3)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 64, size=n).tolist()


def _jax_margins(jnet, prompt, generated):
    """Top-1 minus top-2 log-probability at each step that chose a
    generated token, from one JAX forward over the final sequence."""
    seq = list(prompt) + list(generated)
    buf = np.zeros((1, CAP), np.int32)
    buf[0, :len(seq)] = seq
    logp = np.log(np.asarray(jnet.output(buf))[0])
    rows = logp[len(prompt) - 1:len(seq) - 1]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _engine(pnet, **kw):
    return GenerationEngine(pnet, device="cpu", **dict(ENG, **kw))


def _jengine(jnet, **kw):
    return JEngine(jnet, model_name="default", **dict(ENG, **kw))


# ----------------------------------------------------------------- hashes
@pytest.mark.parametrize("block_len, n", [(8, 0), (8, 7), (8, 8), (8, 30),
                                          (16, 64), (4, 33), (1, 5)])
def test_block_hashes_are_the_references_bytes(block_len, n):
    prompt = np.random.default_rng(n + block_len).integers(
        0, 2 ** 31 - 1, size=n)
    want = jblock_hashes(prompt.astype(np.int32), block_len)
    assert _block_hashes(prompt.astype(np.int64), block_len) == want
    assert _block_hashes(prompt.astype(np.int32), block_len) == want
    assert len(want) == n // block_len


# -------------------------------------------------------- cache operations
def _op_log(alloc_cls, cache_cls):
    """One sequence of allocator and prefix-cache operations: registration,
    a full and a partial match, release to the LRU, duplicate
    registration, an eviction of a chain under pressure, the refusal of
    freeing a shared block. Returns everything observable after each."""
    a = alloc_cls(12)                   # 11 usable blocks
    pc = cache_cls(a, 4)
    log = []

    def snap(tag, *vals):
        log.append((tag, vals, a.free_blocks, sorted(a.allocated),
                    sorted((b, a.refcount(b)) for b in a.allocated),
                    pc.stats(), sorted(pc.cached_block_ids())))

    A = np.arange(1, 11)                # 2 full blocks + 2 tokens
    B = np.concatenate([A[:8], [40, 41, 42, 43, 44]])
    C = np.arange(20, 33)               # 3 full blocks
    own_a = a.alloc(3)
    snap("register A", pc.register(A, np.array(own_a + [0]), own_a))
    snap("probe B", pc.probe(B), pc.evictable_for(B))
    shared, matched = pc.match(B)
    snap("match B", shared, matched)
    own_b = a.alloc(2)
    row = np.array(shared + own_b)
    managed_b = pc.register(B, row, own_b)
    snap("register B", managed_b)
    with pytest.raises(ValueError, match="refcount"):
        a.free(managed_b)
    pc.release(shared + managed_b)
    a.free([b for b in own_b if b not in managed_b])
    snap("release B")
    pc.release(own_a[:2])
    a.free(own_a[2:])
    snap("release A")
    own_c = a.alloc(4)
    snap("register C", pc.register(C, np.array(own_c), own_c))
    snap("duplicate C", pc.register(C, np.array(own_c), own_c))
    pc.release(own_c[:3])
    a.free(own_c[3:])
    snap("release C")
    snap("ensure_free 9", pc.ensure_free(9))
    snap("probe A after eviction", pc.probe(A), pc.evictable_for(C))
    shared, matched = pc.match(C)
    snap("match C", shared, matched)
    return log


def test_cache_operations_match_the_reference():
    ours = _op_log(BlockAllocator, PrefixCache)
    ref = _op_log(JAllocator, JPrefixCache)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o == r, o[0]


def test_allocator_refcounts():
    for cls in (BlockAllocator, JAllocator):
        a = cls(6)
        got = a.alloc(3)
        assert a.used_blocks == 3 and a.allocated == frozenset(got)
        assert a.incref(got[0]) == 1 and a.incref(got[0]) == 2
        assert a.refcount(got[0]) == 2 and a.refcount(got[1]) == 0
        with pytest.raises(ValueError, match="refcount"):
            a.free([got[0]])
        assert a.decref(got[0]) == 1 and a.decref(got[0]) == 0
        with pytest.raises(ValueError, match="below zero"):
            a.decref(got[0])
        with pytest.raises(ValueError, match="unallocated"):
            a.incref(5 if 5 not in got else 4)
        a.free(got)
        assert a.used_blocks == 0 and a.allocated == frozenset()
        with pytest.raises(BlockPoolExhaustedError if cls is BlockAllocator
                           else Exception, match="exhausted"):
            a.alloc(6)


# ------------------------------------------------------ engine parity
def test_hit_and_miss_equal_the_jax_engine(nets):
    """A block-aligned prompt (its hit copies the last block and replays one
    token), one with a 3-token suffix past those two blocks and one that
    shares only the first block, each sent twice: the port's miss and hit
    streams equal the JAX engine's, and so do the prefix counters."""
    jnet, pnet = nets
    base = _prompt(1, 16)
    prompts = [base, base + _prompt(2, 3), base[:8] + _prompt(3, 9)]
    keys = ("hits", "misses", "tokens_saved", "cow_copies", "evictions",
            "cached_blocks", "cached_lru_blocks", "shared_blocks")
    jeng = _jengine(jnet)
    try:
        refs = [jeng.generate(p, max_tokens=10)[0] for p in prompts]
        jhit = [jeng.generate(p, max_tokens=10)[0] for p in prompts]
        jsnap = jeng.metrics()["default"]["prefix"]
    finally:
        jeng.stop()
    assert jhit == refs
    for p, ref in zip(prompts, refs):
        assert ref == jnaive(jnet, p, 10, pad_to=CAP)
        assert np.all(_jax_margins(jnet, p, ref) > 1e-4)
    eng = _engine(pnet)
    try:
        miss = [eng.generate(p, max_tokens=10)[0] for p in prompts]
        hit = [eng.generate(p, max_tokens=10)[0] for p in prompts]
        snap = eng.metrics()["default"]["prefix"]
    finally:
        eng.stop()
    assert miss == refs and hit == refs
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["hits"] == 5 and snap["cow_copies"] == 1


def test_copy_on_write_under_concurrent_admission(nets):
    jnet, pnet = nets
    p = _prompt(4, 24)                      # 3 full blocks: every hit COWs
    want = jnaive(jnet, p, 12, pad_to=CAP)
    eng = _engine(pnet)
    try:
        assert eng.generate(p, max_tokens=12)[0] == want        # the miss
        outs = {}

        def client(i):
            outs[i] = eng.generate(p, max_tokens=12)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # the shared blocks were never written: a later hit still matches
        again = eng.generate(p, max_tokens=12)[0]
        snap = eng.metrics()["default"]
    finally:
        eng.stop()
    assert all(outs[i] == (want, "length") for i in range(6))
    assert again == want
    assert snap["prefix"]["hits"] == 7 and snap["prefix"]["cow_copies"] == 7
    assert snap["finished"] == {"length": 8}


def test_eviction_under_pool_pressure_matches_jax(nets):
    """9 blocks (8 usable): the first prompt's 3 cached blocks park in the
    LRU; the next prompt needs 6 fresh blocks and evicts them — the same
    evictions and tokens as the JAX engine."""
    jnet, pnet = nets
    prompts = [_prompt(5, 24), _prompt(6, 40), _prompt(5, 24)]
    kw = dict(num_blocks=9, decode_slots=1)
    jeng = _jengine(jnet, **kw)
    try:
        refs = [jeng.generate(p, max_tokens=8)[0] for p in prompts]
        jsnap = jeng.metrics()["default"]["prefix"]
    finally:
        jeng.stop()
    eng = _engine(pnet, **kw)
    try:
        got = [eng.generate(p, max_tokens=8)[0] for p in prompts]
        snap = eng.metrics()["default"]["prefix"]
    finally:
        eng.stop()
    assert got == refs
    assert snap["evictions"] == jsnap["evictions"] >= 3
    for key in ("hits", "misses", "cached_blocks", "cached_lru_blocks",
                "cow_copies"):
        assert snap[key] == jsnap[key], key


def test_opt_out(nets):
    jnet, pnet = nets
    p = _prompt(7, 16)
    want = jnaive(jnet, p, 6, pad_to=CAP)
    eng = _engine(pnet, prefix_cache=False)
    try:
        assert eng.models()["default"]["prefix_cache"] is False
        assert [eng.generate(p, max_tokens=6)[0] for _ in range(2)] == \
            [want, want]
        snap = eng.metrics()["default"]["prefix"]
    finally:
        eng.stop()
    assert snap["hits"] == snap["misses"] == 0


def test_no_sharing_across_a_hot_swap_cohort(nets):
    """After a same-architecture swap the new cohort starts with an empty
    prefix cache: the repeated prompt is a miss, and its tokens are the
    new weights'."""
    _, pnet = nets
    _, pnet_b = _pair(4)
    p = _prompt(8, 16)
    want_a = naive_generate(pnet, p, 8, pad_to=CAP, device="cpu")
    want_b = naive_generate(pnet_b, p, 8, pad_to=CAP, device="cpu")
    assert want_a != want_b
    eng = _engine(pnet)
    try:
        assert eng.generate(p, max_tokens=8)[0] == want_a
        assert eng.generate(p, max_tokens=8)[0] == want_a          # a hit
        traces = eng.trace_count
        assert eng.hot_swap("default", pnet_b) == 2
        assert eng.generate(p, max_tokens=8)[0] == want_b
        snap = eng.metrics()["default"]
        assert eng.trace_count == traces        # same shapes: no warm run
        assert len(eng.runtime().cohorts) == 1
    finally:
        eng.stop()
    assert snap["prefix"]["hits"] == 1 and snap["prefix"]["misses"] == 2
    assert snap["hot_swaps"] == 1


@pytest.mark.parametrize("kind", ["paged", "state"])
@pytest.mark.parametrize("prefix_cache", [None, True, False])
def test_prefix_cache_default_is_the_references(nets, kind, prefix_cache):
    """``prefix_cache=None`` is on for the paged adapter and off for the
    state adapter, as in the JAX package; True cannot turn it on where
    there are no blocks."""
    jnet, pnet = nets
    if kind == "state":
        jnet = jtext_generation_lstm(vocab_size=64, hidden=16,
                                     max_length=64, seed=5).init()
        pnet = text_generation_lstm(vocab_size=64, hidden=16,
                                    max_length=64, device="cpu").init()
    kw = dict(ENG, prefix_cache=prefix_cache)
    ours = GenerationProgramSet(pnet, config=GenerationConfig(**kw))
    ref = JProgramSet(jnet, config=JConfig(**kw))
    assert ours.adapter == ref.adapter
    assert ours.prefix_enabled == ref.prefix_enabled
    assert ours.prefix_enabled == (kind == "paged"
                                   and prefix_cache is not False)
