"""The decode step's CUDA graph (``serving/generation/graphs.py``): on the
CPU a cohort runs the eager step and the graph refuses to be made; the
runtime counts graphs, replays and the kernel launches they hold; a
capture that fails surfaces from the engine with no eager retry. The
``cuda`` tests (a replay equals the eager step on the same inputs, also
head-sharded over a model axis of 2, K5's launches are counted through
replays, a kernel that fails inside the capture raises) need a card and
skip without one."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo_extra import (text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.ops import lstm
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.serving.generation import (GenerationConfig,
                                                         GenerationEngine,
                                                         graphs, scheduler)
from deeplearning4j_tpu_torch.serving.generation.programs import \
    GenerationProgramSet

ENG = dict(block_len=8, max_seq_len=64, decode_slots=4,
           prefill_batches=(1, 2), prompt_rungs=(32, 64))
LM = dict(vocab_size=64, d_model=64, n_heads=4, n_blocks=2, max_length=64,
          token_input=True)
CHAR = dict(vocab_size=31, hidden=64, max_length=64)


def test_a_cpu_cohort_runs_the_eager_step():
    net = transformer_lm(**LM, device="cpu").init()
    eng = GenerationEngine(net, device="cpu", **ENG)
    try:
        rt = eng.runtime()
        assert [c.graph for c in rt.cohorts] == [None]
        toks, _ = eng.generate([1, 2, 3], max_tokens=5)
        assert len(toks) == 5
        assert rt.wait_idle(10)
        assert rt.graph_stats() == {"captures": 0, "replays": 0,
                                    "kernel_runs": {}}
        assert eng.metrics()["default"]["decode_steps"] == 4
    finally:
        eng.stop()


def test_the_graph_refuses_a_cpu_or_unwarmed_program_set():
    net = transformer_lm(**LM, device="cpu").init()
    ps = GenerationProgramSet(net, config=GenerationConfig(**ENG))
    gen = ps.fresh_generator()
    with pytest.raises(ValueError, match="CUDA"):
        graphs.DecodeGraph(ps, ps.make_cache(), gen)
    ps.device = torch.device("cuda", 0)       # the check comes before use
    with pytest.raises(RuntimeError, match="warm"):
        graphs.DecodeGraph(ps, None, gen)


def test_the_counted_wrappers_are_the_kernels():
    assert graphs._COUNTED == {"lstm_fwd": lstm.fused_lstm_fwd}
    assert isinstance(lstm.fused_lstm_fwd.launches, int)


def test_a_failed_first_cohort_fails_the_engine(monkeypatch):
    """The first cohort (its graph, on the card) is made before the engine
    returns; when that fails the engine raises it, and nothing serves."""
    class Boom(scheduler._Cohort):
        def __init__(self, *a, **k):
            raise RuntimeError("capturing the decode step failed: boom")

    monkeypatch.setattr(scheduler, "_Cohort", Boom)
    net = transformer_lm(**LM, device="cpu").init()
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        GenerationEngine(net, device="cpu", **ENG)


def test_a_swapped_in_cohort_that_fails_fails_its_requests(monkeypatch):
    """A hot swap's cohort is made on the dispatch thread at its next turn;
    if that fails, the requests waiting for it fail with the reason (no
    eager retry) and the old cohort's work is unaffected."""
    net = transformer_lm(**LM, device="cpu").init()
    eng = GenerationEngine(net, device="cpu", **ENG)
    try:
        want = eng.generate([4, 5, 6], max_tokens=4)[0]

        class Boom(scheduler._Cohort):
            def __init__(self, *a, **k):
                raise RuntimeError("capturing the decode step failed: boom")

        monkeypatch.setattr(scheduler, "_Cohort", Boom)
        eng.hot_swap("default", transformer_lm(**LM, device="cpu").init(
            seed=9))
        with pytest.raises(RuntimeError, match="boom"):
            eng.generate([4, 5, 6], max_tokens=4)
        assert eng.metrics()["default"]["rejected"]["error"] >= 1
        monkeypatch.undo()
        assert len(eng.generate([4, 5, 6], max_tokens=4)[0]) == 4
    finally:
        eng.stop()
    assert len(want) == 4


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _clone(cache):
    if isinstance(cache, list):                       # recurrent states
        return [None if c is None else (c[0].clone(), c[1].clone())
                for c in cache]
    return tuple(p.clone() for p in cache)


def _same_cache(a, b, S):
    if isinstance(a, list):
        for x, y in zip(a, b):
            if x is not None:
                assert torch.equal(x[0][:S], y[0][:S])
                assert torch.equal(x[1][:S], y[1][:S])
        return
    for x, y in zip(a, b):
        assert torch.equal(x[:, 1:], y[:, 1:])        # block 0 is trash


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["transformer", "char_rnn"])
def test_a_replay_equals_the_eager_step(card, model):
    """After a prefill, the same decode inputs (two slots live, two idle)
    through the eager step and through the graph: the same tokens and the
    same cache, step after step."""
    if model == "transformer":
        net = transformer_lm(**LM, device=card).init(seed=3)
        V = LM["vocab_size"]
    else:
        net = text_generation_lstm(**CHAR, device=card).init(seed=3)
        V = CHAR["vocab_size"]
    ps = GenerationProgramSet(net, config=GenerationConfig(**ENG)).warm()
    c = ps.config
    S, mb = c.decode_slots, c.blocks_per_seq
    r = np.random.default_rng(0)
    cache, gen = ps.make_cache(), ps.fresh_generator()
    tables = np.zeros((S, mb), np.int64)
    tables[0, :4], tables[1, :4] = [1, 2, 3, 4], [5, 6, 7, 8]
    prompt = r.integers(1, V, size=(2, 32))
    first = ps.run_prefill(cache, prompt, np.array([20, 27]), tables[:2],
                           np.array([0, 1]), gen, np.zeros(2, np.float32),
                           np.zeros(2, np.int64))
    other = _clone(cache)
    graph = graphs.DecodeGraph(ps, other, ps.fresh_generator())
    tokens = np.zeros(S, np.int64)
    tokens[:2] = first
    pos = np.array([20, 27, 0, 0])
    active = np.array([True, True, False, False])
    temp, topk = np.zeros(S, np.float32), np.zeros(S, np.int64)
    for _ in range(6):
        want = ps.run_decode(cache, tokens, pos, tables, active, gen, temp,
                             topk)
        got = graph.run(tokens, pos, tables, active, temp, topk)
        assert got.tolist() == want.tolist()
        _same_cache(cache, other, 2)
        tokens[:2], pos[:2] = want[:2], pos[:2] + 1
    assert graph.replays == 6


@pytest.mark.cuda
def test_a_head_sharded_replay_equals_the_eager_step(card):
    """The decode step over head-sharded pools ([2, layers, blocks, blk,
    H/2, Dh], a (1, 2) mesh) captured and replayed: the eager step's
    tokens and pools, step after step."""
    net = transformer_lm(**LM, device=card).init(seed=3)
    ps = GenerationProgramSet(net, config=GenerationConfig(**ENG),
                              mesh=make_mesh((1, 2), ("data", "model"),
                                             card)).warm()
    assert ps.model_shards == 2
    c = ps.config
    S, mb = c.decode_slots, c.blocks_per_seq
    cache, gen = ps.make_cache(), ps.fresh_generator()
    assert cache[0].shape[0] == 2 and cache[0].shape[4] == LM["n_heads"] // 2
    tables = np.zeros((S, mb), np.int64)
    tables[0, :4], tables[1, :4] = [1, 2, 3, 4], [5, 6, 7, 8]
    prompt = np.random.default_rng(0).integers(1, LM["vocab_size"],
                                               size=(2, 32))
    first = ps.run_prefill(cache, prompt, np.array([20, 27]), tables[:2],
                           np.array([0, 1]), gen, np.zeros(2, np.float32),
                           np.zeros(2, np.int64))
    other = _clone(cache)
    graph = graphs.DecodeGraph(ps, other, ps.fresh_generator())
    tokens = np.zeros(S, np.int64)
    tokens[:2] = first
    pos = np.array([20, 27, 0, 0])
    active = np.array([True, True, False, False])
    temp, topk = np.zeros(S, np.float32), np.zeros(S, np.int64)
    for _ in range(4):
        want = ps.run_decode(cache, tokens, pos, tables, active, gen, temp,
                             topk)
        got = graph.run(tokens, pos, tables, active, temp, topk)
        assert got.tolist() == want.tolist()
        for x, y in zip(cache, other):                # block 0 is trash
            assert torch.equal(x[:, :, 1:], y[:, :, 1:])
        tokens[:2], pos[:2] = want[:2], pos[:2] + 1
    assert graph.replays == 4


@pytest.mark.cuda
def test_k5_launches_are_counted_through_replays(card, monkeypatch):
    monkeypatch.setattr(lstm.fused_lstm_fwd, "launches", 0)
    net = text_generation_lstm(**CHAR, device=card).init(seed=4)
    n_layers = sum(hasattr(l, "apply_with_final_state") for l in net.layers)
    eng = GenerationEngine(net, **ENG)
    try:
        rt = eng.runtime()
        assert rt.cohorts[0].graph.launches == {"lstm_fwd": n_layers}
        before = lstm.fused_lstm_fwd.launches
        toks, _ = eng.generate([1, 2, 3, 4], max_tokens=6)
        assert rt.wait_idle(10)
        snap = eng.metrics()["default"]
        stats = rt.graph_stats()
    finally:
        eng.stop()
    assert len(toks) == 6
    assert lstm.fused_lstm_fwd.launches - before == \
        n_layers * snap["prefills"]
    assert stats["replays"] == snap["decode_steps"] == 5
    assert stats["kernel_runs"] == {"lstm_fwd": n_layers * 5}


@pytest.mark.cuda
def test_a_kernel_that_fails_inside_the_capture_raises(card, monkeypatch):
    """K5's C entry refusing its grid (CUDA error 720) while the decode
    step is captured: the engine raises with that reason and never serves
    the step eagerly."""
    monkeypatch.setattr(lstm.fused_lstm_fwd, "launches", 0)
    real = lstm._fwd_launch

    def refuse(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("dl4j_lstm_fwd launch failed with CUDA error "
                               "720 (the plan's clusters cannot all be "
                               "resident at once)")
        return real(*a, **k)

    monkeypatch.setattr(lstm, "_fwd_launch", refuse)
    net = text_generation_lstm(**CHAR, device=card).init(seed=5)
    with pytest.raises(RuntimeError, match="capturing the decode step "
                                           "failed: .*720"):
        GenerationEngine(net, **ENG)
