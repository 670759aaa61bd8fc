"""The port's speculative decoding against the JAX package's: the
acceptance rule, ``window_attention`` and the verify window's logits,
``truncated_draft``, and the engine's greedy streams with a truncated
transformer draft and with an LSTM draft (weights carried across with
``load_jax_params``, the draft's too), a stop token or the length landing
mid-window, sampling and ``spec_k=0`` on the plain path, and the hot-swap
cohort pinning. f32 on the CPU; tokens token for token, with the JAX
forward's top-1/top-2 margin at every compared step above 1e-4."""
import _torch_threads  # noqa: F401
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.decode import (
    TransformerDecodeSpec as JSpec, naive_generate as jnaive,
    truncated_draft as jtruncated_draft, window_attention as
    jwindow_attention)
from deeplearning4j_tpu.models.zoo_extra import (
    text_generation_lstm as jtext_generation_lstm,
    transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.serving.generation import GenerationEngine as JEngine
from deeplearning4j_tpu.serving.generation import kvcache as jkv
from deeplearning4j_tpu.serving.generation.speculative import \
    accept_greedy as jaccept_greedy
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate,
                                                    truncated_draft,
                                                    window_attention)
from deeplearning4j_tpu_torch.models.zoo_extra import (text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.serving.generation import (GenerationEngine,
                                                         accept_greedy)
from deeplearning4j_tpu_torch.serving.generation import kvcache as tkv
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_blocks=2, max_length=64,
           token_input=True)
ENG = dict(block_len=8, max_seq_len=64, decode_slots=4,
           prefill_batches=(1, 2), prompt_rungs=(32, 64))
LSTM = dict(vocab_size=64, hidden=16, max_length=64)
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


@pytest.fixture(scope="module")
def lstm_drafts():
    jd = jtext_generation_lstm(**LSTM, seed=5).init()
    pd = text_generation_lstm(**LSTM, device="cpu").init()
    load_jax_params(pd, _np(jd.params))
    return jd, pd


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 64, size=n).tolist()


def _jax_margins(jnet, prompt, generated):
    seq = list(prompt) + list(generated)
    buf = np.zeros((1, CAP), np.int32)
    buf[0, :len(seq)] = seq
    logp = np.log(np.asarray(jnet.output(buf))[0])
    rows = logp[len(prompt) - 1:len(seq) - 1]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


PROMPTS = [_prompt(11, 5), _prompt(12, 16), _prompt(13, 23)]


@pytest.fixture(scope="module")
def plain_refs(nets):
    """The JAX engine's plain greedy streams (= its naive decode) of
    PROMPTS, 14 tokens each."""
    jnet, _ = nets
    refs = [jnaive(jnet, p, 14, pad_to=CAP) for p in PROMPTS]
    for p, ref in zip(PROMPTS, refs):
        assert np.all(_jax_margins(jnet, p, ref) > 1e-4)
    return refs


# ------------------------------------------------------------ rule + attention
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_greedy_matches_the_reference(seed):
    r = np.random.default_rng(seed)
    S, k = 6, 4
    targets = r.integers(0, 5, size=(S, k + 1))
    props = targets[:, :k].copy()
    # slot s disagrees first at position s (none for s >= k)
    for s in range(min(S, k)):
        props[s, s] = (props[s, s] + 1) % 5
    counts, emitted = accept_greedy(props, targets)
    jcounts, jemitted = jaccept_greedy(props, targets)
    assert counts.tolist() == jcounts.tolist() == [0, 1, 2, 3, 4, 4]
    assert [[int(t) for t in e] for e in emitted] == \
        [[int(t) for t in e] for e in jemitted]


@pytest.mark.parametrize("B, H, W, L, D", [(2, 3, 5, 24, 16), (1, 1, 1, 8, 4),
                                           (3, 2, 4, 40, 32)])
def test_window_attention_matches_jax(B, H, W, L, D):
    r = np.random.default_rng(B + W + L)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((B, H, W, D), (B, H, L, D), (B, H, L, D)))
    pos = r.integers(0, L - W + 1, size=B)
    mask = (np.arange(L)[None, None, :]
            <= (pos[:, None] + np.arange(W)[None, :])[:, :, None])
    got = window_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(mask))
    want = jwindow_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_verify_window_logits_and_pools_match_jax(nets):
    """One verify window (W 4 at mixed positions, one slot idle, one window
    running past the cache's capacity) through ``PagedWindowStore`` over
    pools that hold a prefill: logits at 1e-4, every pool block at 1e-5."""
    jnet, pnet = nets
    S, W, blk, mb = 3, 4, 8, 8
    r = np.random.default_rng(9)
    jspec, spec = JSpec(jnet), TransformerDecodeSpec(pnet)
    shape = (2, 25, blk, 4, 16)
    kp = r.normal(size=shape).astype(np.float32)
    vp = r.normal(size=shape).astype(np.float32)
    tables = np.stack([np.arange(1, 9), np.arange(9, 17),
                       np.arange(17, 25)]).astype(np.int32)
    pos = np.array([5, 20, 62], np.int32)
    active = np.array([True, False, True])
    feeds = r.integers(1, 64, size=(S, W)).astype(np.int32)
    jstore = jkv.PagedWindowStore(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(tables), jnp.asarray(pos),
                                  jnp.asarray(active), blk, W)
    jlogits = jspec.decode_window(jnet.params, jnet.state, jnp.asarray(feeds),
                                  jnp.asarray(pos), jstore)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    store = tkv.PagedWindowStore(tk, tv, torch.from_numpy(tables).long(),
                                 torch.from_numpy(pos).long(),
                                 torch.from_numpy(active), blk, W)
    logits = spec.decode_window(torch.from_numpy(feeds).long(),
                                torch.from_numpy(pos).long(), store)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    jk, jv = jstore.pools
    # block 0 is trash (several writes land there, in no fixed order)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               atol=1e-5)


def test_truncated_draft_copies_the_targets_weights(nets):
    jnet, pnet = nets
    draft = truncated_draft(pnet, 1)
    jdraft = jtruncated_draft(jnet, 1)
    assert draft.vertex_names == list(jdraft.vertex_names)
    assert "b1_attn" not in draft.vertex_names
    src, dst = pnet.param_dicts(), draft.param_dicts()
    for (name, params), jp in zip(dst.items(), jdraft.params):
        for pname, p in params.items():
            assert torch.equal(p, src[name][pname])
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(jp[pname]))
            assert p.data_ptr() != src[name][pname].data_ptr()
    with torch.no_grad():
        dst["embed"]["W"].add_(1.0)          # the draft shares no tensor
    assert not torch.equal(dst["embed"]["W"], src["embed"]["W"])
    with pytest.raises(ValueError, match="n_blocks"):
        truncated_draft(pnet, 3)
    assert draft.device == pnet.device


# ------------------------------------------------------------ engine streams
def _spec_streams(eng, n_new=14):
    return [eng.generate(p, max_tokens=n_new)[0] for p in PROMPTS]


def _settled_spec(eng):
    """The engine's speculative counters once its dispatch thread has
    recorded the last window. Both schedulers emit a window's tokens (which
    can complete a request) before they record the window, so a read right
    after the last result may miss it; the counters are read until two
    reads 50 ms apart agree."""
    prev = None
    for _ in range(40):
        cur = eng.metrics()["default"]["speculative"]
        if cur == prev:
            break
        prev = cur
        time.sleep(0.05)
    return cur


def test_spec_streams_equal_the_jax_engine_with_a_transformer_draft(
        nets, plain_refs):
    jnet, pnet = nets
    jeng = JEngine(jnet, model_name="default", draft=jtruncated_draft(jnet, 1),
                   spec_k=3, **ENG)
    try:
        jgot = _spec_streams(jeng)
        jsp = _settled_spec(jeng)
    finally:
        jeng.stop()
    eng = GenerationEngine(pnet, device="cpu", draft=truncated_draft(pnet, 1),
                           spec_k=3, **ENG)
    try:
        assert eng.models()["default"]["speculative"] == {
            "enabled": True, "k": 3, "draft_adapter": "dense"}
        got = _spec_streams(eng)
        sp = _settled_spec(eng)
    finally:
        eng.stop()
    assert jgot == plain_refs and got == plain_refs
    for key in ("verify_steps", "proposed", "accepted", "emitted"):
        assert sp[key] == jsp[key], key
    assert sp["verify_steps"] > 0 and sp["accepted"] > 0


def test_spec_streams_equal_the_jax_engine_with_an_lstm_draft(
        nets, lstm_drafts, plain_refs):
    jnet, pnet = nets
    jd, pd = lstm_drafts
    jeng = JEngine(jnet, model_name="default", draft=jd, spec_k=3, **ENG)
    try:
        jgot = _spec_streams(jeng)
        jsp = _settled_spec(jeng)
    finally:
        jeng.stop()
    eng = GenerationEngine(pnet, device="cpu", draft=pd, spec_k=3, **ENG)
    try:
        assert eng.models()["default"]["speculative"]["draft_adapter"] == \
            "state"
        got = _spec_streams(eng)
        sp = _settled_spec(eng)
    finally:
        eng.stop()
    assert jgot == plain_refs and got == plain_refs
    for key in ("verify_steps", "proposed", "accepted", "emitted"):
        assert sp[key] == jsp[key], key


def test_stop_token_and_length_mid_window(nets):
    """A self-draft accepts every proposal, so windows are full: a stop
    token (or the max_tokens budget) lands mid-window and truncates where
    plain greedy decode stops."""
    _, pnet = nets
    p = PROMPTS[2]
    greedy = naive_generate(pnet, p, 14, pad_to=CAP, device="cpu")
    # the first token past the first window not seen before it
    j = next(j for j in range(5, 14) if greedy[j] not in greedy[:j])
    stop = greedy[j]
    eng = GenerationEngine(pnet, device="cpu", draft=pnet, spec_k=3, **ENG)
    try:
        toks, reason = eng.generate(p, max_tokens=14, stop=[stop])
        assert (toks, reason) == (greedy[:j], "stop")
        assert eng.generate(p, max_tokens=7) == (greedy[:7], "length")
        sp = _settled_spec(eng)
    finally:
        eng.stop()
    assert sp["accepted"] == sp["proposed"] > 0


def test_sampling_and_spec_k0_ride_the_plain_path(nets):
    jnet, pnet = nets
    p = [5, 7, 11]
    want = naive_generate(pnet, p, 6, pad_to=CAP, device="cpu")
    eng = GenerationEngine(pnet, device="cpu", draft=truncated_draft(pnet, 1),
                           spec_k=3, **ENG)
    try:
        assert eng.generate(p, max_tokens=6, speculative=False)[0] == want
        toks, reason = eng.generate(p, max_tokens=8, temperature=1.0,
                                    top_k=5)
        snap = eng.metrics()["default"]
    finally:
        eng.stop()
    assert reason == "length" and len(toks) == 8
    assert all(0 <= t < 64 for t in toks)
    assert snap["speculative"]["verify_steps"] == 0
    assert snap["decode_steps"] > 0
    # spec_k=0: no draft means plain decode; a draft with spec_k 0 takes 4,
    # as the reference's does
    for draft, enabled, k in ((None, False, 0), ("draft", True, 4)):
        d = truncated_draft(pnet, 1) if draft else None
        jd = jtruncated_draft(jnet, 1) if draft else None
        eng = GenerationEngine(pnet, device="cpu", draft=d, spec_k=0, **ENG)
        jeng = JEngine(jnet, model_name="default", draft=jd, spec_k=0,
                       warm=False, **ENG)
        try:
            row = eng.models()["default"]["speculative"]
            assert row == jeng.models()["default"]["speculative"]
            assert (row["enabled"], row["k"]) == (enabled, k)
            if not enabled:
                assert eng.generate(p, max_tokens=6)[0] == want
                assert eng.metrics()["default"]["speculative"][
                    "verify_steps"] == 0
        finally:
            eng.stop()
            jeng.stop()


def test_hot_swap_pins_in_flight_requests_to_the_old_cohort(nets):
    """In-flight speculative generations finish on the OLD weights and the
    OLD draft; admissions after the swap run the new weights (the draft
    carries over). A same-architecture swap runs no warm-up."""
    _, pnet_a = nets
    _, pnet_b = _pair(4)
    prompt = _prompt(21, 6)
    want_a = naive_generate(pnet_a, prompt, 50, pad_to=CAP, device="cpu")
    want_b = naive_generate(pnet_b, prompt, 50, pad_to=CAP, device="cpu")
    assert want_a != want_b
    eng = GenerationEngine(pnet_a, device="cpu",
                           draft=truncated_draft(pnet_a, 1), spec_k=3, **ENG)
    try:
        traces = eng.trace_count
        st_a = eng.generate(prompt, max_tokens=50, stream=True)
        deadline = time.monotonic() + 10.0
        while st_a.emitted < 1:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert eng.hot_swap("default", pnet_b) == 2
        in_flight = not st_a.done
        st_b = eng.generate(prompt, max_tokens=50, stream=True)
        assert st_a.result() == (want_a, "length")
        assert st_b.result() == (want_b, "length")
        assert eng.trace_count == traces
        assert eng.runtime().wait_idle(10)
        assert len(eng.runtime().cohorts) == 1
        assert eng.runtime().cohorts_made == 2
    finally:
        eng.stop()
    assert in_flight, "the first request finished before the swap"
