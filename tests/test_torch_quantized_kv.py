"""The port's int8 KV tier against the JAX package's: ``kv_quantize`` bit
for bit (exact .5 codes and all-zero rows included) and ``kv_dequantize``,
the quantize-on-write / dequantize-in-attention stores, ``pool_bytes`` and
``kv_bytes_per_token``, the int8 engine's greedy stream against the JAX
int8 engine's (weights carried across with ``load_jax_params``), a prefix
hit against a miss and speculation against plain decode under int8 (and
all three together against the JAX engine), and the configuration's
messages. f32 on the CPU."""
import _torch_threads  # noqa: F401
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.decode import truncated_draft as jtruncated
from deeplearning4j_tpu.models.zoo_extra import (
    text_generation_lstm as jtext_generation_lstm,
    transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.serving.generation import GenerationEngine as JEngine
from deeplearning4j_tpu.serving.generation import kvcache as jkv
from deeplearning4j_tpu.serving.generation.programs import (
    GenerationConfig as JConfig, GenerationProgramSet as JProgramSet)
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.decode import truncated_draft
from deeplearning4j_tpu_torch.models.zoo_extra import (text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.serving.generation import (GenerationConfig,
                                                         GenerationEngine)
from deeplearning4j_tpu_torch.serving.generation import kvcache as tkv
from deeplearning4j_tpu_torch.serving.generation.programs import \
    GenerationProgramSet
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_blocks=2, max_length=64,
           token_input=True)
ENG = dict(block_len=8, max_seq_len=64, decode_slots=4,
           prefill_batches=(1, 2), prompt_rungs=(32, 64))
CPU = torch.device("cpu")


def _np(params):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in params]


@pytest.fixture(scope="module")
def nets():
    jnet = jtransformer_lm(**CFG, seed=3).init()
    pnet = transformer_lm(**CFG, device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 64, size=n).tolist()


def _half_codes():
    """Rows whose amax is 127 (scale exactly 1), so x / scale lands on
    k + 0.5: round half to even decides every code."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                    3.5, 4.5, -3.5, 0.0, -0.0, 63.5, 64.5], np.float32)
    return np.stack([row, -row])[:, None, :]             # [2, 1, 16]


def _cases():
    r = np.random.default_rng(0)
    return {
        "normal": r.normal(size=(3, 5, 4, 16)).astype(np.float32),
        "half_codes": _half_codes(),
        "zero_rows": np.concatenate(
            [np.zeros((2, 3, 8), np.float32),
             r.normal(size=(1, 3, 8)).astype(np.float32)]),
        "wide_range": (r.normal(size=(4, 2, 32)) * np.logspace(
            -30, 30, 32)).astype(np.float32),
        "one_hot_rows": np.eye(16, dtype=np.float32)[None] * 3.0,
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_kv_quantize_is_the_references_bits(case):
    x = _cases()[case]
    q, s = tkv.kv_quantize(torch.from_numpy(x))
    jq, js = jkv.kv_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    back = tkv.kv_dequantize(q, s, torch.float32)
    jback = jkv.kv_dequantize(jq, js, jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_half_codes_round_to_even():
    q, s = tkv.kv_quantize(torch.from_numpy(_half_codes()))
    assert s.flatten().tolist() == [1.0, 1.0]
    assert q[0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4, 4,
                                -4, 0, 0, 64, 64]
    assert tkv.kv_quantize(torch.zeros(2, 4))[1].tolist() == [1.0, 1.0]


def test_kv_quantize_bf16_matches_jax():
    x = np.random.default_rng(1).normal(size=(4, 3, 16)).astype(np.float32)
    q, s = tkv.kv_quantize(torch.from_numpy(x).to(torch.bfloat16))
    jq, js = jkv.kv_quantize(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantized", [False, True])
def test_stores_write_and_read_what_the_references_do(quantized):
    """A prefill scatter, one decode step's ``PagedStore`` and a verify
    window's ``PagedWindowStore`` over the same pools: the same pool
    contents (codes and scales bitwise) and the same gathered context."""
    r = np.random.default_rng(2)
    L_, nb, blk, H, Dh = 2, 9, 4, 2, 8
    tp = tkv.make_pools(L_, nb, blk, H, Dh, torch.float32, CPU,
                        quantized=quantized)
    jp = jkv.make_pools(L_, nb, blk, H, Dh, jnp.float32, quantized=quantized)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    kv = [r.normal(size=(2, 8, H, Dh)).astype(np.float32) for _ in range(L_)]
    tk = tkv.prefill_scatter(tp[0], [torch.from_numpy(a) for a in kv],
                             torch.from_numpy(tables))
    jk = jkv.prefill_scatter(jp[0], [jnp.asarray(a) for a in kv],
                             jnp.asarray(tables))
    assert tk is None            # in place
    leaves = (lambda p: tuple(p)) if quantized else (lambda p: (p,))

    def same_pools(t, j):
        for a, b in zip(leaves(t), leaves(j)):
            np.testing.assert_array_equal(a.numpy()[:, 1:],
                                          np.asarray(b)[:, 1:])

    same_pools(tp[0], jk)
    pos, active = np.array([8, 13], np.int32), np.array([True, True])
    tok = r.normal(size=(2, H, Dh)).astype(np.float32)
    ts = tkv.PagedStore(tp[0], tp[1], torch.from_numpy(tables),
                        torch.from_numpy(pos), torch.from_numpy(active), blk)
    js = jkv.PagedStore(jk, jp[1], jnp.asarray(tables), jnp.asarray(pos),
                        jnp.asarray(active), blk)
    for i in range(L_):
        K, V, m = ts.put_get(i, torch.from_numpy(tok), torch.from_numpy(tok))
        jK, jV, jm = js.put_get(i, jnp.asarray(tok), jnp.asarray(tok))
        np.testing.assert_array_equal(K.numpy(), np.asarray(jK))
        np.testing.assert_array_equal(V.numpy(), np.asarray(jV))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    same_pools(tp[0], js.pools[0])
    win = r.normal(size=(2, 3, H, Dh)).astype(np.float32)
    tw = tkv.PagedWindowStore(tp[0], tp[1], torch.from_numpy(tables),
                              torch.from_numpy(pos + 1),
                              torch.from_numpy(active), blk, 3)
    jw = jkv.PagedWindowStore(js.pools[0], js.pools[1], jnp.asarray(tables),
                              jnp.asarray(pos + 1), jnp.asarray(active),
                              blk, 3)
    K, V, m = tw.put_get(0, torch.from_numpy(win), torch.from_numpy(win))
    jK, jV, jm = jw.put_get(0, jnp.asarray(win), jnp.asarray(win))
    np.testing.assert_array_equal(K.numpy()[0], np.asarray(jK)[0])
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    same_pools(tp[0], jw.pools[0])


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_bytes_and_kv_bytes_per_token_equal_the_references(
        kv_cache_dtype, dtype):
    cfg = dict(CFG, dtype=dtype)
    jnet = jtransformer_lm(**cfg, seed=3).init()
    pnet = transformer_lm(**cfg, device="cpu").init()
    kw = dict(ENG, kv_cache_dtype=kv_cache_dtype)
    ours = GenerationProgramSet(pnet, config=GenerationConfig(**kw))
    ref = JProgramSet(jnet, config=JConfig(**kw))
    assert ours.kv_bytes_per_token() == ref.kv_bytes_per_token()
    cache, jcache = ours.make_cache(), ref.make_cache()
    assert [tkv.pool_bytes(p) for p in cache] == \
        [jkv.pool_bytes(p) for p in jcache]
    assert ours.kv_pool_bytes_per_chip(cache) == \
        ref.kv_pool_bytes_per_chip(jcache)


def test_int8_engine_stream_equals_the_jax_int8_engine(nets):
    jnet, pnet = nets
    prompts = [_prompt(31, 5), _prompt(32, 19), _prompt(33, 40)]
    jeng = JEngine(jnet, model_name="default", kv_cache_dtype="int8", **ENG)
    try:
        want = [jeng.generate(p, max_tokens=12)[0] for p in prompts]
    finally:
        jeng.stop()
    eng = GenerationEngine(pnet, device="cpu", kv_cache_dtype="int8", **ENG)
    try:
        row = eng.models()["default"]
        got = [eng.generate(p, max_tokens=12)[0] for p in prompts]
    finally:
        eng.stop()
    assert got == want
    assert row["kv_cache_dtype"] == "int8"
    assert row["kv_bytes_per_token"] == 2 * 2 * 4 * (16 + 4)


def test_int8_hit_equals_miss_and_spec_equals_plain(nets):
    """Under int8: a block-aligned hit (COW + a one-token replay) and a
    hit with a suffix give the miss's tokens, and speculation with a
    truncated draft gives plain decode's — the port's own engines and the
    JAX engine with the prefix cache and speculation on together."""
    jnet, pnet = nets
    base = _prompt(41, 16)
    prompts = [base, base + _prompt(42, 5), _prompt(43, 9)]
    eng = GenerationEngine(pnet, device="cpu", kv_cache_dtype="int8", **ENG)
    try:
        plain = [eng.generate(p, max_tokens=12)[0] for p in prompts]
        hits = [eng.generate(p, max_tokens=12)[0] for p in prompts]
        pre = eng.metrics()["default"]["prefix"]
    finally:
        eng.stop()
    assert hits == plain
    assert pre["hits"] == 4 and pre["cow_copies"] == 1
    eng = GenerationEngine(pnet, device="cpu", kv_cache_dtype="int8",
                           draft=truncated_draft(pnet, 1), spec_k=3, **ENG)
    try:
        spec = [eng.generate(p, max_tokens=12)[0] for p in prompts]
        spec_hits = [eng.generate(p, max_tokens=12)[0] for p in prompts]
        snap = eng.metrics()["default"]
    finally:
        eng.stop()
    assert spec == plain and spec_hits == plain
    assert snap["speculative"]["verify_steps"] > 0
    assert snap["prefix"]["hits"] == 4
    jeng = JEngine(jnet, model_name="default", kv_cache_dtype="int8",
                   draft=jtruncated(jnet, 1), spec_k=3, **ENG)
    try:
        jgot = [jeng.generate(p, max_tokens=12)[0] for p in prompts]
        jhits = [jeng.generate(p, max_tokens=12)[0] for p in prompts]
        jsnap = jeng.metrics()["default"]
    finally:
        jeng.stop()
    assert jgot == plain and jhits == plain
    for key in ("verify_steps", "proposed", "accepted", "emitted"):
        assert snap["speculative"][key] == jsnap["speculative"][key], key


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("bad", [dict(kv_cache_dtype="fp8"),
                                 dict(kv_cache_dtype="float16"),
                                 dict(spec_k=-1), dict(prefix_max_replay=0),
                                 dict(block_len=0), dict(num_blocks=1),
                                 dict(prefill_batches=(0,))])
def test_config_messages_are_the_references(bad):
    kw = dict(ENG, **bad)
    ours = _message(lambda: GenerationConfig(**kw))
    assert ours is not None and ours == _message(lambda: JConfig(**kw))


def test_program_set_refusals_are_the_references(nets):
    jnet, pnet = nets
    jl = jtext_generation_lstm(vocab_size=64, hidden=12, max_length=64,
                               seed=5).init()
    pl = text_generation_lstm(vocab_size=64, hidden=12, max_length=64,
                              device="cpu").init()
    jbad = jtext_generation_lstm(vocab_size=29, hidden=12, max_length=64,
                                 seed=5).init()
    pbad = text_generation_lstm(vocab_size=29, hidden=12, max_length=64,
                                device="cpu").init()
    for ours, ref in (
            # int8 needs a block pool; a state target cannot speculate;
            # a draft must share the target's vocabulary
            (lambda: GenerationProgramSet(pl, config=GenerationConfig(
                **ENG, kv_cache_dtype="int8")),
             lambda: JProgramSet(jl, config=JConfig(
                 **ENG, kv_cache_dtype="int8"))),
            (lambda: GenerationProgramSet(pl, config=GenerationConfig(**ENG),
                                          draft_net=pnet),
             lambda: JProgramSet(jl, config=JConfig(**ENG), draft_net=jnet)),
            (lambda: GenerationProgramSet(pnet, config=GenerationConfig(
                **ENG), draft_net=pbad),
             lambda: JProgramSet(jnet, config=JConfig(**ENG),
                                 draft_net=jbad))):
        got = _message(ours)
        assert got is not None and got == _message(ref)


@pytest.mark.parametrize("ask, item", [("mesh", "A7b"), ("path", "A2b"),
                                       ("reload", "A2b"),
                                       ("head_sharding", "A7b")])
def test_what_is_left_raises_naming_its_item(nets, ask, item):
    jnet, pnet = nets
    if ask == "mesh":
        # A7b-2 is ported: a (data, model) mesh serves the heads sharded
        from deeplearning4j_tpu_torch.parallel import make_mesh
        eng = GenerationEngine(pnet, device="cpu", mesh=make_mesh(
            (1, 2), ("data", "model"), "cpu"), **ENG)
        try:
            assert eng.runtime().active_ps.model_shards == 2
        finally:
            eng.stop()
        return
    if ask == "head_sharding":
        # A7b-2 is ported: the reference's answer at every axis size
        from deeplearning4j_tpu.models.decode import \
            TransformerDecodeSpec as JSpec
        from deeplearning4j_tpu_torch.models.decode import \
            TransformerDecodeSpec
        for m in (1, 2, 3, 4):
            assert TransformerDecodeSpec(pnet).supports_head_sharding(m) \
                == JSpec(jnet).supports_head_sharding(m)
        return
    eng = GenerationEngine(pnet, device="cpu", **ENG)
    try:
        if ask in ("path", "reload"):
            # A2b is ported: a model zip or a checkpoint directory swaps in
            from deeplearning4j_tpu_torch.util.serialization import \
                write_model
            d = tempfile.mkdtemp()
            write_model(pnet, os.path.join(d, "checkpoint_epoch1.zip"))
            path = os.path.join(d, "checkpoint_epoch1.zip") \
                if ask == "path" else d
            swap = eng.hot_swap if ask == "path" else \
                eng.reload_from_checkpoint
            assert swap("default", path) == 2
    finally:
        eng.stop()


class _Storage:
    """A StatsStorage stand-in: keeps every ``put_update``."""

    def __init__(self):
        self.updates = []

    def put_update(self, session_id, worker_id, snap):
        self.updates.append((session_id, worker_id, snap))


def test_publish_metrics_pushes_the_snapshot_as_the_jax_engine(nets):
    """``publish_metrics`` (ported with the telemetry): one update a model
    under the reference's session and worker ids, holding the keys the
    JAX engine's snapshot holds (the port's ``decode_tokens_per_sec``
    besides)."""
    jnet, pnet = nets
    eng = GenerationEngine(pnet, device="cpu", **ENG)
    jeng = JEngine(jnet, **ENG)
    try:
        ours, ref = _Storage(), _Storage()
        assert eng.generate([1, 2, 3], max_tokens=2)[1] == "length"
        jeng.generate([1, 2, 3], max_tokens=2)
        eng.runtime().wait_idle(10)
        eng.publish_metrics(ours)
        jeng.publish_metrics(ref)
        assert [u[:2] for u in ours.updates] == [u[:2] for u in ref.updates]
        assert set(ours.updates[0][2]) - {"decode_tokens_per_sec"} \
            == set(ref.updates[0][2])
        assert ours.updates[0][2]["requests"] == 1
    finally:
        eng.stop()
        jeng.stop()
