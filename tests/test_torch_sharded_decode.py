"""Head-sharded generation (``GenerationProgramSet(mesh=...)``,
``TransformerDecodeSpec``'s sharded path, ``GenerationEngine(mesh=...)``)
against the JAX package's sharded set, driven as
``tests/test_tensor_parallel.py:193-232`` drives it: the same tokens as
the JAX sharded set and as the port's unsharded set, the pools a rank
half, the ``"paged"`` and ``"n_heads"`` refusals with the reference's
words, and ``with_params_from`` keeping the mesh and its warmed programs
(no warm run). The engine's path (prefix hits, a sharded draft, the int8
pools, a hot swap) against ``naive_generate``."""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.zoo_extra import (
    text_generation_lstm as jtext_generation_lstm,
    transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.serving.generation.programs import (
    GenerationConfig as JConfig, GenerationProgramSet as JProgramSet)
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.decode import (naive_generate,
                                                    truncated_draft)
from deeplearning4j_tpu_torch.models.zoo_extra import (text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.serving.generation import (GenerationConfig,
                                                         GenerationEngine)
from deeplearning4j_tpu_torch.serving.generation.programs import \
    GenerationProgramSet

V = 29
CFG = dict(block_len=8, max_seq_len=16, decode_slots=2, prefill_batches=(1,))


def _lm(d_model=16, n_heads=4, n_blocks=1, max_length=16):
    return dict(vocab_size=V, d_model=d_model, n_heads=n_heads,
                n_blocks=n_blocks, max_length=max_length, token_input=True)


def _pair(seed=3, **kw):
    jnet = jtransformer_lm(**_lm(**kw), seed=seed).init()
    pnet = transformer_lm(**_lm(**kw), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def _mesh():
    return make_mesh((1, 2), ("data", "model"), "cpu")


@pytest.fixture(scope="module")
def sets():
    """The JAX sharded set's greedy tokens and the port's two sets."""
    jnet, pnet = _pair()
    jmesh = jmake_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    js = JProgramSet(jnet, config=JConfig(**CFG), mesh=jmesh).warm()
    warm = []
    rep = GenerationProgramSet(pnet, config=GenerationConfig(**CFG)).warm()
    sh = GenerationProgramSet(pnet, config=GenerationConfig(**CFG),
                              mesh=_mesh(),
                              trace_hook=lambda: warm.append(1)).warm()
    return {"jax_tokens": _jax_greedy(js), "jax_pool": js.kv_pool_chip_bytes,
            "pnet": pnet, "rep": rep, "sh": sh, "warm": warm}


def _jax_greedy(ps, n_decode=3):
    cache, key = ps.make_cache(), ps.fresh_key()
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :3] = [3, 5, 7]
    t, cache, key = ps.run_prefill(
        cache, prompt, np.array([3], np.int32),
        np.array([[1, 2]], np.int32), np.array([0], np.int32), key,
        np.zeros((1,), np.float32), np.zeros((1,), np.int32))
    out = [int(np.asarray(t)[0])]
    for i in range(n_decode):
        t, cache, key = ps.run_decode(
            cache, np.array([out[-1], 0], np.int32),
            np.array([3 + i, 0], np.int32),
            np.array([[1, 2], [0, 0]], np.int32),
            np.array([True, False]), key,
            np.zeros((2,), np.float32), np.zeros((2,), np.int32))
        out.append(int(np.asarray(t)[0]))
    return out


def _greedy(ps, n_decode=3):
    cache, gen = ps.make_cache(), ps.fresh_generator()
    prompt = np.zeros((1, 16), np.int64)
    prompt[0, :3] = [3, 5, 7]
    t = ps.run_prefill(cache, prompt, np.array([3]), np.array([[1, 2]]),
                       np.array([0]), gen, np.zeros(1, np.float32),
                       np.zeros(1, np.int64))
    out = [int(t[0])]
    for i in range(n_decode):
        t = ps.run_decode(cache, np.array([out[-1], 0]),
                          np.array([3 + i, 0]),
                          np.array([[1, 2], [0, 0]]), np.array([True, False]),
                          gen, np.zeros(2, np.float32), np.zeros(2, np.int64))
        out.append(int(t[0]))
    return out


def test_sharded_tokens_equal_the_jax_sharded_sets_and_pools_halve(sets):
    sh, rep = sets["sh"], sets["rep"]
    assert sh.model_shards == 2 and rep.model_shards == 1
    assert _greedy(sh) == _greedy(rep) == sets["jax_tokens"]
    assert sh.kv_pool_chip_bytes * 2 == rep.kv_pool_chip_bytes
    assert sh.kv_pool_chip_bytes == sets["jax_pool"]
    k_pool = sh.make_cache()[0]
    assert tuple(k_pool.shape) == (2, 1, sh.config.num_blocks, 8, 2, 4)
    # the caller's network is not laid out: the set serves a copy
    assert sh.served is not sets["pnet"]
    assert all(p.dim() == 2 or p.dim() == 1
               for p in sets["pnet"].param_dicts()["b0_attn"].values())


def test_with_params_from_keeps_the_mesh_and_adds_no_warm_run(sets):
    sh, warm = sets["sh"], sets["warm"]
    before = len(warm)
    swapped = sh.with_params_from(_pair(seed=9)[1])
    assert swapped.model_shards == 2 and swapped.mesh is sh.mesh
    assert swapped.kv_pool_chip_bytes == sh.kv_pool_chip_bytes
    assert swapped._warmed is sh._warmed and len(warm) == before
    assert len(_greedy(swapped, n_decode=1)) == 2
    assert len(warm) == before


@pytest.mark.parametrize("what", ["paged", "n_heads"])
def test_the_refusals_are_the_references(what):
    cfg = dict(block_len=8, max_seq_len=16, decode_slots=2)
    jmesh = jmake_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    if what == "paged":
        jnet = jtext_generation_lstm(vocab_size=20, hidden=16).init()
        pnet = text_generation_lstm(20, hidden=16, device="cpu").init()
    else:
        jnet, pnet = _pair(d_model=18, n_heads=3)
    msgs = []
    for make, net, mesh in ((GenerationProgramSet, pnet, _mesh()),
                            (JProgramSet, jnet, jmesh)):
        conf = (GenerationConfig if make is GenerationProgramSet
                else JConfig)(**cfg)
        with pytest.raises(ValueError, match=what) as e:
            make(net, config=conf, mesh=mesh)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_the_engine_serves_head_sharded_with_a_draft(kv):
    """Through the engine on a (1, 2) mesh: a prompt, its repeat (a prefix
    hit), a sharded truncated draft speculating, optionally the int8 pools;
    every stream the unsharded engine's, the greedy ones
    ``naive_generate``'s; a hot swap keeps the mesh."""
    net = transformer_lm(**_lm(n_blocks=2, max_length=64), seed=5,
                         device="cpu").init()
    eng_kw = dict(device="cpu", block_len=8, max_seq_len=64, decode_slots=4,
                  prefill_batches=(1, 2), prompt_rungs=(32, 64),
                  kv_cache_dtype=kv, spec_k=3)
    prompts = [[3, 4, 5, 6, 7, 8, 9, 10, 11, 12], [1, 2, 3]]
    streams = {}
    for what, mesh in (("unsharded", None), ("sharded", _mesh())):
        eng = GenerationEngine(net, mesh=mesh, draft=truncated_draft(net, 1),
                               **eng_kw)
        try:
            ps = eng.runtime().active_ps
            assert ps.model_shards == (2 if mesh else 1)
            assert ps.draft_spec.model_shards == ps.model_shards
            streams[what] = [eng.generate(p, max_tokens=8)[0]
                             for p in prompts + prompts[:1]]
            if mesh is not None:
                eng.hot_swap("default", net)
                assert eng.runtime().active_ps.model_shards == 2
                streams["swapped"] = eng.generate(prompts[0],
                                                  max_tokens=8)[0]
        finally:
            eng.stop()
    assert streams["sharded"] == streams["unsharded"]
    assert streams["swapped"] == streams["sharded"][0]
    if kv is None:
        assert streams["sharded"][0] == naive_generate(
            net, prompts[0], 8, pad_to=64, device="cpu")
