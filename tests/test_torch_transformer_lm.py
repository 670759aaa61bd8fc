"""The slice end to end: the port's transformer_lm, its decode spec, paged
cache and GenerationEngine against the JAX package's, on weights carried
across with ``load_jax_params``.

The model, transformer_lm(vocab 64, d_model 128, 2 heads, 2 blocks,
max_length 256, token ids), has head dim 64, so at T=256 the JAX prefill
runs its Pallas flash kernel (interpret mode) and the port's probe admits
the same shapes (its plain version on the CPU). Logits at atol 1e-4;
greedy tokens token for token, with the JAX top-1/top-2 logit margin of
every compared step above 1e-3 so that no match rests on a tie."""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.decode import (
    TransformerDecodeSpec as JSpec, naive_generate as jnaive_generate)
from deeplearning4j_tpu.models.zoo_extra import transformer_lm as jtransformer_lm
from deeplearning4j_tpu.serving.generation import kvcache as jkv
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
from deeplearning4j_tpu_torch.serving.generation import kvcache as tkv
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


ATOL = 1e-4
CFG = dict(vocab_size=64, d_model=128, n_heads=2, n_blocks=2,
           max_length=256, token_input=True)
CAP, BLK = 256, 16
CPU = torch.device("cpu")


def _numpy_params(jnet):
    return [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]


@pytest.fixture(scope="module")
def nets():
    jnet = jtransformer_lm(**CFG, seed=7).init()
    pnet = transformer_lm(**CFG, device="cpu").init()
    assert pnet.vertex_names == list(jnet.vertex_names)
    load_jax_params(pnet, _numpy_params(jnet))
    return jnet, pnet


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        1, CFG["vocab_size"], size=shape).astype(np.int32)


def test_output_matches_jax(nets):
    jnet, pnet = nets
    x = _tokens(1, (2, CAP))
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)


def test_one_hot_input_graph_matches_jax():
    cfg = dict(CFG, token_input=False, max_length=16)
    jnet = jtransformer_lm(**cfg, seed=3).init()
    pnet = transformer_lm(**cfg, device="cpu").init()
    load_jax_params(pnet, _numpy_params(jnet))
    ids = _tokens(2, (2, 16))
    x = np.eye(cfg["vocab_size"], dtype=np.float32)[ids]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=ATOL)
    spec = TransformerDecodeSpec(pnet)
    logits, _, _ = spec.prefill_forward(torch.from_numpy(ids))
    jlogits, _, _ = JSpec(jnet).prefill_forward(jnet.params, jnet.state,
                                                jnp.asarray(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


def test_prefill_forward_logits_and_kv_match_jax(nets):
    jnet, pnet = nets
    tok = _tokens(4, (2, CAP))
    logits, ks, vs = TransformerDecodeSpec(pnet).prefill_forward(
        torch.from_numpy(tok))
    jlogits, jks, jvs = JSpec(jnet).prefill_forward(jnet.params, jnet.state,
                                                    jnp.asarray(tok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)
    for a, b in zip(ks + vs, list(jks) + list(jvs)):
        assert tuple(a.shape) == (2, CAP, 2, 64)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_paged_decode_logits_match_jax_for_8_steps(nets):
    """Prefill a 40-token prompt into both paged pools, then feed 8 greedy
    tokens through each package's decode_step over its PagedStore."""
    jnet, pnet = nets
    jspec, spec = JSpec(jnet), TransformerDecodeSpec(pnet)
    plen, nb = 40, CAP // BLK + 1
    buf = np.zeros((1, CAP), np.int32)
    buf[0, :plen] = _tokens(6, plen)
    tables = np.arange(1, nb, dtype=np.int32)[None, :]          # [1, 16]
    jk, jv = jkv.make_pools(CFG["n_blocks"], nb, BLK, 2, 64, jnp.float32)
    tk, tv = tkv.make_pools(CFG["n_blocks"], nb, BLK, 2, 64, torch.float32,
                            CPU)
    jlog, jks, jvs = jspec.prefill_forward(jnet.params, jnet.state,
                                           jnp.asarray(buf))
    jk = jkv.prefill_scatter(jk, jks, jnp.asarray(tables))
    jv = jkv.prefill_scatter(jv, jvs, jnp.asarray(tables))
    _, ks, vs = spec.prefill_forward(torch.from_numpy(buf))
    tkv.prefill_scatter(tk, ks, torch.from_numpy(tables))
    tkv.prefill_scatter(tv, vs, torch.from_numpy(tables))
    tok = int(np.argmax(np.asarray(jlog)[0, plen - 1]))
    for step in range(8):
        pos = np.array([plen + step], np.int32)
        store = jkv.PagedStore(jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                               jnp.asarray([True]), BLK)
        jlogits = np.asarray(jspec.decode_step(
            jnet.params, jnet.state, jnp.asarray([tok], jnp.int32),
            jnp.asarray(pos), store))
        jk, jv = store.pools
        tstore = tkv.PagedStore(tk, tv, torch.from_numpy(tables),
                                torch.from_numpy(pos), torch.tensor([True]),
                                BLK)
        logits = spec.decode_step(torch.tensor([tok]), torch.from_numpy(pos),
                                  tstore)
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=ATOL,
                                   err_msg=f"step {step}")
        tok = int(np.argmax(jlogits[0]))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def _jax_margins(jnet, prompt, generated):
    """Top-1 minus top-2 log-probability (= logit gap) at every step that
    chose a generated token, from one JAX forward over the final sequence
    (causal attention: position t does not see later tokens or padding)."""
    seq = list(prompt) + list(generated)
    buf = np.zeros((1, CAP), np.int32)
    buf[0, :len(seq)] = seq
    logp = np.log(np.asarray(jnet.output(buf))[0])
    rows = logp[len(prompt) - 1:len(seq) - 1]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_engine_greedy_tokens_equal_jax_naive_generate(nets):
    jnet, pnet = nets
    n_new = 8
    prompts = [_tokens(10 + i, n).tolist() for i, n in enumerate((5, 37, 90))]
    refs = [jnaive_generate(jnet, p, n_new, pad_to=CAP) for p in prompts]
    for p, ref in zip(prompts, refs):
        assert np.all(_jax_margins(jnet, p, ref) > 1e-3)
    eng = GenerationEngine(pnet, device="cpu", block_len=BLK,
                           max_seq_len=CAP, decode_slots=2,
                           prompt_rungs=(CAP,))
    try:
        # 3 concurrent requests over 2 slots: continuous batching
        streams = [eng.generate(p, max_tokens=n_new, stream=True)
                   for p in prompts]
        got = [s.result() for s in streams]
    finally:
        eng.stop()
    assert [g[0] for g in got] == refs
    assert all(g[1] == "length" for g in got)
    assert naive_generate(pnet, prompts[1], n_new, pad_to=CAP,
                          device="cpu") == refs[1]


def test_load_jax_params_checks_every_shape_and_name(nets):
    jnet, _ = nets
    fresh = lambda: transformer_lm(**CFG, device="cpu").init(seed=1)
    params = _numpy_params(jnet)
    bad = [dict(p) for p in params]
    bad[3]["Wq"] = bad[3]["Wq"][:, :64]
    pnet = fresh()
    wq = lambda: pnet.vertices[pnet.vertex_names[3]].param_dict()["Wq"]
    before = wq().clone()
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(pnet, bad)
    # nothing was copied before the mismatch was found
    assert torch.equal(wq(), before)
    missing = [dict(p) for p in params]
    del missing[0]["W"]
    with pytest.raises(ValueError, match="parameters"):
        load_jax_params(pnet, missing)
    with pytest.raises(ValueError, match="vertex names"):
        load_jax_params(pnet, params[::-1],
                        vertex_names=[n + "_x" for n in pnet.vertex_names])
    with pytest.raises(ValueError, match="dicts"):
        load_jax_params(pnet, params[:-1])
    with pytest.raises(RuntimeError, match="init"):
        load_jax_params(transformer_lm(**CFG, device="cpu"), params)


def test_entry_points_default_to_cuda(nets, monkeypatch):
    _, pnet = nets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm(**CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(pnet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        naive_generate(pnet, [1, 2], 1, pad_to=CAP)
