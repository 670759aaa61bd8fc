"""The char-RNN slice end to end: the port's ``text_generation_lstm``
MultiLayerNetwork against the JAX package's, on weights (and RmsProp
state) carried across with ``load_jax_params`` / ``load_jax_opt_state``.

The model is text_generation_lstm(vocab 31, hidden 128) at B 8, so the JAX
side takes its fused Pallas LSTM kernels in interpret mode and the port its
autograd Functions over the plain versions. Tolerances: output atol 1e-5,
loss rel 1e-5, gradients rel-to-max 1e-4, parameters after three tBPTT
iterations from a carried-over RmsProp state atol 1e-5; greedy tokens and
sampled ids are equal."""
import _torch_threads  # noqa: F401
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.decode import LSTMDecodeSpec as JSpec
from deeplearning4j_tpu.models.decode import (
    naive_generate_lstm as jnaive_generate_lstm)
from deeplearning4j_tpu.models.zoo_extra import (
    sample_text as jsample_text, text_generation_lstm as jtext_lstm)
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import (
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_opt_state,
                                                         load_jax_params)
from deeplearning4j_tpu_torch.models.decode import (LSTMDecodeSpec,
                                                    naive_generate_lstm)
from deeplearning4j_tpu_torch.models.zoo_extra import (sample_text,
                                                       text_generation_lstm)
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


V, HID, B, T = 31, 128, 8, 12
CFG = dict(vocab_size=V, hidden=HID, max_length=T)


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _np_state(opt_state):
    return [{k: {s: np.asarray(a, np.float32) for s, a in st.items()}
             for k, st in p.items()} for p in opt_state]


def _nets(tbptt_length=50, jupdater=None, tupdater=None):
    jnet = jtext_lstm(**CFG, tbptt_length=tbptt_length, seed=5,
                      updater=jupdater).init()
    pnet = text_generation_lstm(**CFG, tbptt_length=tbptt_length,
                                updater=tupdater, device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _batch(seed, n=B, t=T, masked=False):
    """One-hot characters and one-hot next-character labels (bench.py
    ``bench_lstm``'s ``np.roll(ids, -1, axis=1)``); with ``masked`` a
    right-padded [n,t] mask used as feature and label mask."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, V, size=(n, t))
    x = np.eye(V, dtype=np.float32)[ids]
    y = np.eye(V, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    if not masked:
        return x, y, None
    lens = r.integers(t // 2, t + 1, size=n)
    lens[0] = t
    return x, y, (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)


def _rel_to_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_output_and_feed_forward_match_jax(nets):
    jnet, pnet = nets
    x, _, _ = _batch(1)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
    got, want = pnet.feed_forward(x), jnet.feed_forward(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_jax(nets, masked):
    jnet, pnet = nets
    x, y, m = _batch(2, masked=masked)
    jm = None if m is None else jnp.asarray(m)

    def lf(p):
        return jnet.loss_fn(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                            labels_mask=jm, features_mask=jm)[0]
    jloss, jgrads = jax.value_and_grad(lf)(jnet.params)
    tm = None if m is None else torch.from_numpy(m)
    loss = pnet.loss_fn(torch.from_numpy(x), torch.from_numpy(y),
                        labels_mask=tm, features_mask=tm)
    flat = [(i, k, p) for i, pd in pnet.param_dicts().items()
            for k, p in pd.items()]
    grads = torch.autograd.grad(loss, [p for _, _, p in flat])
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for (i, k, _), g in zip(flat, grads):
        assert _rel_to_max(g.numpy(), np.asarray(jgrads[i][k])) < 1e-4, (i, k)
    assert float(grads[[f[:2] for f in flat].index((0, "R"))].abs().max()) > 0


class _Losses:
    def __init__(self):
        self.seen = []

    def iteration_done(self, net, iteration, loss):
        self.seen.append((iteration, float(loss)))


def test_three_tbptt_iterations_from_a_carried_rmsprop_state_match_jax():
    """tbptt_length 5 cuts T 12 into chunks of 5, 5 and 2: one ``fit`` is
    three iterations, each chunk starting from the last one's detached
    state. The RmsProp ``h`` comes from a JAX fit first."""
    jnet, pnet = _nets(tbptt_length=5, jupdater=jupd.RmsProp(1e-3),
                       tupdater=tupd.RmsProp(1e-3))
    x0, y0, _ = _batch(3)
    jnet.fit(x0, y0, batch_size=B)
    assert jnet.iteration_count == 3
    load_jax_params(pnet, _np(jnet.params))
    load_jax_opt_state(pnet, _np_state(jnet.opt_state),
                       iteration_count=jnet.iteration_count)
    x, y, _ = _batch(4)
    jrec, prec = _Losses(), _Losses()
    jnet.set_listeners(jrec)
    pnet.set_listeners(prec)
    jnet.fit(x, y, batch_size=B)
    pnet.fit(x, y, batch_size=B)
    assert pnet.iteration_count == jnet.iteration_count == 6
    assert [i for i, _ in prec.seen] == [i for i, _ in jrec.seen] == [5]
    np.testing.assert_allclose(prec.seen[0][1], jrec.seen[0][1], rtol=1e-5)
    for i, jp in enumerate(jnet.params):
        for k, v in jp.items():
            np.testing.assert_allclose(
                pnet.param_dicts()[i][k].detach().numpy(), np.asarray(v),
                atol=1e-5, err_msg=f"layer {i} {k}")
    for i, js in enumerate(jnet.opt_state):
        for k, st in js.items():
            np.testing.assert_allclose(pnet.opt_state[i][k]["h"].numpy(),
                                       np.asarray(st["h"]), atol=1e-5)


def test_params_flat_is_the_jax_order(nets):
    jnet, pnet = nets
    flat = pnet.params_flat()
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jnet.params_flat()))
    assert pnet.num_params() == jnet.num_params() == flat.numel()
    other = text_generation_lstm(**CFG, device="cpu").init(seed=99)
    other.set_params_flat(flat)
    np.testing.assert_array_equal(other.params_flat().numpy(), flat.numpy())
    with pytest.raises(ValueError, match="length"):
        other.set_params_flat(flat[:-1])


def test_rnn_time_step_chunk_by_chunk_equals_the_sequence_and_jax(nets):
    jnet, pnet = nets
    x, _, _ = _batch(5)
    full = pnet.output(x).numpy()
    pnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    outs, jouts = [pnet.rnn_time_step(x[:, :5]).numpy()], \
        [np.asarray(jnet.rnn_time_step(x[:, :5]))]
    for t in range(5, T):
        outs.append(pnet.rnn_time_step(x[:, t]).numpy()[:, None])
        jouts.append(np.asarray(jnet.rnn_time_step(x[:, t]))[:, None])
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, full, atol=1e-5)
    np.testing.assert_allclose(got, np.concatenate(jouts, axis=1), atol=1e-5)
    pnet.rnn_clear_previous_state()
    np.testing.assert_allclose(pnet.rnn_time_step(x[:, 0]).numpy(),
                               full[:, 0], atol=1e-5)


def test_sample_text_draws_what_jax_draws(nets):
    jnet, pnet = nets
    kw = dict(vocab_size=V, seed_ids=[3, 1, 4, 1, 5], n_steps=12,
              temperature=0.8, rng_seed=11)
    assert sample_text(pnet, **kw) == jsample_text(jnet, **kw)


def test_prefill_scan_matches_jax(nets):
    """The port's prefill is one masked pass per layer over the padded
    prompt; the reference's steps token by token. Logits and states agree."""
    jnet, pnet = nets
    r = np.random.default_rng(6)
    tokens = r.integers(0, V, size=(3, 16))
    lengths = np.array([16, 5, 9])
    jspec, spec = JSpec(jnet), LSTMDecodeSpec(pnet)
    jlog, jst = jspec.prefill_scan(jnet.params, jnet.state,
                                   jnp.asarray(tokens, jnp.int32),
                                   jnp.asarray(lengths, jnp.int32),
                                   jspec.init_states(3))
    log, st = spec.prefill_scan(torch.from_numpy(tokens),
                                torch.from_numpy(lengths),
                                spec.init_states(3))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-5)
    assert [s is None for s in st] == [s is None for s in jst]
    for s, js in zip(st, jst):
        if s is not None:
            for a, b in zip(s, js):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-5)


def test_engine_state_adapter_matches_jax_naive_generate_concurrently(nets):
    jnet, pnet = nets
    r = np.random.default_rng(11)
    prompts = [r.integers(0, V, size=n).tolist() for n in (3, 7)]
    refs = [jnaive_generate_lstm(jnet, p, 8) for p in prompts]
    assert [naive_generate_lstm(pnet, p, 8, device="cpu")
            for p in prompts] == refs
    eng = GenerationEngine(pnet, model_name="charlm", block_len=8,
                           max_seq_len=32, decode_slots=2,
                           prefill_batches=(1, 2), prompt_rungs=(16,),
                           device="cpu")
    try:
        assert eng.models()["charlm"]["adapter"] == "state"
        outs = {}

        def client(i):
            outs[i] = eng.generate(prompts[i % 2], max_tokens=8)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(4):
            assert outs[i] == (refs[i % 2], "length")
        snap = eng.metrics()["charlm"]
        assert snap["requests"] == 4 and snap["tokens_out"] == 32
    finally:
        eng.stop()


def _dense_nets():
    kw = dict(seed=3, weight_init="xavier", activation="tanh")
    jconf = (JConf(**kw, updater=jupd.Sgd(0.05))
             .list(jl.DenseLayer(n_out=10),
                   jl.RnnOutputLayer(n_out=4, activation="softmax",
                                     loss="mcxent"))
             .set_input_type(JInputType.recurrent(6, 5)).build())
    pconf = (NeuralNetConfiguration(**kw, updater=tupd.Sgd(0.05))
             .list(tl.DenseLayer(n_out=10),
                   tl.RnnOutputLayer(n_out=4, activation="softmax",
                                     loss="mcxent"))
             .set_input_type(InputType.recurrent(6, 5)).build())
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init()
    assert pnet.layers[0].n_in == 6 and pnet.layers[1].n_in == 10
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def test_a_dense_multilayer_network_matches_jax():
    jnet, pnet = _dense_nets()
    r = np.random.default_rng(8)
    x = r.normal(size=(4, 5, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, size=(4, 5))]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    np.testing.assert_allclose(pnet.score(x, y), jnet.score(x, y),
                               rtol=1e-6)
    jnet.fit(x, y, batch_size=2, epochs=2)
    pnet.fit(x, y, batch_size=2, epochs=2)
    assert pnet.iteration_count == jnet.iteration_count == 4
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=1e-6)


@pytest.mark.parametrize("ask", ["evaluate", "pretrain", "clone",
                                 "graph_tbptt", "lstm_draft",
                                 "prefix_cache"])
def test_what_the_slice_leaves_raises_not_implemented(nets, ask):
    _, pnet = nets
    if ask in ("lstm_draft", "prefix_cache"):
        # ported since (ROADMAP A2a): both now do what the reference's do —
        # an LSTM target cannot speculate (no block tables to verify over),
        # and the state adapter has no blocks to share, so the prefix
        # cache stays off whatever is asked
        if ask == "lstm_draft":
            with pytest.raises(ValueError, match="paged"):
                GenerationEngine(pnet, draft=pnet, device="cpu")
        else:
            eng = GenerationEngine(pnet, prefix_cache=True, device="cpu")
            try:
                assert eng.models()["default"]["prefix_cache"] is False
            finally:
                eng.stop()
        return
    if ask == "clone":
        # ported (ROADMAP A10): real copies, equal to the reference's clone
        # before training and independent of the source after it
        jnet, _ = nets
        x, y, _ = _batch(31, n=2)
        jc, pc = jnet.clone(), pnet.clone()
        np.testing.assert_allclose(pc.output(x).numpy(),
                                   np.asarray(jc.output(x)), atol=1e-6)
        before = pnet.params_flat().clone()
        pc.fit(x, y, batch_size=2)
        jc.fit(x, y, batch_size=2)
        np.testing.assert_allclose(pc.params_flat().numpy(),
                                   np.asarray(jc.params_flat()), atol=1e-6)
        assert torch.equal(pnet.params_flat(), before)
        assert not torch.equal(pc.params_flat(), before)
        return
    if ask == "graph_tbptt":
        # ported (ROADMAP A10): the graph builder takes the chunk length
        # and refuses bwd != fwd, as the reference's does
        g = NeuralNetConfiguration().graph_builder().tbptt_length(8)
        assert (g._backprop_type, g._tbptt_fwd, g._tbptt_bwd) == \
            ("tbptt", 8, 8)
        with pytest.raises(ValueError, match="bwd"):
            NeuralNetConfiguration().graph_builder().tbptt_length(8, 4)
        return
    if ask == "evaluate":
        # ported (ROADMAP A5): the reference's time-series evaluation,
        # [B,T,V] labels flattened to B·T rows
        jnet, _ = nets
        x, y, _ = _batch(31, n=2)
        t, j = pnet.evaluate(x, y), jnet.evaluate(x, y)
        np.testing.assert_array_equal(t.confusion, j.confusion)
        assert t.confusion.sum() == y.shape[0] * y.shape[1]
        assert t.stats() == j.stats()
        return
    # ported (ROADMAP A5): the char-RNN has no layer with a pretraining
    # loss, so pretraining leaves it as it is, as the reference's does
    jnet, _ = nets
    x, y, _ = _batch(31, n=2)
    it = ListDataSetIterator(features=x, labels=y, batch_size=2)
    jbefore, before = np.asarray(jnet.params_flat()), pnet.params_flat()
    assert pnet.pretrain(it) is pnet
    jnet.pretrain(it)
    assert torch.equal(pnet.params_flat(), before)
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()), jbefore)


def test_configuration_checks():
    with pytest.raises(ValueError, match="bwd"):
        NeuralNetConfiguration().list().tbptt_length(10, 5)
    with pytest.raises(ValueError, match="FF input to an RNN"):
        (NeuralNetConfiguration()
         .list(tl.DenseLayer(n_in=4, n_out=3), tl.GravesLSTM(n_out=3))
         .build())
    with pytest.raises(ValueError, match="MultiLayerNetwork"):
        LSTMDecodeSpec(object())
