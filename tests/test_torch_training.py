"""The training slice end to end: the port's transformer_lm loss, gradients
and ``fit`` steps against the JAX package's, on weights (and updater state)
carried across with ``load_jax_params`` / ``load_jax_opt_state``.

The model, transformer_lm(vocab 64, d_model 128, 2 heads, 2 blocks,
max_length 256, token ids), has head dim 64, so at T=256 both packages take
their flash-attention paths: the JAX side its Pallas forward and backward
kernels in interpret mode, the port its autograd Function over the plain
versions. Tolerances: loss rel 1e-5, gradients rel-to-max 1e-4, parameters
after three ``fit`` steps atol 1e-5 with Sgd(1e-3) and 1e-4 with Adam(3e-4)
(Adam's m/sqrt(v) magnifies differences in near-zero gradients), and a
bf16 step's loss rtol 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import (DataSet as JDataSet,
                                                 ListDataSetIterator as JIter)
from deeplearning4j_tpu.models.zoo_extra import transformer_lm as jtransformer_lm
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_opt_state,
                                                         load_jax_params)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import maybe_dropout
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.optimize import updaters as tupd

CFG = dict(vocab_size=64, d_model=128, n_heads=2, n_blocks=2,
           max_length=256, token_input=True)
B, T, V = 2, 256, 64
# The loss sums cross-entropy over 256 timesteps, so Sgd(0.1) diverges
# within three steps (parameters reach 1e5) and the comparison would hold
# two chaotic trajectories to each other; 1e-3 keeps training stable.
SGD_LR = 1e-3


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _np_state(opt_state):
    return [{k: {s: np.asarray(a, np.float32) for s, a in st.items()}
             for k, st in p.items()} for p in opt_state]


def _nets(jupdater, tupdater, dtype="float32"):
    jnet = jtransformer_lm(**CFG, seed=7, updater=jupdater,
                           dtype=dtype).init()
    pnet = transformer_lm(**CFG, updater=tupdater, dtype=dtype,
                          device="cpu").init()
    assert pnet.vertex_names == list(jnet.vertex_names)
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _batch(seed, n=B, masked=False):
    """Token ids, one-hot labels of the previous token (bench.py's
    transformer-LM feed) and, when ``masked``, a right-padded [n,T] mask
    used as both feature and label mask."""
    r = np.random.default_rng(seed)
    ids = r.integers(1, V, size=(n, T)).astype(np.int32)
    y = np.eye(V, dtype=np.float32)[np.roll(ids, 1, axis=1)]
    if not masked:
        return ids, y, None
    lens = r.integers(T // 2, T, size=n)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return ids, y, mask


def _rel_to_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_every_gradient_match_jax(masked):
    jnet, pnet = _nets(jupd.Sgd(0.1), tupd.Sgd(0.1))
    ids, y, m = _batch(1, masked=masked)
    jm = None if m is None else jnp.asarray(m)

    def lf(p):
        return jnet.loss_fn(p, jnet.state, jnp.asarray(ids), jnp.asarray(y),
                            labels_mask=jm, features_mask=jm)[0]
    jloss, jgrads = jax.value_and_grad(lf)(jnet.params)

    tm = None if m is None else torch.from_numpy(m)
    loss = pnet.loss_fn(torch.from_numpy(ids), torch.from_numpy(y),
                        labels_mask=tm, features_mask=tm)
    params = pnet.param_dicts()
    flat = [(n, k, p) for n, pd in params.items() for k, p in pd.items()]
    grads = torch.autograd.grad(loss, [p for _, _, p in flat])
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    jg = dict(zip(jnet.vertex_names, jgrads))
    for (n, k, _), g in zip(flat, grads):
        ref = np.asarray(jg[n][k])
        assert _rel_to_max(g.numpy(), ref) < 1e-4, (n, k)
    # attention parameters do get a gradient through the flash Function
    assert float(grads[[f[:2] for f in flat].index(("b0_attn", "Wq"))]
                 .abs().max()) > 0


def _fit_both(jnet, pnet, batches, masked):
    if masked:
        jnet.fit(iterator=JIter([JDataSet(x, y, m, m) for x, y, m in batches]))
        pnet.fit(iterator=ListDataSetIterator(
            [DataSet(x, y, m, m) for x, y, m in batches]))
    else:
        xs = np.concatenate([b[0] for b in batches])
        ys = np.concatenate([b[1] for b in batches])
        jnet.fit(xs, ys, batch_size=B)
        pnet.fit(xs, ys, batch_size=B)


def _assert_params_close(jnet, pnet, atol):
    for n, jp in zip(jnet.vertex_names, jnet.params):
        own = pnet.vertices[n].param_dict()
        for k, v in jp.items():
            np.testing.assert_allclose(own[k].detach().float().numpy(),
                                       np.asarray(v, np.float32), atol=atol,
                                       err_msg=f"{n}.{k}")


@pytest.mark.parametrize("rule,masked", [("sgd", False), ("sgd", True),
                                         ("adam", False), ("adam", True)])
def test_three_fit_steps_match_jax(rule, masked):
    if rule == "sgd":
        jnet, pnet = _nets(jupd.Sgd(SGD_LR), tupd.Sgd(SGD_LR))
        atol = 1e-5
    else:
        jnet, pnet = _nets(jupd.Adam(3e-4), tupd.Adam(3e-4))
        atol = 1e-4
    batches = [_batch(10 + i, masked=masked) for i in range(3)]
    _fit_both(jnet, pnet, batches, masked)
    assert pnet.iteration_count == jnet.iteration_count == 3
    _assert_params_close(jnet, pnet, atol)
    # the updater state, rel-to-max as the gradients it accumulates
    for n, js in zip(jnet.vertex_names, jnet.opt_state):
        for k, st in js.items():
            for s, a in st.items():
                ref = np.asarray(a)
                if np.abs(ref).max() > 0:
                    assert _rel_to_max(pnet.opt_state[n][k][s].numpy(),
                                       ref) < 1e-4, (n, k, s)


def test_fit_from_a_carried_over_adam_state_matches_jax():
    """Two JAX steps, then both packages start from the JAX parameters,
    Adam moments and iteration count and take two more."""
    jnet, pnet = _nets(jupd.Adam(3e-4), tupd.Adam(3e-4))
    first = [_batch(20 + i) for i in range(2)]
    jnet.fit(np.concatenate([b[0] for b in first]),
             np.concatenate([b[1] for b in first]), batch_size=B)
    assert jnet.iteration_count == 2
    load_jax_params(pnet, _np(jnet.params))
    load_jax_opt_state(pnet, _np_state(jnet.opt_state),
                       iteration_count=jnet.iteration_count)
    assert pnet.iteration_count == 2
    assert float(pnet.opt_state["b0_attn"]["Wq"]["v"].abs().max()) > 0
    _fit_both(jnet, pnet, [_batch(30 + i) for i in range(2)], masked=False)
    _assert_params_close(jnet, pnet, 1e-4)


def test_load_jax_opt_state_checks_names_and_shapes():
    jnet, pnet = _nets(jupd.Adam(3e-4), tupd.Adam(3e-4))
    state = _np_state(jnet.opt_state)
    before = pnet.opt_state["b0_attn"]["Wq"]["m"].clone()
    bad = [dict(p) for p in state]
    i = pnet.vertex_names.index("b0_attn")
    bad[i] = dict(bad[i], Wq={"m": np.ones((3, 3), np.float32),
                              "v": bad[i]["Wq"]["v"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_opt_state(pnet, bad, iteration_count=1)
    bad[i] = dict(state[i], Wq={"m": state[i]["Wq"]["m"]})
    with pytest.raises(ValueError, match="updater state"):
        load_jax_opt_state(pnet, bad, iteration_count=1)
    with pytest.raises(ValueError, match="state dicts"):
        load_jax_opt_state(pnet, state[:-1], iteration_count=1)
    assert torch.equal(pnet.opt_state["b0_attn"]["Wq"]["m"], before)
    assert pnet.iteration_count == 0


def test_one_bf16_step_matches_jax_loss():
    jnet, pnet = _nets(jupd.Adam(3e-4), tupd.Adam(3e-4), dtype="bfloat16")
    ids, y, _ = _batch(40)
    jl, pl = [], []

    class Rec:
        def __init__(self, out):
            self.out = out

        def iteration_done(self, net, iteration, loss):
            self.out.append(float(loss))

    jnet.set_listeners(Rec(jl))
    pnet.set_listeners(Rec(pl))
    jnet.fit(ids, y, batch_size=B)
    pnet.fit(ids, y, batch_size=B)
    assert pnet.vertices["b0_attn"].layer.Wq.dtype == torch.bfloat16
    assert pnet.opt_state["b0_attn"]["Wq"]["m"].dtype == torch.bfloat16
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    np.testing.assert_allclose(pnet.score(ids, y), jnet.score(ids, y),
                               rtol=2e-2)


def test_fit_goes_through_the_flash_function(monkeypatch):
    """Every step's attention runs forward and backward through the
    flash-attention wrappers (on the CPU their plain versions)."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name, key in (("flash_attention_fwd", "fwd"),
                      ("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(fa, name, counted)
    _, pnet = _nets(jupd.Sgd(0.1), tupd.Sgd(0.1))
    ids, y, _ = _batch(50)
    pnet.fit(ids, y, batch_size=B)
    assert calls == {"fwd": 2, "dq": 2, "dkv": 2}


@pytest.mark.parametrize("ask", ["prefetch", "window", "tbptt", "second_order",
                                 "compute_dtype", "checkpointing",
                                 "multilayer", "epoch_listener"])
def test_what_this_slice_leaves_raises_not_implemented(ask):
    _, pnet = _nets(jupd.Sgd(0.1), tupd.Sgd(0.1))
    ids, y, _ = _batch(60)

    class EpochListener:
        def iteration_done(self, net, iteration, loss):
            pass

        def on_epoch_start(self, net):
            pass

    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        if ask == "prefetch":
            pnet.fit(ids, y, async_prefetch=True)
        elif ask == "window":
            pnet.fit(ids, y, steps_per_dispatch=2)
        elif ask == "tbptt":
            NeuralNetConfiguration().graph_builder().tbptt_length(16)
        elif ask == "second_order":
            NeuralNetConfiguration(optimization_algorithm="lbfgs")
        elif ask == "compute_dtype":
            NeuralNetConfiguration(compute_dtype="bfloat16")
        elif ask == "checkpointing":
            NeuralNetConfiguration(gradient_checkpointing=True)
        elif ask == "multilayer":
            NeuralNetConfiguration().list().pretrain(True)
        else:
            pnet.set_listeners(EpochListener())
    assert pnet.iteration_count == 0


@pytest.mark.parametrize("kind", ["dense", "attention", "norm"])
def test_regularization_matches_jax(kind):
    """l1/l2 act on each layer's weight parameters only (the reference's
    ``weight_param_names``): Dense W, attention Wq/Wk/Wv/Wo, nothing on
    LayerNorm's gain and bias."""
    cls, kw = {"dense": ("DenseLayer", dict(n_out=6)),
               "attention": ("SelfAttentionLayer", dict(n_out=8, n_heads=2)),
               "norm": ("LayerNormalization", dict(n_out=8))}[kind]
    reg = dict(l1=1e-3, l2=1e-2, weight_init="xavier", activation="identity",
               bias_init=0.5)
    jlayer = getattr(jl, cls)(**kw, **reg)
    jparams, _ = jlayer.init(jax.random.PRNGKey(0),
                             JInputType.recurrent(8, 4), jnp.float32)
    tlayer = getattr(tl, cls)(**kw, **reg)
    tlayer.init_params(InputType.recurrent(8, 4), torch.float32,
                       torch.device("cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in tlayer.param_dict().items():
            p.copy_(torch.from_numpy(np.array(jparams[k])))
    want = float(jlayer.regularization(jparams))
    got = float(torch.as_tensor(tlayer.regularization()).detach())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == 0.0) == (kind == "norm")


def test_dropout_is_inverted_and_draws_from_the_given_generator():
    x = torch.ones(64, 256)
    assert maybe_dropout(x, 0.8, None, train=False) is x
    assert maybe_dropout(x, 0.0, None, train=True) is x
    a = maybe_dropout(x, 0.8, torch.Generator().manual_seed(3), train=True)
    b = maybe_dropout(x, 0.8, torch.Generator().manual_seed(3), train=True)
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.8))
    assert abs(kept.float().mean().item() - 0.8) < 0.02
