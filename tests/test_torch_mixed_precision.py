"""Mixed precision (``compute_dtype``): the port's f32-master, bf16-compute
training against the JAX package's on the same seeded inputs and weights.

A ``MultiLayerNetwork`` and a ``ComputationGraph`` (``transformer_lm`` at
d_model 64, two blocks, T 32: both packages take their plain attention)
train three steps with ``compute_dtype="bfloat16"`` on f32 master
parameters: the master parameters, updater state and gradients stay f32,
and the losses match JAX's at 2e-2. The master update is held so that a
missing or wrong-signed one fails: the MLP's change of each parameter
tensor equals JAX's at rel-to-max 2e-2 (``_same_change``); the
transformer's and the LSTM's parameters equal JAX's at 2e-2 after a fit
that moved them by at least ten times that (``_same_params``). Their
per-tensor changes differ from JAX's by more than 2e-2 in bf16 alone (up
to 4e-2 on the CPU; JAX's own bf16 change is 6e-2 from its f32 one), so
they are held on the parameters. An LSTM network under bf16 compute takes
the fused K5/K6 Function with bf16 operands. The field
survives the JSON round trip in both directions, and the decode path
refuses a mixed-precision network with the reference's words."""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import decode as jdecode
from deeplearning4j_tpu.models.zoo_extra import transformer_lm as jtlm
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import (
    MultiLayerConfiguration as JMLC, NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.conf.graph_conf import \
    ComputationGraphConfiguration as JCGC
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models import decode as tdecode
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import (MultiLayerConfiguration,
                                                     NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.optimize import updaters as tupd

TOL = 2e-2
TLM = dict(vocab_size=64, d_model=64, n_heads=2, n_blocks=2, max_length=32,
           token_input=True)


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


class _Rec:
    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration, loss):
        self.losses.append(float(loss))


def _mlp_layers(mod):
    return (mod.DenseLayer(n_in=6, n_out=32, activation="tanh"),
            mod.DenseLayer(n_out=32, activation="relu"),
            mod.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))


def _mlp_pair(**kw):
    jnet = JMLN(JConf(seed=1, updater=jupd.Sgd(0.1), **kw)
                .list(*_mlp_layers(jl)).build()).init()
    pnet = MultiLayerNetwork(NeuralNetConfiguration(
        seed=1, updater=tupd.Sgd(0.1), **kw).list(*_mlp_layers(tl)).build(),
        device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _mlp_data(seed, n=32):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[r.integers(0, 3, n)]


def _tlm_pair():
    # Sgd: Adam's first steps are about lr times the gradient's sign, which
    # bf16 rounding flips where a gradient is near 0
    jnet = jtlm(**TLM, seed=3, updater=jupd.Sgd(3e-2)).init()
    pnet = transformer_lm(**TLM, updater=tupd.Sgd(3e-2),
                          device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    # set on the built configuration, as a JSON configuration carries it
    jnet.conf.compute_dtype = "bfloat16"
    pnet.conf.compute_dtype = "bfloat16"
    return jnet, pnet


def _tlm_data(seed, n=4):
    r = np.random.default_rng(seed)
    ids = r.integers(1, 64, size=(n, 32)).astype(np.int32)
    return ids, np.eye(64, dtype=np.float32)[np.roll(ids, 1, axis=1)]


def _snapshot(pnet):
    """The port's parameters as numpy, per layer or vertex, in the JAX
    package's order."""
    return [{k: v.detach().numpy().copy() for k, v in pd.items()}
            for pd in pnet.param_dicts().values()]


def _changes(p0, p1, j0, j1):
    """(name, the port's change, JAX's change) of each parameter tensor
    over a fit: ``p0`` -> ``p1`` in the port, ``j0`` -> ``j1`` in JAX
    (``j0`` taken as numpy before the fit, which donates JAX's buffers)."""
    for i, (a0, a1, b0, b1) in enumerate(zip(p0, p1, j0, _np(j1))):
        for k, want in b1.items():
            yield f"{i}.{k}", a1[k] - a0[k], want - b0[k]


def _same_change(p0, p1, j0, j1):
    """Each parameter tensor's change equals JAX's at rel-to-max ``TOL``: a
    change never applied is 1 from it, one of the wrong sign 2."""
    for name, dp, dj in _changes(p0, p1, j0, j1):
        err = np.abs(dp - dj).max() / np.abs(dj).max()
        assert err <= TOL, f"{name}: change rel-to-max {err:.3g}"


def _same_params(p0, p1, j0, j1):
    """The parameters after the fit equal JAX's at ``TOL``, and the fit
    moved some parameter by at least ten times that, so a change never
    applied or of the wrong sign is far outside it."""
    moved = 0.0
    for name, dp, dj in _changes(p0, p1, j0, j1):
        moved = max(moved, float(np.abs(dj).max()))
        np.testing.assert_allclose(dp, dj, atol=TOL, err_msg=name)
    assert moved >= 10 * TOL, f"the fit moved the parameters {moved:.3g}"


def _all_f32(pnet):
    return all(p.dtype == torch.float32 for p in pnet.parameters())


def test_mln_trains_bf16_compute_on_f32_master_like_jax():
    jnet, pnet = _mlp_pair(compute_dtype="bfloat16")
    x, y = _mlp_data(2, n=24)
    # the forward computes in bf16 and answers in the master dtype
    out = pnet.output(x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)),
                               atol=TOL)
    grads = torch.autograd.grad(
        pnet.loss_fn(torch.from_numpy(x), torch.from_numpy(y)),
        list(pnet.parameters()))
    assert all(g.dtype == torch.float32 for g in grads)
    jr, pr = _Rec(), _Rec()
    jnet.set_listeners(jr)
    pnet.set_listeners(pr)
    j0, p0 = _np(jnet.params), _snapshot(pnet)
    jnet.fit(x, y, batch_size=8)
    pnet.fit(x, y, batch_size=8)
    assert pnet.iteration_count == 3
    np.testing.assert_allclose(pr.losses, jr.losses, rtol=TOL)
    _same_change(p0, _snapshot(pnet), j0, jnet.params)
    assert _all_f32(pnet)
    assert all(s.dtype == torch.float32 for layer in pnet.opt_state.values()
               for st in layer.values() for s in st.values())


def test_bf16_compute_gradients_track_full_precision():
    """The reference's check: bf16-compute master gradients are f32 and
    within a few per cent of the f32 network's."""
    _, amp = _mlp_pair(compute_dtype="bfloat16")
    _, full = _mlp_pair()
    x, y = (torch.from_numpy(a) for a in _mlp_data(4, n=64))
    ga = torch.autograd.grad(amp.loss_fn(x, y, train=False),
                             list(amp.parameters()))
    gf = torch.autograd.grad(full.loss_fn(x, y, train=False),
                             list(full.parameters()))
    fa = torch.cat([g.reshape(-1) for g in ga])
    ff = torch.cat([g.reshape(-1) for g in gf])
    assert fa.dtype == torch.float32
    rel = (fa - ff).abs() / torch.clamp(ff.abs(), min=1e-2)
    assert float(rel.mean()) < 0.05


def test_graph_trains_bf16_compute_like_jax():
    jnet, pnet = _tlm_pair()
    batches = [_tlm_data(10 + i) for i in range(3)]
    jr, pr = _Rec(), _Rec()
    jnet.set_listeners(jr)
    pnet.set_listeners(pr)
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    j0, p0 = _np(jnet.params), _snapshot(pnet)
    jnet.fit(xs, ys, batch_size=4)
    pnet.fit(xs, ys, batch_size=4)
    assert pnet.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(pr.losses, jr.losses, rtol=TOL)
    assert _all_f32(pnet)
    _same_params(p0, _snapshot(pnet), j0, jnet.params)
    acts = pnet.feed_forward(xs[:4])
    assert all(a.dtype == torch.float32 for k, a in acts.items()
               if k != "tokens")


def test_lstm_under_bf16_compute_takes_the_fused_path(monkeypatch):
    """bf16 compute feeds the LSTM layers' K5/K6 Function bf16 operands
    (on the CPU the wrappers compute their plain versions)."""
    seen = []
    for name in ("fused_lstm_fwd", "fused_lstm_bwd"):
        real = getattr(tlstm, name)

        def counted(*a, _real=real, _name=name, **kw):
            seen.append((_name, a[0].dtype))
            return _real(*a, **kw)
        monkeypatch.setattr(tlstm, name, counted)

    def build(mod, conf_cls, itype, upd):
        return (conf_cls(seed=7, updater=upd, dtype="float32",
                         compute_dtype="bfloat16")
                .list(mod.LSTM(n_out=16, activation="tanh"),
                      mod.RnnOutputLayer(n_out=5, activation="softmax",
                                         loss="mcxent"))
                .set_input_type(itype.recurrent(5, 6)).build())
    jnet = JMLN(build(jl, JConf, JInputType, jupd.Sgd(1.0))).init()
    pnet = MultiLayerNetwork(build(tl, NeuralNetConfiguration, InputType,
                                   tupd.Sgd(1.0)), device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    r = np.random.default_rng(8)
    x = r.normal(size=(16, 6, 5)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[r.integers(0, 5, (16, 6))]
    s0 = pnet.score(x, y)
    np.testing.assert_allclose(s0, jnet.score(x, y), rtol=TOL)
    seen.clear()
    j0, p0 = _np(jnet.params), _snapshot(pnet)
    pnet.fit(x, y, batch_size=16)
    assert seen == [("fused_lstm_fwd", torch.bfloat16),
                    ("fused_lstm_bwd", torch.bfloat16)]
    jnet.fit(x, y, batch_size=16)
    _same_params(p0, _snapshot(pnet), j0, jnet.params)
    assert _all_f32(pnet) and pnet.score(x, y) < s0


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_compute_dtype_survives_json_both_ways(kind):
    if kind == "multilayer":
        conf = NeuralNetConfiguration(
            compute_dtype="bfloat16", gradient_checkpointing=True).list(
            *_mlp_layers(tl)).build()
        back = MultiLayerConfiguration.from_json(conf.to_json())
        jback = JMLC.from_json(conf.to_json())
    else:
        _, pnet = _tlm_pair()
        conf = pnet.conf
        back = ComputationGraphConfiguration.from_json(conf.to_json())
        jback = JCGC.from_json(conf.to_json())
    assert back.compute_dtype == jback.compute_dtype == "bfloat16"
    assert back.gradient_checkpointing == jback.gradient_checkpointing == \
        conf.gradient_checkpointing
    with pytest.raises(ValueError, match="compute_dtype"):
        NeuralNetConfiguration(compute_dtype="float8")


def test_decode_refuses_a_compute_dtype_net_as_the_reference_does():
    jnet, pnet = _tlm_pair()
    with pytest.raises(ValueError) as want:
        jdecode.TransformerDecodeSpec(jnet)
    with pytest.raises(ValueError) as got:
        tdecode.TransformerDecodeSpec(pnet)
    assert str(got.value) == str(want.value)

    def lstm_net(mod, conf_cls, itype):
        return (conf_cls(seed=7, compute_dtype="bfloat16")
                .list(mod.GravesLSTM(n_out=8, activation="tanh"),
                      mod.RnnOutputLayer(n_out=5, activation="softmax",
                                         loss="mcxent"))
                .set_input_type(itype.recurrent(5, 6)).build())
    jl_net = JMLN(lstm_net(jl, JConf, JInputType)).init()
    pl_net = MultiLayerNetwork(lstm_net(tl, NeuralNetConfiguration,
                                        InputType), device="cpu").init()
    with pytest.raises(ValueError) as want:
        jdecode.LSTMDecodeSpec(jl_net)
    with pytest.raises(ValueError) as got:
        tdecode.LSTMDecodeSpec(pl_net)
    assert str(got.value) == str(want.value)
    assert jnp.dtype(jnet.conf.dtype) == jnp.float32
