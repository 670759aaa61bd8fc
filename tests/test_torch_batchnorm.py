"""BatchNormalization and layer state in the port against the JAX package.

The layer alone in training and evaluation mode, on NHWC maps and on
[B, F] features, with and without ``lock_gamma_beta`` (float32 at atol
1e-5, float64 at 1e-10); a small conv network with three BatchNorms whose
running statistics, parameters and gradients follow JAX's over 1 and 3
``fit`` steps (float64 at 1e-9, gradients float32 at rel-to-max 1e-4); a
bfloat16 compute dtype (2e-2, the state float32); gradient checkpointing,
whose recompute must not move the statistics a second time; a K-step
window, bitwise K single steps, and the captured step's binding of the
state buffers; 4 logical ``ParallelWrapper`` workers, plain sync and
accumulator; and ``clone``.
The JAX weights and state cross with ``load_jax_params`` /
``load_jax_state``. Inputs come from numpy seeds."""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.inputs import InputType as JIT
from deeplearning4j_tpu.optimize import updaters as ju
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_params,
                                                         load_jax_state)
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.inputs import InputTypeConvolutional
from deeplearning4j_tpu_torch.nn.inputs import InputTypeFeedForward
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tape import collect_state
from deeplearning4j_tpu_torch.optimize import updaters as tu
from deeplearning4j_tpu_torch.optimize.step_graph import binding
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel import accumulation as tacc

TORCH = {"float32": torch.float32, "float64": torch.float64}


def _np(tree):
    return [{k: np.asarray(v, np.float64 if v.dtype == jnp.float64
                           else np.float32) for k, v in p.items()}
            for p in tree]


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("float64", 1e-10)])
@pytest.mark.parametrize("lock", [False, True], ids=["gamma_beta", "locked"])
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_layer_matches_jax_in_train_and_eval(kind, lock, dtype, tol):
    r = np.random.default_rng(0)
    kw = dict(activation="relu", lock_gamma_beta=lock, gamma_init=1.5,
              beta_init=-0.25)
    if kind == "conv":
        shape, jit, tit = (4, 5, 6, 7), JIT.convolutional(5, 6, 7), \
            InputTypeConvolutional(5, 6, 7)
    else:
        shape, jit, tit = (16, 9), JIT.feed_forward(9), \
            InputTypeFeedForward(9)
    x = (3.0 + 2.0 * r.standard_normal(shape)).astype(dtype)
    jlayer = jl.BatchNormalization(**kw)
    jp, js = jlayer.init(jax.random.PRNGKey(0), jit, jnp.dtype(dtype))
    nf = shape[-1]
    js = {"mean": jnp.asarray(r.standard_normal(nf), jnp.float32),
          "var": jnp.asarray(r.uniform(0.5, 2.0, nf), jnp.float32)}
    if not lock:
        jp = {"gamma": jnp.asarray(r.standard_normal(nf), dtype),
              "beta": jnp.asarray(r.standard_normal(nf), dtype)}
    layer = tl.BatchNormalization(**kw)
    layer.init_params(tit, TORCH[dtype], torch.device("cpu"),
                      torch.Generator().manual_seed(0))
    assert sorted(layer.param_dict()) == sorted(jp)
    assert sorted(layer.layer_state()) == ["mean", "var"]
    assert all(t.dtype == torch.float32 for t in layer.layer_state().values())
    with torch.no_grad():
        for k, v in jp.items():
            getattr(layer, k).copy_(torch.tensor(np.asarray(v)))
        for k, v in js.items():
            getattr(layer, k).copy_(torch.tensor(np.asarray(v)))
    for train in (True, False):
        want, wstate = jlayer.apply(jp, js, jnp.asarray(x), train=train)
        with collect_state({}) as sink:
            got = layer(torch.tensor(x), train=train)
        assert got.dtype == TORCH[dtype]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=tol, rtol=0)
        if train:
            for k in ("mean", "var"):
                assert sink[layer][k].dtype == torch.float32
                np.testing.assert_allclose(sink[layer][k].numpy(),
                                           np.asarray(wstate[k]), atol=1e-6,
                                           rtol=1e-6)
        else:
            assert sink == {}
    # a training forward outside a step writes nothing
    np.testing.assert_array_equal(layer.mean.numpy(), np.asarray(js["mean"]))


# ------------------------------------------------------------ a network
def _net(pkg, dtype="float32", updater="adam", **conf_kw):
    L = jl if pkg == "jax" else tl
    U = ju if pkg == "jax" else tu
    upd = U.Adam(1e-2) if updater == "adam" else U.Sgd(0.1)
    conf = (JConf if pkg == "jax" else TConf)(
        seed=3, updater=upd, weight_init="relu", dtype=dtype, **conf_kw)
    b = conf.list(
        L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                           convolution_mode="same", has_bias=False),
        L.BatchNormalization(activation="relu"),
        L.ConvolutionLayer(n_out=8, kernel_size=(3, 3), stride=(2, 2),
                           convolution_mode="same"),
        L.BatchNormalization(decay=0.7, eps=1e-3),
        L.DenseLayer(n_out=12, activation="identity"),
        L.BatchNormalization(activation="tanh", lock_gamma_beta=True),
        L.OutputLayer(n_out=5, activation="softmax", loss="mcxent"))
    b = b.set_input_type((JIT if pkg == "jax" else TIT).convolutional(8, 8, 3))
    if pkg == "jax":
        return JMLN(b.build()).init()
    return MultiLayerNetwork(b.build(), device="cpu").init()


def _pair(dtype="float32", **kw):
    jnet, pnet = _net("jax", dtype, **kw), _net("torch", dtype, **kw)
    load_jax_params(pnet, _np(jnet.params))
    load_jax_state(pnet, _np(jnet.state))
    return jnet, pnet


def _data(n, seed=1, dtype="float32"):
    r = np.random.default_rng(seed)
    x = (1.0 + r.standard_normal((n, 8, 8, 3))).astype(dtype)
    y = np.eye(5, dtype=dtype)[r.integers(0, 5, n)]
    return x, y


def _assert_same(jnet, pnet, atol, state_rtol=0.0):
    """Parameters and state at ``atol``; the state, float32 in both
    packages whatever the network's dtype, also at ``state_rtol`` (a
    float32 rounding of equal float64 statistics may differ by an ulp)."""
    for i, (jp, js) in enumerate(zip(jnet.params, jnet.state)):
        for k, v in jp.items():
            np.testing.assert_allclose(pnet.param_dicts()[i][k].detach()
                                       .numpy(), np.asarray(v), atol=atol,
                                       rtol=0, err_msg=f"{i}.{k}")
        assert sorted(pnet.state_dicts()[i]) == sorted(js)
        for k, v in js.items():
            np.testing.assert_allclose(pnet.state_dicts()[i][k].numpy(),
                                       np.asarray(v), atol=atol,
                                       rtol=state_rtol,
                                       err_msg=f"state {i}.{k}")


def test_state_dicts_have_the_reference_names_and_float32():
    jnet, pnet = _pair("float64")
    sd = pnet.state_dicts()
    assert list(sd) == list(range(7))
    assert [sorted(s) for s in sd.values()] == [sorted(s) for s in
                                                jnet.state]
    assert all(t.dtype == torch.float32 for s in sd.values()
               for t in s.values())
    assert sorted(pnet.param_dicts()[5]) == []          # lock_gamma_beta


@pytest.mark.parametrize("steps", [1, 3])
def test_running_statistics_follow_jax_over_fit_steps(steps):
    # Sgd: the Dense bias before the last BatchNorm has a zero gradient,
    # which Adam's normalization would turn into updates of float noise
    jnet, pnet = _pair("float64", updater="sgd")
    x, y = _data(8 * steps, dtype="float64")
    jnet.fit(x, y, batch_size=8)
    pnet.fit(x, y, batch_size=8)
    assert pnet.iteration_count == jnet.iteration_count == steps
    # the statistics moved, once a step
    assert np.abs(pnet.state_dicts()[1]["mean"].numpy()).max() > 1e-3
    _assert_same(jnet, pnet, atol=1e-9, state_rtol=1e-6)
    x2, _ = _data(4, seed=9, dtype="float64")
    np.testing.assert_allclose(pnet.output(x2).numpy(),
                               np.asarray(jnet.output(x2)), atol=1e-9)


def test_training_gradients_match_jax():
    jnet, pnet = _pair("float32")
    x, y = _data(8)
    (_, _), jg = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, jnet.state, jnp.asarray(x),
                               jnp.asarray(y), train=True),
        has_aux=True)(jnet.params)
    loss = pnet.loss_fn(torch.tensor(x), torch.tensor(y), train=True)
    params = [(i, k, p) for i, pd in pnet.param_dicts().items()
              for k, p in pd.items()]
    gs = torch.autograd.grad(loss, [p for *_, p in params])
    # relative to the largest entry of all (a bias before a BatchNorm has
    # a zero gradient, which each package gives as float noise)
    got = np.concatenate([g.numpy().ravel() for g in gs])
    want = np.concatenate([np.asarray(jg[i][k]).ravel()
                           for i, k, _ in params])
    assert _rel_to_max(got, want) <= 1e-4


def test_bf16_compute_keeps_float32_state_and_follows_jax():
    jnet, pnet = _pair("float32", compute_dtype="bfloat16")
    x, y = _data(8)
    jnet.fit(x, y, batch_size=8)
    pnet.fit(x, y, batch_size=8)
    for i, js in enumerate(jnet.state):
        for k, v in js.items():
            t = pnet.state_dicts()[i][k]
            assert t.dtype == torch.float32
            assert np.asarray(v).dtype == np.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(v), atol=2e-2,
                                       rtol=2e-2)
    x2, _ = _data(4, seed=9)
    got, want = pnet.output(x2).numpy(), np.asarray(jnet.output(x2))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_remat_updates_the_statistics_once():
    x, y = _data(24, seed=4, dtype="float64")
    plain = _net("torch", "float64", updater="sgd")
    jnet, remat = _pair("float64", updater="sgd",
                        gradient_checkpointing=True)
    load_jax_params(plain, _np(jnet.params))
    plain.fit(x, y, batch_size=8)
    remat.fit(x, y, batch_size=8)
    jnet.fit(x, y, batch_size=8)
    for i in plain.state_dicts():
        for k, t in plain.state_dicts()[i].items():
            torch.testing.assert_close(remat.state_dicts()[i][k], t, rtol=0,
                                       atol=0)
        for k, p in plain.param_dicts()[i].items():
            torch.testing.assert_close(remat.param_dicts()[i][k], p,
                                       rtol=0, atol=1e-12)
    _assert_same(jnet, remat, atol=1e-9, state_rtol=1e-6)


def _jmesh(n):
    return jmesh.make_mesh((n,), ("data",), jax.devices()[:n])


@pytest.mark.parametrize("acc", [None, "psum"], ids=["plain_sync", "psum"])
def test_four_logical_workers_average_the_state_as_jax(acc):
    """Plain sync is one GSPMD program over the global batch in JAX (batch
    statistics of the whole batch); the accumulator path is a shard_map
    (each worker's own statistics, the new states averaged)."""
    jnet, pnet = _pair("float32", updater="sgd")
    x, y = _data(32, seed=6)
    jkw = {} if acc is None else dict(
        gradient_accumulator=jacc.PsumAccumulator())
    pkw = {} if acc is None else dict(
        gradient_accumulator=tacc.PsumAccumulator())
    JPW(jnet, mesh=_jmesh(4), prefetch_buffer=0, **jkw).fit(
        JIter(features=x, labels=y, batch_size=16))
    ParallelWrapper(pnet, mesh=make_mesh((4,), ("data",), "cpu"),
                    **pkw).fit(ListDataSetIterator(features=x, labels=y,
                                                   batch_size=16))
    assert pnet.iteration_count == jnet.iteration_count == 2
    _assert_same(jnet, pnet, atol=2e-5)
    # the workers did not chain their moving averages: one decay a step
    single = _net("torch", updater="sgd")
    load_jax_params(single, _np(_net("jax", updater="sgd").params))
    single.fit(x, y, batch_size=16)
    if acc is None:                       # the whole batch's statistics
        for i, sd in single.state_dicts().items():
            for k, t in sd.items():
                torch.testing.assert_close(pnet.state_dicts()[i][k], t,
                                           rtol=1e-5, atol=1e-6)


def test_a_window_leaves_parameters_and_state_as_single_steps():
    x, y = _data(32, seed=8)
    a, b = _net("torch"), _net("torch")
    a.fit(x, y, batch_size=4)
    b.fit(x, y, batch_size=4, steps_per_dispatch=8)
    assert a.iteration_count == b.iteration_count == 8
    for i in a.param_dicts():
        for k, v in a.param_dicts()[i].items():
            torch.testing.assert_close(b.param_dicts()[i][k], v, rtol=0,
                                       atol=0)
        for k, v in a.state_dicts()[i].items():
            torch.testing.assert_close(b.state_dicts()[i][k], v, rtol=0,
                                       atol=0)


def test_the_captured_step_binds_the_state_buffers():
    _, pnet = _pair("float32")
    before = binding(pnet)
    ptrs = {t.data_ptr() for sd in pnet.state_dicts().values()
            for t in sd.values()}
    assert len(ptrs) == 6 and ptrs <= set(before)
    x, y = _data(8)
    pnet.fit(x, y, batch_size=8)              # written in place
    load_jax_state(pnet, [{k: v.numpy() for k, v in sd.items()}
                          for sd in pnet.state_dicts().values()])
    assert binding(pnet) == before
    pnet.init()                               # new buffers: a new capture
    assert binding(pnet) != before


def test_clone_copies_the_state_and_shares_nothing():
    _, pnet = _pair("float32")
    x, y = _data(8)
    pnet.fit(x, y, batch_size=8)
    c = pnet.clone()
    before = {k: t.clone() for k, t in pnet.state_dicts()[1].items()}
    for k, t in c.state_dicts()[1].items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
        assert t.data_ptr() != pnet.state_dicts()[1][k].data_ptr()
    c.fit(x, y, batch_size=8)
    for k, t in pnet.state_dicts()[1].items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
    assert not torch.equal(c.state_dicts()[1]["mean"], before["mean"])
    np.testing.assert_allclose(c.clone().output(x).numpy(),
                               c.output(x).numpy(), atol=0)


def test_load_jax_state_checks_names_and_shapes():
    jnet, pnet = _pair("float32")
    state = _np(jnet.state)
    bad = [dict(s) for s in state]
    bad[1] = {"mean": bad[1]["mean"]}
    with pytest.raises(ValueError, match="layer state"):
        load_jax_state(pnet, bad)
    bad = [dict(s) for s in state]
    bad[1]["var"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_state(pnet, bad)
