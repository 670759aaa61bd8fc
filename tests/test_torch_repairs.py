"""Five conventions the port broke against the reference, each pinned:

- ``ComputationGraph`` has every method of the reference's graph (all
  ported since: ``rnn_time_step``, ``rnn_clear_previous_state``,
  ``clone``, ``evaluate`` and ``pretrain``), and ``output`` takes
  ``train``.
- ``dtype="float64"`` builds a network whose loss and gradients equal the
  reference's float64 network's (x64 is on in the tests); the kernels'
  probes refuse float64, so a float64 tensor takes the plain paths by the
  probe's own rule.
- The dense encoder's update and the plain encode's subtraction come from
  one function, ``ops.threshold_encode.threshold_update``; the combine
  that uses it stays bitwise equal to the reference's ``shard_map`` form.
- The activation registry has the reference's 19 names, each equal to
  the JAX function on the same inputs; an unknown name raises
  ``ValueError``, as the reference's does.
- ``NeuralNetConfiguration`` takes ``max_num_line_search_iterations``
  (carried into the network's and the graph's configuration) and the
  workspace and cache-mode keywords (ignored), as the reference does.
"""
import _torch_threads  # noqa: F401
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo_extra import googlenet as jgooglenet
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.conf.config import \
    NeuralNetConfiguration as JConf
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.device import torch_dtype
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import googlenet
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.config import \
    NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.ops.flash_attention import (
    fused_attention_applicable, fused_ring_applicable)
from deeplearning4j_tpu_torch.ops.kernels.conv import \
    conv1x1_bias_relu_applicable
from deeplearning4j_tpu_torch.ops.lstm import fused_lstm_applicable
from deeplearning4j_tpu_torch.parallel import accumulation as tacc
from deeplearning4j_tpu_torch.parallel import make_mesh

tk = importlib.import_module("deeplearning4j_tpu_torch.ops.threshold_encode")

CFG = dict(n_classes=10, height=32, width=32)


@pytest.fixture(scope="module")
def gnet():
    return googlenet(**CFG, device="cpu").init(seed=5)


# ------------------------------------------------------------------- C1
@pytest.mark.parametrize("method, args, item", [
    ("rnn_time_step", (np.zeros((1, 32, 32, 3), np.float32),), "A10"),
    ("rnn_clear_previous_state", (), "A10"),
    ("pretrain", (iter(()),), "A5"),
    ("evaluate", (np.zeros((1, 32, 32, 3), np.float32),), "A5"),
    ("clone", (), "A10")])
def test_graph_methods_not_ported_raise_naming_their_item(gnet, method, args,
                                                          item):
    """All are ported: ``pretrain`` (A5's second half; GoogLeNet has
    nothing to pretrain), the A10 ones (on GoogLeNet, which has no recurrent vertex, ``rnn_time_step``
    is the plain forward and ``clone`` a real copy) and ``evaluate`` (A5's
    first half), whose confusion matrix is the output's argmax against
    the labels'."""
    jnet = jgooglenet(**CFG)
    assert callable(getattr(jnet, method))          # the reference has it
    if method == "evaluate":
        x = np.random.default_rng(7).normal(size=(6, 32, 32, 3)).astype(
            np.float32)
        y = np.eye(10, dtype=np.float32)[[0, 3, 3, 9, 1, 5]]
        e = gnet.evaluate(x, y)
        want = np.zeros((10, 10), np.int64)
        np.add.at(want, (y.argmax(1), gnet.output(x).numpy().argmax(1)), 1)
        np.testing.assert_array_equal(e.confusion, want)
        return
    if method == "pretrain":
        # ported (A5's second half): GoogLeNet has no layer with a
        # pretraining loss, so pretraining leaves it as it is
        before = gnet.params_flat()
        assert gnet.pretrain(*args) is gnet
        assert torch.equal(gnet.params_flat(), before)
        return
    x = np.random.default_rng(6).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    if method == "rnn_time_step":
        torch.testing.assert_close(gnet.rnn_time_step(x), gnet.output(x),
                                   rtol=0, atol=0)
        assert gnet._rnn_state == [None] * len(gnet.vertex_names)
    elif method == "rnn_clear_previous_state":
        gnet.rnn_time_step(x)
        assert gnet.rnn_clear_previous_state() is None
        assert gnet._rnn_state is None
    else:
        other = gnet.clone()
        torch.testing.assert_close(other.output(x), gnet.output(x),
                                   rtol=0, atol=0)
        mine = dict(gnet.named_parameters())
        for name, p in other.named_parameters():
            assert torch.equal(p, mine[name])
            assert p.data_ptr() != mine[name].data_ptr()


def test_graph_output_takes_the_train_keyword(gnet):
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    infer = gnet.output(x).numpy()
    np.testing.assert_array_equal(gnet.output(x, train=False).numpy(), infer)
    trained = gnet.output(x, train=True).numpy()   # fc1's dropout is on
    assert trained.shape == infer.shape and np.isfinite(trained).all()
    np.testing.assert_allclose(trained.sum(axis=1), 1.0, atol=1e-5)
    assert not np.array_equal(trained, infer)


# ------------------------------------------------------------------- C2
def test_float64_googlenet_builds_and_differentiates():
    """The float64 GoogLeNet's loss and every gradient equal the JAX
    package's float64 GoogLeNet's (x64 is on in the tests) from the same
    weights, at a float64 tolerance."""
    assert torch_dtype("float64") is torch.float64
    jnet = jgooglenet(**CFG, dtype="float64").init()
    net = googlenet(**CFG, dtype="float64", device="cpu").init(seed=1)
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    assert all(p.dtype == torch.float64 for p in net.parameters())
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 3))
    y = np.eye(10)[[3, 7]]

    def lf(p):
        return jnet.loss_fn(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                            train=False)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(lf))(jnet.params)
    assert jloss.dtype == jnp.float64

    loss = net.loss_fn([torch.from_numpy(x)], [torch.from_numpy(y)],
                       train=False)
    assert loss.dtype == torch.float64
    flat = [(n, k, p) for n, pd in net.param_dicts().items()
            for k, p in pd.items()]
    grads = torch.autograd.grad(loss, [p for _, _, p in flat])
    assert abs(loss.item() - float(jloss)) <= 1e-10 * abs(float(jloss))
    jg = dict(zip(jnet.vertex_names, jgrads))
    assert len(flat) == sum(len(p) for p in jnet.params)
    for (n, k, _), g in zip(flat, grads):
        assert g.dtype == torch.float64
        ref = np.asarray(jg[n][k])
        err = np.abs(g.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300)
        assert err <= 1e-10, (n, k, err)


def test_kernel_probes_refuse_float64():
    for dt in (torch.float32, torch.bfloat16):
        assert fused_attention_applicable(2, 8, 1024, 64, dt)
        assert fused_ring_applicable(2048, 64, dt)
        assert fused_lstm_applicable(32, 512, dt, peepholes=None, mask=None,
                                     reverse=False, activation="tanh",
                                     gate_activation="sigmoid")
        assert conv1x1_bias_relu_applicable((1, 1), (1, 1), (1, 1), (0, 0),
                                            "truncate", True, "relu", 64, 64,
                                            dt)
    f64 = torch.float64
    assert not fused_attention_applicable(2, 8, 1024, 64, f64)
    assert not fused_ring_applicable(2048, 64, f64)
    assert not fused_lstm_applicable(32, 512, f64, peepholes=None, mask=None,
                                     reverse=False, activation="tanh",
                                     gate_activation="sigmoid")
    assert not conv1x1_bias_relu_applicable((1, 1), (1, 1), (1, 1), (0, 0),
                                            "truncate", True, "relu", 64, 64,
                                            f64)


# ------------------------------------------------------------------- C3
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_encode_subtracts_the_shared_update(dtype):
    r = torch.tensor(np.random.default_rng(3).normal(0, 2e-2, 4096)
                     .astype(np.float32)).to(dtype)
    signs, new_r = tk.threshold_encode_plain(r, 1e-2)
    want = r - tk.threshold_update(signs, 1e-2, dtype)
    assert new_r.dtype == dtype
    assert torch.equal(new_r.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_dense_combine_takes_its_update_from_the_op_module(monkeypatch):
    n, sz, t = 4, 96, 1e-2
    rng = np.random.default_rng(4)
    grads = rng.normal(0, 2e-2, (n, sz)).astype(np.float32)
    state = rng.normal(0, 5e-3, (n, sz)).astype(np.float32)
    calls = []

    def counted(*a, **kw):
        calls.append(a[1])
        return tk.threshold_update(*a, **kw)

    monkeypatch.setattr(tacc, "threshold_update", counted)
    tu, tns = tacc.EncodedAccumulator(threshold=t).combine(
        torch.tensor(grads), torch.tensor(state),
        make_mesh((n,), ("data",), "cpu"))
    assert calls == [t] * n

    def worker(g, s):
        u, ns = jacc.EncodedAccumulator(threshold=t).combine(g[0], s[0],
                                                             "data")
        return u[None], ns[None]

    P = jax.sharding.PartitionSpec
    mesh = jmesh.make_mesh((n,), ("data",), jax.devices()[:n])
    ju, jns = jax.jit(jmesh.shard_map(
        worker, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))(
            jnp.asarray(grads), jnp.asarray(state))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))


# ------------------------------------------------------------------- C4
def test_activation_names_equal_the_reference():
    assert tact.activation_names() == jact.activation_names()
    assert len(tact.activation_names()) == 19


def _activation_inputs():
    """Both signs, near 0 and beyond +-20, as [4, 16] f32 (rows for the
    activations over the last axis)."""
    r = np.random.default_rng(11)
    x = np.concatenate([
        r.normal(0, 3, 24), r.normal(0, 1e-3, 8), [0.0, -0.0, 1e-7, -1e-7],
        [-40.0, -25.0, -20.5, -6.0, -3.0, 3.0, 6.0, 20.5, 25.0, 40.0],
        r.uniform(-30, 30, 18)])
    return x.astype(np.float32).reshape(4, 16)


@pytest.mark.parametrize("name", jact.activation_names())
def test_each_activation_equals_the_jax_function(name):
    x = _activation_inputs()
    want = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    got = tact.get_activation(name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_an_unknown_activation_raises_value_error():
    with pytest.raises(ValueError, match="Unknown activation 'swishy'"):
        tact.get_activation("swishy")
    with pytest.raises(ValueError):
        jact.get_activation("swishy")
    assert tact.get_activation("ReLU6") is tact.get_activation("relu6")


def test_register_activation_adds_a_name(monkeypatch):
    monkeypatch.setattr(tact, "_ACTIVATIONS", dict(tact._ACTIVATIONS))
    fn = tact.register_activation("twice")(lambda x: 2 * x)
    assert tact.get_activation("twice") is fn
    assert "twice" in tact.activation_names()


# ------------------------------------------------------------------- C5
_C5 = dict(training_workspace_mode="single",
           inference_workspace_mode="separate", cache_mode="device",
           max_num_line_search_iterations=8)


@pytest.mark.parametrize("conf, layers", [(JConf, jlayers),
                                          (TConf, tlayers)],
                         ids=["reference", "port"])
def test_c5_keywords_build_and_reach_both_configurations(conf, layers):
    nc = conf(seed=3, **_C5)
    assert nc.max_num_line_search_iterations == 8
    dense = lambda: layers.DenseLayer(n_in=4, n_out=3, activation="relu")
    out = lambda: layers.OutputLayer(n_in=3, n_out=2, activation="softmax",
                                     loss="mcxent")
    net_conf = nc.list(dense(), out()).build()
    graph_conf = (nc.graph_builder().add_inputs("in")
                  .add_layer("d", dense(), "in")
                  .add_layer("o", out(), "d").set_outputs("o").build())
    assert net_conf.max_num_line_search_iterations == 8
    assert graph_conf.max_num_line_search_iterations == 8
    assert conf().list(dense(), out()).build() \
        .max_num_line_search_iterations == 5


# ------------------------------------------------ A7b-1 / A8 part 1 raises
def _profile_schedule():
    ov = importlib.import_module("deeplearning4j_tpu_torch.parallel.overlap")
    return ov.profile_schedule(make_mesh((2,), ("data",), "cpu"),
                               ov.build_bucket_schedule([torch.zeros(4)]))


@pytest.mark.parametrize("call, check", [
    (lambda: _dp().ParallelWrapper(_tiny(), mesh_shape=(2, 2)),
     lambda pw: pw.m == 2),
    (_profile_schedule,
     lambda r: len(r["buckets"]) == 1 and r["collective_ms"] >= 0),
    (lambda: importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.zero").ZeroUpdateEngine.from_net(
        _tiny(), make_mesh((2,), ("data",), "cpu")).profile(),
     lambda r: len(r["reduce_scatter"]) >= 1 and len(r["all_gather"]) >= 1
     and r["reduce_scatter_ms"] >= 0 and r["allgather_ms"] >= 0)],
    ids=["model_axis", "profile_schedule", "zero_profile"])
def test_what_the_parallel_slice_leaves_names_its_item(call, check):
    """Nothing that ROADMAP A7b-1 and A8's first part left raises any
    more: since A7b-2 a model axis builds
    (tests/test_torch_tensor_parallel.py), and since A8's part 2b the
    collective profiles run (tests/test_torch_parallel_telemetry.py holds
    their metric and span names to the reference's)."""
    assert check(call())


def _dp():
    return importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.data_parallel")


def _tiny():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = TConf(seed=1).list(
        tlayers.DenseLayer(n_in=3, n_out=4, activation="tanh"),
        tlayers.OutputLayer(n_out=2, activation="softmax")).build()
    return MultiLayerNetwork(conf, device="cpu").init()
