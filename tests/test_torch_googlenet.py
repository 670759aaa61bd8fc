"""GoogLeNet end to end: the port's ``googlenet`` ComputationGraph against the
JAX package's, with the JAX weights carried across by
``load_jax_params``.

The architecture is the zoo's (nine inception modules, 1000-class head
narrowed to 10); only the input is small (32x32x3, B 2). The JAX side runs
eagerly with its K7 Pallas kernel opted into interpret mode (it takes the
four 1x1 convs whose C and F are multiples of 128); the port's 37 1x1 convs
take K7's plain version. Every vertex's activation agrees at rel-to-max
1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo_extra import googlenet as jgooglenet
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import googlenet
from deeplearning4j_tpu_torch.nn.layers import conv as tconv

CFG = dict(n_classes=10, height=32, width=32)


@pytest.fixture(scope="module")
def nets():
    jnet = jgooglenet(**CFG).init()
    pnet = googlenet(**CFG, device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def _rel_to_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_vertices_and_parameters_match_jax_vertex_by_vertex(nets):
    jnet, pnet = nets
    assert pnet.vertex_names == list(jnet.vertex_names)
    assert len(pnet.vertex_names) == 1 + 1 + 1 + 1 + 1 + 1 + 1 + 9 * 8 + 1 \
        + 1 + 3
    for name, jp in zip(jnet.vertex_names, jnet.params):
        tp = pnet.vertices[name].param_dict()
        assert sorted(tp) == sorted(jp), name
        for k in jp:
            assert tuple(tp[k].shape) == tuple(jp[k].shape), (name, k)
    assert pnet.num_params() == sum(int(np.prod(v.shape)) for p in jnet.params
                                    for v in p.values())


def test_init_follows_the_zoo_recipe():
    net = googlenet(**CFG, device="cpu").init(seed=3)
    cnn1 = net.vertices["cnn1"].layer
    assert tuple(cnn1.W.shape) == (7, 7, 3, 64)
    assert torch.all(cnn1.b == 0.2)                 # bias_init 0.2
    std = float(cnn1.W.detach().std())
    assert abs(std - (2.0 / (7 * 7 * 3)) ** 0.5) < 0.1 * std   # relu init
    assert net.vertices["output"].layer.weight_init == "xavier"
    assert net.vertices["fc1"].layer.dropout == 0.4
    assert net.conf.updater.learning_rate == 1e-2
    assert all(v.layer.l2 == 2e-4 for v in net.vertices.values()
               if hasattr(v, "layer"))


def test_every_vertex_matches_jax_feed_forward(nets, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_KERNEL_CONV1X1_BIAS_RELU_INTERPRET", "1")
    jnet, pnet = nets
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = jnet.feed_forward(jnp.asarray(x))
    got = pnet.feed_forward(x)
    assert set(got) == set(want)
    for name in pnet.vertex_names:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert g.shape == w.shape, name
        assert _rel_to_max(g, w) <= 1e-5, (name, _rel_to_max(g, w))
    out = got["output"].numpy()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pnet.output(x).numpy(), out, atol=0)


def test_the_37_pointwise_convs_take_k7(nets, monkeypatch):
    _, pnet = nets
    calls = []
    real = tconv.conv1x1_bias_relu
    monkeypatch.setattr(tconv, "conv1x1_bias_relu",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    pnet.output(np.zeros((1, 32, 32, 3), np.float32))
    assert len(calls) == 37


def test_graph_output_types_follow_the_reference(nets):
    jnet, pnet = nets
    conf = pnet.conf
    itypes = dict(zip(conf.network_inputs, conf.input_types))
    for name in conf.vertex_names:
        itypes[name] = conf.vertices[name].output_type(
            [itypes[i] for i in conf.vertex_inputs[name]])
    assert (itypes["5b-depthconcat1"].height, itypes["5b-depthconcat1"].width,
            itypes["5b-depthconcat1"].channels) == (1, 1, 1024)
    assert conf.vertices["fc1"].layer.n_in == 1024
    assert conf.vertices["3a-cnn1"].layer.n_in == 192
