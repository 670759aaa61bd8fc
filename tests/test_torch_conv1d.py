"""The port's 1-D layers (``nn/layers/conv.py``: ``Convolution1DLayer``,
``Subsampling1DLayer``, ``ZeroPadding1DLayer``) against the JAX package on
the same seeded inputs and weights.

The convolution in every ``convolution_mode`` with strides and dilations
(its output and the gradients of a weighted sum with respect to the input,
``W`` and ``b``, at 1e-5 in f32); every pooling type in every mode,
including "same" average pooling that leaves the padding out of the
divisor; every padding form; the output length each layer's
``output_type`` gives; and a graph of them whose [B,T] mask a strided
conv drops before an LSTM and a ``LastTimeStepVertex``, in both packages.
In a graph the ``GlobalPoolingLayer`` takes no mask, as the reference's
takes none (its layer does not ``accepts_mask``)."""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import vertices as jv
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.inputs import InputType as JIT
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import vertices as tv
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType

R = np.random.default_rng(21)


def _layer_pair(name, T, F, **kw):
    jlay, tlay = getattr(jl, name)(**kw), getattr(tl, name)(**kw)
    params, _ = jlay.init(jax.random.PRNGKey(1), JIT.recurrent(F, T),
                          jnp.float32)
    tlay.init_params(InputType.recurrent(F, T), torch.float32,
                     torch.device("cpu"), torch.Generator())
    with torch.no_grad():
        for k, v in params.items():
            getattr(tlay, k).copy_(torch.as_tensor(np.array(v)))
    return jlay, tlay, params


def _check(jlay, tlay, params, x, atol=1e-5):
    jout, _ = jlay.apply(params, {}, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tout = tlay(tx)
    assert tuple(tout.shape) == np.asarray(jout).shape
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=atol)
    t_len = jlay.output_type(JIT.recurrent(x.shape[2], x.shape[1]))
    assert tlay.output_type(InputType.recurrent(
        x.shape[2], x.shape[1])).timestep_length == t_len.timestep_length
    w = R.normal(size=tout.shape).astype(np.float32)
    jgx, jgp = jax.grad(lambda xx, p: jnp.sum(jlay.apply(p, {}, xx)[0] * w),
                        argnums=(0, 1))(jnp.asarray(x), params)
    names = sorted(params)
    tg = torch.autograd.grad((tout * torch.as_tensor(w)).sum(),
                             [tx] + [getattr(tlay, k) for k in names])
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jgx), atol=atol)
    for k, g in zip(names, tg[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[k]), atol=atol,
                                   err_msg=k)
    return tout


_CONV = [(mode, k, s, d) for mode in ("same", "truncate", "strict")
         for k, s, d in ((3, 1, 1), (3, 2, 1), (2, 2, 1), (3, 1, 2),
                         (5, 3, 2))]


@pytest.mark.parametrize("mode,k,s,d", _CONV,
                         ids=[f"{m}-k{k}s{s}d{d}" for m, k, s, d in _CONV])
def test_convolution1d_matches_jax(mode, k, s, d):
    jlay, tlay, params = _layer_pair(
        "Convolution1DLayer", 11, 4, n_in=4, n_out=6, kernel_size=k,
        stride=s, padding=1, convolution_mode=mode, dilation=d,
        activation="tanh")
    _check(jlay, tlay, params, R.normal(size=(3, 11, 4)).astype(np.float32))


_POOL = [(pt, mode, k, s, inc) for pt in ("max", "avg", "sum", "pnorm")
         for mode, k, s in (("truncate", 2, 2), ("same", 3, 2),
                            ("truncate", 3, 1), ("same", 2, 1))
         for inc in ((True, False) if pt == "avg" and mode == "same"
                     else (True,))]


@pytest.mark.parametrize("pt,mode,k,s,inc", _POOL,
                         ids=[f"{p}-{m}-k{k}s{s}-{i}"
                              for p, m, k, s, i in _POOL])
def test_subsampling1d_matches_jax(pt, mode, k, s, inc):
    jlay, tlay, params = _layer_pair(
        "Subsampling1DLayer", 9, 5, pooling_type=pt, kernel_size=k,
        stride=s, padding=1 if mode == "truncate" else 0,
        convolution_mode=mode, pnorm=3, avg_pool_include_pad_in_divisor=inc)
    x = R.normal(size=(2, 9, 5)).astype(np.float32)
    if pt == "pnorm":
        x = np.abs(x) + 0.1        # away from |x|'s kink at 0
    _check(jlay, tlay, params, x)


@pytest.mark.parametrize("padding", [2, (1, 3), (2,), (0, 0)],
                         ids=["int", "pair", "one", "none"])
def test_zero_padding1d_matches_jax(padding):
    jlay, tlay, params = _layer_pair("ZeroPadding1DLayer", 6, 3,
                                     padding=padding)
    _check(jlay, tlay, params, R.normal(size=(2, 6, 3)).astype(np.float32),
           atol=0)


def _conv_graph(pkg, stride, head="lstm"):
    L, V, C, IT, G = ((jl, jv, JConf, JIT, JCG) if pkg == "jax" else
                      (tl, tv, NeuralNetConfiguration, InputType,
                       ComputationGraph))
    g = (C(seed=4, activation="tanh").graph_builder().add_inputs("in")
         .add_layer("conv", L.Convolution1DLayer(
             n_out=6, kernel_size=3, stride=stride,
             convolution_mode="same"), "in")
         .add_layer("pool", L.Subsampling1DLayer(
             pooling_type="max", kernel_size=2, stride=1,
             convolution_mode="same"), "conv"))
    if head == "lstm":
        g.add_layer("lstm", L.GravesLSTM(n_out=5), "pool")
        g.add_vertex("last", V.LastTimeStepVertex(), "lstm")
    else:
        g.add_layer("last", L.GlobalPoolingLayer(pooling_type="avg"), "pool")
    g.add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"), "last")
    conf = g.set_outputs("out").set_input_types(IT.recurrent(4, 10)).build()
    return (G(conf) if pkg == "jax" else G(conf, device="cpu")).init()


def _masked_acts(stride, head):
    jnet = _conv_graph("jax", stride, head)
    pnet = _conv_graph("torch", stride, head)
    load_jax_params(pnet, [{k: np.asarray(v, np.float32)
                            for k, v in p.items()} for p in jnet.params])
    x = R.normal(size=(3, 10, 4)).astype(np.float32)
    lens = np.array([4, 10, 7])
    mask = (np.arange(10)[None] < lens[:, None]).astype(np.float32)
    jacts, _ = jnet.apply_fn(jnet.params, jnet.state, [jnp.asarray(x)],
                             features_masks=[jnp.asarray(mask)])
    tacts = pnet.apply_fn([torch.as_tensor(x)],
                          features_masks=[torch.as_tensor(mask)])
    for name in tacts:
        np.testing.assert_allclose(tacts[name].detach().numpy(),
                                   np.asarray(jacts[name]), atol=1e-5,
                                   err_msg=name)
    return {k: v.detach().numpy() for k, v in tacts.items()}, lens


@pytest.mark.parametrize("stride", [1, 2])
def test_a_strided_conv_drops_the_mask_as_jax_does(stride):
    """At stride 1 the [B,T] mask flows through the conv and the pooling to
    the LSTM and ``LastTimeStepVertex`` (each sequence's last real step);
    at stride 2 the conv halves T, the mask is dropped, and the vertex
    takes the literal last step."""
    acts, lens = _masked_acts(stride, "lstm")
    want = (acts["lstm"][:, -1] if stride == 2
            else acts["lstm"][np.arange(3), lens - 1])
    np.testing.assert_array_equal(acts["last"], want)


def test_global_pooling_in_a_graph_takes_no_mask_as_jax():
    """The reference's executors hand a mask only to a layer that
    ``accepts_mask``, which its ``GlobalPoolingLayer`` does not: in a graph
    it pools every step, masked input or not."""
    acts, _ = _masked_acts(1, "glob")
    np.testing.assert_allclose(acts["last"], acts["pool"].mean(1),
                               atol=1e-6)
    assert not getattr(tl.GlobalPoolingLayer, "accepts_mask", False)
