"""The port's conv layers, pooling, LRN, MergeVertex and K7 (the fused 1x1
conv + bias + relu) against the JAX package, on the same numpy inputs and
weights.

Layers: atol 1e-5. K7's plain version against the Pallas kernel run in
interpret mode at the reference's parity shape (atol 1e-5, the reference's
pin) and against ``_conv1x1_xla`` at GoogLeNet's ragged (C, F) pairs; K7's
autograd gradients against ``jax.grad`` at rel-to-max 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.graph.vertices import MergeVertex as JMerge
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import norm as jnorm
from deeplearning4j_tpu.ops.kernels import conv as jk7
from deeplearning4j_tpu_torch.models.zoo_extra import googlenet
from deeplearning4j_tpu_torch.nn.graph.vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import conv as tconv
from deeplearning4j_tpu_torch.nn.layers import norm as tnorm
from deeplearning4j_tpu_torch.ops import nvcc
from deeplearning4j_tpu_torch.ops.kernels import conv as tk7

N, H, W, C = 2, 9, 9, 5


def _x(seed, shape=(N, H, W, C)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel_to_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(jlayer, tlayer, itype=(H, W, C), seed=0):
    """Init the JAX layer, init the port layer and copy the JAX params in."""
    jp, js = jlayer.init(jax.random.PRNGKey(seed),
                         JInputType.convolutional(*itype), jnp.float32)
    tlayer.init_params(InputType.convolutional(*itype), torch.float32,
                       torch.device("cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in jp.items():
            getattr(tlayer, k).copy_(torch.tensor(np.asarray(v)))
    return jp, js


def _run(jlayer, tlayer, x, jp=None, js=None, **kw):
    jy, _ = jlayer.apply(jp or {}, js or {}, jnp.asarray(x), **kw)
    with torch.no_grad():
        ty = tlayer(torch.tensor(x), **kw)
    return np.asarray(jy), ty.numpy()


CONV_CASES = [   # kernel, stride, mode, padding, has_bias, activation
    ((1, 1), (1, 1), "same", (0, 0), True, "relu"),
    ((1, 1), (1, 1), "truncate", (0, 0), True, "relu"),
    ((1, 1), (1, 1), "truncate", (0, 0), False, "relu"),
    ((3, 3), (1, 1), "same", (0, 0), True, "relu"),
    ((5, 5), (1, 1), "same", (0, 0), True, "relu"),
    ((7, 7), (2, 2), "same", (0, 0), True, "relu"),
    ((3, 3), (2, 2), "truncate", (1, 1), True, "tanh"),
    ((3, 2), (1, 2), "truncate", (0, 1), False, "identity"),
]


@pytest.mark.parametrize("k,s,mode,pad,bias,act", CONV_CASES)
def test_convolution_layer_matches_jax(k, s, mode, pad, bias, act):
    kw = dict(n_in=C, n_out=7, kernel_size=k, stride=s, padding=pad,
              convolution_mode=mode, has_bias=bias, activation=act,
              weight_init="relu", bias_init=0.2)
    jl, tl = jconv.ConvolutionLayer(**kw), tconv.ConvolutionLayer(**kw)
    jp, js = _pair(jl, tl)
    assert set(jp) == ({"W", "b"} if bias else {"W"})
    assert tuple(tl.W.shape) == tuple(jp["W"].shape) == (*k, C, 7)
    jy, ty = _run(jl, tl, _x(1), jp, js)
    assert ty.shape == jy.shape
    assert jy.shape[1:] == (tl.output_type(InputType.convolutional(
        H, W, C)).height, tl.output_type(InputType.convolutional(
            H, W, C)).width, 7)
    np.testing.assert_allclose(ty, jy, atol=1e-5)


def test_dilated_same_convolution_matches_jax():
    kw = dict(n_in=C, n_out=4, kernel_size=(3, 3), dilation=(2, 2),
              convolution_mode="same", activation="identity")
    jl, tl = jconv.ConvolutionLayer(**kw), tconv.ConvolutionLayer(**kw)
    jp, js = _pair(jl, tl)
    jy, ty = _run(jl, tl, _x(2), jp, js)
    np.testing.assert_allclose(ty, jy, atol=1e-5)


@pytest.mark.parametrize("size,k,s", [(9, 3, 2), (8, 3, 2), (7, 7, 2),
                                      (5, 1, 1), (224, 7, 2), (112, 3, 2)])
def test_same_padding_is_lax_asymmetric_padding(size, k, s):
    want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert tconv.same_padding(size, k, s) == tuple(want)


POOL_CASES = [   # type, kernel, stride, mode, padding, include_pad
    ("max", (3, 3), (2, 2), "same", (0, 0), True),
    ("max", (3, 3), (1, 1), "same", (0, 0), True),
    ("max", (2, 2), (2, 2), "truncate", (0, 0), True),
    ("max", (3, 3), (2, 2), "truncate", (1, 1), True),
    ("avg", (3, 3), (2, 2), "same", (0, 0), True),
    ("avg", (3, 3), (2, 2), "same", (0, 0), False),
    ("avg", (2, 2), (2, 2), "truncate", (1, 1), True),
    ("sum", (3, 3), (2, 2), "same", (0, 0), True),
    ("sum", (2, 3), (1, 2), "truncate", (0, 0), True),
    ("pnorm", (3, 3), (2, 2), "same", (0, 0), True),
]


@pytest.mark.parametrize("pt,k,s,mode,pad,incl", POOL_CASES)
def test_subsampling_layer_matches_jax(pt, k, s, mode, pad, incl):
    kw = dict(pooling_type=pt, kernel_size=k, stride=s, padding=pad,
              convolution_mode=mode, avg_pool_include_pad_in_divisor=incl)
    jl, tl = jconv.SubsamplingLayer(**kw), tconv.SubsamplingLayer(**kw)
    jy, ty = _run(jl, tl, _x(3))
    it = tl.output_type(InputType.convolutional(H, W, C))
    assert ty.shape == jy.shape == (N, it.height, it.width, C)
    np.testing.assert_allclose(ty, jy, atol=1e-5)


def test_zero_padding_layer_matches_jax():
    for pad in ((1, 2), (0, 1, 2, 3)):
        jl = jconv.ZeroPaddingLayer(padding=pad)
        tl = tconv.ZeroPaddingLayer(padding=pad)
        jy, ty = _run(jl, tl, _x(4))
        np.testing.assert_array_equal(ty, jy)
        it = tl.output_type(InputType.convolutional(H, W, C))
        assert ty.shape == (N, it.height, it.width, C)


@pytest.mark.parametrize("pt", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_jax(pt):
    jl = jconv.GlobalPoolingLayer(pooling_type=pt, pnorm=3)
    tl = tconv.GlobalPoolingLayer(pooling_type=pt, pnorm=3)
    jy, ty = _run(jl, tl, _x(5))
    assert ty.shape == (N, C)
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    # [B,T,F] under a [B,T] mask
    x = _x(6, (3, 6, 4))
    m = (np.arange(6)[None, :] < np.array([6, 3, 1])[:, None]).astype(
        np.float32)
    jy, _ = jl.apply({}, {}, jnp.asarray(x), mask=jnp.asarray(m))
    with torch.no_grad():
        ty = tl(torch.tensor(x), mask=torch.tensor(m))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)


def test_local_response_normalization_matches_jax():
    jl = jnorm.LocalResponseNormalization(n=5, alpha=1e-1, beta=0.75)
    tl = tnorm.LocalResponseNormalization(n=5, alpha=1e-1, beta=0.75)
    x = 3.0 * _x(7, (2, 4, 4, 9))
    jy, ty = _run(jl, tl, x)
    np.testing.assert_allclose(ty, jy, atol=1e-5)
    # the reference's defaults (k 2, n 5, alpha 1e-4, beta 0.75)
    jy, ty = _run(jnorm.LocalResponseNormalization(),
                  tnorm.LocalResponseNormalization(), x)
    np.testing.assert_allclose(ty, jy, atol=1e-5)


def test_merge_vertex_matches_jax():
    xs = [_x(8 + i, (N, 3, 3, c)) for i, c in enumerate((2, 5, 1))]
    jy, _ = JMerge().apply({}, {}, [jnp.asarray(x) for x in xs])
    ty = MergeVertex()([torch.tensor(x) for x in xs])
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    it = [InputType.convolutional(3, 3, c) for c in (2, 5, 1)]
    jit = [JInputType.convolutional(3, 3, c) for c in (2, 5, 1)]
    got, want = MergeVertex().output_type(it), JMerge().output_type(jit)
    assert (got.height, got.width, got.channels) == \
        (want.height, want.width, want.channels) == (3, 3, 8)
    with pytest.raises(ValueError, match="equal spatial dims"):
        MergeVertex().output_type([InputType.convolutional(3, 3, 2),
                                   InputType.convolutional(2, 3, 2)])
    assert MergeVertex().output_type([InputType.feed_forward(3),
                                      InputType.feed_forward(4)]).size == 7


# ------------------------------------------------------------------- K7
def _k7_inputs(seed, M, C_, F_, wscale=0.1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, C_)).astype(np.float32),
            (r.standard_normal((C_, F_)) * wscale).astype(np.float32),
            (r.standard_normal((F_,)) * 0.1).astype(np.float32))


def test_plain_k7_matches_the_pallas_kernel_at_the_parity_shape():
    """The reference's parity shape (ops/kernels/conv.py:152-162): N2 H4
    W4 C128 F128, the Pallas kernel in interpret mode."""
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 4, 4, 128)).astype(np.float32)
    Wt = (r.standard_normal((1, 1, 128, 128)) * 0.1).astype(np.float32)
    b = (r.standard_normal((128,)) * 0.1).astype(np.float32)
    want = np.asarray(jk7.conv1x1_bias_relu(jnp.asarray(x), jnp.asarray(Wt),
                                            jnp.asarray(b)))
    got = tk7.conv1x1_bias_relu(torch.tensor(x), torch.tensor(Wt),
                                torch.tensor(b))
    assert got.shape == (2, 4, 4, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# GoogLeNet's (C, F) pairs of its 1x1 convs, ragged everywhere
GOOGLENET_CF = [(64, 64), (192, 16), (192, 96), (256, 128), (480, 192),
                (512, 24), (528, 256), (832, 48), (832, 384)]


@pytest.mark.parametrize("C_,F_", GOOGLENET_CF)
def test_plain_k7_matches_conv1x1_xla_at_googlenet_shapes(C_, F_):
    x, w, b = _k7_inputs(C_ + F_, 37, C_, F_, wscale=(2.0 / C_) ** 0.5)
    want = np.asarray(jk7._conv1x1_xla(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b)))
    got = tk7._conv1x1_plain(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b)).numpy()
    assert _rel_to_max(got, want) <= 1e-5
    assert (got >= 0).all() and (got == 0).any()


def test_plain_k7_in_bf16_matches_conv1x1_xla():
    x, w, b = _k7_inputs(9, 40, 64, 24)
    bf = jnp.bfloat16
    want = np.asarray(jk7._conv1x1_xla(jnp.asarray(x, bf), jnp.asarray(w, bf),
                                       jnp.asarray(b, bf)).astype(jnp.float32))
    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    got = tk7._conv1x1_plain(tb(x), tb(w), tb(b))
    assert got.dtype == torch.bfloat16
    assert _rel_to_max(got.float().numpy(), want) <= 2e-2


@pytest.mark.parametrize("shape", [(2, 4, 4, 128, 128), (2, 3, 5, 40, 24)])
def test_k7_gradients_match_jax(shape):
    """x, W and b gradients of sum(y * g) through the port's autograd
    Function and jax.grad through the reference's custom_vjp (Pallas
    forward in interpret mode where its tiling admits the shape, else
    autodiff of the XLA recipe)."""
    n, h, w_, c, f = shape
    r = np.random.default_rng(sum(shape))
    x = r.standard_normal((n, h, w_, c)).astype(np.float32)
    Wt = (r.standard_normal((1, 1, c, f)) * 0.1).astype(np.float32)
    b = (r.standard_normal((f,)) * 0.1).astype(np.float32)
    g = r.standard_normal((n, h, w_, f)).astype(np.float32)
    if c % 128 == 0 and f % 128 == 0:
        jfn = jk7.conv1x1_bias_relu
    else:
        def jfn(x_, W_, b_):
            return jk7._conv1x1_xla(x_.reshape(-1, c), W_.reshape(c, f),
                                    b_).reshape(n, h, w_, f)

    def loss(x_, W_, b_):
        return jnp.sum(jfn(x_, W_, b_) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(Wt),
                                             jnp.asarray(b))
    tx, tW, tb = (torch.tensor(a, requires_grad=True) for a in (x, Wt, b))
    y = tk7.conv1x1_bias_relu(tx, tW, tb)
    assert y.grad_fn is not None
    (y * torch.tensor(g)).sum().backward()
    for got, w in zip((tx.grad, tW.grad, tb.grad), want):
        assert got.shape == w.shape
        assert _rel_to_max(got.numpy(), np.asarray(w)) <= 1e-5


def test_probe_admits_all_37_googlenet_1x1_convs():
    net = googlenet(n_classes=10, height=32, width=32, device="cpu")
    conf = net.conf
    itypes = dict(zip(conf.network_inputs, conf.input_types))
    admitted = []
    for name in conf.vertex_names:
        v = conf.vertices[name]
        it = [itypes[i] for i in conf.vertex_inputs[name]]
        itypes[name] = v.output_type(it)
        layer = getattr(v, "layer", None)
        if isinstance(layer, tconv.ConvolutionLayer) and \
                tuple(layer.kernel_size) == (1, 1):
            assert tk7.conv1x1_bias_relu_applicable(
                layer.kernel_size, layer.stride, layer.dilation,
                layer.padding, layer.convolution_mode, layer.has_bias,
                layer.activation, it[0].channels, layer.n_out, torch.float32)
            admitted.append(name)
    assert len(admitted) == 37
    # the TPU probe's tiling (C % 128, F % 128) admits only four of them
    tpu = [n for n in admitted
           if conf.vertices[n].layer.n_in % 128 == 0
           and conf.vertices[n].layer.n_out % 128 == 0]
    assert sorted(tpu) == ["3b-cnn1", "3b-cnn2", "4c-cnn1", "4c-cnn2"]


@pytest.mark.parametrize("kw,ok", [
    (dict(), True),
    (dict(kernel_size=(3, 3)), False),
    (dict(stride=(2, 2)), False),
    (dict(dilation=(2, 1)), False),
    (dict(mode="truncate", padding=(1, 0)), False),
    (dict(mode="truncate"), True),
    (dict(has_bias=False), False),
    (dict(activation="tanh"), False),
    (dict(dtype=torch.bfloat16, C=3, F=1000), True),
    (dict(dtype=torch.float16), False),
])
def test_probe_states_what_k7_takes(kw, ok):
    args = dict(kernel_size=(1, 1), stride=(1, 1), dilation=(1, 1),
                padding=(0, 0), mode="same", has_bias=True, activation="relu",
                C=832, F=48, dtype=torch.float32)
    args.update(kw)
    assert tk7.conv1x1_bias_relu_applicable(*args.values()) is ok


def test_layer_takes_k7_exactly_when_the_probe_admits(monkeypatch):
    calls = []
    real = tconv.conv1x1_bias_relu
    monkeypatch.setattr(tconv, "conv1x1_bias_relu",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.tensor(_x(11))
    for kw, fused in ((dict(kernel_size=(1, 1), activation="relu"), True),
                      (dict(kernel_size=(1, 1), activation="tanh"), False),
                      (dict(kernel_size=(3, 3), activation="relu"), False)):
        layer = tconv.ConvolutionLayer(n_in=C, n_out=6, bias_init=0.1,
                                       convolution_mode="same", **kw)
        layer.init_params(None, torch.float32, torch.device("cpu"),
                          torch.Generator().manual_seed(1))
        calls.clear()
        with torch.no_grad():
            y = layer(x)
            stock = layer.act(layer.pre_output(x))
        assert bool(calls) is fused
        np.testing.assert_allclose(y.numpy(), stock.numpy(), atol=1e-5)


def test_k7_wrapper_checks_and_counts(monkeypatch):
    x, w, b = (torch.tensor(a) for a in _k7_inputs(12, 8, 4, 3))
    before = tk7.conv1x1_fused.launches
    tk7.conv1x1_fused(x, w, b)          # CPU: the plain version, no launch
    assert tk7.conv1x1_fused.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk7.conv1x1_fused(x.to("meta"), w.to("meta"), b.to("meta"))
    tag = nvcc.library_path(tk7.SOURCE).name
    assert tag.startswith("libconv1x1_bias_relu_") and tag.endswith(".so")
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(nvcc, "library_path",
                        lambda source: nvcc.BUILD_DIR / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk7.build()


def test_k7_roofline_is_the_references():
    assert tk7.roofline(6272, 528, 256) == jk7.roofline("6272x528x256")
    flops, nbytes = tk7.roofline(10, 4, 3, itemsize=2)
    assert (flops, nbytes) == (240.0, 2.0 * (40 + 12 + 3 + 30))


@pytest.mark.cuda
def test_k7_on_the_card_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the wrapper computes its "
                    "plain version")
    x, w, b = (torch.tensor(a).cuda() for a in _k7_inputs(13, 1000, 100, 50))
    got = tk7.conv1x1_fused(x, w, b)
    want = tk7._conv1x1_plain(x, w, b)
    assert _rel_to_max(got.cpu().numpy(), want.cpu().numpy()) <= 1e-5


def test_one_d_layers_name_their_roadmap_item():
    """Their item, A5, is done: each builds and runs (its parity with the
    JAX package is ``tests/test_torch_conv1d.py``)."""
    x = torch.zeros(2, 6, 3)
    for layer in (tconv.Convolution1DLayer(n_out=4),
                  tconv.Subsampling1DLayer(), tconv.ZeroPadding1DLayer(1)):
        layer.init_params(InputType.recurrent(3, 6), torch.float32,
                          torch.device("cpu"), torch.Generator())
        it = layer.output_type(InputType.recurrent(3, 6))
        assert tuple(layer(x).shape) == (2, it.timestep_length, it.size)
