"""Port's layers, activations, vertices and initializers against the JAX
package's: the same numpy parameters and inputs through each JAX layer's
``apply`` and the port's module, at atol 1e-5."""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.graph.vertices import ElementWiseVertex as JEW
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.graph.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import (NormalDistribution,
                                                 UniformDistribution,
                                                 init_weights)

ATOL = 1e-5
R = np.random.default_rng(5)


def _params(shapes, scale=0.3):
    return {k: (scale * R.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}


def _port(layer, itype, params):
    """Initialize the port's layer, check it has exactly the reference's
    parameter names and shapes, and copy ``params`` in."""
    layer.init_params(itype, torch.float32, torch.device("cpu"),
                      torch.Generator().manual_seed(0))
    own = layer.param_dict()
    assert set(own) == set(params)
    with torch.no_grad():
        for k, p in own.items():
            assert tuple(p.shape) == params[k].shape, k
            p.copy_(torch.from_numpy(params[k]))
    return layer


def _jax_apply(layer, params, x, **kw):
    out, _ = layer.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                         jnp.asarray(x), **kw)
    return np.asarray(out)


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(port_out.detach().numpy(), jax_out, atol=atol)


@pytest.mark.parametrize("name", ["identity", "gelu", "softmax"])
def test_activations_match(name):
    x = (3 * R.normal(size=(4, 7))).astype(np.float32)
    _close(tact.get_activation(name)(torch.from_numpy(x)),
           np.asarray(jact.get_activation(name)(jnp.asarray(x))))


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    assert torch.allclose(tact.get_activation("gelu")(x),
                          torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.allclose(tact.get_activation("gelu")(x),
                              torch.nn.functional.gelu(x), atol=1e-5)
    with pytest.raises(ValueError, match="available"):
        tact.get_activation("nope")


def test_layer_normalization_matches():
    x = (2 * R.normal(size=(2, 5, 16)) + 1.5).astype(np.float32)
    p = {"gain": (1 + 0.2 * R.normal(size=16)).astype(np.float32),
         "bias": (0.2 * R.normal(size=16)).astype(np.float32)}
    port = _port(tl.LayerNormalization(n_out=16, activation="identity"),
                 InputType.recurrent(16, 5), p)
    _close(port(torch.from_numpy(x)),
           _jax_apply(jl.LayerNormalization(n_out=16, activation="identity"),
                      p, x))


def test_dense_matches_on_recurrent_input():
    x = R.normal(size=(2, 5, 16)).astype(np.float32)
    p = _params({"W": (16, 24), "b": (24,)})
    port = _port(tl.DenseLayer(n_in=16, n_out=24, activation="gelu"),
                 InputType.recurrent(16, 5), p)
    _close(port(torch.from_numpy(x)),
           _jax_apply(jl.DenseLayer(n_in=16, n_out=24, activation="gelu"),
                      p, x))


@pytest.mark.parametrize("trailing_one", [False, True])
def test_embedding_sequence_matches(trailing_one):
    ids = R.integers(0, 11, size=(2, 6)).astype(np.int32)
    if trailing_one:
        ids = ids[..., None]
    p = _params({"W": (11, 8)})
    port = _port(tl.EmbeddingSequenceLayer(n_in=11, n_out=8,
                                           activation="identity"),
                 InputType.recurrent(1, 6), p)
    _close(port(torch.from_numpy(ids)),
           _jax_apply(jl.EmbeddingSequenceLayer(n_in=11, n_out=8,
                                                activation="identity"),
                      p, ids))


def test_positional_embedding_matches_and_bounds_length():
    x = R.normal(size=(2, 6, 8)).astype(np.float32)
    p = _params({"P": (10, 8)})
    port = _port(tl.PositionalEmbeddingLayer(n_out=8, max_length=10,
                                             activation="identity"),
                 InputType.recurrent(8, 6), p)
    _close(port(torch.from_numpy(x)),
           _jax_apply(jl.PositionalEmbeddingLayer(n_out=8, max_length=10,
                                                  activation="identity"),
                      p, x))
    with pytest.raises(ValueError, match="max_length"):
        port(torch.zeros((1, 11, 8)))


def test_rnn_output_matches():
    x = R.normal(size=(2, 5, 16)).astype(np.float32)
    p = _params({"W": (16, 9), "b": (9,)})
    port = _port(tl.RnnOutputLayer(n_in=16, n_out=9, activation="softmax"),
                 InputType.recurrent(16, 5), p)
    jlayer = jl.RnnOutputLayer(n_in=16, n_out=9, activation="softmax")
    _close(port(torch.from_numpy(x)), _jax_apply(jlayer, p, x))
    jpre = np.asarray(jlayer.pre_output({k: jnp.asarray(v)
                                         for k, v in p.items()},
                                        jnp.asarray(x)))
    _close(port.pre_output(torch.from_numpy(x)), jpre)


@pytest.mark.parametrize("T,n_out,causal,masked", [
    (8, 16, False, False), (8, 16, True, False), (8, 16, False, True),
    (8, 16, True, True),
    # head dim 64 at T=256: the JAX layer takes its Pallas kernel
    # (interpret mode), the port's probe admits the same shapes
    (256, 128, True, False)])
def test_self_attention_matches(T, n_out, causal, masked):
    n_in = 12
    x = R.normal(size=(2, T, n_in)).astype(np.float32)
    p = _params({"Wq": (n_in, n_out), "Wk": (n_in, n_out),
                 "Wv": (n_in, n_out), "Wo": (n_out, n_out), "b": (n_out,)})
    mask = None
    if masked:
        mask = (R.random((2, T)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
    kw = dict(n_in=n_in, n_out=n_out, n_heads=2, causal=causal,
              activation="identity")
    port = _port(tl.SelfAttentionLayer(**kw), InputType.recurrent(n_in, T), p)
    ours = port(torch.from_numpy(x),
                mask=None if mask is None else torch.from_numpy(mask))
    ref = _jax_apply(jl.SelfAttentionLayer(**kw), p, x,
                     **({} if mask is None else {"mask": jnp.asarray(mask)}))
    _close(ours, ref)


def test_self_attention_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="divisible"):
        tl.SelfAttentionLayer(n_in=8, n_out=10, n_heads=4).init_params(
            InputType.recurrent(8, 4), torch.float32, torch.device("cpu"),
            torch.Generator())


@pytest.mark.parametrize("n_inputs", [2, 3])
def test_elementwise_add_vertex_matches(n_inputs):
    xs = [R.normal(size=(2, 3, 4)).astype(np.float32) for _ in range(n_inputs)]
    ours = ElementWiseVertex("add")([torch.from_numpy(a) for a in xs])
    ref, _ = JEW("add").apply({}, {}, [jnp.asarray(a) for a in xs])
    _close(ours, np.asarray(ref))


def test_elementwise_vertex_refuses_ops_not_ported():
    with pytest.raises(ValueError, match="not ported"):
        ElementWiseVertex("max")
    it = InputType.recurrent(4, 3)
    with pytest.raises(ValueError, match="same-shaped"):
        ElementWiseVertex("add").output_type([it, InputType.recurrent(5, 3)])


@pytest.mark.parametrize("scheme,fan_in,fan_out,std", [
    ("relu", 400, 100, (2 / 400) ** 0.5),
    ("xavier", 300, 100, (2 / 400) ** 0.5),
    ("xavier_uniform", 300, 100, (6 / 400) ** 0.5 / 3 ** 0.5),
    ("lecun_normal", 400, 100, 400 ** -0.5)])
def test_init_weights_scale_and_seeding(scheme, fan_in, fan_out, std):
    w = init_weights(torch.Generator().manual_seed(1), (400, 100), scheme,
                     fan_in, fan_out)
    assert abs(float(w.std()) / std - 1) < 0.03
    again = init_weights(torch.Generator().manual_seed(1), (400, 100),
                         scheme, fan_in, fan_out)
    assert torch.equal(w, again)


def test_init_weights_distributions_and_errors():
    g = torch.Generator().manual_seed(2)
    w = init_weights(g, (200, 200), "distribution", 1, 1,
                     distribution=NormalDistribution(1.0, 0.5))
    assert abs(float(w.mean()) - 1.0) < 0.02 and abs(float(w.std()) - 0.5) < 0.02
    u = init_weights(g, (200, 200), "distribution", 1, 1,
                     distribution=UniformDistribution(2.0, 3.0))
    assert float(u.min()) >= 2.0 and float(u.max()) < 3.0
    assert torch.equal(init_weights(g, (3,), "zero", 1, 1), torch.zeros(3))
    with pytest.raises(ValueError, match="distribution"):
        init_weights(g, (3,), "distribution", 1, 1)
    with pytest.raises(ValueError, match="Unknown weight init"):
        init_weights(g, (3,), "bogus", 1, 1)
