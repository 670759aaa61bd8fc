"""The port's DropoutLayer, EmbeddingLayer, LossLayer and AutoEncoder
(``nn/layers/core.py``) and ``BinomialDistribution`` (``nn/weights.py``)
against the JAX package on the same seeded inputs and weights.

Dropout is the identity outside training and draws its mask through the
tape (a replay gives the same output). The embedding takes [B], [B,1] and
float ids, forward and gradient at 1e-6 (f32). A LossLayer network's loss
and gradients match for each loss the reference's gradient checks use,
at rel 1e-5 / rel-to-max 1e-4. The AutoEncoder's encode matches, and its
pretraining loss on the JAX package's own corruption mask (drawn with the
reference's key handling) matches at atol 1e-6, its gradients at
rel-to-max 1e-4. The binomial init has the right shape, support and
mean."""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.weights import BinomialDistribution as JBinomial
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.tape import dropout_masks
from deeplearning4j_tpu_torch.nn.weights import (BinomialDistribution,
                                                 init_weights)

R = np.random.default_rng(31)


def _np(tree, dtype=np.float32):
    return [{k: np.asarray(v, dtype) for k, v in p.items()} for p in tree]


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _pair(make_layers, dtype="float32", **conf):
    jnet = JMLN(JConf(seed=5, dtype=dtype, **conf).list(
        *make_layers(jl)).build()).init()
    pnet = MultiLayerNetwork(NeuralNetConfiguration(
        seed=5, dtype=dtype, **conf).list(*make_layers(tl)).build(),
        device="cpu").init()
    load_jax_params(pnet, _np(jnet.params, np.dtype(dtype)))
    return jnet, pnet


def _grads_vs(jnet, pnet, x, y, lmask=None):
    """(loss rel, worst gradient rel-to-max) of the two networks' losses."""
    def jloss(p):
        return jnet.loss_fn(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                            train=False, labels_mask=None if lmask is None
                            else jnp.asarray(lmask))[0]
    jl_, jg = jax.value_and_grad(jloss)(jnet.params)
    tl_ = pnet.loss_fn(torch.as_tensor(x), torch.as_tensor(y), train=False,
                       labels_mask=None if lmask is None
                       else torch.as_tensor(lmask))
    params = pnet.param_dicts()
    names = [(i, k) for i, d in params.items() for k in d]
    tg = torch.autograd.grad(tl_, [params[i][k] for i, k in names])
    worst = max(_rel_to_max(g.numpy(), jg[i][k]) for (i, k), g in
                zip(names, tg))
    return abs(float(tl_.detach()) - float(jl_)) / abs(float(jl_)), worst


# ------------------------------------------------------------------ dropout
def test_dropout_layer_is_the_identity_outside_training():
    layer = tl.DropoutLayer(dropout=0.6)
    x = torch.as_tensor(R.normal(size=(4, 5, 3)).astype(np.float32))
    assert torch.equal(layer(x, train=False), x)
    assert tl.DropoutLayer.expected_input == jl.DropoutLayer.expected_input


def test_dropout_layer_trains_through_the_tape():
    layer = tl.DropoutLayer(dropout=0.6)
    x = torch.ones(200, 50)
    gen = torch.Generator().manual_seed(3)
    masks = []
    with dropout_masks(masks, replay=False):
        a = layer(x, train=True, gen=gen)
    assert len(masks) == 1
    with dropout_masks(masks, replay=True):
        b = layer(x, train=True, gen=torch.Generator().manual_seed(99))
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.6) < 0.02
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0],
                                                          1 / 0.6))


# ---------------------------------------------------------------- embedding
@pytest.mark.parametrize("ids", ["flat", "column", "float"])
def test_embedding_layer_matches_jax(ids):
    jnet, pnet = _pair(lambda L: [
        L.EmbeddingLayer(n_in=9, n_out=5, activation="tanh"),
        L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")])
    idx = R.integers(0, 9, 12)
    x = {"flat": idx, "column": idx[:, None],
         "float": idx[:, None].astype(np.float32)}[ids]
    y = np.eye(3, dtype=np.float32)[R.integers(0, 3, 12)]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    loss_rel, grad_rel = _grads_vs(jnet, pnet, x, y)
    assert loss_rel <= 1e-6 and grad_rel <= 1e-6


# --------------------------------------------------------------- loss layer
_LOSSES = [("mcxent", "softmax"), ("mse", "identity"), ("mse", "tanh"),
           ("xent", "sigmoid"), ("l1", "identity"), ("l2", "tanh"),
           ("hinge", "identity"), ("squared_hinge", "identity"),
           ("poisson", "softplus"), ("mean_absolute_error", "identity"),
           ("kl_divergence", "sigmoid"), ("cosine_proximity", "identity")]


@pytest.mark.parametrize("loss,act", _LOSSES,
                         ids=[f"{a}-{b}" for a, b in _LOSSES])
def test_loss_layer_matches_jax(loss, act):
    """The losses of the reference's gradient checks
    (``tests/test_gradient_checks.py``), on a LossLayer after a Dense
    layer, with a labels mask for mcxent as the reference's check has."""
    jnet, pnet = _pair(lambda L: [
        L.DenseLayer(n_in=4, n_out=3, activation="tanh"),
        L.LossLayer(loss=loss, activation=act)])
    x = R.normal(size=(8, 4)).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[R.integers(0, 3, 8)]
    if loss in ("hinge", "squared_hinge"):
        y = 2 * onehot - 1
    elif loss == "kl_divergence":
        y = np.clip(onehot, 0.05, 0.9)
        y = (y / y.sum(-1, keepdims=True)).astype(np.float32)
    elif loss in ("mcxent", "xent"):
        y = onehot
    elif loss == "poisson":
        y = R.poisson(3.0, size=(8, 3)).astype(np.float32)
    else:
        y = R.normal(size=(8, 3)).astype(np.float32)
    lmask = None
    if loss == "mcxent":
        lmask = np.ones(8, np.float32)
        lmask[5:] = 0
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    loss_rel, grad_rel = _grads_vs(jnet, pnet, x, y, lmask)
    assert loss_rel <= 1e-5 and grad_rel <= 1e-4


# -------------------------------------------------------------- autoencoder
def _ae_pair():
    return _pair(lambda L: [
        L.AutoEncoder(n_in=7, n_out=4, corruption_level=0.3,
                      activation="sigmoid", loss="xent"),
        L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")])


def test_autoencoder_encode_matches_jax():
    jnet, pnet = _ae_pair()
    x = R.random((6, 7)).astype(np.float32)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    jlay, play = jnet.layers[0], pnet.layers[0]
    h = np.array(jlay.encode(jnet.params[0], jnp.asarray(x)))
    np.testing.assert_allclose(play.encode(torch.as_tensor(x))
                               .detach().numpy(), h, atol=1e-6)
    np.testing.assert_allclose(
        play.decode(torch.as_tensor(h)).detach().numpy(),
        np.asarray(jlay.decode(jnet.params[0], jnp.asarray(h))), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoencoder_pretrain_loss_on_the_jax_noise(seed):
    jnet, pnet = _ae_pair()
    jlay, play = jnet.layers[0], pnet.layers[0]
    x = R.random((6, 7)).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    # the reference's corruption (core.py:282-283), its noise drawn here
    corrupt_rng, _ = jax.random.split(rng)
    keep = np.asarray(jax.random.bernoulli(
        corrupt_rng, 1.0 - jlay.corruption_level, x.shape))
    jloss, jg = jax.value_and_grad(
        lambda p: jlay.pretrain_loss(p, jnp.asarray(x), rng))(jnet.params[0])
    tloss = play.pretrain_loss_given(torch.as_tensor(x),
                                     torch.as_tensor(keep.copy()))
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-6
    params = play.param_dict()
    tg = torch.autograd.grad(tloss, [params[k] for k in play.param_order])
    for k, g in zip(play.param_order, tg):
        assert _rel_to_max(g.numpy(), jg[k]) <= 1e-4, k


def test_autoencoder_corruption_draw():
    play = tl.AutoEncoder(n_in=50, n_out=4, corruption_level=0.3)
    x = torch.ones(400, 50)
    keep = play.pretrain_noise(x, torch.Generator().manual_seed(1))
    assert keep.dtype == torch.bool and keep.shape == x.shape
    assert abs(keep.float().mean().item() - 0.7) < 0.01


# ----------------------------------------------------------------- binomial
def test_binomial_distribution_init():
    dist = BinomialDistribution(trials=6, p=0.25)
    w = init_weights(torch.Generator().manual_seed(4), (200, 300),
                     "distribution", 200, 300, torch.float64,
                     distribution=dist)
    assert w.shape == (200, 300) and w.dtype == torch.float64
    vals = set(np.unique(w.numpy()).tolist())
    assert vals <= set(range(7)) and len(vals) >= 5
    assert abs(w.mean().item() - 6 * 0.25) < 0.02
    assert abs(w.var().item() - 6 * 0.25 * 0.75) < 0.05
    # the reference's sampler has the same support and moments
    jw = np.asarray(JBinomial(trials=6, p=0.25).sample(
        jax.random.PRNGKey(0), (200, 300), jnp.float64))
    assert abs(jw.mean() - w.mean().item()) < 0.03
