"""The port's VAE, RBM and reconstruction distributions
(``nn/layers/variational.py``) and layerwise pretraining
(``optimize/solver.py`` ``Solver.pretrain``) against the JAX package, in
float64.

Random draws cannot match across frameworks, so each comparison hands the
port the JAX package's own noise, drawn with the reference's key handling
(``fold_in``, ``split``, a Bernoulli draw as a uniform below its
probability), through the port's plain functions of the noise: the VAE's
negative ELBO and its gradients for each reconstruction distribution and
the composite, ``reconstruction_log_probability``, and the RBM's CD-k
surrogate gradient on the same Gibbs samples for binary and rectified
hidden and binary and gaussian visible units (all at 1e-9). Pretraining a
``MultiLayerNetwork`` (an AutoEncoder, then an RBM) and a
``ComputationGraph`` (a VAE) with the JAX noise injected gives the JAX
parameters after one epoch at 1e-9. The port's own samplers are checked
apart: shapes, support, and mean and variance over many draws against
stated bounds. A configuration JSON with every new class crosses both
ways."""
import _torch_threads  # noqa: F401
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import \
    ListDataSetIterator as JIterator
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.inputs import InputType as JIT
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import variational as tvar
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd

R = np.random.default_rng(7)
PRETRAIN_SALT = 104729          # the reference's pretraining key offset


def _np(tree):
    return [{k: np.asarray(v) for k, v in p.items()} for p in tree]


def _dists(L):
    return {"gaussian": L.GaussianReconstructionDistribution(),
            "gaussian-tanh": L.GaussianReconstructionDistribution(
                activation="tanh"),
            "bernoulli": L.BernoulliReconstructionDistribution(),
            "bernoulli-hardsigmoid": L.BernoulliReconstructionDistribution(
                activation="hardsigmoid"),
            "exponential": L.ExponentialReconstructionDistribution(),
            "losswrapper": L.LossFunctionWrapper(loss="mse"),
            "composite": L.CompositeReconstructionDistribution(parts=[
                [3, L.GaussianReconstructionDistribution()],
                [3, L.BernoulliReconstructionDistribution()]])}


def _data(name, n=8, d=6):
    if name.startswith("bernoulli"):
        return (R.random((n, d)) > 0.5).astype(float)
    if name == "exponential":
        return R.exponential(1.0, size=(n, d))
    if name == "composite":
        return np.concatenate([R.normal(size=(n, 3)),
                               (R.random((n, 3)) > 0.5).astype(float)], 1)
    return R.normal(size=(n, d))


def _vae_pair(dist_name, num_samples=2, n_in=6, latent=3):
    def conf(C, L, S):
        return C(seed=12345, updater=S(0.05), dtype="float64").list(
            L.VariationalAutoencoder(
                n_in=n_in, n_out=latent, encoder_layer_sizes=(7, 5),
                decoder_layer_sizes=(5, 7), activation="tanh",
                reconstruction_distribution=_dists(L)[dist_name],
                num_samples=num_samples),
            L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")
        ).build()
    jnet = JMLN(conf(JConf, jl, jupd.Sgd)).init()
    pnet = MultiLayerNetwork(conf(NeuralNetConfiguration, tl, tupd.Sgd),
                             device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _vae_eps(rng, shape, n):
    """The reference's draws (variational.py:318-319): sample s from
    fold_in(rng, s)."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(rng, s), shape, jnp.float64)) for s in range(n)])


def _grads_close(tloss, layer, jg, atol=1e-9):
    params = layer.param_dict()
    names = list(layer.param_order)
    tg = torch.autograd.grad(tloss, [params[k] for k in names],
                             allow_unused=True)
    for k, g in zip(names, tg):
        g = torch.zeros_like(params[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=0,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------- the VAE
@pytest.mark.parametrize("dist", sorted(_dists(jl)))
def test_vae_elbo_and_gradients_on_the_jax_noise(dist):
    jnet, pnet = _vae_pair(dist)
    jlay, play = jnet.layers[0], pnet.layers[0]
    assert play.param_order == jlay.param_order
    x = _data(dist)
    rng = jax.random.PRNGKey(11)
    eps = _vae_eps(rng, (x.shape[0], 3), 2)
    jelbo = np.asarray(jlay.elbo_per_example(jnet.params[0],
                                             jnp.asarray(x), rng))
    telbo = play.elbo_per_example_given(torch.as_tensor(x),
                                        torch.as_tensor(eps))
    np.testing.assert_allclose(telbo.detach().numpy(), jelbo, rtol=1e-12,
                               atol=1e-10)
    jloss, jg = jax.value_and_grad(lambda p: jlay.pretrain_loss(
        p, jnp.asarray(x), rng))(jnet.params[0])
    tloss = play.pretrain_loss_given(torch.as_tensor(x),
                                     torch.as_tensor(eps))
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-10
    _grads_close(tloss, play, jg)


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "composite"])
def test_vae_reconstruction_log_probability_on_the_jax_noise(dist):
    jnet, pnet = _vae_pair(dist)
    x = _data(dist, n=5)
    rng = jax.random.PRNGKey(0)             # the reference's default
    want = np.asarray(jnet.layers[0].reconstruction_log_probability(
        jnet.params[0], jnp.asarray(x), num_samples=6))
    got = pnet.layers[0].reconstruction_log_probability_given(
        torch.as_tensor(x), torch.as_tensor(_vae_eps(rng, (5, 3), 6)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-10)


def test_vae_supervised_forward_and_zero_decoder_gradients():
    jnet, pnet = _vae_pair("gaussian")
    x = R.normal(size=(10, 6))
    y = np.eye(2)[R.integers(0, 2, 10)]
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-12)
    jg = jax.grad(lambda p: jnet.loss_fn(p, jnet.state, jnp.asarray(x),
                                         jnp.asarray(y), train=False)[0])(
        jnet.params)
    loss = pnet.loss_fn(torch.as_tensor(x), torch.as_tensor(y), train=False)
    _grads_close(loss, pnet.layers[0], jg[0], atol=1e-12)
    assert pnet.layers[0].weight_param_names == \
        jnet.layers[0].weight_param_names
    # a supervised step moves no decoder parameter, as the reference's
    before = {k: v.clone() for k, v in pnet.layers[0].param_dict().items()}
    pnet.fit(x, y, batch_size=10)
    after = pnet.layers[0].param_dict()
    for k in ("dW0", "db1", "pXZW", "pZXLogStd2W"):
        assert torch.equal(after[k], before[k]), k
    assert not torch.equal(after["eW0"], before["eW0"])


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "exponential",
                                  "composite", "losswrapper"])
def test_vae_generative_calls(dist):
    _, pnet = _vae_pair(dist)
    play = pnet.layers[0]
    z = torch.as_tensor(R.normal(size=(4000, 3)))
    with torch.no_grad():
        mean = play.generate_at_mean_given_z(z)
        pre = play.decode(z)
        draws = play.generate_random_given_z(
            z, torch.Generator().manual_seed(2))
    assert mean.shape == draws.shape == (4000, 6)
    d = play.reconstruction_distribution
    if dist == "gaussian":
        mu, log_var = d._split(pre)
        zscore = (draws - mu) / torch.exp(0.5 * log_var)
        assert abs(zscore.mean()) < 0.05 and abs(zscore.var() - 1) < 0.05
    elif dist == "bernoulli":
        assert set(torch.unique(draws).tolist()) <= {0.0, 1.0}
        assert float((draws - mean).mean().abs()) < 0.01
    elif dist == "exponential":
        assert bool((draws > 0).all())
        ratio = draws / mean                  # Exp(1) draws
        assert abs(ratio.mean() - 1) < 0.05 and abs(ratio.var() - 1) < 0.1
    elif dist == "losswrapper":
        assert torch.equal(draws, mean)
    logp = play.reconstruction_log_probability(
        torch.as_tensor(_data(dist, n=4)), num_samples=5)
    assert logp.shape == (4,) and bool(torch.isfinite(logp).all())


def test_vae_eps_draw():
    play = tl.VariationalAutoencoder(n_in=4, n_out=3, num_samples=2)
    eps = play.pretrain_noise(torch.zeros(5000, 4, dtype=torch.float64),
                              torch.Generator().manual_seed(5))
    assert eps.shape == (2, 5000, 3) and eps.dtype == torch.float64
    assert abs(eps.mean()) < 0.02 and abs(eps.var() - 1) < 0.03


# ---------------------------------------------------------------- the RBM
def _rbm_noise(rng, B, n_in, n_out, hidden, visible, k):
    """The reference's Gibbs chain draws (variational.py:413-427):
    fold_in(rng, 2 step) for h, fold_in(rng, 2 step + 1) for v."""
    out = []
    for step in range(k):
        r1 = jax.random.fold_in(rng, 2 * step)
        r2 = jax.random.fold_in(rng, 2 * step + 1)
        draw_h = jax.random.normal if hidden == "rectified" \
            else jax.random.uniform
        draw_v = jax.random.normal if visible == "gaussian" \
            else jax.random.uniform
        out.append((torch.as_tensor(np.array(draw_h(r1, (B, n_out),
                                                      jnp.float64))),
                    torch.as_tensor(np.array(draw_v(r2, (B, n_in),
                                                      jnp.float64)))))
    return out


@pytest.mark.parametrize("hidden", ["binary", "rectified"])
@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_rbm_surrogate_gradient_on_the_same_gibbs_samples(hidden, visible):
    jlay = jl.RBM(n_in=5, n_out=4, hidden_unit=hidden, visible_unit=visible,
                  k=2)
    play = tl.RBM(n_in=5, n_out=4, hidden_unit=hidden, visible_unit=visible,
                  k=2)
    params = {"W": jnp.asarray(R.normal(size=(5, 4)) * 0.5),
              "b": jnp.asarray(R.normal(size=4) * 0.1),
              "vb": jnp.asarray(R.normal(size=5) * 0.1)}
    play.init_params(InputType.feed_forward(5), torch.float64,
                     torch.device("cpu"), torch.Generator())
    with torch.no_grad():
        for k, v in params.items():
            getattr(play, k).copy_(torch.as_tensor(np.array(v)))
    v0 = (R.random((16, 5)) > 0.5).astype(float) if visible == "binary" \
        else R.normal(size=(16, 5))
    rng = jax.random.PRNGKey(3)
    noise = _rbm_noise(rng, 16, 5, 4, hidden, visible, 2)
    tv0 = torch.as_tensor(v0)
    np.testing.assert_allclose(
        play.gibbs_chain_given(tv0, noise).detach().numpy(),
        np.asarray(jlay.gibbs_chain(params, jnp.asarray(v0), rng)),
        rtol=0, atol=1e-12)
    jloss, jg = jax.value_and_grad(lambda p: jlay.pretrain_loss(
        p, jnp.asarray(v0), rng))(params)
    tloss = play.pretrain_loss_given(tv0, noise)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-10
    _grads_close(tloss, play, jg)
    np.testing.assert_allclose(
        play.reconstruct(tv0).detach().numpy(),
        np.asarray(jlay.reconstruct(params, jnp.asarray(v0))), atol=1e-12)


def test_rbm_gibbs_noise_draw():
    play = tl.RBM(n_in=3, n_out=2, hidden_unit="rectified", k=3)
    noise = play.gibbs_noise(torch.zeros(20000, 3, dtype=torch.float64),
                             torch.Generator().manual_seed(8))
    assert len(noise) == 3
    nh, nv = noise[0]
    assert nh.shape == (20000, 2) and nv.shape == (20000, 3)
    assert abs(nh.mean()) < 0.02 and abs(nh.var() - 1) < 0.03   # normal
    assert float(nv.min()) >= 0 and float(nv.max()) < 1        # uniform
    assert abs(nv.mean() - 0.5) < 0.01 and abs(nv.var() - 1 / 12) < 0.005


# -------------------------------------------------------------- pretraining
class _JaxNoise:
    """Stands in for a port layer's ``pretrain_noise``: the noise the JAX
    package's ``Solver.pretrain`` draws for the same layer at the same
    iteration (solver.py:640, :702: fold_in(PRNGKey(seed + 104729),
    it * 1000 + index))."""

    def __init__(self, jlayer, index, seed):
        self.jlayer, self.index, self.it = jlayer, index, 0
        self.base = jax.random.PRNGKey(seed + PRETRAIN_SALT)

    def __call__(self, x, gen):
        rng = jax.random.fold_in(self.base, self.it * 1000 + self.index)
        self.it += 1
        lay = self.jlayer
        if isinstance(lay, jl.AutoEncoder):
            corrupt, _ = jax.random.split(rng)
            return torch.as_tensor(np.asarray(jax.random.bernoulli(
                corrupt, 1.0 - lay.corruption_level, tuple(x.shape))))
        if isinstance(lay, jl.RBM):
            return _rbm_noise(rng, x.shape[0], lay.n_in, lay.n_out,
                              lay.hidden_unit, lay.visible_unit, lay.k)
        return torch.as_tensor(_vae_eps(rng, (x.shape[0], lay.n_out),
                                        lay.num_samples))


def test_multilayer_pretrain_matches_jax():
    def conf(C, L, U):
        return C(seed=21, updater=U.RmsProp(1e-2), l2=1e-4,
                 dtype="float64").list(
            L.AutoEncoder(n_in=8, n_out=6, corruption_level=0.25,
                          activation="sigmoid", loss="xent"),
            L.RBM(n_out=5, hidden_unit="binary", visible_unit="binary", k=1),
            L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")
        ).build()
    jnet = JMLN(conf(JConf, jl, jupd)).init()
    pnet = MultiLayerNetwork(conf(NeuralNetConfiguration, tl, tupd),
                             device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    for i in (0, 1):
        pnet.layers[i].pretrain_noise = _JaxNoise(jnet.layers[i], i, 21)
    x = (R.random((48, 8)) > 0.5).astype(float)
    jnet.pretrain(JIterator(features=x, labels=x, batch_size=16), epochs=1)
    assert pnet.pretrain(ListDataSetIterator(features=x, labels=x,
                                             batch_size=16)) is pnet
    assert [pnet.layers[i].pretrain_noise.it for i in (0, 1)] == [3, 3]
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-9)
    # the output layer takes no pretraining
    np.testing.assert_array_equal(pnet.layers[2].W.detach().numpy(),
                                  np.asarray(jnet.params[2]["W"]))


def test_graph_pretrain_matches_jax():
    def conf(C, L, U, IT):
        return (C(seed=4, updater=U.Adam(1e-2), dtype="float64")
                .graph_builder().add_inputs("in")
                .add_layer("dense", L.DenseLayer(n_out=8,
                                                 activation="tanh"), "in")
                .add_layer("vae", L.VariationalAutoencoder(
                    n_out=2, encoder_layer_sizes=(10,),
                    decoder_layer_sizes=(10,), activation="tanh",
                    reconstruction_distribution=(
                        L.BernoulliReconstructionDistribution()),
                    num_samples=2), "dense")
                .add_layer("out", L.OutputLayer(n_out=2,
                                                activation="softmax",
                                                loss="mcxent"), "vae")
                .set_outputs("out").set_input_types(IT.feed_forward(6))
                .build())
    jnet = JCG(conf(JConf, jl, jupd, JIT)).init()
    pnet = ComputationGraph(conf(NeuralNetConfiguration, tl, tupd,
                                 InputType), device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    vi = jnet.vertex_names.index("vae")
    pnet.vertices["vae"].layer.pretrain_noise = _JaxNoise(jnet.layers[vi],
                                                          vi, 4)
    x = R.normal(size=(40, 6))
    jnet.pretrain(JIterator(features=x, labels=x, batch_size=20), epochs=2)
    pnet.pretrain(ListDataSetIterator(features=x, labels=x, batch_size=20),
                  epochs=2)
    assert pnet.vertices["vae"].layer.pretrain_noise.it == 4
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-9)


def test_pretrain_noise_draws_vary_by_iteration():
    """Without injection each iteration draws new noise from the
    generator the solver reseeds per (iteration, layer)."""
    conf = NeuralNetConfiguration(seed=3, updater=tupd.Sgd(0.1),
                                  dtype="float64").list(
        tl.AutoEncoder(n_in=6, n_out=4, corruption_level=0.5)).build()
    net = MultiLayerNetwork(conf, device="cpu").init()
    seen = []
    draw = net.layers[0].pretrain_noise

    def record(x, gen):
        seen.append(draw(x, gen))
        return seen[-1]
    net.layers[0].pretrain_noise = record
    x = R.random((10, 6))
    net.pretrain(ListDataSetIterator(features=x, labels=x, batch_size=5),
                 epochs=2)
    assert len(seen) == 4
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[0], seen[2])
    first = seen[0].clone()
    seen.clear()
    net.pretrain(ListDataSetIterator(features=x, labels=x, batch_size=5))
    assert torch.equal(seen[0], first)         # same seed, same iteration


# ------------------------------------------------------------- the config
def test_configuration_json_crosses_both_ways():
    def conf(C, L, IT):
        return C(seed=9, dtype="float64").list(
            L.DropoutLayer(dropout=0.8),
            L.AutoEncoder(n_in=6, n_out=5, corruption_level=0.1),
            L.RBM(n_out=4, hidden_unit="rectified", visible_unit="gaussian",
                  k=3),
            L.VariationalAutoencoder(
                n_out=2, encoder_layer_sizes=(4, 3),
                decoder_layer_sizes=(3,), pzx_activation="tanh",
                num_samples=2,
                reconstruction_distribution=(
                    L.CompositeReconstructionDistribution(parts=[
                        [2, L.ExponentialReconstructionDistribution()],
                        [2, L.LossFunctionWrapper(loss="l1")]]))),
            L.LossLayer(loss="mse", activation="identity")
        ).set_input_type(IT.feed_forward(6)).build()
    jconf = conf(JConf, jl, JIT)
    pconf = conf(NeuralNetConfiguration, tl, InputType)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    back = jserde.from_json(pconf.to_json())
    assert json.loads(jserde.to_json(back)) == json.loads(jconf.to_json())
    pback = tserde.from_json(jconf.to_json())
    assert json.loads(pback.to_json()) == json.loads(jconf.to_json())
    net = MultiLayerNetwork(pback, device="cpu").init()
    assert isinstance(net.layers[3].reconstruction_distribution,
                      tvar.CompositeReconstructionDistribution)
    assert net.output(R.normal(size=(3, 6))).shape == (3, 2)


def test_vae_and_rbm_zip_cross_both_ways(tmp_path):
    """A network of the new layers through the model zip: the port's zip
    restores in the JAX package and the JAX package's in the port, each
    answering as the network that wrote it."""
    from deeplearning4j_tpu.util import serialization as jzip
    from deeplearning4j_tpu_torch.util import serialization as tzip

    def conf(C, L):
        return C(seed=1).list(
            L.VariationalAutoencoder(n_in=6, n_out=2,
                                     encoder_layer_sizes=(5,),
                                     decoder_layer_sizes=(4,)),
            L.RBM(n_out=3),
            L.OutputLayer(n_out=2, activation="softmax")).build()
    pnet = MultiLayerNetwork(conf(NeuralNetConfiguration, tl),
                             device="cpu").init()
    jnet = JMLN(conf(JConf, jl)).init()
    x = R.normal(size=(3, 6)).astype(np.float32)
    tzip.write_model(pnet, str(tmp_path / "port.zip"))
    jzip.write_model(jnet, str(tmp_path / "jax.zip"))
    np.testing.assert_allclose(
        np.asarray(jzip.restore_model(str(tmp_path / "port.zip")).output(x)),
        pnet.output(x).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        tzip.restore_model(str(tmp_path / "jax.zip"),
                           device="cpu").output(x).numpy(),
        np.asarray(jnet.output(x)), atol=1e-6)
