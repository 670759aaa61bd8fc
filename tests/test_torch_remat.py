"""Gradient checkpointing (``gradient_checkpointing=True``): each layer's
forward recomputed in the backward changes no number.

As the reference's ``tests/test_remat.py``: on a ``MultiLayerNetwork`` and
a ``ComputationGraph`` (a GravesLSTM graph), remat against plain at atol
1e-6 on outputs and 1e-5 on parameters after three steps, and both against
the JAX package's remat networks on the same weights. With dropout 0.5 on
one layer the recompute must draw the forward's mask: the port replays the
first forward's masks (``torch.utils.checkpoint`` restores only the global
generators, not the explicit one dropout draws from), so remat equals
plain there too, where a fresh draw would give another gradient."""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd

R = np.random.default_rng(51)


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _mln(mod, conf_cls, upd, remat, dropout, torch_side):
    conf = (conf_cls(seed=5, updater=upd, dtype="float32",
                     gradient_checkpointing=remat)
            .list(mod.DenseLayer(n_in=6, n_out=16, activation="tanh",
                                 dropout=dropout),
                  mod.DenseLayer(n_out=16, activation="relu"),
                  mod.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .build())
    if torch_side:
        return MultiLayerNetwork(conf, device="cpu").init()
    return JMLN(conf).init()


def _graph(mod, conf_cls, itype, upd, remat, dropout, torch_side):
    g = (conf_cls(seed=7, updater=upd, dtype="float32",
                  gradient_checkpointing=remat)
         .graph_builder()
         .add_inputs("in")
         .add_layer("l1", mod.GravesLSTM(n_out=8, activation="tanh",
                                         dropout=dropout), "in")
         .add_layer("d", mod.DenseLayer(n_out=8, activation="tanh"), "l1")
         .add_layer("out", mod.RnnOutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "d")
         .set_outputs("out")
         .set_input_types(itype.recurrent(3, 6)))
    if torch_side:
        return ComputationGraph(g.build(), device="cpu").init()
    return JCG(g.build()).init()


def _nets(kind, remat, dropout=0.0):
    if kind == "multilayer":
        j = _mln(jl, JConf, jupd.Sgd(0.1), remat, dropout, False)
        p = _mln(tl, NeuralNetConfiguration, tupd.Sgd(0.1), remat, dropout,
                 True)
        x = R.normal(size=(16, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[R.integers(0, 3, 16)]
    else:
        j = _graph(jl, JConf, JInputType, jupd.Sgd(0.1), remat, dropout,
                   False)
        p = _graph(tl, NeuralNetConfiguration, InputType, tupd.Sgd(0.1),
                   remat, dropout, True)
        x = R.normal(size=(4, 6, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[R.integers(0, 2, (4, 6))]
    load_jax_params(p, _np(j.params))
    return j, p, x, y


def _out(net, x):
    out = net.output(x)
    return out if isinstance(out, torch.Tensor) else out[0]


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_remat_matches_plain_and_jax(kind):
    jplain, plain, x, y = _nets(kind, remat=False)
    jremat, remat, _, _ = _nets(kind, remat=True)
    remat.set_params_flat(plain.params_flat())
    np.testing.assert_allclose(_out(remat, x).numpy(),
                               _out(plain, x).numpy(), atol=1e-6)
    for net in (plain, remat):
        net.fit(x, y, epochs=3, batch_size=x.shape[0])
    for net in (jplain, jremat):
        net.fit(x, y, epochs=3, batch_size=x.shape[0])
    assert remat.iteration_count == 3
    np.testing.assert_allclose(remat.params_flat().numpy(),
                               plain.params_flat().numpy(), atol=1e-5)
    np.testing.assert_allclose(remat.params_flat().numpy(),
                               np.asarray(jremat.params_flat()), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jremat.params_flat()),
                               np.asarray(jplain.params_flat()), atol=1e-5)


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_remat_with_dropout_equals_plain(kind):
    """Dropout 0.5 on the first layer: the recompute replays the forward's
    mask, so the gradients and the parameters after three steps equal the
    plain network's."""
    _, plain, x, y = _nets(kind, remat=False, dropout=0.5)
    _, remat, _, _ = _nets(kind, remat=True, dropout=0.5)
    remat.set_params_flat(plain.params_flat())
    for net in (plain, remat):
        net.fit(x, y, epochs=3, batch_size=x.shape[0])
    np.testing.assert_allclose(remat.params_flat().numpy(),
                               plain.params_flat().numpy(), atol=1e-5)
    # one step's gradients with the same generator state: equal, and the
    # mask really is drawn (a train-mode forward differs from inference)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    grads = []
    for net in (plain, remat):
        gen = torch.Generator().manual_seed(11)
        loss = net.loss_fn(xt, yt, train=True, gen=gen)
        grads.append(torch.autograd.grad(loss, list(net.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(11)
        assert not torch.equal(plain.loss_fn(xt, yt, train=True, gen=gen),
                               plain.loss_fn(xt, yt, train=False))
