"""The zoo's Inception-ResNet-v1 and FaceNet nn4.small2 in the port against
the JAX package's.

At the reference's own small sizes (``tests/test_zoo_datasets.py:57, 93``:
FaceNet at 48x48 with 5 classes and a 32-wide embedding, Inception-ResNet
at 64x64 with one block of each kind), each JAX network built once a
module: the same vertex names, parameter and state names and shapes, and,
with the JAX weights and a random running state carried across, the same
float32 evaluation output at atol 1e-5. FaceNet then takes one float64
``fit`` step (``Sgd``, B 8) through its ``CenterLossOutputLayer`` against
JAX's jitted ``train_step_math``: the loss at rel 1e-10, every parameter,
the class ``centers`` among them, at atol 1e-9, and the running statistics
(float32) at rel 1e-6 plus atol 1e-7."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.optimize import updaters as ju
from deeplearning4j_tpu.optimize.solver import train_step_math as jstep
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_params,
                                                         load_jax_state)
from deeplearning4j_tpu_torch.models import zoo_extra as tzoo
from deeplearning4j_tpu_torch.optimize import updaters as tu

jzoo = importlib.import_module("deeplearning4j_tpu.models.zoo_extra")

BUILDERS = {
    "facenet_nn4_small2": (
        jzoo.facenet_nn4_small2, tzoo.facenet_nn4_small2,
        dict(n_classes=5, height=48, width=48, embedding_size=32),
        (2, 48, 48, 3)),
    "inception_resnet_v1": (
        jzoo.inception_resnet_v1, tzoo.inception_resnet_v1,
        dict(n_classes=5, height=64, width=64, embedding_size=32, res_a=1,
             res_b=1, res_c=1), (2, 64, 64, 3)),
}


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def built(request):
    """(name, JAX network, port network with the JAX weights and a random
    running state, that state)."""
    jb, tb, kw, _ = BUILDERS[request.param]
    jnet = jb(**kw).init()
    pnet = tb(**kw, device="cpu").init()
    r = np.random.default_rng(3)
    state = [{k: (r.standard_normal(v.shape) if k == "mean"
                  else r.uniform(0.5, 2.0, v.shape)).astype(np.float32)
              for k, v in s.items()} for s in jnet.state]
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    load_jax_state(pnet, state)
    return request.param, jnet, pnet, state


def test_structure_matches_jax(built):
    _, jnet, pnet, _ = built
    assert pnet.vertex_names == list(jnet.vertex_names)
    for name, jp, js in zip(jnet.vertex_names, jnet.params, jnet.state):
        assert {k: tuple(v.shape) for k, v in
                pnet.param_dicts()[name].items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}, name
        assert {k: tuple(v.shape) for k, v in
                pnet.state_dicts()[name].items()} == \
            {k: tuple(v.shape) for k, v in js.items()}, name
    head = pnet.vertices[pnet.conf.network_outputs[0]].layer
    assert type(head).__name__ == "CenterLossOutputLayer"
    assert head.param_order == ("W", "b", "centers")
    assert (head.alpha, head.lambda_) == (0.9, 1e-4)


def test_float32_output_matches_jax(built):
    name, jnet, pnet, state = built
    x = np.random.default_rng(1).standard_normal(
        BUILDERS[name][3]).astype(np.float32)
    jstate = tuple({k: jnp.asarray(v) for k, v in s.items()} for s in state)
    want = jnet.apply_fn(jnet.params, jstate, [jnp.asarray(x)])[0]
    got = pnet.feed_forward(x)
    for v in ("embeddings", jnet.conf.network_outputs[0]):
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want[v]),
                                   atol=1e-5, err_msg=v)
    emb = got["embeddings"].numpy()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)


def test_facenet_center_loss_step_matches_jax_in_float64():
    jb, tb, kw, shape = BUILDERS["facenet_nn4_small2"]
    jnet = jb(**kw, dtype="float64", updater=ju.Sgd(0.1)).init()
    pnet = tb(**kw, dtype="float64", updater=tu.Sgd(0.1),
              device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    r = np.random.default_rng(2)
    x = r.standard_normal((8,) + shape[1:])
    y = np.eye(5)[r.integers(0, 5, 8)]
    new_p, new_s, _, jloss = jax.jit(
        lambda p, s, o, xx, yy: jstep(jnet, p, s, o, jnp.asarray(0),
                                      jax.random.PRNGKey(0), [xx], [yy]))(
        jnet.params, jnet.state, jnet.opt_state, jnp.asarray(x),
        jnp.asarray(y))
    losses = []
    pnet.set_listeners(type("L", (), {"iteration_done": staticmethod(
        lambda net, it, loss: losses.append(float(loss)))})())
    pnet.fit(x, y, batch_size=8)
    assert losses[0] == pytest.approx(float(jloss), rel=1e-10)
    for name, jp, js in zip(jnet.vertex_names, new_p, new_s):
        for k, v in pnet.param_dicts()[name].items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-9, rtol=0,
                                       err_msg=f"{name}.{k}")
        for k, v in pnet.state_dicts()[name].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"state {name}.{k}")
    centers = pnet.vertices["lossLayer"].layer.centers
    assert centers.dtype == torch.float64
    assert torch.count_nonzero(centers) > 0     # the alpha term moved them
