"""The CNN zoo in the port against the JAX package's: ``resnet50``,
``vgg16``, ``vgg19``, ``alexnet``, ``simple_cnn``, ``lenet`` and
``digits_cnn``.

Each builder at a small input size (the reference's own 32x32 where the
network allows it; AlexNet's strides need 64x64): the same vertex (or
layer) names, parameter names and shapes and state names and shapes as
JAX's, and, with the JAX weights and a random running state carried
across, the same float32 evaluation output at atol 1e-5. ``resnet50`` and
``simple_cnn`` then take one float64 ``fit`` step, whose forward
normalizes by batch statistics, against JAX's jitted ``train_step_math``:
loss at rel 1e-10, parameters at atol 1e-9, the running statistics
(float32 in both packages, decay·old + (1 - decay)·new rounded in float32,
which XLA may fuse into one multiply-add) at rel 1e-6 plus atol 1e-7, an
ulp of the O(1) terms. ResNet-50 takes that step at
B 8: its last stage is 1x1 at a 32x32 input, so its BatchNorms average
over the batch alone, and at B 2 var = E[x²] - E[x]² of two values cancels
so far that each such layer multiplies the frameworks' rounding
differences by ~100 (1e-7 by the end in float64); at B 8 they stay at
1e-12. The same conditioning keeps the float32 training forward from a
1e-5 comparison at any of these sizes (1e-3 at the worst vertex), so
float32 is compared in evaluation. The step uses
``Sgd``: under Adam an entry whose gradient is far below Adam's epsilon
moves by lr·g/eps, which turns the two frameworks' float noise in such
an entry into parameter differences of 1e-7; and SimpleCNN's dropout is
switched off in both, since the port's masks draw from its own generator
(their bits differ from JAX's by design)."""
import _torch_threads  # noqa: F401
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.optimize import updaters as ju
from deeplearning4j_tpu.optimize.solver import train_step_math as jstep
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_params,
                                                         load_jax_state)
from deeplearning4j_tpu_torch.models import lenet as tlenet
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.optimize import updaters as tu

# the JAX models package exports the function ``lenet``, which hides the
# module of that name from ``from ... import``
jlenet = importlib.import_module("deeplearning4j_tpu.models.lenet")
jzoo = importlib.import_module("deeplearning4j_tpu.models.zoo")

BUILDERS = {
    "resnet50": (jzoo.resnet50, tzoo.resnet50,
                 dict(n_classes=10, height=32, width=32), (2, 32, 32, 3)),
    "vgg16": (jzoo.vgg16, tzoo.vgg16,
              dict(n_classes=10, height=32, width=32), (2, 32, 32, 3)),
    "vgg19": (jzoo.vgg19, tzoo.vgg19,
              dict(n_classes=10, height=32, width=32), (2, 32, 32, 3)),
    "alexnet": (jzoo.alexnet, tzoo.alexnet,
                dict(n_classes=10, height=64, width=64), (2, 64, 64, 3)),
    "simple_cnn": (jzoo.simple_cnn, tzoo.simple_cnn,
                   dict(n_classes=5, height=16, width=16), (4, 16, 16, 3)),
    "lenet": (jlenet.lenet, tlenet.lenet, {}, (2, 28, 28, 1)),
    "digits_cnn": (jlenet.digits_cnn, tlenet.digits_cnn, {}, (4, 8, 8, 1)),
}
_JAX = {}


def _jax_net(name):
    """The JAX network of a builder, made once a module."""
    if name not in _JAX:
        jb, _, kw, _ = BUILDERS[name]
        _JAX[name] = jb(**kw).init()
    return _JAX[name]


def _np(tree, dtype=np.float32):
    return [{k: np.asarray(v, dtype) for k, v in p.items()} for p in tree]


def _groups(net):
    """(group key, param dict, state dict) in the network's order."""
    return [(k, net.param_dicts()[k], net.state_dicts()[k])
            for k in net.param_dicts()]


def _random_state(jnet, seed):
    """A running state with a random mean and a variance in [0.5, 2]."""
    r = np.random.default_rng(seed)
    return [{k: (r.standard_normal(v.shape) if k == "mean"
                 else r.uniform(0.5, 2.0, v.shape)).astype(np.float32)
             for k, v in s.items()} for s in jnet.state]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_structure_matches_jax(name):
    jnet = _jax_net(name)
    _, tb, kw, _ = BUILDERS[name]
    pnet = tb(**kw, device="cpu").init()
    if hasattr(jnet, "vertex_names"):
        assert pnet.vertex_names == list(jnet.vertex_names)
    else:
        assert len(pnet.layers) == len(jnet.layers)
        assert [type(x).__name__ for x in pnet.layers] == \
            [type(x).__name__ for x in jnet.layers]
    groups = _groups(pnet)
    assert len(groups) == len(jnet.params) == len(jnet.state)
    for (key, pd, sd), jp, js in zip(groups, jnet.params, jnet.state):
        assert {k: tuple(v.shape) for k, v in pd.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}, key
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in js.items()}, key
        assert all(v.dtype == torch.float32 for v in sd.values())
    assert pnet.num_params() == sum(int(np.prod(v.shape)) for p in jnet.params
                                    for v in p.values())
    assert json.loads(pnet.conf.to_json()) == json.loads(jnet.conf.to_json())


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_float32_output_matches_jax(name):
    jnet = _jax_net(name)
    _, tb, kw, shape = BUILDERS[name]
    pnet = tb(**kw, device="cpu").init()
    state = _random_state(jnet, 3)
    load_jax_params(pnet, _np(jnet.params))
    load_jax_state(pnet, state)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jstate = tuple({k: jnp.asarray(v) for k, v in s.items()} for s in state)

    def jout():
        out = jnet._output_pure(jnet.params, jstate, jnp.asarray(x))
        return np.asarray(out[0] if isinstance(out, list) else out)

    want, got = jout(), pnet.output(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["resnet50", "simple_cnn"])
def test_one_float64_fit_step_matches_jax(name):
    jb, tb, kw, shape = BUILDERS[name]
    jnet = jb(**kw, dtype="float64", updater=ju.Sgd(0.1)).init()
    pnet = tb(**kw, dtype="float64", updater=tu.Sgd(0.1), device="cpu").init()
    if name == "simple_cnn":
        jnet.conf.vertices["fc"].layer_conf.dropout = None
        pnet.vertices["fc"].layer.dropout = None
    state = _random_state(jnet, 4)
    load_jax_params(pnet, _np(jnet.params, np.float64))
    load_jax_state(pnet, state)
    jstate = tuple({k: jnp.asarray(v) for k, v in s.items()} for s in state)
    r = np.random.default_rng(2)
    if name == "resnet50":
        shape = (8,) + shape[1:]
    x = r.standard_normal(shape)
    y = np.eye(kw["n_classes"])[r.integers(0, kw["n_classes"], shape[0])]
    new_p, new_s, _, jloss = jax.jit(
        lambda p, s, o, xx, yy: jstep(jnet, p, s, o, jnp.asarray(0),
                                      jax.random.PRNGKey(0), [xx], [yy]))(
        jnet.params, jstate, jnet.opt_state, jnp.asarray(x), jnp.asarray(y))
    losses = []
    pnet.set_listeners(type("L", (), {"iteration_done": staticmethod(
        lambda net, it, loss: losses.append(float(loss)))})())
    pnet.fit(x, y, batch_size=shape[0])
    assert losses[0] == pytest.approx(float(jloss), rel=1e-10)
    for (key, pd, sd), jp, js in zip(_groups(pnet), new_p, new_s):
        for k, v in pd.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-9, rtol=0, err_msg=f"{key}.{k}")
        for k, v in sd.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"state {key}.{k}")
    moved = [k for k, _, sd in _groups(pnet) if sd]
    assert moved and not np.allclose(
        pnet.state_dicts()[moved[0]]["mean"].numpy(), state[
            list(pnet.param_dicts()).index(moved[0])]["mean"])


def test_digits_cnn_pretrained_names_its_item():
    """The item (ROADMAP A9b, models/pretrained.py) is ported:
    ``pretrained=True`` restores exactly the committed artifact's
    parameters, where it raised before."""
    from deeplearning4j_tpu_torch.util.serialization import restore_model
    net = tlenet.digits_cnn(pretrained=True, device="cpu")
    want = restore_model(tlenet.DIGITS_CNN_ARTIFACT, load_updater=False,
                         device="cpu").params_flat()
    assert torch.equal(net.params_flat(), want)


def test_graft_entry_is_resnet50s_eval_forward():
    """The port's counterpart of ``__graft_entry__.entry()``: ResNet-50 at
    its full width, B 8 at 224x224x3, its eval forward on the images
    alone."""
    from deeplearning4j_tpu_torch.graft_entry import entry
    forward, args = entry(device="cpu")
    (x,) = args
    assert tuple(x.shape) == (8, 224, 224, 3) and x.dtype == torch.float32
    out = forward(x)
    assert tuple(out.shape) == (8, 1000)
    torch.testing.assert_close(out.sum(-1), torch.ones(8), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out, forward.net.output(x), rtol=0, atol=0)
