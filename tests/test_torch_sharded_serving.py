"""Mesh-sharded forward serving (``InferenceEngine(mesh=...)``,
``serving/programs.py``, ``BucketLadder.validate_for_mesh``) against the
JAX package's engine on its 8 virtual CPU devices: the same responses for
batches that fill and that pad a rung, the workers' rows in worker order,
the same refusal of a ladder whose rungs do not divide over the data axis,
and a hot swap that keeps the mesh."""
import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.serving import InferenceEngine as JEngine
from deeplearning4j_tpu.serving.buckets import BucketLadder as JLadder
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.serving import InferenceEngine
from deeplearning4j_tpu_torch.serving.buckets import BucketLadder
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


R = np.random.default_rng(5)


def _layers(L):
    return [L.DenseLayer(n_in=6, n_out=16, activation="tanh"),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


@pytest.fixture(scope="module")
def nets():
    jnet = JMLN(JConf(seed=3).list(*_layers(jl)).build()).init()
    pnet = MultiLayerNetwork(NeuralNetConfiguration(seed=3).list(
        *_layers(tl)).build(), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def test_mesh_sharded_responses_equal_the_references(nets):
    jnet, pnet = nets
    x = R.normal(size=(11, 6)).astype(np.float32)
    jeng = JEngine(jnet, feature_shape=(6,), buckets=(4, 8),
                   mesh=jmake_mesh((4,), ("data",), jax.devices()[:4]))
    peng = InferenceEngine(pnet, feature_shape=(6,), buckets=(4, 8),
                           mesh=make_mesh((4,), ("data",), "cpu"))
    try:
        for n in (1, 4, 7, 8, 11):
            want = np.asarray(jeng.predict(x[:n]))
            got = peng.predict(x[:n])
            np.testing.assert_allclose(got, want, atol=1e-6)
            np.testing.assert_allclose(
                got, pnet.output(torch.as_tensor(x[:n])).numpy(), atol=1e-6)
        assert peng.trace_count == 2            # a warm run a rung
        # a same-shape swap keeps the mesh and its warmed rungs
        assert peng.hot_swap("default", pnet) == 2
        entry = peng.registry.get("default")
        assert entry.active.mesh is peng.mesh and peng.trace_count == 2
        np.testing.assert_allclose(peng.predict(x[:5]),
                                   np.asarray(jeng.predict(x[:5])), atol=1e-6)
    finally:
        jeng.stop()
        peng.stop()


def test_each_worker_runs_its_rows_in_worker_order(nets):
    """The padded batch is cut into the data axis' rows and each worker's
    rows go through the forward, in worker order."""
    _, pnet = nets
    seen = []

    def fwd(net, x):
        seen.append(x.clone())
        return net._output_pure(x)

    eng = InferenceEngine(pnet, feature_shape=(6,), buckets=(8,),
                          mesh=make_mesh((4,), ("data",), "cpu"),
                          forward_fn=fwd)
    try:
        seen.clear()
        x = R.normal(size=(8, 6)).astype(np.float32)
        eng.predict(x)
    finally:
        eng.stop()
    assert [tuple(s.shape) for s in seen] == [(2, 6)] * 4
    np.testing.assert_array_equal(torch.cat(seen).numpy(), x)


def test_a_ladder_that_does_not_divide_is_refused_as_the_reference():
    mesh = make_mesh((4,), ("data",), "cpu")
    jmesh = jmake_mesh((4,), ("data",), jax.devices()[:4])
    msgs = []
    for ladder, m in ((BucketLadder((1, 8, 30)), mesh),
                      (JLadder((1, 8, 30)), jmesh)):
        with pytest.raises(ValueError, match="not divisible") as e:
            ladder.validate_for_mesh(m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    BucketLadder((4, 8, 32)).validate_for_mesh(mesh)
