"""The int8 serving tier: the port's quantizers, K8's plain version and
``int8_forward_fn`` against the JAX package's ``ops/kernels/quantized.py``.

The quantizers and the int8 matmul are bitwise equal to JAX's (zero rows and
columns included, the Pallas kernel in interpret mode at ``_parity_run``'s
shape); the int8 forward of bench.py's int8 serving net (Dense 512 -> 512
-> 512, softmax 256) at B 16 equals JAX's at atol 1e-6 (its activations are
relu, so no quantization step flips) and stays within the reference's rel
0.05 of the f32 forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.ops.kernels import quantized as jq
from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import nvcc
from deeplearning4j_tpu_torch.ops.kernels import quantized as tq
from deeplearning4j_tpu_torch.optimize.updaters import Sgd


def _rng(seed):
    return np.random.default_rng(seed)


def _with_zeros(a, axis, idx):
    a = a.copy()
    if axis == 0:
        a[idx] = 0.0
    else:
        a[:, idx] = 0.0
    return a


def test_quantize_weights_is_bitwise_jax():
    w = _with_zeros(_rng(0).standard_normal((70, 33)).astype(np.float32),
                    1, [0, 5])
    w[3, 7] = 1e-30                       # a tiny column entry
    jqv, js = jq.quantize_weights(jnp.asarray(w))
    tqv, ts = tq.quantize_weights(torch.tensor(w))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0] == 1.0 and (tqv[:, 0] == 0).all()      # zero column


def test_quantize_rows_is_bitwise_jax():
    x = _with_zeros(3 * _rng(1).standard_normal((41, 64)).astype(np.float32),
                    0, [2, 40])
    # values exactly half a step: round half to even on both sides
    x[5, :4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32)
    x[5, 4:] = 0.0
    jqv, js = jq.quantize_rows(jnp.asarray(x))
    tqv, ts = tq.quantize_rows(torch.tensor(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[2] == 1.0 and (tqv[2] == 0).all()        # zero row


def _quantized(seed, M, K, N, zero_rows=()):
    r = _rng(seed)
    x = _with_zeros(r.standard_normal((M, K)).astype(np.float32), 0,
                    list(zero_rows))
    w = r.standard_normal((K, N)).astype(np.float32)
    jargs = (*jq.quantize_rows(jnp.asarray(x)),
             *jq.quantize_weights(jnp.asarray(w)))
    jargs = (jargs[0], jargs[2], jargs[1], jargs[3])   # x_q, w_q, xs, ws
    targs = tuple(torch.tensor(np.asarray(a)) for a in jargs)
    return jargs, targs


def test_plain_int8_matmul_is_bitwise_the_pallas_kernel():
    """``_parity_run``'s shape (M 64, K 256, N 256), the Pallas kernel in
    interpret mode, and the XLA fallback."""
    jargs, targs = _quantized(0, 64, 256, 256, zero_rows=(3,))
    got = tq.int8_matmul_plain(*targs).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.int8_matmul_pallas(
        *jargs)))
    np.testing.assert_array_equal(got, np.asarray(jq.int8_matmul_xla(*jargs)))


@pytest.mark.parametrize("M,K,N", [(1, 512, 512), (8, 512, 256),
                                   (33, 512, 512), (5, 37, 70),
                                   (256, 512, 256)])
def test_plain_int8_matmul_is_bitwise_xla_at_ragged_shapes(M, K, N):
    jargs, targs = _quantized(M + K + N, M, K, N, zero_rows=(0,))
    got = tq.int8_matmul_fused(*targs)     # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.int8_matmul_xla(*jargs)))
    assert (got[0] == 0).all()


def test_int8_matmul_and_dense_are_bitwise_jax():
    r = _rng(5)
    x = r.standard_normal((6, 3, 40)).astype(np.float32)
    w = r.standard_normal((40, 24)).astype(np.float32)
    b = r.standard_normal((24,)).astype(np.float32)
    want = jq.int8_dense({"W": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x))
    got = tq.int8_dense({"W": torch.tensor(w), "b": torch.tensor(b)},
                        torch.tensor(x))
    assert got.shape == (6, 3, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bench_int8_nets(seed=7):
    """bench.py:1484-1490's int8 serving net in both packages, the JAX
    weights carried into the port's."""
    K, H, V = 512, 512, 256
    jnet = JMLN(JConf(seed=seed, updater=JSgd(0.1), dtype="float32")
                .list(jl.DenseLayer(n_in=K, n_out=H, activation="relu"),
                      jl.DenseLayer(n_out=H, activation="relu"),
                      jl.OutputLayer(n_out=V, activation="softmax",
                                     loss="mcxent")).build()).init()
    pnet = MultiLayerNetwork(
        NeuralNetConfiguration(seed=seed, updater=Sgd(0.1), dtype="float32")
        .list(DenseLayer(n_in=K, n_out=H, activation="relu"),
              DenseLayer(n_out=H, activation="relu"),
              OutputLayer(n_out=V, activation="softmax", loss="mcxent"))
        .build(), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


@pytest.fixture(scope="module")
def bench_nets():
    return _bench_int8_nets()


def test_int8_forward_fn_matches_jax_on_the_bench_net(bench_nets):
    jnet, pnet = bench_nets
    x = _rng(11).standard_normal((16, 512)).astype(np.float32)
    want = np.asarray(jax.jit(jq.int8_forward_fn(jnet))(
        jnet.params, jnet.state, jnp.asarray(x)))
    with torch.inference_mode():
        got = tq.int8_forward_fn(pnet)(pnet, torch.tensor(x)).numpy()
    assert got.shape == (16, 256)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_int8_forward_stays_within_the_references_bound(bench_nets):
    """tests/test_quantized_kv.py:200-219: rel < 0.05 against f32."""
    _, pnet = bench_nets
    x = _rng(12).standard_normal((16, 512)).astype(np.float32)
    y32 = pnet.output(x).numpy()
    with torch.inference_mode():
        y8 = tq.int8_forward_fn(pnet)(pnet, torch.tensor(x)).numpy()
    rel = np.max(np.abs(y8 - y32)) / (np.max(np.abs(y32)) + 1e-12)
    assert 0 < rel < 0.05


def test_int8_forward_runs_each_dense_matmul_through_the_kernel(
        bench_nets, monkeypatch):
    _, pnet = bench_nets
    calls = []
    real = tq.int8_matmul_fused
    monkeypatch.setattr(tq, "int8_matmul_fused",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tq.int8_forward_fn(pnet)(pnet, torch.zeros(3, 512))
    assert calls == [(3, 512)] * 3


def test_int8_forward_fn_requantizes_the_networks_live_weights(bench_nets):
    """The forward quantizes from the network it is handed, on every call:
    a net with other weights gives other outputs through the same fn."""
    _, pnet = bench_nets
    _, other = _bench_int8_nets(seed=8)
    fwd = tq.int8_forward_fn(pnet)
    x = torch.tensor(_rng(13).standard_normal((4, 512)).astype(np.float32))
    with torch.inference_mode():
        a, b = fwd(pnet, x), fwd(other, x)
        assert not torch.equal(a, b)
        y8 = tq.int8_forward_fn(other)(other, x)
    assert torch.equal(b, y8)


def test_int8_forward_fn_rejects_a_compute_dtype_net(bench_nets):
    _, pnet = bench_nets

    class _Conf:
        compute_dtype = "bfloat16"

    class _Net:
        conf = _Conf()

    with pytest.raises(ValueError, match="full-precision"):
        tq.int8_forward_fn(_Net())
    tq.int8_forward_fn(pnet)                # no compute_dtype: accepted
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        NeuralNetConfiguration(compute_dtype="bfloat16")


def test_probe_and_wrapper_checks(monkeypatch):
    assert tq.int8_matmul_applicable(1, 1, 1)
    assert tq.int8_matmul_applicable(33, 37, 70)     # the TPU probe refuses
    assert not jq.int8_matmul_applicable(33, 37, 70)
    _, targs = _quantized(3, 4, 8, 5)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tq.int8_matmul_fused(*(t.to("meta") for t in targs))
    before = tq.int8_matmul_fused.launches
    tq.int8_matmul_fused(*targs)
    assert tq.int8_matmul_fused.launches == before
    assert tq.roofline(256, 512, 256) == jq.roofline("256x512x256")
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(nvcc, "library_path",
                        lambda source: nvcc.BUILD_DIR / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tq.build()


@pytest.mark.cuda
def test_k8_on_the_card_is_bitwise_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the wrapper computes its "
                    "plain version")
    _, targs = _quantized(4, 33, 515, 129, zero_rows=(1,))
    targs = tuple(t.cuda() for t in targs)
    assert torch.equal(tq.int8_matmul_fused(*targs),
                       tq.int8_matmul_plain(*targs))
