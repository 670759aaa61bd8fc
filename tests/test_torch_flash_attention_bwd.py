"""The flash-attention backward of the port (K2 dq and K3 dk/dv in
deeplearning4j_tpu_torch/ops/flash_attention.py) against the JAX package's.

On the CPU the port's autograd Function runs the kernels' plain versions;
the JAX side differentiates its ``flash_attention`` through the Pallas
``_bwd`` kernels in interpret mode (conftest sets
DL4J_TPU_FUSED_ATTN_INTERPRET). Tolerance: max error over max |grad| below
1e-4 in f32, the reference's own pin (tests/test_pallas_attention.py).
The plain backward is also held against autograd through the plain
forward, including rows that see no key, where the port deliberately
differs from the TPU kernel. The CUDA kernels are held against the plain
versions on the card by chip_smoke.py."""
import _torch_threads  # noqa: F401
import hashlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import nvcc

H = 2
TOL = 1e-4


def _inputs(seed, B, T, D, masked):
    """q/k/v/dO [B,H,T,D] and, when ``masked``, a [B,T] key mask whose key
    0 is visible in every batch row, so every query row sees a key."""
    r = np.random.default_rng(seed)
    q, k, v, do = (r.normal(size=(B, H, T, D)).astype(np.float32)
                   for _ in range(4))
    if not masked:
        return q, k, v, do, None
    km = (r.random((B, T)) > 0.3).astype(np.float32)
    km[:, 0] = 1.0
    return q, k, v, do, km


def _port_grads(q, k, v, do, km, causal):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal,
                             key_mask=None if km is None
                             else torch.from_numpy(km))
    return [g.numpy() for g in torch.autograd.grad(
        out, (tq, tk, tv), torch.from_numpy(do))]


def _jax_grads(q, k, v, do, km, causal):
    mask = None if km is None else jnp.asarray(km)

    def f(q, k, v):
        o = jpa.flash_attention(q, k, v, causal=causal, key_mask=mask)
        return jnp.sum(o * jnp.asarray(do))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))]


def _rel_to_max(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("T", [256, 512])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_gradients_match_jax_flash_backward(T, D, causal, masked):
    args = _inputs(T + D + 2 * causal + masked, 2, T, D, masked)
    ours = _port_grads(*args, causal)
    ref = _jax_grads(*args, causal)
    for name, a, b in zip("qkv", ours, ref):
        assert _rel_to_max(a, b) < TOL, name


def _autograd_plain(q3, k3, v3, do3, km, causal, scale):
    xs = [t.clone().requires_grad_() for t in (q3, k3, v3)]
    o, _ = fa.flash_attention_reference(*xs, causal, scale, km)
    return torch.autograd.grad(o, xs, do3)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_equals_autograd_through_plain_forward(causal):
    """With a fully masked batch row (every key hidden) and, causal, query
    rows 0..7 of another row whose first 8 keys are hidden: each such row
    averages all T values in the forward, so autograd gives it dv = dO/T
    per key and no gradient to q or k; the plain backward must agree on
    every row."""
    B, T, D = 2, 256, 64
    q, k, v, do, km = _inputs(5, B, T, D, True)
    km[0, :8] = 0.0
    km[1] = 0.0
    q3, k3, v3, do3 = (torch.from_numpy(a.reshape(B * H, T, D))
                       for a in (q, k, v, do))
    tkm = torch.from_numpy(km)
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_attention_fwd(q3, k3, v3, tkm, causal=causal,
                                    scale=scale)
    assert bool((lse[H:] <= fa.DEAD).all())
    delta = (do3 * o).sum(-1)
    got = fa.flash_attention_bwd_reference(q3, k3, v3, do3, lse, delta,
                                           causal, scale, tkm)
    want = _autograd_plain(q3, k3, v3, do3, tkm, causal, scale)
    for name, a, b in zip("qkv", got, want):
        assert _rel_to_max(a.numpy(), b.numpy()) < TOL, name
    # the dead batch row: dv is dO averaged over queries, dq is zero
    np.testing.assert_allclose(
        got[2][H:].numpy(),
        np.broadcast_to(do3[H:].mean(dim=1, keepdim=True).numpy(),
                        got[2][H:].shape), atol=1e-6)
    assert float(got[0][H:].abs().max()) == 0.0
    # the two wrappers are the reference's two halves on the CPU
    dq = fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, tkm,
                                   causal=causal, scale=scale)
    dk, dv = fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, tkm,
                                        causal=causal, scale=scale)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


def test_the_tpu_backward_overcounts_a_row_that_sees_no_key():
    """The decision the port's kernels take on purpose: the TPU backward
    takes p = exp(s - lse) = 1 for a row with no visible key (lse is
    -1e30 + log T, which is -1e30 in f32), so its dv is T times the
    autograd value; the port's equals autograd."""
    B, T, D = 2, 256, 64
    q, k, v, do, km = _inputs(9, B, T, D, True)
    km[1] = 0.0
    ours = _port_grads(q, k, v, do, km, causal=False)
    ref = _jax_grads(q, k, v, do, km, causal=False)
    dv_auto = do[1].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(ours[2][1], np.broadcast_to(
        dv_auto, ours[2][1].shape), atol=1e-6)
    np.testing.assert_allclose(ref[2][1], T * np.broadcast_to(
        dv_auto, ref[2][1].shape), rtol=1e-4, atol=1e-4)
    # rows that see a key agree
    for a, b in zip(ours, ref):
        assert _rel_to_max(a[0], b[0]) < TOL


def test_bf16_backward_rounds_like_the_reference():
    """bf16 operands: P and dS are rounded to bf16 before the products, as
    the TPU kernel casts them, and dq/dk/dv come back in bf16."""
    B, T, D = 1, 256, 64
    q, k, v, do, _ = _inputs(13, B, T, D, False)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    for t in bf:
        t.requires_grad_()
    out = fa.flash_attention(*bf, causal=True)
    grads = torch.autograd.grad(out, bf, torch.from_numpy(do).to(
        torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    ref = _jax_grads(*(np.asarray(t.detach().float()) for t in bf),
                     np.asarray(torch.from_numpy(do).to(torch.bfloat16)
                                .float()), None, True)
    for name, a, b in zip("qkv", grads, ref):
        assert _rel_to_max(a.float().numpy(), b) < 2e-2, name


def test_output_has_the_function_as_grad_fn():
    q = torch.randn(1, H, 256, 64, requires_grad=True)
    out = fa.flash_attention(q, q.detach(), q.detach(), causal=True)
    assert isinstance(out.grad_fn, fa.FlashAttentionFunction._backward_cls)
    with torch.no_grad():
        assert fa.flash_attention(q, q, q).grad_fn is None


def test_layer_trains_its_projections_through_the_function():
    """The fault this Function repairs: the attention layer's Wq/Wk/Wv get
    a gradient through the flash path."""
    from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    layer = SelfAttentionLayer(n_out=128, n_heads=2, causal=True,
                               activation="identity", weight_init="xavier",
                               bias_init=0.0)
    layer.init_params(InputType.recurrent(128, 256), torch.float32,
                      torch.device("cpu"), torch.Generator().manual_seed(1))
    x = torch.randn(2, 256, 128)
    assert fa.fused_attention_applicable(2, 2, 256, 64, torch.float32)
    loss = layer(x).square().sum()
    grads = torch.autograd.grad(loss, [layer.Wq, layer.Wk, layer.Wv])
    assert all(float(g.abs().max()) > 0 for g in grads)


def _bwd_args(**over):
    q = torch.zeros((4, 256, 64))
    a = dict(q3=q, k3=q.clone(), v3=q.clone(), dout=q.clone(),
             lse=torch.zeros((4, 256)), delta=torch.zeros((4, 256)),
             key_mask=None)
    a.update(over)
    return a


@pytest.mark.parametrize("bad", ["dout_shape", "dout_dtype", "dout_layout",
                                 "lse_shape", "delta_dtype", "lse_layout"])
def test_backward_checks_refuse_what_the_kernels_do_not_take(bad):
    over = {
        "dout_shape": dict(dout=torch.zeros((4, 128, 64))),
        "dout_dtype": dict(dout=torch.zeros((4, 256, 64),
                                            dtype=torch.bfloat16)),
        "dout_layout": dict(dout=torch.zeros((4, 64, 256)).transpose(1, 2)),
        "lse_shape": dict(lse=torch.zeros((4, 256, 128))),
        "delta_dtype": dict(delta=torch.zeros((4, 256),
                                              dtype=torch.float64)),
        "lse_layout": dict(lse=torch.zeros((256, 4)).t()),
    }[bad]
    a = _bwd_args(**over)
    with pytest.raises(ValueError):
        fa._check_bwd(a["q3"], a["k3"], a["v3"], a["dout"], a["lse"],
                      a["delta"], a["key_mask"])
    fa._check_bwd(*_bwd_args().values())


def test_backward_refuses_non_cpu_non_cuda_tensors():
    a = _bwd_args()
    meta = {k: (v.to("meta") if v is not None else None)
            for k, v in a.items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention_bwd_dq(*meta.values(), causal=True, scale=0.125)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention_bwd_dkv(*meta.values(), causal=True, scale=0.125)


def test_backward_library_is_built_apart_and_named_by_its_hash(monkeypatch):
    h = hashlib.sha256(fa.BWD_SOURCE.read_bytes())
    h.update((fa.BWD_SOURCE.parent / "hopper_mma.cuh").read_bytes())
    tag = h.hexdigest()[:16]
    assert fa.bwd_library_path().name == f"libflash_attention_bwd_{tag}.so"
    assert fa.bwd_library_path().parent == nvcc.BUILD_DIR
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(nvcc, "library_path",
                        lambda source: nvcc.BUILD_DIR / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.build_bwd()
