"""Port's flash attention (deeplearning4j_tpu_torch/ops/flash_attention.py)
against the JAX package's: on the CPU the port computes the kernel's plain
version, held against the JAX Pallas forward ``_fwd`` in interpret mode
(conftest sets DL4J_TPU_FUSED_ATTN_INTERPRET) and against the plain
``ring_attention.attention``. O and lse at atol 2e-5, the reference's own
attention pin (ops/kernels/builtins.py:54). The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.parallel.ring_attention import attention as jattention
from deeplearning4j_tpu_torch import device as tdevice
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import nvcc
from deeplearning4j_tpu_torch.parallel.ring_attention import attention

ATOL = 2e-5
H, T = 2, 256


def _inputs(seed, B, D, masked, full_row):
    """q/k/v [B,H,T,D] and a [B,T] key mask. ``full_row`` hides the first
    8 keys of batch row 0 (so causal query rows 0..7 see no key) and, with
    B=2, every key of batch row 1 (a fully masked row without causality)."""
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    if not masked:
        return q, k, v, None
    km = (r.random((B, T)) > 0.3).astype(np.float32)
    if full_row:
        km[0, :8] = 0.0
        if B > 1:
            km[1] = 0.0
    return q, k, v, km


def _port(q, k, v, km, causal):
    B, _, _, D = q.shape
    t = lambda a: torch.from_numpy(a.reshape(B * H, T, D))
    o, lse = fa.flash_attention_fwd(
        t(q), t(k), t(v), None if km is None else torch.from_numpy(km),
        causal=causal, scale=1.0 / np.sqrt(D))
    return o.numpy().reshape(B, H, T, D), lse.numpy()


def _jax_fwd(q, k, v, km, causal):
    B, _, _, D = q.shape
    j = lambda a: jnp.asarray(a.reshape(B * H, T, D))
    o, lse = jpa._fwd(j(q), j(k), j(v), None if km is None else jnp.asarray(km),
                      causal, 1.0 / float(np.sqrt(D)))
    return np.asarray(o).reshape(B, H, T, D), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_plain_version_matches_jax_flash_forward(D, causal, masked):
    q, k, v, km = _inputs(D + 2 * causal + masked, 1, D, masked,
                          full_row=True)
    o, lse = _port(q, k, v, km, causal)
    jo, jlse = _jax_fwd(q, k, v, km, causal)
    np.testing.assert_allclose(o, jo, atol=ATOL)
    np.testing.assert_allclose(lse, jlse, atol=ATOL)
    # the XLA-path reference the TPU kernel is pinned against
    ref = np.asarray(jattention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal,
                                key_mask=None if km is None
                                else jnp.asarray(km)))
    np.testing.assert_allclose(o, ref, atol=ATOL)


def test_fully_masked_batch_row_is_uniform():
    q, k, v, km = _inputs(7, 2, 64, True, full_row=True)
    o, lse = _port(q, k, v, km, causal=False)
    jo, jlse = _jax_fwd(q, k, v, km, causal=False)
    np.testing.assert_allclose(o, jo, atol=ATOL)
    # row 1 sees no key: every query averages all values, lse is -1e30
    np.testing.assert_allclose(o[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), o[1].shape), atol=ATOL)
    assert np.all(lse[H:] == jlse[H:]) and np.all(lse[H:] <= -1e29)


@pytest.mark.parametrize("causal", [False, True])
def test_port_plain_attention_matches_jax(causal):
    """parallel/ring_attention.attention: both fill values (-inf causal
    without a key mask, -1e30 with one), at a decode-like Tq < Tk."""
    r = np.random.default_rng(3)
    q = r.normal(size=(2, 2, 5, 16)).astype(np.float32)
    k, v = (r.normal(size=(2, 2, 12, 16)).astype(np.float32)
            for _ in range(2))
    for km in (None, (r.random((2, 12)) > 0.4).astype(np.float32)):
        ours = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=causal,
                         key_mask=None if km is None else torch.from_numpy(km))
        ref = jattention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                         key_mask=None if km is None else jnp.asarray(km))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_flash_attention_bhtd_wrapper_matches_jax():
    q, k, v, _ = _inputs(11, 1, 64, False, False)
    ours = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    ref = jpa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("B", [1, 2])
def test_wrapper_hands_the_kernel_what_it_checks(B, monkeypatch):
    """The layer's heads are a transposed view; whatever layout reaches
    flash_attention, the [BH,T,D] tensors it passes on pass the kernel
    wrapper's checks."""
    seen = []
    plain = fa.flash_attention_fwd

    def checked(q3, k3, v3, key_mask=None, **kw):
        fa._check(q3, k3, v3, key_mask)
        seen.append(q3.shape)
        return plain(q3, k3, v3, key_mask, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd", checked)
    x = torch.randn(B, T, H, 64)
    q = x.transpose(1, 2)                       # [B,H,T,D], not contiguous
    out = fa.flash_attention(q, q, q, causal=True)
    assert seen == [(B * H, T, 64)] and out.shape == (B, H, T, 64)


def test_probe_agrees_with_jax_probe():
    dts = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
           (torch.float16, jnp.float16)]
    for t in (128, 200, 256, 384, 512, 1024):
        for d in (32, 64, 80, 96, 128, 256):
            for tdt, jdt in dts:
                assert fa.fused_attention_applicable(1, 2, t, d, tdt) == \
                    jpa.fused_attention_applicable(1, 2, t, d, jdt), (t, d, tdt)


def test_probe_states_the_kernels_head_dims():
    # the TPU probe admits any multiple of 128; the Hopper kernel is built
    # for D <= 256, so wider heads take the plain attention in the port
    assert jpa.fused_attention_applicable(1, 2, 256, 384, jnp.float32)
    assert not fa.fused_attention_applicable(1, 2, 256, 384, torch.float32)
    assert fa.KERNEL_HEAD_DIMS == (64, 96, 128, 256)


def test_cuda_only_requests_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_non_cpu_non_cuda_tensors_are_refused():
    q = torch.empty((2, 256, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention_fwd(q, q, q, causal=True, scale=0.125)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout", "mask",
                                 "shape"])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(bad):
    q = torch.zeros((4, 256, 64))
    k, v, km = q.clone(), q.clone(), torch.ones((2, 256))
    if bad == "head_dim":
        q = k = v = torch.zeros((4, 256, 80))
    elif bad == "dtype":
        q = k = v = q.to(torch.float16)
    elif bad == "layout":
        q = torch.zeros((4, 64, 256)).transpose(1, 2)
    elif bad == "mask":
        km = torch.ones((3, 256))
    else:
        k = torch.zeros((4, 128, 64))
    with pytest.raises(ValueError):
        fa._check(q, k, v, km)


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(nvcc, "library_path",
                        lambda source: nvcc.BUILD_DIR / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.build()


def test_library_is_named_by_source_hash():
    import hashlib
    # the source and the local headers it includes (the key loop it shares
    # with the ring hop's kernel, and the wgmma helpers)
    h = hashlib.sha256(fa.SOURCE.read_bytes())
    for header in ("flash_fwd_tile.cuh", "hopper_mma.cuh"):
        h.update((fa.SOURCE.parent / header).read_bytes())
    tag = h.hexdigest()[:16]
    assert fa.library_path().name == f"libflash_attention_fwd_{tag}.so"
    assert fa.library_path().parent == nvcc.BUILD_DIR
