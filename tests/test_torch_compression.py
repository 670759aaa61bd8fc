"""Threshold compression: the port's ``ops/compression.py`` and the plain
version of the one-pass encode kernel (K9, ``ops/threshold_encode.py``)
against the JAX package's ``ops/compression.py`` and its Pallas kernel
``threshold_encode_pallas`` (interpret mode).

Everything here is pinned BITWISE (the reference's parity pin for this
kernel is 0.0): indices, sign maps and counts are compared as integers and
residuals bit for bit, any NaN equal to any NaN (the two frameworks give a
NaN different payload bits). bf16 arrays cross as float32, which holds
every bf16 value exactly."""
import _torch_threads  # noqa: F401
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import compression as jc
from deeplearning4j_tpu.ops import pallas_compression as jpc
from deeplearning4j_tpu_torch import ops as tops
from deeplearning4j_tpu_torch.ops import compression as tc

# the package also exports the function ``ops.threshold_encode``, which
# hides the kernel module of that name from a ``from ... import``
tk = importlib.import_module("deeplearning4j_tpu_torch.ops.threshold_encode")

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
IDS = ["f32", "bf16"]
SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e-30],
                   np.float32)


def _pair(values, jdt, tdt):
    """The same float32 numpy values as a JAX array and a torch tensor of
    the wanted dtype (both round to bf16 to nearest even)."""
    return jnp.asarray(values, jdt), torch.tensor(values).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_same_bits(got, want):
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape
    differ = (a.view(np.uint32) != b.view(np.uint32)) \
        & ~(np.isnan(a) & np.isnan(b))
    assert not differ.any(), (np.nonzero(differ)[0][:5], a[differ][:5],
                              b[differ][:5])


def _residual(seed, n, scale=1.0, special=True):
    g = (np.random.default_rng(seed).normal(size=(n,)) * scale).astype(
        np.float32)
    if special:
        g[:len(SPECIAL)] = SPECIAL
    return g


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("threshold,capacity", [
    (0.5, 2000),       # every live entry fits
    (0.5, 10),         # capacity smaller than the live count
    (0.0, 2000),       # threshold 0: zeros are not live, -0.0 keeps its sign
    (0.0, 17),
    (10.0, 64),        # all below threshold: an empty payload
    (0.01, 100)])
def test_encode_decode_roundtrip_are_bitwise_jax(jdt, tdt, threshold,
                                                 capacity):
    g = _residual(0, 1000)
    if threshold >= 10.0:
        g[3:5] = 0.0                       # no infinities: nothing is live
    gj, gt = _pair(g, jdt, tdt)
    pj, rj = jc.threshold_encode(gj, threshold, capacity)
    pt, rt = tc.threshold_encode(gt, threshold, capacity)
    assert pt.indices.dtype == torch.int32 and pt.signs.dtype == torch.int8
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(pt.signs.numpy(), np.asarray(pj.signs))
    assert int(pt.count) == int(pj.count)
    assert rt.dtype == tdt
    _assert_same_bits(rt, rj)
    if threshold >= 10.0:
        assert int(pt.count) == 0 and not pt.signs.any()
        _assert_same_bits(rt, gt)          # the residual is carried as it was
    dj = jc.threshold_decode(pj, threshold, 1000, jdt)
    dt_ = tc.threshold_decode(pt, threshold, 1000, tdt)
    _assert_same_bits(dt_, dj)
    uj, r2j, _ = jc.threshold_roundtrip(gj, threshold=threshold,
                                        capacity=capacity)
    ut, r2t, p2t = tc.threshold_roundtrip(gt, threshold=threshold,
                                          capacity=capacity)
    _assert_same_bits(ut, uj)
    _assert_same_bits(r2t, r2j)
    np.testing.assert_array_equal(p2t.indices.numpy(), pt.indices.numpy())


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("threshold", [0.0, 0.01, 0.5, 10.0])
def test_signs_and_dense_are_bitwise_jax(jdt, tdt, threshold):
    """Below the kernel's 64K floor both packages take their elementwise
    paths."""
    gj, gt = _pair(_residual(1, 3000), jdt, tdt)
    sj, rj = jc.threshold_encode_signs(gj, threshold)
    st, rt = tc.threshold_encode_signs(gt, threshold)
    assert st.dtype == torch.int8 and rt.dtype == tdt
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    _assert_same_bits(rt, rj)
    dj, r2j = jc.threshold_encode_dense(gj, threshold)
    dt_, r2t = tc.threshold_encode_dense(gt, threshold)
    _assert_same_bits(dt_, dj)
    _assert_same_bits(r2t, r2j)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("threshold", [1e-3, 0.0])
def test_kernel_plain_version_is_bitwise_the_pallas_kernel(jdt, tdt,
                                                           threshold):
    """n = 65,536 + 777, the reference's parity shape (a ragged tail past
    the kernel's block): the Pallas kernel interpreted, the port's plain
    version, and both packages' ``threshold_encode_signs`` seams, which at
    this size route to the kernel's wrapper."""
    n = 65_536 + 777
    g = _residual(2, n, scale=2e-3)
    g[-len(SPECIAL):] = SPECIAL
    g[100], g[101] = threshold, -threshold         # exactly at the threshold
    gj, gt = _pair(g, jdt, tdt)
    assert jpc.fused_threshold_encode_applicable(n, jdt)
    assert tk.fused_threshold_encode_applicable(n, tdt)
    sj, rj = jpc.threshold_encode_pallas(gj, threshold)
    for fn in (tk.threshold_encode_plain, tk.threshold_encode_fused,
               tc.threshold_encode_signs):
        st, rt = fn(gt, threshold)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        _assert_same_bits(rt, rj)
    s2j, r2j = jc.threshold_encode_signs(gj, threshold)
    np.testing.assert_array_equal(np.asarray(s2j), np.asarray(sj))
    if threshold:
        assert st[100] == 1 and st[101] == -1
    assert st[-len(SPECIAL) + 2] == 0 and torch.isnan(rt[-len(SPECIAL) + 2])
    assert tk.threshold_encode_fused.launches == 0     # no launch on the CPU


def test_bf16_threshold_is_rounded_before_the_compare():
    """1e-3 is not a bf16 value: the compare uses bf16(1e-3) = 0.00100040436,
    so a bf16 residual just under it stays."""
    t = tk.threshold_in_dtype(1e-3, torch.bfloat16)
    assert float(t) != 1e-3 and float(t) == float(
        jnp.asarray(1e-3, jnp.bfloat16))
    below = np.nextafter(np.float32(float(t)), np.float32(0.0))
    r = torch.tensor([float(t), float(below)]).bfloat16()
    signs, _ = tk.threshold_encode_plain(r, 1e-3)
    assert signs.tolist() == [1, 0 if float(r[1]) < float(t) else 1]
    sj, _ = jc.threshold_encode_signs(jnp.asarray(_f32(r), jnp.bfloat16), 1e-3)
    np.testing.assert_array_equal(signs.numpy(), np.asarray(sj))


def test_probe_rules():
    ok = tk.fused_threshold_encode_applicable
    assert ok(65_536, torch.float32) and ok(1 << 20, torch.bfloat16)
    assert not ok(65_535, torch.float32)            # below one 64K block
    assert not ok(1 << 20, torch.float16)
    assert not ok(1 << 20, torch.float64)
    # the reference's probe, with its interpreter switch on as the tests
    # run it, admits the same calls
    for n, jdt, tdt in ((65_536, jnp.float32, torch.float32),
                        (65_535, jnp.float32, torch.float32),
                        (1 << 20, jnp.bfloat16, torch.bfloat16),
                        (1 << 20, jnp.float16, torch.float16)):
        assert ok(n, tdt) == jpc.fused_threshold_encode_applicable(n, jdt)


def test_wrapper_and_encode_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="flat 1-D"):
        tk.threshold_encode_fused(torch.zeros(4, 4), 0.1)
    with pytest.raises(ValueError, match="flat 1-D"):
        tc.threshold_encode(torch.zeros(4, 4), 0.1, 3)
    # a 2-D residual is not the kernel's: the seam takes the elementwise path
    s, r = tc.threshold_encode_signs(torch.full((300, 300), 0.2), 0.1)
    assert s.shape == (300, 300) and (s == 1).all()
    np.testing.assert_allclose(r.numpy(), 0.1, atol=1e-7)


def test_residual_carry_is_exact_over_three_steps():
    """The reference's ``test_residual_carry_bit_exact_across_steps``: the
    residual equals a numpy f32 recurrence bitwise at every step, and the
    JAX carry."""
    size, threshold = 512, 5e-3
    rng = np.random.default_rng(77)
    grads = [rng.normal(0, 4e-3, (size,)).astype(np.float32)
             for _ in range(4)]
    res = torch.zeros(size)
    jres = jnp.zeros((size,), jnp.float32)
    ref = np.zeros((size,), np.float32)
    t32 = np.float32(threshold)
    for g in grads:
        signs, res = tc.threshold_encode_signs(res + torch.tensor(g),
                                               threshold)
        jsigns, jres = jc.threshold_encode_signs(jres + jnp.asarray(g),
                                                 threshold)
        acc = ref + g
        s = np.where(np.abs(acc) >= t32, np.sign(acc).astype(np.float32),
                     np.float32(0))
        ref = acc - s * t32
        np.testing.assert_array_equal(res.numpy(), ref)
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        np.testing.assert_array_equal(signs.numpy(), s.astype(np.int8))
        np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))


def test_error_feedback_ships_a_small_entry_later():
    """An entry below the threshold accumulates in the residual and ships
    once it clears it (the reference's error-feedback test)."""
    g = torch.tensor([0.04, 0.0, 0.0, 0.0])
    residual = torch.zeros(4)
    sent_total = torch.zeros(4)
    for _ in range(5):
        update, residual, _ = tc.threshold_roundtrip(
            residual + g, threshold=0.1, capacity=4)
        sent_total += update
    np.testing.assert_allclose(float(sent_total[0] + residual[0]), 0.2,
                               atol=1e-6)
    assert sent_total[0] > 0.0


def test_package_exports_match_the_reference():
    import deeplearning4j_tpu.ops as jops
    assert set(tops.__all__) == set(jops.__all__)
    for name in tops.__all__:
        assert getattr(tops, name) is getattr(tc, name)
