"""The LSTM kernels' plain versions against the JAX Pallas kernels, on the
CPU.

``pallas_lstm._fwd_call`` and ``_bwd_call`` run in the Pallas interpreter
here (tests/conftest.py), at shapes the TPU probe admits (B 8, H 128, T 6).
Every output is compared, the backward's residuals included, for the plain
and the peephole (Graves) variants with and without a mask: forward atol
1e-6 and backward atol 3e-5 in f32 (tests/test_pallas_lstm.py's pins),
bf16 at 2e-2. The layer-level reverse path and GravesBidirectionalLSTM go
through both packages' ``_lstm_scan`` dispatch; the autograd Functions are
pinned against autograd through the plain forward; the probe and the
wrappers' checks are pinned; and a CUDA tensor without a built kernel
raises instead of computing the plain version (on a card only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.ops import pallas_lstm as jpl
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.ops import lstm as tlstm
from deeplearning4j_tpu_torch.ops import nvcc

T, B, H = 6, 8, 128
FWD_ATOL, BWD_ATOL, BF16_ATOL = 1e-6, 3e-5, 2e-2
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]
IDS = ["plain", "plain-masked", "peephole", "peephole-masked"]


def _inputs(seed, peep, masked, dtype=np.float32):
    r = np.random.default_rng(seed)
    a = {"x_proj": r.normal(size=(T, B, 4 * H)) * 0.3,
         "h0": r.normal(size=(B, H)) * 0.1,
         "c0": r.normal(size=(B, H)) * 0.1,
         "R": r.normal(size=(H, 4 * H)) * 0.1}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    mask = None
    if masked:
        lens = r.integers(2, T + 1, size=B)
        mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
        mask[1, 0] = 0.0             # a hole before the end
    peeps = None
    if peep:
        peeps = tuple((r.normal(size=(H,)) * 0.2).astype(np.float32)
                      for _ in range(3))
    return a, mask, peeps


def _jax(a, mask, peeps, dtype):
    j = lambda v: jnp.asarray(v, dtype)
    return ([j(a[k]) for k in ("x_proj", "h0", "c0", "R")],
            None if mask is None else j(mask),
            None if peeps is None else tuple(j(p) for p in peeps))


def _torch(a, mask, peeps, dtype):
    t = lambda v: torch.from_numpy(v).to(dtype)
    return ([t(a[k]) for k in ("x_proj", "h0", "c0", "R")],
            None if mask is None else t(mask),
            None if peeps is None else tuple(t(p) for p in peeps))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _close(got, want, atol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{what} output {i}")


def _bwd_extras(seed, dtype_np=np.float32):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(T, B, H)) * 0.5).astype(dtype_np),
            (r.normal(size=(B, H)) * 0.5).astype(dtype_np),
            (r.normal(size=(B, H)) * 0.5).astype(dtype_np))


@pytest.mark.parametrize("peep,masked", VARIANTS, ids=IDS)
def test_forward_and_backward_equal_the_pallas_kernels(peep, masked):
    a, mask, peeps = _inputs(1, peep, masked)
    (jx, jh, jc, jR), jm, jp = _jax(a, mask, peeps, jnp.float32)
    (tx, th, tc, tR), tm, tp = _torch(a, mask, peeps, torch.float32)
    want = jpl._fwd_call(jx, jh, jc, jR, jm, jp)
    got = tlstm.fused_lstm_fwd(tx, th, tc, tR, tm, tp)
    _close(got, want, FWD_ATOL, "forward")

    dhs, dhT, dcT = _bwd_extras(2)
    gates, cs, c_prev, h_prev = want[1:5]
    jwant = jpl._bwd_call(gates, cs, c_prev, h_prev, jnp.asarray(dhs), jR,
                          jnp.asarray(dhT), jnp.asarray(dcT), jm, jp)
    res = [torch.from_numpy(np.array(v)) for v in (gates, cs, c_prev,
                                                      h_prev)]
    tgot = tlstm.fused_lstm_bwd(*res, torch.from_numpy(dhs), tR,
                                torch.from_numpy(dhT), torch.from_numpy(dcT),
                                tm, tp)
    assert len(tgot) == (7 if peep else 4)
    _close(tgot, jwant, BWD_ATOL, "backward")


@pytest.mark.parametrize("peep,masked", [(True, True), (False, False)],
                         ids=["peephole-masked", "plain"])
def test_bf16_equals_the_pallas_kernels(peep, masked):
    a, mask, peeps = _inputs(3, peep, masked)
    (jx, jh, jc, jR), jm, jp = _jax(a, mask, peeps, jnp.bfloat16)
    (tx, th, tc, tR), tm, tp = _torch(a, mask, peeps, torch.bfloat16)
    want = jpl._fwd_call(jx, jh, jc, jR, jm, jp)
    got = tlstm.fused_lstm_fwd(tx, th, tc, tR, tm, tp)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close(got, want, BF16_ATOL, "bf16 forward")
    dhs, dhT, dcT = _bwd_extras(4)
    jb = lambda v: jnp.asarray(v, jnp.bfloat16)
    tb = lambda v: torch.from_numpy(v).to(torch.bfloat16)
    jwant = jpl._bwd_call(*want[1:5], jb(dhs), jR, jb(dhT), jb(dcT), jm, jp)
    res = [torch.from_numpy(np.array(_np(v))).to(torch.bfloat16)
           for v in want[1:5]]
    tgot = tlstm.fused_lstm_bwd(*res, tb(dhs), tR, tb(dhT), tb(dcT), tm, tp)
    _close(tgot, jwant, BF16_ATOL, "bf16 backward")


@pytest.mark.parametrize("masked", [False, True])
def test_reverse_scan_is_the_flipped_forward(masked):
    """``_lstm_scan(reverse=True)`` in both packages: the fused path over
    the flipped sequence, hs returned in the original order."""
    a, mask, peeps = _inputs(5, True, masked)
    (jx, jh, jc, jR), jm, jp = _jax(a, mask, peeps, jnp.float32)
    (tx, th, tc, tR), tm, tp = _torch(a, mask, peeps, torch.float32)
    names = ("tanh", "sigmoid")
    jhs, (jhT, jcT) = jrec._lstm_scan(
        jx, jh, jc, jR, jnp.tanh, jax.nn.sigmoid, jp,
        None if jm is None else jm[..., None], reverse=True,
        activation_names=names)
    ths, (thT, tcT) = trec._lstm_scan(
        tx, th, tc, tR, torch.tanh, torch.sigmoid, tp,
        None if tm is None else tm[..., None], reverse=True,
        activation_names=names)
    _close([ths, thT, tcT], [jhs, jhT, jcT], 1e-5, "reverse")


def _carry_params(jparams, tlayer):
    with torch.no_grad():
        for k, p in tlayer.param_dict().items():
            p.copy_(torch.tensor(np.asarray(jparams[k], np.float32)))


def test_bidirectional_layer_output_and_gradients_equal_jax():
    n_in = 12
    jlayer = jl.GravesBidirectionalLSTM(n_out=H, weight_init="xavier")
    jparams, _ = jlayer.init(jax.random.PRNGKey(3),
                             JInputType.recurrent(n_in, T), jnp.float32)
    tlayer = tl.GravesBidirectionalLSTM(n_out=H, weight_init="xavier")
    tlayer.init_params(InputType.recurrent(n_in, T), torch.float32,
                       torch.device("cpu"), torch.Generator().manual_seed(0))
    assert list(tlayer.param_dict()) == list(tlayer.param_order)
    r = np.random.default_rng(6)
    jparams = {k: jnp.asarray(r.normal(size=v.shape).astype(np.float32)
                              * 0.2) for k, v in jparams.items()}
    _carry_params(jparams, tlayer)
    x = r.normal(size=(B, T, n_in)).astype(np.float32)
    mask = (np.arange(T)[None, :] < r.integers(3, T + 1, size=B)[:, None]
            ).astype(np.float32)
    w = r.normal(size=(B, T, H)).astype(np.float32)

    def jloss(p):
        out, _ = jlayer.apply(p, {}, jnp.asarray(x), mask=jnp.asarray(mask))
        return jnp.sum(out * w), out
    (jl_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tout = tlayer(torch.from_numpy(x), mask=torch.from_numpy(mask))
    tloss = (tout * torch.from_numpy(w)).sum()
    names = list(tlayer.param_dict())
    tg = torch.autograd.grad(tloss, list(tlayer.param_dict().values()))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    for n, g in zip(names, tg):
        ref = np.asarray(jg[n])
        err = np.abs(g.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < 1e-4, n


@pytest.mark.parametrize("cls,act", [("LSTM", "tanh"), ("GravesLSTM", "tanh"),
                                     ("GravesLSTM", "relu")])
def test_unidirectional_layers_equal_jax(cls, act):
    """The layer's output and final state from a given initial state, with
    a mask: tanh takes the kernels' path, relu the plain recurrence (in
    both packages)."""
    n_in = 12
    jlayer = getattr(jl, cls)(n_out=H, activation=act, weight_init="xavier")
    jparams, _ = jlayer.init(jax.random.PRNGKey(4),
                             JInputType.recurrent(n_in, T), jnp.float32)
    tlayer = getattr(tl, cls)(n_out=H, activation=act, weight_init="xavier")
    tlayer.init_params(InputType.recurrent(n_in, T), torch.float32,
                       torch.device("cpu"), torch.Generator().manual_seed(0))
    assert list(tlayer.param_dict()) == list(tlayer.param_order)
    r = np.random.default_rng(13)
    jparams = {k: jnp.asarray(r.normal(size=v.shape).astype(np.float32)
                              * 0.2) for k, v in jparams.items()}
    _carry_params(jparams, tlayer)
    x = r.normal(size=(B, T, n_in)).astype(np.float32)
    mask = (np.arange(T)[None, :] < r.integers(3, T + 1, size=B)[:, None]
            ).astype(np.float32)
    h0, c0 = ((r.normal(size=(B, H)) * 0.1).astype(np.float32)
              for _ in range(2))
    jout, (jh, jc) = jlayer.apply_with_final_state(
        jparams, {}, jnp.asarray(x), mask=jnp.asarray(mask),
        initial_state=(jnp.asarray(h0), jnp.asarray(c0)))
    tout, (th, tc) = tlayer.apply_with_final_state(
        torch.from_numpy(x), mask=torch.from_numpy(mask),
        initial_state=(torch.from_numpy(h0), torch.from_numpy(c0)))
    _close([tout, th, tc], [jout, jh, jc], 1e-5, cls)


def test_last_time_step_layer_equals_jax():
    r = np.random.default_rng(14)
    x = r.normal(size=(B, T, 5)).astype(np.float32)
    mask = (np.arange(T)[None, :] < r.integers(1, T + 1, size=B)[:, None]
            ).astype(np.float32)
    jlayer, tlayer = jl.LastTimeStepLayer(), tl.LastTimeStepLayer()
    for m in (None, mask):
        want, _ = jlayer.apply({}, {}, jnp.asarray(x),
                               mask=None if m is None else jnp.asarray(m))
        got = tlayer(torch.from_numpy(x),
                     mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("peep,masked", VARIANTS, ids=IDS)
def test_autograd_function_equals_autograd_through_the_plain_forward(
        peep, masked):
    a, mask, peeps = _inputs(7, peep, masked)
    (x, h0, c0, R), m, p = _torch(a, mask, peeps, torch.float32)
    leaves = [x, h0, c0, R] + (list(p) if p is not None else [])
    for t in leaves:
        t.requires_grad_(True)
    w_hs, w_h, w_c = (torch.from_numpy(v) for v in _bwd_extras(9))

    def loss(hs, hT, cT):
        return (hs * w_hs).sum() + (torch.tanh(hT) * w_h).sum() \
            + (cT * cT * w_c).sum()

    if p is not None:
        hs, (hT, cT) = tlstm.fused_lstm_peephole(x, h0, c0, R, *p, mask=m)
    else:
        hs, (hT, cT) = tlstm.fused_lstm(x, h0, c0, R, mask=m)
    got = torch.autograd.grad(loss(hs, hT, cT), leaves)
    ref_out = tlstm.lstm_fwd_reference(x, h0, c0, R, m, p)
    want = torch.autograd.grad(loss(ref_out[0], ref_out[5], ref_out[6]),
                               leaves)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=3e-5)


def test_an_unused_output_gets_a_zero_cotangent():
    a, _, _ = _inputs(10, False, False)
    (x, h0, c0, R), _, _ = _torch(a, None, None, torch.float32)
    x.requires_grad_(True)
    hs, (hT, cT) = tlstm.fused_lstm(x, h0, c0, R)
    g, = torch.autograd.grad(hs.sum(), [x])
    ref, = torch.autograd.grad(tlstm.lstm_fwd_reference(x, h0, c0, R)[0]
                               .sum(), [x])
    np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=3e-5)


def test_probe_admits_what_the_kernels_take():
    ok = dict(peepholes=None, mask=None, reverse=False, activation="tanh",
              gate_activation="sigmoid")
    f32, bf16 = torch.float32, torch.bfloat16
    # shapes the TPU probe refuses (B % 8, H % 128) are the kernels' too
    assert tlstm.fused_lstm_applicable(3, 24, f32, **ok)
    assert tlstm.fused_lstm_applicable(1, 512, bf16, **ok)
    assert tlstm.fused_lstm_applicable(32, 1024, f32, **ok)
    assert jpl.fused_lstm_applicable(8, 128, jnp.float32, **ok)
    assert not jpl.fused_lstm_applicable(3, 24, jnp.float32, **ok)
    assert not tlstm.fused_lstm_applicable(8, 1025, f32, **ok)
    assert not tlstm.fused_lstm_applicable(8, 128, torch.float16, **ok)
    assert not tlstm.fused_lstm_applicable(8, 128, f32, **dict(
        ok, reverse=True))
    assert not tlstm.fused_lstm_applicable(8, 128, f32, **dict(
        ok, activation="relu"))


def test_wrappers_check_their_inputs_and_devices():
    a, _, _ = _inputs(11, False, False)
    (x, h0, c0, R), _, _ = _torch(a, None, None, torch.float32)
    with pytest.raises(ValueError, match="R must be"):
        tlstm._check_common(x, T, B, H, R.T, None, None)
    with pytest.raises(ValueError, match="mask must be"):
        tlstm._check_common(x, T, B, H, R, torch.ones(B, T), None)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tlstm._check_common(x.double(), T, B, H, R, None, None)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tlstm.fused_lstm_fwd(x.to("meta"), h0.to("meta"), c0.to("meta"),
                             R.to("meta"))


def test_build_needs_nvcc_and_names_libraries_by_hash(monkeypatch):
    import hashlib
    h = hashlib.sha256(tlstm.FWD_SOURCE.read_bytes())
    for header in nvcc._local_headers(tlstm.FWD_SOURCE):
        h.update(header.read_bytes())
    tag = h.hexdigest()[:16]
    assert nvcc.library_path(tlstm.FWD_SOURCE).name == f"liblstm_fwd_{tag}.so"
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(nvcc, "library_path",
                        lambda source: nvcc.BUILD_DIR / "missing.so")
    for build in (tlstm.build_fwd, tlstm.build_bwd):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build()


@pytest.mark.cuda
def test_a_cuda_tensor_without_a_kernel_raises(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the wrappers compute "
                    "their plain versions")
    a, _, _ = _inputs(12, False, False)
    (x, h0, c0, R), _, _ = _torch(a, None, None, torch.float32)
    monkeypatch.setattr(nvcc, "_symbols", {})
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc.os.path, "exists", lambda p: False)
    monkeypatch.setattr(nvcc, "library_path",
                        lambda source: nvcc.BUILD_DIR / "missing.so")
    before = tlstm.fused_lstm_fwd.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tlstm.fused_lstm_fwd(*(t.cuda() for t in (x, h0, c0, R)))
    assert tlstm.fused_lstm_fwd.launches == before
