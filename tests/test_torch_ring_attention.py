"""Ring attention: the port's carry-kernel plain version, plain ring and fused
ring against the JAX package's ``flash_block_update`` (the Pallas kernel in
interpret mode) and ``ring_attention_sharded`` on its eight virtual CPU
devices, and against plain ``attention`` on the whole sequence.

Tolerances are the reference's (``tests/test_attention.py:241-272``): forward
atol 2e-5, gradients max error over max |gradient| 1e-4; bf16 2e-2. On the
CPU the port's kernel wrappers compute their plain versions."""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_attention as jpa
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import ring_attention as jring
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.parallel import ring_attention as tring
from deeplearning4j_tpu_torch.parallel.mesh import (Sharding, make_mesh,
                                                    ppermute_next)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _qkv(seed, B, H, T, D, scale=0.2):
    r = np.random.default_rng(seed)
    return tuple((r.normal(size=(B, H, T, D)) * scale).astype(np.float32)
                 for _ in range(3))


# ------------------------------------------------------- the carry kernel
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Tq,Tk,causal", [(256, 256, True),
                                          (256, 256, False),
                                          (128, 384, False),
                                          (384, 128, False)])
def test_block_update_plain_version_matches_the_pallas_kernel(dtype, Tq, Tk,
                                                              causal):
    """From a non-trivial incoming carry (what an earlier hop over other
    keys left): the raw (acc, m, l) and the normalised acc / l."""
    BH, D = 4, 64
    scale = float(1.0 / np.sqrt(D))    # a Python float: x64 is on
    r = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    arrs = [r.normal(size=(BH, t, D)).astype(np.float32) * 0.5
            for t in (Tq, Tk, Tk, Tk, Tk)]
    q, k, v, kp, vp = arrs
    tq, tk_, tv, tkp, tvp = (torch.tensor(a).to(dtype) for a in arrs)
    jq, jk, jv, jkp, jvp = (jnp.asarray(a, jdt) for a in arrs)
    # the first hop's empty carry, then an earlier hop, then the hop tested
    carry_t = (torch.zeros(BH, Tq, D), torch.full((BH, Tq), -1e30),
               torch.zeros(BH, Tq))
    carry_j = (jnp.zeros((BH, Tq, D), jnp.float32),
               jnp.full((BH, Tq, 128), -1e30, jnp.float32),
               jnp.zeros((BH, Tq, 128), jnp.float32))
    carry_t = fa.flash_block_update(*carry_t, tq, tkp, tvp, causal=False,
                                    scale=scale)
    carry_j = jpa.flash_block_update(*carry_j, jq, jkp, jvp, causal=False,
                                     scale=scale)
    assert float(carry_t[2].min()) > 0 and float(carry_t[1].max()) > -1e29
    acc, m, l = fa.flash_block_update(*carry_t, tq, tk_, tv, causal=causal,
                                      scale=scale)
    jacc, jm, jl = jpa.flash_block_update(*carry_j, jq, jk, jv,
                                          causal=causal, scale=scale)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert acc.shape == (BH, Tq, D) and m.shape == l.shape == (BH, Tq)
    # the reference keeps m and l lane-replicated [BH,Tq,128]
    jm, jl = np.asarray(jm)[..., 0], np.asarray(jl)[..., 0]
    tol = TOL[dtype]
    np.testing.assert_allclose(m.numpy(), jm, atol=tol)
    assert _rel_to_max(l.numpy(), jl) < GRAD_TOL[dtype]
    np.testing.assert_allclose((acc / l[..., None]).numpy(),
                               np.asarray(jacc) / jl[..., None], atol=tol)
    assert fa.flash_block_update.launches == 0        # no launch on the CPU


def test_block_update_first_hop_gives_no_nan_and_checks_its_arguments():
    BH, T, D = 2, 128, 64
    q, k, v = (torch.randn(BH, T, D) for _ in range(3))
    empty = (torch.zeros(BH, T, D), torch.full((BH, T), -1e30),
             torch.zeros(BH, T))
    acc, m, l = fa.flash_block_update(*empty, q, k, v, causal=True,
                                      scale=0.125)
    assert all(torch.isfinite(t).all() for t in (acc, m, l))
    o, lse = fa.flash_attention_reference(q, k, v, True, 0.125)
    np.testing.assert_allclose((acc / l[..., None]).numpy(), o.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose((m + torch.log(l)).numpy(), lse.numpy(),
                               atol=2e-5)
    # the wrapper's checks are what a CUDA tensor would meet
    bad = [((empty[0], empty[1][:, :64], empty[2], q, k, v), "carry's m"),
           ((empty[0].double(), *empty[1:], q, k, v), "carry's acc"),
           ((*empty, q.half(), k.half(), v.half()), "float32 or bfloat16"),
           ((*empty, q[..., :48], k[..., :48], v[..., :48]), "head dim 48"),
           ((*empty, q, k[:, :64], v[:, :64]), "diagonal hop")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            fa._check_block_update(*args, causal=True)


def test_block_bwd_sums_to_the_whole_backward():
    """Two hops' contributions with the global logsumexp add up to the
    single-call backward over both key blocks."""
    BH, t, D = 2, 128, 64
    g = torch.Generator().manual_seed(0)
    q = torch.randn(BH, t, D, generator=g) * 0.3
    k = torch.randn(BH, 2 * t, D, generator=g) * 0.3
    v = torch.randn(BH, 2 * t, D, generator=g)
    do = torch.randn(BH, t, D, generator=g)
    s = torch.matmul(q, k.transpose(1, 2)) * 0.125
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = torch.matmul(torch.softmax(torch.matmul(
        leaves[0], leaves[1].transpose(1, 2)) * 0.125, dim=-1), leaves[2])
    want = torch.autograd.grad(out, leaves, do)
    parts = [fa.flash_block_bwd(q, k[:, h * t:(h + 1) * t].contiguous(),
                                v[:, h * t:(h + 1) * t].contiguous(), o, lse,
                                do, causal=False, scale=0.125)
             for h in range(2)]
    assert _rel_to_max(parts[0][0] + parts[1][0], want[0]) < 1e-4
    assert _rel_to_max(torch.cat([parts[0][1], parts[1][1]], 1),
                       want[1]) < 1e-4
    assert _rel_to_max(torch.cat([parts[0][2], parts[1][2]], 1),
                       want[2]) < 1e-4


# ------------------------------------------------------------- the rings
def _jax_ring(n, causal, use_fused, q, k, v, grads=True):
    mesh = jmesh.make_mesh((n,), ("seq",), jax.devices()[:n])
    fn = jring.ring_attention_sharded(mesh, "seq", causal=causal,
                                      use_fused=use_fused)
    sh = jring.sequence_sharding(mesh, "seq")
    qs, ks, vs = (jax.device_put(jnp.asarray(t), sh) for t in (q, k, v))
    out = np.asarray(jax.device_get(fn(qs, ks, vs)))
    if not grads:
        return out, None
    g = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                 argnums=(0, 1, 2))(qs, ks, vs)
    return out, [np.asarray(jax.device_get(x)) for x in g]


def _port(fn, q, k, v):
    leaves = [torch.tensor(t).requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    return out, [x.numpy() for x in grads]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "plain"])
def test_rings_match_the_jax_ring_and_whole_attention(n, use_fused):
    """Causal, T 1024, D 64 (the reference's fused-ring test): forward and
    gradients against ``ring_attention_sharded`` on n virtual devices and
    against plain ``attention`` on the whole sequence."""
    q, k, v = _qkv(7, 1, 2, 1024, 64)
    mesh = make_mesh((n,), ("seq",), "cpu")
    fn = tring.ring_attention_sharded(mesh, "seq", causal=True,
                                      use_fused=use_fused)
    got, ggot = _port(fn, q, k, v)
    assert got.shape == (1, 2, 1024, 64)
    jout, jg = _jax_ring(n, True, use_fused, q, k, v)
    whole, gwhole = _port(lambda a, b, c: tring.attention(a, b, c,
                                                          causal=True),
                          q, k, v)
    np.testing.assert_allclose(got.detach().numpy(), jout, atol=2e-5)
    np.testing.assert_allclose(got.detach().numpy(), whole.detach().numpy(),
                               atol=2e-5)
    for name, a, b, c in zip("qkv", ggot, jg, gwhole):
        assert _rel_to_max(a, b) < 1e-4, (name, "jax ring")
        assert _rel_to_max(a, c) < 1e-4, (name, "whole attention")


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "plain"])
def test_noncausal_rings_match(use_fused):
    q, k, v = _qkv(8, 2, 2, 512, 64)
    mesh = make_mesh((4,), ("seq",), "cpu")
    got, ggot = _port(tring.ring_attention_sharded(
        mesh, "seq", causal=False, use_fused=use_fused), q, k, v)
    jout, jg = _jax_ring(4, False, use_fused, q, k, v)
    whole, gwhole = _port(tring.attention, q, k, v)
    np.testing.assert_allclose(got.detach().numpy(), jout, atol=2e-5)
    np.testing.assert_allclose(got.detach().numpy(), whole.detach().numpy(),
                               atol=2e-5)
    for a, b, c in zip(ggot, jg, gwhole):
        assert _rel_to_max(a, b) < 1e-4 and _rel_to_max(a, c) < 1e-4


def test_fused_ring_bf16_and_an_explicit_scale():
    q, k, v = _qkv(9, 1, 2, 1024, 64, scale=0.5)
    mesh = make_mesh((8,), ("seq",), "cpu")
    fn = tring.ring_attention_sharded(mesh, "seq", causal=True, scale=0.2)
    got = fn(*(torch.tensor(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = tring.attention(*(torch.tensor(t) for t in (q, k, v)),
                           causal=True, scale=0.2)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)
    jout, _ = _jax_ring(8, True, True, *(jnp.asarray(t, jnp.bfloat16)
                                         for t in (q, k, v)), grads=False)
    # the JAX ring above ran at the default scale: compare like with like
    got_default = tring.ring_attention_sharded(mesh, "seq", causal=True)(
        *(torch.tensor(t).bfloat16() for t in (q, k, v)))
    np.testing.assert_allclose(got_default.float().numpy(),
                               jout.astype(np.float32), atol=2e-2)


def test_auto_probe_engages_the_fused_ring():
    """``use_fused=None`` takes the carry kernel's path exactly when the
    local block qualifies; the probe's rules are the reference's, with the
    head dims the kernels are built for."""
    ok = fa.fused_ring_applicable
    assert ok(128, 64, torch.float32) and ok(256, 128, torch.bfloat16)
    assert not ok(100, 64, torch.float32)         # t_local % 128
    assert not ok(128, 80, torch.float32)         # a head dim not built
    assert not ok(0, 64, torch.float32)
    assert not ok(128, 64, torch.float16)
    for t, D, jdt, tdt in ((128, 64, jnp.float32, torch.float32),
                           (256, 128, jnp.bfloat16, torch.bfloat16),
                           (100, 64, jnp.float32, torch.float32),
                           (128, 80, jnp.float32, torch.float32)):
        assert ok(t, D, tdt) == jpa.fused_ring_applicable(t, D, jdt)
    # a difference, on purpose: the kernels are not built for D 384
    assert jpa.fused_ring_applicable(128, 384, jnp.float32)
    assert not ok(128, 384, torch.float32)
    q, k, v = (torch.tensor(t) for t in _qkv(3, 1, 1, 1024, 64))
    mesh = make_mesh((8,), ("seq",), "cpu")
    calls = []
    real = tring.flash_block_update
    tring.flash_block_update = lambda *a, **kw: (calls.append(kw["causal"]),
                                                 real(*a, **kw))[1]
    try:
        auto = tring.ring_attention_sharded(mesh, "seq", causal=True)(q, k, v)
        # 8 diagonal hops and 28 full ones; the 28 hidden ones are skipped
        assert sorted(calls) == [False] * 28 + [True] * 8
        calls.clear()
        plain = tring.ring_attention_sharded(mesh, "seq", causal=True,
                                             use_fused=False)(q, k, v)
        odd = tring.ring_attention_sharded(make_mesh((8,), ("seq",), "cpu"),
                                           "seq", causal=True)(
            q[:, :, :800], k[:, :, :800], v[:, :, :800])   # t_local 100
        assert calls == [] and odd.shape == (1, 1, 800, 64)
    finally:
        tring.flash_block_update = real
    np.testing.assert_allclose(auto.numpy(), plain.numpy(), atol=2e-5)


def test_forced_misuse_is_a_targeted_error():
    mesh = make_mesh((2,), ("seq",), "cpu")
    fn = tring.ring_attention_sharded(mesh, "seq", causal=True,
                                      use_fused=True)
    q, k, v = (torch.tensor(t) for t in _qkv(4, 1, 2, 64, 64))
    with pytest.raises(ValueError, match=r"t_local.*multiple of 128"):
        fn(q, k, v)                                # t_local = 32
    q, k, v = (torch.tensor(t) for t in _qkv(4, 1, 2, 256, 80))
    with pytest.raises(ValueError, match="head dim 80"):
        fn(q, k, v)
    with pytest.raises(ValueError, match="does not divide"):
        tring.ring_attention_sharded(make_mesh((3,), ("seq",), "cpu"), "seq")(
            *(torch.tensor(t) for t in _qkv(4, 1, 1, 256, 64)))
    with pytest.raises(ValueError, match="no axis 'seq'"):
        tring.ring_attention_sharded(make_mesh((2,), ("data",), "cpu"), "seq")
    # the tensors lie where the mesh lies
    with pytest.raises(ValueError, match="q lives on meta"):
        fn(*(torch.empty(1, 2, 256, 64, device="meta") for _ in range(3)))


def test_zero_mass_row_gives_zeros_not_nan(monkeypatch):
    """The reference's regression: a q row that gathered no probability
    mass (every hop skipped, simulated by a no-op hop) normalises to zeros
    through the epsilon guard, and its lse stays finite."""
    monkeypatch.setattr(tring, "flash_block_update",
                        lambda acc, m, l, q, k, v, **kw: (acc, m, l))
    mesh = make_mesh((2,), ("seq",), "cpu")
    q3 = torch.randn(2, 2, 128, 64)
    o, lse = tring._ring_fused_fwd(q3, q3, q3, mesh, "seq", False, 0.125)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert not o.any()


def test_fused_ring_result_carries_a_grad_fn():
    mesh = make_mesh((2,), ("seq",), "cpu")
    q, k, v = (torch.tensor(t).requires_grad_()
               for t in _qkv(5, 1, 1, 256, 64))
    out = tring.ring_attention_sharded(mesh, "seq", causal=True)(q, k, v)
    assert out.grad_fn is not None and out.requires_grad
    q3 = q.detach().reshape(2, 1, 128, 64).requires_grad_()
    o3 = tring._RingFused.apply(q3, q3.detach(), q3.detach(), mesh, "seq",
                                True, 0.125)
    assert type(o3.grad_fn).__name__ == "_RingFusedBackward"
    (g,) = torch.autograd.grad(o3.sum(), q3)
    assert g.shape == q3.shape and torch.isfinite(g).all()


def test_sequence_sharding_and_the_ring_permutation():
    mesh = make_mesh((4,), ("seq",), "cpu")
    sh = tring.sequence_sharding(mesh, "seq")
    assert isinstance(sh, Sharding) and sh.dim == 2
    x = torch.arange(2 * 3 * 8 * 5, dtype=torch.float32).reshape(2, 3, 8, 5)
    rows = sh.split(x)
    assert rows.shape == (4, 2, 3, 2, 5)
    assert torch.equal(rows[1], x[:, :, 2:4])
    assert torch.equal(sh.gather(rows), x)
    # after j hops worker i holds the block of worker (i - j) mod n
    held = rows
    for j in range(1, 4):
        held = ppermute_next(held, mesh, "seq")
        for i in range(4):
            assert torch.equal(held[i], rows[(i - j) % 4])
