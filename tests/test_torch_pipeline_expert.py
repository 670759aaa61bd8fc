"""Pipeline and expert parallelism (``parallel/pipeline.py``,
``parallel/expert_parallel.py``) and the logical mesh's new collectives
against the JAX package's on the same stacked parameters (JAX on its 8
virtual CPU devices): ``pipeline_apply``'s outputs and gradients,
``expert_parallel_apply`` at top-1 and top-2, with overflow and
re-routing, its router gradient, and ``load_balancing_loss``; ``psum``,
``all_to_all`` and ``shard_map`` against ``lax``'s under ``shard_map``.
All at rel-to-max 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu.parallel import expert_parallel as jep
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.mesh import shard_map as jshard_map
from deeplearning4j_tpu_torch.parallel import expert_parallel as tep
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import pipeline as tpipe

R = np.random.default_rng(47)
N_DEV = 8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _stages(n, d, scale=0.4):
    return [{"W": R.normal(size=(d, d)).astype(np.float32) * scale,
             "b": R.normal(size=(d,)).astype(np.float32) * 0.1}
            for _ in range(n)]


def _jblock(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def _tblock(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def _jstack(stages):
    return {k: jnp.stack([jnp.asarray(s[k]) for s in stages])
            for k in stages[0]}


def _tstack(stages, grad=False):
    return {k: torch.tensor(np.stack([s[k] for s in stages]),
                            requires_grad=grad) for k in stages[0]}


# ------------------------------------------------------------- pipeline
@pytest.fixture(scope="module")
def pipe_case():
    stages = _stages(N_DEV, 6)
    x = R.normal(size=(5, 4, 6)).astype(np.float32)
    fn = jpipe.pipeline_apply(_jblock, jmake_mesh((N_DEV,), ("pipe",)),
                              "pipe")
    stacked = _jstack(stages)
    y = fn(stacked, jnp.asarray(x))
    g = jax.grad(lambda p: jnp.sum(fn(p, jnp.asarray(x)) ** 2))(stacked)
    return stages, x, np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


def test_pipeline_output_and_gradients_equal_the_references(pipe_case):
    stages, x, y_ref, g_ref = pipe_case
    fn = tpipe.pipeline_apply(_tblock, tmesh.make_mesh((N_DEV,), ("pipe",),
                                                      "cpu"), "pipe")
    stacked = _tstack(stages, grad=True)
    y = fn(stacked, torch.tensor(x))
    assert _rel(y.detach(), y_ref) < 1e-5
    grads = torch.autograd.grad((y ** 2).sum(), list(stacked.values()))
    for k, g in zip(stacked, grads):
        assert _rel(g, g_ref[k]) < 1e-5


def test_pipeline_refuses_a_stage_count_that_is_not_the_axis():
    fn = tpipe.pipeline_apply(_tblock, tmesh.make_mesh((4,), ("pipe",),
                                                      "cpu"), "pipe")
    with pytest.raises(ValueError, match="leading dim"):
        fn(_tstack(_stages(3, 4)), torch.zeros(2, 2, 4))
    sh = tpipe.stage_sharding(tmesh.make_mesh((4,), ("pipe",), "cpu"))
    rows = sh.split(_tstack(_stages(4, 4))["W"])
    assert tuple(rows.shape) == (4, 1, 4, 4)     # one stage a worker


# ------------------------------------------------------------- experts
def _logits(case, N):
    if case == "overflow":           # everyone to expert 0, one slot
        lg = np.full((N, N_DEV), -10.0, np.float32)
        lg[:, 0] = 10.0
        return lg
    if case == "reroute":            # first choices overflow expert 0
        lg = np.full((N, N_DEV), -10.0, np.float32)
        lg[:, 0] = 10.0
        for i in range(N):
            lg[i, i + 1] = 9.0
        return lg
    return R.normal(size=(N, N_DEV)).astype(np.float32)


EXPERT_CASES = {"top1": (1, 8.0, 32), "top2": (2, 8.0, 32),
                "overflow": (1, 0.125, 8), "reroute": (2, 1.0, 4),
                "top2_tight": (2, 0.5, 32)}


@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_experts_equal_the_references(case):
    """Output and router gradient: ``top2_tight`` drops and re-routes at a
    capacity of 8 slots for 64 choices."""
    top_k, cf, N = EXPERT_CASES[case]
    experts = _stages(N_DEV, 6 if N > 8 else 4)
    d = experts[0]["W"].shape[0]
    tokens = R.normal(size=(N, d)).astype(np.float32)
    logits = _logits(case, N)
    jfn = jep.expert_parallel_apply(_jblock, jmake_mesh((N_DEV,),
                                                        ("expert",)),
                                    "expert", capacity_factor=cf,
                                    top_k=top_k)
    js = _jstack(experts)
    y_ref = np.asarray(jfn(js, jnp.asarray(tokens), jnp.asarray(logits)))
    g_ref = np.asarray(jax.grad(lambda l: jnp.sum(
        jfn(js, jnp.asarray(tokens), l) ** 2))(jnp.asarray(logits)))
    tfn = tep.expert_parallel_apply(_tblock, tmesh.make_mesh(
        (N_DEV,), ("expert",), "cpu"), "expert", capacity_factor=cf,
        top_k=top_k)
    lg = torch.tensor(logits, requires_grad=True)
    y = tfn(_tstack(experts), torch.tensor(tokens), lg)
    g, = torch.autograd.grad((y ** 2).sum(), lg)
    assert _rel(y.detach(), y_ref) < 1e-5
    assert _rel(g, g_ref) < 1e-5 if np.abs(g_ref).max() > 0 \
        else np.abs(g.numpy()).max() == 0
    if case in ("top1", "top2"):
        assert float(g.abs().max()) > 0              # the router learns


def test_expert_refusals_are_the_references():
    mesh = tmesh.make_mesh((4,), ("expert",), "cpu")
    with pytest.raises(ValueError, match="top_k"):
        tep.expert_parallel_apply(_tblock, mesh, "expert", top_k=5)
    fn = tep.expert_parallel_apply(_tblock, mesh, "expert")
    with pytest.raises(ValueError, match="gate_logits last dim"):
        fn(_tstack(_stages(4, 4)), torch.zeros(8, 4), torch.zeros(8, 3))
    with pytest.raises(ValueError, match="leading dim"):
        fn(_tstack(_stages(3, 4)), torch.zeros(8, 4), torch.zeros(8, 4))


@pytest.mark.parametrize("top_k", [1, 2])
def test_load_balancing_loss_equals_the_references(top_k):
    for lg in (np.zeros((64, 8), np.float32),
               R.normal(size=(64, 8)).astype(np.float32) * 3):
        want = float(jep.load_balancing_loss(jnp.asarray(lg), top_k=top_k))
        got = float(tep.load_balancing_loss(torch.tensor(lg), top_k=top_k))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


# ---------------------------------------------------------- collectives
def test_psum_all_to_all_and_shard_map_equal_lax():
    """The logical mesh's ``psum`` and ``all_to_all`` (rows a worker) and
    ``shard_map`` against ``lax.psum`` / ``lax.all_to_all`` under the JAX
    package's ``shard_map`` on 8 devices."""
    n = N_DEV
    x = R.normal(size=(n * n, 3)).astype(np.float32)
    jm = jmake_mesh((n,), ("e",))

    def jbody(a):                                     # a: [n, 3] a worker
        return (jax.lax.psum(a, "e"),
                jax.lax.all_to_all(a, "e", 0, 0, tiled=False))
    jsum, ja2a = jshard_map(jbody, mesh=jm, in_specs=(P("e"),),
                            out_specs=(P("e"), P("e")),
                            check_vma=False)(jnp.asarray(x))
    tm = tmesh.make_mesh((n,), ("e",), "cpu")
    rows = torch.tensor(x).reshape(n, n, 3)          # worker i: its n rows
    tsum = tmesh.psum(rows, tm, "e")
    ta2a = tmesh.all_to_all(rows, tm, "e")
    np.testing.assert_array_equal(tsum.reshape(n * n, 3).numpy(),
                                  np.asarray(jsum))
    np.testing.assert_array_equal(ta2a.reshape(n * n, 3).numpy(),
                                  np.asarray(ja2a))
    out = tmesh.shard_map(
        lambda r: (tmesh.psum(r, tm, "e"), tmesh.all_to_all(r, tm, "e")),
        mesh=tm, in_specs=(("e",),), out_specs=(("e",), ("e",)))(
            torch.tensor(x))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jsum))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ja2a))
    assert tmesh.replicated(tm) == ()
    w = tmesh.window_sharding(tmesh.make_mesh((2,), ("data",), "cpu"))
    assert tuple(w.split(torch.zeros(3, 4, 5)).shape) == (2, 3, 2, 5)
