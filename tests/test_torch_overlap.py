"""Bucketed gradient sync (``parallel/overlap.py``) and the wrapper's
``overlap_sync`` path, windows, K-step averaging and remainder batches,
against the JAX package's ``parallel/overlap.py`` and ``ParallelWrapper``
on its virtual CPU devices.

The schedule is host metadata and equals the reference's leaf for leaf.
``bucketed_pmean`` and ``fused_pmean`` are held bitwise to the per-leaf
``pmean`` sweep (the rows added in worker order whatever the grouping),
and the overlap path bitwise to the plain sync path at every bucket size.
Across the packages a fit is held at 1e-6 rel-to-max (their forward and
backward passes differ in the last bits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import overlap as jov
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.data_parallel import flat_param_order
from deeplearning4j_tpu_torch.parallel.overlap import (build_bucket_schedule,
                                                       bucketed_pmean,
                                                       fused_pmean,
                                                       profile_schedule)

R = np.random.default_rng(23)
X = R.normal(size=(256, 6)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[(X.sum(-1) > 0).astype(int)
                                + (X[:, 0] > 1).astype(int)]


# ------------------------------------------------------------- scheduling
def test_bucket_schedule_covers_every_leaf_once():
    leaves = [torch.zeros(100), torch.zeros(3, 7), torch.zeros(50),
              torch.zeros(2, 2, 2)]
    sched = build_bucket_schedule(leaves, bucket_bytes=256)
    seen = sorted(i for b in sched.buckets for i in b.indices)
    assert seen == list(range(sched.num_leaves))
    assert sched.total_bytes == sum(t.numel() * 4 for t in leaves)


def test_bucket_schedule_reverse_order_and_singletons():
    leaves = [torch.zeros(4), torch.zeros(1000), torch.zeros(4),
              torch.zeros(4)]
    sched = build_bucket_schedule(leaves, bucket_bytes=64)
    assert [b.indices for b in sched.buckets] == [(3, 2), (1,), (0,)]


def test_bucket_schedule_separates_dtypes():
    leaves = [torch.zeros(8), torch.zeros(8, dtype=torch.bfloat16),
              torch.zeros(8)]
    sched = build_bucket_schedule(leaves, bucket_bytes=1 << 20)
    assert [b.indices for b in sched.buckets] == [(2,), (1,), (0,)]
    for b in sched.buckets:
        assert len({sched.leaf_dtypes[i] for i in b.indices}) == 1


def test_bucket_schedule_rejects_empty_and_bad_bytes():
    with pytest.raises(ValueError, match="empty"):
        build_bucket_schedule([], 1024)
    with pytest.raises(ValueError, match="bucket_bytes"):
        build_bucket_schedule([torch.zeros(4)], 0)
    with pytest.raises(NotImplementedError, match="A8, part 2b"):
        profile_schedule(make_mesh((2,), ("data",), "cpu"),
                         build_bucket_schedule([torch.zeros(4)]))


@pytest.mark.parametrize("bucket_bytes", [1, 256, 2048, 1 << 30])
def test_schedule_equals_the_references(bucket_bytes):
    """The schedule of a network's parameters equals the reference's of
    the same network, bucket for bucket."""
    jnet, pnet = _pair()
    mine = build_bucket_schedule([p for _, _, p in flat_param_order(pnet)],
                                 bucket_bytes)
    theirs = jov.build_bucket_schedule(jnet.params, bucket_bytes)
    assert [b.indices for b in mine.buckets] == \
        [b.indices for b in theirs.buckets]
    assert mine.describe() == theirs.describe()


# ------------------------------------------------- pmean grouping parity
def _rows(n=8):
    shapes = [(64, 32), (32,), (32, 8), (8,)]
    return [torch.tensor(R.normal(size=(n,) + s).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("bucket_bytes", [1, 2048, 1 << 30])
def test_bucketed_pmean_bit_identical_to_per_leaf_sweep(bucket_bytes):
    mesh = make_mesh((8,), ("data",), "cpu")
    rows = _rows()
    ref = [tmesh.pmean(r, mesh, "data") for r in rows]
    sched = build_bucket_schedule([r[0] for r in rows], bucket_bytes)
    got = bucketed_pmean(rows, sched, mesh, "data")
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    # and the reference's bucketed pmean under shard_map, per leaf
    tree = [jnp.asarray(r.numpy()) for r in rows]
    jsched = jov.build_bucket_schedule([t[0] for t in tree], bucket_bytes)
    fn = jmesh.shard_map(
        lambda *ls: tuple(jov.bucketed_pmean([l[0] for l in ls], jsched,
                                             "data")),
        mesh=jmesh.make_mesh((8,), ("data",), jax.devices()[:8]),
        in_specs=(P("data"),) * 4, out_specs=(P(),) * 4, check_vma=False)
    for a, b in zip(got, jax.jit(fn)(*tree)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-7)


def test_fused_pmean_bit_identical_to_per_leaf_sweep():
    mesh = make_mesh((8,), ("data",), "cpu")
    rows = _rows() + [torch.tensor(R.normal(size=(8, 5)).astype(np.float64))]
    got = fused_pmean(rows, mesh, "data")
    for r, g in zip(rows, got):
        assert g.dtype == r.dtype
        assert torch.equal(tmesh.pmean(r, mesh, "data"), g)


def test_bucketed_pmean_rejects_mismatched_tree():
    mesh = make_mesh((8,), ("data",), "cpu")
    rows = _rows()
    sched = build_bucket_schedule([r[0] for r in rows], 2048)
    with pytest.raises(ValueError, match="schedule"):
        bucketed_pmean([torch.zeros(8, 4)], sched, mesh, "data")
    with pytest.raises(ValueError, match="schedule"):
        bucketed_pmean([r[:4] for r in rows], sched, mesh, "data")


def test_collectives_match_psum_scatter_and_all_gather():
    """The logical mesh's ``psum_scatter`` and ``all_gather`` equal the
    reference's collectives under ``shard_map``."""
    n = 4
    x = R.normal(size=(n, n, 5)).astype(np.float32)
    fn = jmesh.shard_map(
        lambda r: (jax.lax.psum_scatter(r[0], "data", scatter_dimension=0,
                                        tiled=False)[None],
                   jax.lax.all_gather(r[0, 0], "data", axis=0,
                                      tiled=False)[None]),
        mesh=jmesh.make_mesh((n,), ("data",), jax.devices()[:n]),
        in_specs=(P("data"),), out_specs=(P("data"), P("data")),
        check_vma=False)
    js, jg = jax.jit(fn)(jnp.asarray(x))
    mesh = make_mesh((n,), ("data",), "cpu")
    xt = torch.tensor(x)
    np.testing.assert_allclose(tmesh.psum_scatter(xt, mesh, "data").numpy(),
                               np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(
        tmesh.all_gather(xt[:, 0], mesh, "data").numpy(), np.asarray(jg))
    with pytest.raises(ValueError, match="parts"):
        tmesh.psum_scatter(xt[:, :3], mesh, "data")


# ------------------------------------------------ ParallelWrapper parity
def _layers(L):
    return [L.DenseLayer(n_in=6, n_out=24, activation="tanh"),
            L.DenseLayer(n_in=24, n_out=16, activation="tanh"),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _net(updater=None):
    conf = NeuralNetConfiguration(seed=7, updater=updater or tupd.Sgd(0.1)
                                  ).list(*_layers(tl)).build()
    return MultiLayerNetwork(conf, device="cpu").init()


def _pair(updater="sgd"):
    ju, tu = {"sgd": (jupd.Sgd(0.1), tupd.Sgd(0.1)),
              "adam": (jupd.Adam(5e-3), tupd.Adam(5e-3))}[updater]
    jnet = JMLN(JConf(seed=7, updater=ju).list(*_layers(jl)).build()).init()
    pnet = _net(tu)
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def _it(n=128, bs=64):
    return ListDataSetIterator(features=X[:n], labels=Y[:n], batch_size=bs)


def _fit(net, workers=4, epochs=3, n=128, bs=64, **kw):
    pw = ParallelWrapper(net, mesh=make_mesh((workers,), ("data",), "cpu"),
                         **kw)
    pw.fit(_it(n, bs), epochs=epochs)
    return pw


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_overlap_sync_parity_all_bucket_sizes():
    ref = _net()
    _fit(ref)
    for bucket_bytes in (1, 4 * 2 ** 20, 1 << 30):
        net = _net()
        _fit(net, overlap_sync=True, bucket_bytes=bucket_bytes)
        assert torch.equal(net.params_flat(), ref.params_flat())


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_overlap_sync_matches_the_references(updater):
    jnet, pnet = _pair(updater)
    JPW(jnet, mesh=jmesh.make_mesh((4,), ("data",), jax.devices()[:4]),
        overlap_sync=True, bucket_bytes=2048).fit(
        JIter(features=X[:128], labels=Y[:128], batch_size=64), epochs=3)
    _fit(pnet, overlap_sync=True, bucket_bytes=2048)
    assert _rel(pnet.params_flat().numpy(),
                np.asarray(jnet.params_flat())) <= 1e-6


def test_overlap_window_bit_identical_to_per_step():
    a, b = _net(tupd.Adam(5e-3)), _net(tupd.Adam(5e-3))
    _fit(a, overlap_sync=True, bucket_bytes=2048, bs=32, epochs=2)
    pw = _fit(b, overlap_sync=True, bucket_bytes=2048, bs=32, epochs=2,
              steps_per_dispatch=2)
    assert torch.equal(a.params_flat(), b.params_flat())
    assert pw.graph_stats() == {"captures": 0, "replays": 0,
                                "launches_in_replays": {}}


def test_window_ragged_tail_runs_per_step():
    """5 batches in windows of 2: two windows and a ragged last batch, all
    equal to 5 single steps."""
    a, b = _net(tupd.Adam(5e-3)), _net(tupd.Adam(5e-3))
    _fit(a, n=160, bs=32, epochs=1)
    seen = []
    _fit(b, n=160, bs=32, epochs=1, steps_per_dispatch=2,
         step_callback=lambda net, k: seen.append(k))
    assert seen == [2, 2, 1]
    assert torch.equal(a.params_flat(), b.params_flat())


def test_overlap_sync_converges():
    net = _net(tupd.Adam(5e-3))
    s0 = net.score(X, Y)
    _fit(net, overlap_sync=True, n=256, epochs=8)
    assert net.score(X, Y) < s0
    assert net.evaluate(X, Y).accuracy() > 0.8


def test_sync_remainder_batch_dispatches_replicated():
    """A batch of 36 on 8 workers takes one whole-batch step, on the plain
    and the overlap path alike, close to the single network's fit."""
    single = _net()
    single.fit(iterator=_it(100, 64), epochs=2, async_prefetch=False)
    flats = []
    for kw in ({}, {"overlap_sync": True, "bucket_bytes": 2048}):
        net = _net()
        _fit(net, workers=8, n=100, epochs=2, **kw)
        np.testing.assert_allclose(net.params_flat().numpy(),
                                   single.params_flat().numpy(),
                                   rtol=2e-5, atol=2e-6)
        flats.append(net.params_flat())
    assert torch.equal(flats[0], flats[1])


def test_sync_remainder_window_dispatches_replicated():
    flats = []
    for kw in ({}, {"overlap_sync": True, "bucket_bytes": 2048}):
        net = _net()
        _fit(net, workers=8, n=120, bs=60, epochs=2, steps_per_dispatch=2,
             **kw)
        flats.append(net.params_flat())
    assert torch.equal(flats[0], flats[1])
    single = _net()
    single.fit(iterator=_it(120, 60), epochs=2, async_prefetch=False)
    np.testing.assert_allclose(flats[0].numpy(),
                               single.params_flat().numpy(),
                               rtol=2e-5, atol=2e-6)


def test_overlap_rejects_accumulator():
    from deeplearning4j_tpu_torch.parallel.accumulation import PsumAccumulator
    with pytest.raises(ValueError, match="overlap_sync"):
        ParallelWrapper(_net(), workers=2, overlap_sync=True,
                        gradient_accumulator=PsumAccumulator())


def test_overlap_rejects_averaging_path():
    with pytest.raises(ValueError, match="averaging"):
        ParallelWrapper(_net(), workers=2, overlap_sync=True,
                        training_mode="averaging", averaging_frequency=4)
    ParallelWrapper(_net(), workers=2, overlap_sync=True,
                    training_mode="averaging", averaging_frequency=1)


# ---------------------------------------------------------- averaging
@pytest.mark.parametrize("average_updaters", [True, False])
def test_k_step_averaging_matches_the_references(average_updaters):
    """``training_mode="averaging"`` with K = 3 on 4 workers, 7 batches (two
    windows and a ragged one of 1), Adam: the parameters, the listeners'
    losses and the updater state against the reference's averaging
    program."""
    jnet, pnet = _pair("adam")
    kw = dict(training_mode="averaging", averaging_frequency=3,
              average_updaters=average_updaters)
    jl_, pl_ = [], []

    class Rec:
        def __init__(self, out):
            self.out = out

        def iteration_done(self, net, it, loss):
            self.out.append((it, float(loss)))

    jnet.set_listeners(Rec(jl_))
    pnet.set_listeners(Rec(pl_))
    JPW(jnet, mesh=jmesh.make_mesh((4,), ("data",), jax.devices()[:4]),
        **kw).fit(JIter(features=X[:224], labels=Y[:224], batch_size=32),
                  epochs=1)
    _fit(pnet, n=224, bs=32, epochs=1, **kw)
    assert pnet.iteration_count == jnet.iteration_count == 7
    assert [i for i, _ in pl_] == [i for i, _ in jl_] == list(range(7))
    np.testing.assert_allclose([v for _, v in pl_], [v for _, v in jl_],
                               rtol=1e-6)
    assert _rel(pnet.params_flat().numpy(),
                np.asarray(jnet.params_flat())) <= 1e-6
    jst = [np.asarray(v) for v in jax.tree.leaves(jnet.opt_state)]
    from deeplearning4j_tpu_torch.parallel.data_parallel import \
        flat_opt_state_order
    for (*_, a), b in zip(flat_opt_state_order(pnet), jst):
        assert _rel(a.numpy(), b) <= 1e-5


def test_k_step_averaging_remainder_batch_runs_whole():
    """Batches of 30 do not tile 4 workers: each window runs one whole-batch
    trajectory, equal to the single network's fit of the same batches."""
    single = _net(tupd.Adam(5e-3))
    single.fit(iterator=_it(90, 30), epochs=1, async_prefetch=False)
    net = _net(tupd.Adam(5e-3))
    _fit(net, n=90, bs=30, epochs=1, training_mode="averaging",
         averaging_frequency=3)
    assert torch.equal(net.params_flat(), single.params_flat())
