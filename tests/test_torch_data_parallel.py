"""The data-parallel slice: the port's logical mesh, gradient accumulators and
``ParallelWrapper`` against the JAX package's ``parallel/{mesh,accumulation,
data_parallel}.py`` on its eight virtual CPU devices.

``EncodedAccumulator.combine`` (dense and topk) equals the ``shard_map`` form
bitwise on the same gradients. ``ParallelWrapper`` steps are compared with
one trap in mind: thresholding is a step function, so a gradient entry that
differs by 1e-7 between the frameworks and sits on the threshold flips a
sign. The comparison therefore holds the carried residuals equal within the
float noise the gradients may differ by (2e-6 for the MLP, 1e-4 for the
transformer, whose summed-over-T loss gives entries of up to ~50), allows an entry
whose sign flipped to differ by whole quanta (the threshold, one a step at
most), bounds the share of flipped entries at 0.2 %, and holds the
parameters within ``lr * threshold`` a step (a flipped quantum on every
worker) plus that noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.models.zoo_extra import transformer_lm as jtransformer_lm
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import (acc_state_to_numpy,
                                                         load_jax_acc_state,
                                                         load_jax_params)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel import accumulation as tacc
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.data_parallel import flat_param_order


def _np(tree):
    return [{k: np.asarray(v, np.float32) for k, v in p.items()}
            for p in tree]


def _jmesh(n, axis="data"):
    return jmesh.make_mesh((n,), (axis,), jax.devices()[:n])


def _cpu_mesh(n, axis="data"):
    return make_mesh((n,), (axis,), "cpu")


# ------------------------------------------------------------------ the mesh
def test_mesh_names_sizes_and_one_device(monkeypatch):
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.device == torch.device("cpu")
    assert make_mesh(device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="does not match axis names"):
        make_mesh((2, 2), ("data",), "cpu")
    with pytest.raises(ValueError, match="must be positive"):
        make_mesh((0,), ("data",), "cpu")
    with pytest.raises(ValueError, match="no axis 'seq'"):
        tmesh.axis_size(mesh, "seq")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((4,))                  # the card is the default device


def test_collectives_match_shard_map():
    """pmean, ppermute_next and axis_index on [n, ...] rows equal
    ``lax.pmean``, ``lax.ppermute`` with the ring's perm and
    ``lax.axis_index`` under ``shard_map`` on 8 devices."""
    n = 8
    x = np.random.default_rng(0).normal(size=(n, 5, 3)).astype(np.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def worker(row):
        return (jax.lax.pmean(row, "data"),
                jax.lax.ppermute(row, "data", perm),
                jax.lax.axis_index("data")[None].astype(jnp.int32))

    jm, jp, ji = jax.jit(jmesh.shard_map(
        worker, mesh=_jmesh(n), in_specs=(P("data"),),
        out_specs=(P("data"), P("data"), P("data")),
        check_vma=False))(jnp.asarray(x))
    mesh = _cpu_mesh(n)
    xt = torch.tensor(x)
    np.testing.assert_allclose(tmesh.pmean(xt, mesh, "data").numpy(),
                               np.asarray(jm), atol=1e-7)
    np.testing.assert_array_equal(
        tmesh.ppermute_next(xt, mesh, "data").numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tmesh.axis_index(mesh, "data").numpy(),
                                  np.asarray(ji))
    with pytest.raises(ValueError, match="worker axis leading"):
        tmesh.pmean(xt[:3], mesh, "data")


def test_shardings_split_and_gather():
    mesh = _cpu_mesh(4)
    x = torch.arange(8 * 3).reshape(8, 3)
    rows = tpar.data_sharding(mesh).split(x)
    assert rows.shape == (4, 2, 3) and torch.equal(rows[1], x[2:4])
    assert torch.equal(tpar.data_sharding(mesh).gather(rows), x)
    with pytest.raises(ValueError, match="does not divide"):
        tpar.data_sharding(mesh).split(x[:6])
    with pytest.raises(ValueError, match="no axis"):
        tpar.data_sharding(mesh, "seq")


# --------------------------------------------------------- the accumulators
def _jax_combine(acc, grads, state, n):
    def worker(g, s):
        u, ns = acc.combine(g[0], s[0], axis="data")
        return u[None], ns[None]

    return jax.jit(jmesh.shard_map(
        worker, mesh=_jmesh(n), in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))(grads, state)


@pytest.mark.parametrize("kwargs", [
    dict(threshold=1e-2), dict(threshold=1e-2, capacity_fraction=0.25),
    dict(threshold=0.0), dict(threshold=1.0),
    dict(threshold=1e-2, encoder="topk")],
    ids=["dense", "topk-0.25", "dense-t0", "dense-none-ships", "topk-0.1"])
def test_encoded_combine_is_bitwise_shard_map(kwargs):
    """The reference's ``test_encoded_accumulator_dense_matches_manual``
    set-up (8 workers, N(0, 2e-2) gradients), from a nonzero carry."""
    n, sz = 8, 640
    rng = np.random.default_rng(0)
    grads = rng.normal(0, 2e-2, (n, sz)).astype(np.float32)
    state = rng.normal(0, 5e-3, (n, sz)).astype(np.float32)
    ju, jns = _jax_combine(jacc.EncodedAccumulator(**kwargs),
                           jnp.asarray(grads), jnp.asarray(state), n)
    tu, tns = tacc.EncodedAccumulator(**kwargs).combine(
        torch.tensor(grads), torch.tensor(state), _cpu_mesh(n))
    assert tu.shape == (n, sz) and tns.shape == (n, sz)
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    if kwargs["threshold"] == 1.0:
        assert not tu.any()
        np.testing.assert_array_equal(tns.numpy(), state + grads)


def test_encoded_combine_bf16_stays_bf16_and_matches():
    n, sz = 8, 64
    grads = np.random.default_rng(1).normal(0, 2e-2, (n, sz)).astype(
        np.float32)
    acc_j = jacc.EncodedAccumulator(threshold=1e-2)
    acc_t = tacc.EncodedAccumulator(threshold=1e-2)
    sj = jnp.broadcast_to(acc_j.init(sz, jnp.bfloat16), (n, sz))
    st = acc_t.init(sz, torch.bfloat16, "cpu").expand(n, sz)
    assert st.dtype == torch.bfloat16
    ju, jns = _jax_combine(acc_j, jnp.asarray(grads, jnp.bfloat16), sj, n)
    tu, tns = acc_t.combine(torch.tensor(grads).bfloat16(), st, _cpu_mesh(n))
    assert tu.dtype == torch.bfloat16 and tns.dtype == torch.bfloat16
    np.testing.assert_array_equal(tns.float().numpy(),
                                  np.asarray(jns.astype(jnp.float32)))
    # the mean of eight bf16 quanta: the sum's order may differ by one
    # bf16 rounding of a value of at most the threshold
    np.testing.assert_allclose(tu.float().numpy(),
                               np.asarray(ju.astype(jnp.float32)), atol=1e-4)


def test_psum_combine_and_constructor_checks(monkeypatch):
    n, sz = 4, 33
    g = torch.tensor(np.random.default_rng(2).normal(size=(n, sz)).astype(
        np.float32))
    u, s = tacc.PsumAccumulator().combine(g, (), _cpu_mesh(n))
    np.testing.assert_allclose(u[2].numpy(), g.mean(0).numpy(), atol=1e-7)
    assert s == () and tacc.PsumAccumulator().init(5, torch.float32) == ()
    with pytest.raises(NotImplementedError):
        tacc.GradientsAccumulator().combine(g, (), _cpu_mesh(n))
    # an accumulator's carry lies on the card unless the caller says "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tacc.EncodedAccumulator().init(5, torch.float32)
    # the same refusals and defaults as the reference
    for kw in (dict(encoder="sparse"),
               dict(encoder="dense", capacity_fraction=0.5)):
        with pytest.raises(ValueError):
            jacc.EncodedAccumulator(**kw)
        with pytest.raises(ValueError):
            tacc.EncodedAccumulator(**kw)
    for kw in (dict(), dict(capacity_fraction=0.3), dict(encoder="topk")):
        a, b = jacc.EncodedAccumulator(**kw), tacc.EncodedAccumulator(**kw)
        assert (a.encoder, a.capacity_fraction, a.threshold) == \
            (b.encoder, b.capacity_fraction, b.threshold)


# ------------------------------------------------------- the small networks
def _mlp_pair(lr=0.1):
    """The reference's ``_dp_net`` in both packages, same weights."""
    def build(conf_cls, layers, upd):
        return (conf_cls(seed=4, updater=upd, dtype="float32")
                .list(layers.DenseLayer(n_in=6, n_out=16, activation="tanh"),
                      layers.OutputLayer(n_out=2, activation="softmax",
                                         loss="mcxent")).build())

    class _TL:
        DenseLayer, OutputLayer = DenseLayer, OutputLayer

    jnet = JMLN(build(JConf, jl, jupd.Sgd(lr))).init()
    pnet = MultiLayerNetwork(build(NeuralNetConfiguration, _TL,
                                   tupd.Sgd(lr)), device="cpu").init()
    load_jax_params(pnet, _np(jnet.params))
    return jnet, pnet


def _mlp_data(n=128, seed=3):
    x = np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(-1) > 0).astype(int)]
    return x, y


def _flat_jax(jnet):
    """The JAX network's parameters in ``ravel_pytree`` order."""
    from jax.flatten_util import ravel_pytree
    return np.asarray(ravel_pytree(jnet.params)[0])


def _flat_port(pnet):
    return torch.cat([p.detach().reshape(-1)
                      for _, _, p in flat_param_order(pnet)]).numpy()


def test_flat_param_order_is_ravel_pytree_order():
    jnet, pnet = _mlp_pair()
    np.testing.assert_array_equal(_flat_port(pnet), _flat_jax(jnet))
    jg = jtransformer_lm(vocab_size=32, d_model=32, n_heads=2, n_blocks=1,
                         max_length=16, token_input=True, seed=5).init()
    pg = transformer_lm(vocab_size=32, d_model=32, n_heads=2, n_blocks=1,
                        max_length=16, token_input=True, device="cpu").init()
    load_jax_params(pg, _np(jg.params))
    np.testing.assert_array_equal(_flat_port(pg), _flat_jax(jg))
    # and the graph's own flat view is the reference's params_flat
    np.testing.assert_array_equal(pg.params_flat().numpy(),
                                  np.asarray(jg.params_flat()))
    flat = pg.params_flat() * 2.0
    pg.set_params_flat(flat)
    np.testing.assert_array_equal(pg.params_flat().numpy(), flat.numpy())
    with pytest.raises(ValueError, match="Expected flat parameter vector"):
        pg.set_params_flat(flat[:-1])


def test_psum_accumulator_equals_plain_sync_equals_single_device_fit():
    """The reference's ``test_psum_accumulator_matches_default_sync_path``
    (atol 1e-6), here also against one worker's ``fit`` on the whole batch
    and against the JAX wrapper."""
    x, y = _mlp_data()
    jnet, a = _mlp_pair()
    _, b = _mlp_pair()
    _, c = _mlp_pair()
    mesh = _cpu_mesh(8)
    it = lambda cls=ListDataSetIterator: cls(features=x, labels=y,
                                             batch_size=64)
    ParallelWrapper(a, mesh=mesh).fit(it(), epochs=2)
    pw = ParallelWrapper(b, mesh=mesh,
                         gradient_accumulator=tacc.PsumAccumulator())
    pw.fit(it(), epochs=2)
    c.fit(iterator=it(), epochs=2)
    JPW(jnet, mesh=_jmesh(8), prefetch_buffer=0).fit(it(JIter), epochs=2)
    assert a.iteration_count == b.iteration_count == c.iteration_count == 4
    assert pw._acc_state.shape == (8, 0)          # a stateless accumulator
    for other in (b.params_flat(), c.params_flat(),
                  torch.tensor(np.asarray(jnet.params_flat()))):
        np.testing.assert_allclose(a.params_flat().numpy(), other.numpy(),
                                   atol=1e-6)


def _assert_threshold_aware(jpw, ppw, jnet, pnet, *, threshold, lr, steps,
                            noise):
    """See the module docstring: residuals equal within ``noise`` (the
    float difference the frameworks' gradients may have accumulated) but
    for flipped quanta, few flips, parameters within lr * threshold."""
    ja, pa = np.asarray(jpw._acc_state), acc_state_to_numpy(ppw)
    assert pa.shape == ja.shape == (ppw.n, pnet.num_params())
    diff = np.abs(ja - pa)
    flipped = diff > noise
    # a flipped entry differs by whole quanta (one a step at most)
    quanta = diff[flipped] / threshold
    assert np.all(np.abs(quanta - np.round(quanta)) <= noise / threshold), \
        quanta[:5]
    assert np.all(np.round(quanta) <= steps)
    assert flipped.mean() < 2e-3, flipped.mean()
    np.testing.assert_allclose(
        _flat_port(pnet), _flat_jax(jnet),
        atol=steps * lr * (threshold + noise) + 1e-6)


@pytest.mark.parametrize("kwargs", [dict(threshold=5e-3),
                                    dict(threshold=5e-3,
                                         capacity_fraction=0.5)],
                         ids=["dense", "topk"])
def test_three_encoded_steps_on_an_mlp_match_the_jax_wrapper(kwargs):
    """One JAX step first, so the weights and the per-worker residual that
    are carried across are mid-training ones; then three steps in both."""
    lr, n = 0.5, 4
    x, y = _mlp_data(256, seed=5)
    jnet, pnet = _mlp_pair(lr)
    jpw = JPW(jnet, mesh=_jmesh(n), prefetch_buffer=0,
              gradient_accumulator=jacc.EncodedAccumulator(**kwargs))
    jpw.fit(JIter(features=x[:64], labels=y[:64], batch_size=64))
    ppw = ParallelWrapper(pnet, mesh=_cpu_mesh(n),
                          gradient_accumulator=tacc.EncodedAccumulator(
                              **kwargs))
    load_jax_params(pnet, _np(jnet.params))
    load_jax_acc_state(ppw, np.asarray(jpw._acc_state))
    pnet.iteration_count = jnet.iteration_count
    assert np.abs(acc_state_to_numpy(ppw)).max() > 0
    losses = []
    pnet.set_listeners(type("L", (), {"iteration_done": staticmethod(
        lambda net, it, loss: losses.append((it, float(loss))))})())
    jpw.fit(JIter(features=x[64:], labels=y[64:], batch_size=64))
    ppw.fit(ListDataSetIterator(features=x[64:], labels=y[64:],
                                batch_size=64))
    assert pnet.iteration_count == jnet.iteration_count == 4
    assert [it for it, _ in losses] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in losses)
    _assert_threshold_aware(jpw, ppw, jnet, pnet, threshold=5e-3, lr=lr,
                            steps=3, noise=2e-6)


def test_three_encoded_steps_on_a_transformer_lm_match_the_jax_wrapper():
    """A two-block ``transformer_lm`` (a ComputationGraph) at T 256, head
    dim 64, so both packages take their flash-attention paths."""
    cfg = dict(vocab_size=64, d_model=128, n_heads=2, n_blocks=2,
               max_length=256, token_input=True)
    lr, n, t, B, T, V = 1e-3, 2, 2e-2, 4, 256, 64
    jnet = jtransformer_lm(**cfg, seed=7, updater=jupd.Sgd(lr)).init()
    pnet = transformer_lm(**cfg, updater=tupd.Sgd(lr), device="cpu").init()
    r = np.random.default_rng(11)
    ids = r.integers(1, V, size=(4 * B, T)).astype(np.int32)
    y = np.eye(V, dtype=np.float32)[np.roll(ids, 1, axis=1)]
    jpw = JPW(jnet, mesh=_jmesh(n), prefetch_buffer=0,
              gradient_accumulator=jacc.EncodedAccumulator(threshold=t))
    jpw.fit(JIter(features=ids[:B], labels=y[:B], batch_size=B))
    ppw = ParallelWrapper(pnet, mesh=_cpu_mesh(n),
                          gradient_accumulator=tacc.EncodedAccumulator(
                              threshold=t))
    load_jax_params(pnet, _np(jnet.params))
    load_jax_acc_state(ppw, np.asarray(jpw._acc_state))
    pnet.iteration_count = jnet.iteration_count
    jpw.fit(JIter(features=ids[B:], labels=y[B:], batch_size=B))
    ppw.fit(ListDataSetIterator(features=ids[B:], labels=y[B:],
                                batch_size=B))
    assert pnet.iteration_count == jnet.iteration_count == 4
    shipped = np.abs(np.asarray(jpw._acc_state)) < t
    assert 0.0 < shipped.mean() <= 1.0
    # the residual has summed four gradients with entries of up to ~50, which
    # the two frameworks compute to about six digits: 1e-4 absolute, 200
    # times under the threshold
    _assert_threshold_aware(jpw, ppw, jnet, pnet, threshold=t, lr=lr,
                            steps=3, noise=1e-4)


def test_remainder_batch_takes_the_replicated_step():
    """A batch that does not tile the mesh: the plain sync path takes one
    whole-batch step (the same update as the JAX wrapper's replicated
    program); the accumulator path raises."""
    x, y = _mlp_data(70, seed=9)
    jnet, pnet = _mlp_pair()
    JPW(jnet, mesh=_jmesh(8), prefetch_buffer=0).fit(
        JIter(features=x, labels=y, batch_size=64))
    ParallelWrapper(pnet, mesh=_cpu_mesh(8)).fit(
        ListDataSetIterator(features=x, labels=y, batch_size=64))
    assert pnet.iteration_count == 2                 # 64, then 6 rows
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=1e-6)
    _, other = _mlp_pair()
    pw = ParallelWrapper(other, mesh=_cpu_mesh(8),
                         gradient_accumulator=tacc.EncodedAccumulator())
    with pytest.raises(ValueError, match="does not divide over the 8"):
        pw.fit(ListDataSetIterator(features=x, labels=y, batch_size=64))


def test_workers_and_mesh_shape_build_the_mesh():
    _, pnet = _mlp_pair()
    assert ParallelWrapper(pnet, workers=4).n == 4
    assert ParallelWrapper(pnet, mesh_shape=(2,)).mesh.shape == {"data": 2}
    assert ParallelWrapper(pnet).n == 1
    assert ParallelWrapper(pnet, workers=4).mesh.device == pnet.device
    with pytest.raises(ValueError, match="mesh OR mesh_shape"):
        ParallelWrapper(pnet, mesh=_cpu_mesh(2), mesh_shape=(2,))
    with pytest.raises(ValueError, match=r"\(d,\) or \(d, m\)"):
        ParallelWrapper(pnet, mesh_shape=(2, 2, 2))


_ACC = tacc.EncodedAccumulator()
_AVG = dict(training_mode="averaging", averaging_frequency=3)


@pytest.mark.parametrize("kwargs,match", [
    (dict(gradient_accumulator=_ACC, **_AVG), "gradient_accumulator applies"),
    (dict(mesh_shape=(2, 2), **_AVG), "model-axis sharding applies"),
    (dict(mesh_shape=(2, 2), gradient_accumulator=_ACC),
     "model-sharded layout cannot feed"),
    (dict(steps_per_dispatch=0), "steps_per_dispatch must be >= 1"),
    (dict(steps_per_dispatch=2, gradient_accumulator=_ACC),
     "dispatches per step"),
    (dict(overlap_sync=True, gradient_accumulator=_ACC), "pick one"),
    (dict(overlap_sync=True, **_AVG), "bucket schedule"),
    (dict(zero_stage=3), "zero_stage must be 0, 1 or 2"),
    (dict(zero_stage=1, gradient_accumulator=_ACC), "pick one"),
    (dict(zero_stage=2, **_AVG), "sharded updater state cannot represent"),
    (dict(zero_stage=1, overlap_sync=True), "drop overlap_sync")])
def test_constructor_refusals_are_the_references(kwargs, match):
    jnet, pnet = _mlp_pair()
    with pytest.raises(ValueError, match=match):
        ParallelWrapper(pnet, **kwargs)
    # the reference refuses the same arguments with the same words
    jkw = dict(kwargs)
    if "gradient_accumulator" in jkw:
        jkw["gradient_accumulator"] = jacc.EncodedAccumulator()
    with pytest.raises(ValueError, match=match):
        JPW(jnet, **jkw)


@pytest.mark.parametrize("kwargs,item", [
    (_AVG, "A7b"), (dict(steps_per_dispatch=4), "A7b"),
    (dict(overlap_sync=True), "A7b"), (dict(zero_stage=1), "A7b"),
    (dict(zero_stage=2), "A7b"), (dict(mesh_shape=(2, 2)), "A7b"),
    (dict(step_callback=lambda net, k: None), "A7b"),
    (dict(prefetch_buffer=2), "A10")])
def test_unported_modes_raise_naming_their_roadmap_item(kwargs, item):
    """The modes that raised until their item was ported now train (A10,
    the A7b-1 options: averaging, windows, overlap, ZeRO,
    ``step_callback``, and A7b-2's model axis; their parity is
    ``tests/test_torch_zero.py``, ``tests/test_torch_overlap.py`` and
    ``tests/test_torch_tensor_parallel.py``). The rules shard no leaf of a
    Dense network, so its ``(2, 2)`` run is a data-parallel run."""
    _, pnet = _mlp_pair()
    if item == "A7b":
        seen = []
        kw = dict(kwargs)
        if "step_callback" in kw:
            kw["step_callback"] = lambda net, k: seen.append(
                (net.iteration_count, k))
        pw = ParallelWrapper(pnet, workers=2, **kw)
        x, y = _mlp_data(48)
        before = pnet.params_flat().clone()
        pw.fit(ListDataSetIterator(features=x, labels=y, batch_size=8))
        assert pnet.iteration_count == 6
        assert not torch.equal(pnet.params_flat(), before)
        if "step_callback" in kw:
            assert seen == [(i, 1) for i in range(1, 7)]
        return
    if item == "A10":
        # device prefetch is ported (ROADMAP A10): the reference's default
        # of 2 batches in flight, and a fit through it trains
        assert ParallelWrapper(pnet).prefetch_buffer == 2
        pw = ParallelWrapper(pnet, workers=2, **kwargs)
        x, y = _mlp_data(16)
        pw.fit(ListDataSetIterator(features=x, labels=y, batch_size=8))
        assert pnet.iteration_count == 2
        return


def test_fit_refusals_and_listeners():
    _, pnet = _mlp_pair()
    pw = ParallelWrapper(pnet, workers=2)
    x, y = _mlp_data(8)
    it = ListDataSetIterator(features=x, labels=y, batch_size=8)
    with pytest.raises(ValueError, match="skip_first_batches"):
        pw.fit(it, skip_first_batches=-1)
    # the mid-epoch resume (ROADMAP A10): the skipped batch is consumed,
    # not trained
    before = pnet.params_flat().clone()
    pw.fit(it, skip_first_batches=1)
    assert pnet.iteration_count == 0
    assert torch.equal(pnet.params_flat(), before)
    # performance listeners are ported (ROADMAP A8, part 1): the
    # wrapper's fit counts its batches through note_batch
    noted = []
    pnet.set_listeners(type("Perf", (), {
        "iteration_done": lambda *a: None,
        "note_batch": lambda self, n, **kw: noted.append(n)})())
    pw.fit(it)
    assert noted == [8] and pnet.iteration_count == 1
    with pytest.raises(TypeError, match="iteration_done"):
        pnet.set_listeners(object())
    with pytest.raises(ValueError, match="lives on"):
        ParallelWrapper(pnet, mesh=make_mesh((2,), ("data",), "meta"))


def test_acc_state_carry_round_trips_and_checks_its_shape():
    _, pnet = _mlp_pair()
    pw = ParallelWrapper(pnet, workers=4, gradient_accumulator=_ACC)
    with pytest.raises(ValueError, match="no accumulator carry yet"):
        acc_state_to_numpy(pw)
    carry = np.random.default_rng(4).normal(
        size=(4, pnet.num_params())).astype(np.float32)
    load_jax_acc_state(pw, carry)
    np.testing.assert_array_equal(acc_state_to_numpy(pw), carry)
    with pytest.raises(ValueError, match="does not match the wrapper's"):
        load_jax_acc_state(pw, carry[:3])


def test_package_exports():
    import deeplearning4j_tpu.parallel as jpar
    assert set(tpar.__all__) <= set(jpar.__all__)
    assert {"ParallelWrapper", "make_mesh", "data_sharding",
            "MODEL_AXIS"} <= set(tpar.__all__)
    assert tpar.MODEL_AXIS == jpar.MODEL_AXIS
