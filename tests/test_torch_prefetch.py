"""Device prefetch (``datasets/prefetch.py``), ``AsyncDataSetIterator`` and
the mid-epoch resume, against the unwrapped feed and the JAX package.

The cases of the reference's ``tests/test_prefetch_pipeline.py`` that need
neither sharding nor telemetry: a prefetched fit equals the unwrapped fit
bit for bit (fit's default and an explicit ``.prefetch()``); the stream's
values and order equal the JAX prefetcher's; only floats are cast;
multi-input batches ship per input; the producer stays within its depth;
an early break or a consumer error stops it; a base's exception reaches
the consumer. ``ParallelWrapper(prefetch_buffer=2)`` equals
``prefetch_buffer=0`` on a 4-worker logical mesh; ``skip_batches`` and
``skip_first_batches`` skip what the reference's skip. On the CPU the
iterator runs without pinned memory or streams; the card's copy path
(pinned staging, a side stream, an event the consumer waits on) is held by
the ``cuda`` tests of ``tests/test_torch_step_graph.py`` and by
``chip_smoke.py`` phase 4b."""
import _torch_threads  # noqa: F401
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import \
    ListDataSetIterator as JIter
from deeplearning4j_tpu.datasets.prefetch import \
    DevicePrefetchIterator as JDevicePrefetchIterator
from deeplearning4j_tpu.datasets.prefetch import \
    skip_batches as jskip_batches
from deeplearning4j_tpu_torch.datasets.dataset import (AsyncDataSetIterator,
                                                       DataSet,
                                                       DataSetIterator,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.iterators import (
    ExistingDataSetIterator, ListMultiDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.prefetch import (
    DevicePrefetchIterator, _StagingPool, skip_batches)
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Sgd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from _torch_flightrec import _port_flightrec_dir  # noqa: F401


def _tiny(seed=12, device="cpu"):
    conf = (NeuralNetConfiguration(seed=seed, updater=Sgd(0.1))
            .list(tl.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  tl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _toy(seed=0, n=64):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[r.integers(0, 3, size=n)]


def _it(x, y, bs=16):
    return ListDataSetIterator(features=x, labels=y, batch_size=bs)


class CountingIterator(DataSetIterator):
    """Counts the batches pulled out of it (the prefetcher's look-ahead)."""

    def __init__(self, data):
        self.data = list(data)
        self.pulled = 0

    def __iter__(self):
        for ds in self.data:
            self.pulled += 1
            yield ds


def _prefetch(base, depth=2, **kw):
    return DevicePrefetchIterator(base, depth, device="cpu", **kw)


def _await_no_prefetch_threads(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not [t for t in threading.enumerate()
                if t.name == "device-prefetch" and t.is_alive()]:
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------------------------- correctness
def test_training_results_bit_exact_vs_unwrapped():
    x, y = _toy()
    a = _tiny().fit(iterator=_it(x, y), epochs=3)           # the default
    b = _tiny().fit(iterator=_it(x, y), epochs=3, async_prefetch=False)
    c = _tiny().fit(iterator=_it(x, y), epochs=3, prefetch_depth=0)
    assert torch.equal(a.params_flat(), b.params_flat())
    assert torch.equal(c.params_flat(), b.params_flat())
    assert a._solver_inst.prefetcher is not None
    assert b._solver_inst.prefetcher is None


def test_explicit_prefetched_iterator_bit_exact():
    x, y = _toy()
    a = _tiny().fit(iterator=_it(x, y).prefetch(3, device="cpu"), epochs=2)
    b = _tiny().fit(iterator=_it(x, y), epochs=2, async_prefetch=False)
    assert torch.equal(a.params_flat(), b.params_flat())


def test_stream_values_and_order_equal_the_jax_prefetcher():
    x, y = _toy(n=40)
    got = list(_prefetch(_it(x, y, 8), dtype="float32"))
    want = list(JDevicePrefetchIterator(
        JIter(features=x, labels=y, batch_size=8), 2, dtype="float32"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert isinstance(g.features, torch.Tensor)
        np.testing.assert_array_equal(g.features.numpy(),
                                      np.asarray(w.features))
        np.testing.assert_array_equal(g.labels.numpy(),
                                      np.asarray(w.labels))


def test_dtype_cast_floats_only():
    r = np.random.default_rng(1)
    ds = DataSet(r.integers(0, 255, (4, 3)).astype(np.uint8),
                 r.normal(size=(4, 2)).astype(np.float64))
    out = next(iter(_prefetch(ExistingDataSetIterator([ds]), 1,
                              dtype="float32")))
    assert out.features.dtype == torch.uint8
    assert out.labels.dtype == torch.float32
    np.testing.assert_array_equal(out.features.numpy(), ds.features)
    # a tensor of its own, not a view of the base's buffer
    ds.features[0, 0] = 7 if ds.features[0, 0] != 7 else 8
    assert out.features[0, 0] != int(ds.features[0, 0])


def test_multidataset_batches_ship_per_input():
    r = np.random.default_rng(2)
    mds = MultiDataSet([r.normal(size=(4, 3)).astype(np.float32),
                        r.normal(size=(4, 5)).astype(np.float32)],
                       [r.normal(size=(4, 2)).astype(np.float32)],
                       labels_mask=[None])
    out = next(iter(_prefetch(ExistingDataSetIterator([mds]), 1,
                              dtype="float32")))
    assert isinstance(out, MultiDataSet)
    assert all(isinstance(f, torch.Tensor) for f in out.features)
    assert out.labels_mask == [None]
    np.testing.assert_array_equal(out.features[1].numpy(), mds.features[1])


def _six_same_shape(r, n=4):
    """A MultiDataSet of six [n, 3] float arrays: four inputs, two labels."""
    a = [r.normal(size=(n, 3)).astype(np.float32) for _ in range(6)]
    return MultiDataSet(a[:4], a[4:])


def test_six_same_shape_arrays_of_one_batch_ship_intact():
    r = np.random.default_rng(6)
    data = [_six_same_shape(r) for _ in range(5)]
    got = list(_prefetch(ExistingDataSetIterator(data), 1))
    assert len(got) == 5
    for g, want in zip(got, data):
        for a, b in zip(g.features + g.labels, want.features + want.labels):
            np.testing.assert_array_equal(a.numpy(), b)


class _Event:
    """Stands for the copy's CUDA event: records that staging waited."""

    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_staging_pool_never_reuses_a_slot_within_a_batch():
    """The pinned pool's rule, run on plain host buffers: a batch with
    more same-shape arrays than the pool's slots grows it instead of
    overwriting a slot whose copy may still run; the next batch reuses
    every slot after waiting for the copy that read it."""
    pool = _StagingPool(3, pin=False)      # depth 1: 3 slots a shape
    r = np.random.default_rng(7)
    events = []
    for batch in range(3):
        arrays = [torch.from_numpy(r.normal(size=(4, 3)).astype(np.float32))
                  for _ in range(6)]
        taken = []
        for a in arrays:
            taken.append(pool.stage(a, torch.float32, taken))
        assert len({id(s) for s in taken}) == 6
        for slot, a in zip(taken, arrays):
            assert torch.equal(slot[0], a)
        if batch:      # each of the six slots waited for the last copy
            assert [e.waited for e in events[-1]] == [6]
        ev = _Event()
        events.append([ev])
        pool.mark(taken, ev)
    assert pool.allocations == 6


def test_in_flight_depth_respected():
    x, y = _toy(n=240)
    depth = 2
    base = CountingIterator(_it(x, y, 8).data)
    pre = _prefetch(base, depth)
    it = iter(pre)
    consumed = 0
    for _ in range(10):
        next(it)
        consumed += 1
        time.sleep(0.05)        # let the producer run as far as it can
        assert base.pulled <= consumed + depth + 1, (
            f"pulled {base.pulled} with only {consumed} consumed")
    it.close()
    assert pre.batches == 10 and pre.total_wait_ms >= 0.0


def test_async_iterator_keeps_order():
    x, y = _toy(n=40)
    got = list(AsyncDataSetIterator(_it(x, y, 8), queue_size=2))
    assert [g.features[0, 0] for g in got] == \
        [w.features[0, 0] for w in _it(x, y, 8)]


# ---------------------------------------------------------------- shutdown
def test_early_break_stops_producer_thread():
    x, y = _toy(n=800)
    base = CountingIterator(_it(x, y, 8).data)
    for i, _ in enumerate(_prefetch(base)):
        if i == 1:
            break
    assert _await_no_prefetch_threads(), "producer thread leaked after break"
    pulled = base.pulled
    time.sleep(0.15)
    assert base.pulled == pulled, "producer kept pulling after shutdown"
    assert base.pulled < len(base.data)


def test_consumer_exception_stops_producer():
    x, y = _toy(n=800)
    base = CountingIterator(_it(x, y, 8).data)
    with pytest.raises(RuntimeError, match="boom"):
        for i, _ in enumerate(_prefetch(base)):
            if i == 2:
                raise RuntimeError("boom")
    assert _await_no_prefetch_threads()


def test_base_exception_propagates_to_consumer():
    x, y = _toy(n=32)

    class Exploding(DataSetIterator):
        def __iter__(self):
            yield from _it(x, y)
            raise ValueError("disk on fire")

    with pytest.raises(ValueError, match="disk on fire"):
        list(_prefetch(Exploding()))
    assert _await_no_prefetch_threads()


def test_entry_points_run_on_the_card_unless_asked():
    x, y = _toy(n=16)
    saved = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetchIterator(_it(x, y))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _it(x, y).prefetch(2)
    finally:
        torch.cuda.is_available = saved
    with pytest.raises(ValueError, match="depth"):
        _prefetch(_it(x, y), 0)


# ------------------------------------------------ data-parallel and resume
def test_prefetch_buffer_two_equals_zero_on_a_logical_mesh():
    x, y = _toy(n=64)
    nets = []
    for buf in (2, 0):
        net = _tiny()
        ParallelWrapper(net, workers=4, prefetch_buffer=buf).fit(
            _it(x, y), epochs=2)
        nets.append(net)
    assert nets[0].iteration_count == 8
    assert torch.equal(nets[0].params_flat(), nets[1].params_flat())


def test_skip_batches_matches_the_reference():
    x, y = _toy(n=40)
    for n in (0, 2, 7):
        got = [d.features[0, 0] for d in skip_batches(_it(x, y, 8), n)]
        want = [d.features[0, 0] for d in jskip_batches(
            JIter(features=x, labels=y, batch_size=8), n)]
        assert got == want


def test_skip_first_batches_resumes_mid_epoch():
    """Skipping S batches of the first epoch trains what the run that
    wrote the checkpoint had left: after a 2-batch fit and a resume that
    skips those 2, the parameters equal one uninterrupted epoch's; later
    epochs skip nothing."""
    x, y = _toy(n=64)                 # 4 batches of 16
    full = _tiny().fit(iterator=_it(x, y), epochs=2)
    part = _tiny().fit(iterator=_it(x[:32], y[:32]))
    resumed = part.fit(iterator=_it(x, y), epochs=2, skip_first_batches=2)
    assert resumed.iteration_count == full.iteration_count == 8
    assert torch.equal(resumed.params_flat(), full.params_flat())


def test_parallel_wrapper_skip_first_batches_resumes():
    x, y = _toy(n=64)
    full, part = _tiny(), _tiny()
    ParallelWrapper(full, workers=4).fit(_it(x, y))
    pw = ParallelWrapper(part, workers=4)
    pw.fit(_it(x[:16], y[:16]))
    pw.fit(_it(x, y), skip_first_batches=1)
    assert part.iteration_count == full.iteration_count == 4
    assert torch.equal(part.params_flat(), full.params_flat())


def test_multidataset_iterator_feeds_a_prefetched_graph_fit():
    """A ``ListMultiDataSetIterator`` (one input and output here) through
    fit's prefetcher trains a graph as its ``DataSet`` twin does."""
    def graph():
        g = (NeuralNetConfiguration(seed=3, updater=Sgd(0.1))
             .graph_builder().add_inputs("in")
             .add_layer("d", tl.DenseLayer(n_in=4, n_out=8,
                                           activation="tanh"), "in")
             .add_layer("out", tl.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "d")
             .set_outputs("out")
             .set_input_types(InputType.feed_forward(4)))
        return ComputationGraph(g.build(), device="cpu").init()
    x, y = _toy(n=32)
    a = graph().fit(iterator=ListMultiDataSetIterator(
        MultiDataSet([x], [y]), batch_size=16))
    b = graph().fit(iterator=_it(x, y), async_prefetch=False)
    assert a.iteration_count == 2
    assert torch.equal(a.params_flat(), b.params_flat())
