"""The training step as a CUDA graph (``optimize/step_graph.py``) and the
card's prefetch path. This file imports no JAX, so its ``cuda`` tests run
on the card (``python3 -m pytest --noconftest -m cuda
tests/test_torch_step_graph.py``).

On the CPU: a window runs eagerly and makes no graph, the graph refuses a
CPU network, the feed signature and the parameter binding key the
captured step, the counted wrappers are the kernels', and the decode
graph and this one capture through one routine. On the card
(``cuda``, skipped without one): a GravesLSTM network with dropout, with
and without gradient checkpointing, trains in windows of 4 (one capture,
the other steps replays, K5 and K6 in the replays) to the same bits as
per step; a replaced parameter tensor makes a new capture; a prefetched
fit equals the unwrapped one and its pinned pool rotates depth + 2
buffers a shape; a batch of six same-shape arrays at depth 1 arrives
intact (the pool grows rather than overwrite a buffer still being
copied)."""
import _torch_threads  # noqa: F401
import gc

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.iterators import (
    ExistingDataSetIterator, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.prefetch import DevicePrefetchIterator
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import lstm
from deeplearning4j_tpu_torch.optimize import step_graph
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.serving.generation import graphs
from deeplearning4j_tpu_torch.util import graph_capture

V, T = 5, 16


def _lstm_net(device, remat=False, seed=3):
    conf = (NeuralNetConfiguration(seed=seed, updater=Adam(1e-2),
                                   gradient_checkpointing=remat)
            .list(tl.GravesLSTM(n_out=64, activation="tanh"),
                  tl.DenseLayer(n_out=32, activation="tanh", dropout=0.6),
                  tl.RnnOutputLayer(n_out=V, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _seqs(n=64, seed=1):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, T, V)).astype(np.float32)
    return x, np.eye(V, dtype=np.float32)[r.integers(0, V, (n, T))]


def _it(x, y, bs=8):
    return ListDataSetIterator(features=x, labels=y, batch_size=bs)


def test_a_cpu_window_runs_eagerly_and_makes_no_graph():
    x, y = _seqs()
    net = _lstm_net("cpu")
    net.fit(iterator=_it(x, y), steps_per_dispatch=4)
    assert net.iteration_count == 8
    assert net._solver_inst.graph_stats() == {
        "captures": 0, "replays": 0, "launches_in_replays": {}}


def test_the_graph_refuses_a_cpu_network():
    net = _lstm_net("cpu")
    x = torch.zeros(2, T, V)
    with pytest.raises(ValueError, match="CUDA"):
        step_graph.TrainStepGraph(net, [x, x, None, None], lambda f: None,
                                  torch.Generator(), None)


def test_signature_and_binding_key_the_captured_step():
    a, b = torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int64)
    assert step_graph.feed_signature([a, b, None, a]) == (
        ((2, 3), torch.float32), ((2, 3), torch.int64), None,
        ((2, 3), torch.float32))
    net = _lstm_net("cpu")
    before = step_graph.binding(net)
    n_tensors = (sum(len(pd) for pd in net.param_dicts().values())
                 + sum(len(s) for layer in net.opt_state.values()
                       for s in layer.values()))
    assert len(before) == n_tensors
    net.set_params_flat(net.params_flat() * 2)     # in place: same binding
    assert step_graph.binding(net) == before
    net.init()                                     # new tensors: another
    assert step_graph.binding(net) != before


def test_the_counted_wrappers_are_the_kernels():
    assert step_graph.COUNTED == {
        "flash_attention_fwd": fa.flash_attention,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
        "lstm_fwd": lstm.fused_lstm_fwd, "lstm_bwd": lstm.fused_lstm_bwd}


def test_both_graphs_capture_through_one_routine():
    """The decode graph and the training step's graph share the capture,
    its process-wide lock and its collector guard."""
    assert step_graph.capture is graphs.capture is graph_capture.capture
    assert not hasattr(step_graph, "_capture_lock")
    assert not hasattr(graphs, "_capture_lock")
    gc.enable()
    with graph_capture._no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with graph_capture._no_collection():
            pass
        assert not gc.isenabled()      # left as the caller had it
    finally:
        gc.enable()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs and the kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_card_window_graph_equals_single_steps(card, remat):
    x, y = _seqs()
    a = _lstm_net(card, remat).fit(iterator=_it(x, y), epochs=2,
                                   async_prefetch=False)
    b = _lstm_net(card, remat)
    counts = {n: w.launches for n, w in step_graph.COUNTED.items()}
    b.fit(iterator=_it(x, y), epochs=2, steps_per_dispatch=4)
    stats = b._solver_inst.graph_stats()
    assert torch.equal(a.params_flat(), b.params_flat())
    assert (stats["captures"], stats["replays"]) == (1, 15)
    k5 = 2 if remat else 1        # the remat'd LSTM runs its forward twice
    assert stats["launches_in_replays"] == {"lstm_fwd": 15 * k5,
                                            "lstm_bwd": 15}
    # the capture put its counts back: the eager first step's remain
    eager = {n: w.launches - counts[n]
             for n, w in step_graph.COUNTED.items()}
    assert eager["lstm_fwd"] == k5 and eager["lstm_bwd"] == 1


@pytest.mark.cuda
def test_card_new_parameter_tensors_make_a_new_capture(card):
    x, y = _seqs(n=32)
    net = _lstm_net(card)
    net.fit(iterator=_it(x, y), steps_per_dispatch=4)
    net.init()                            # fresh parameter and state tensors
    ref = _lstm_net(card)
    ref.init()
    net.fit(iterator=_it(x, y), steps_per_dispatch=4)
    ref.iteration_count = 4
    ref.fit(iterator=_it(x, y), async_prefetch=False)
    stats = net._solver_inst.graph_stats()
    assert stats["captures"] == 2 and stats["replays"] == 6
    assert torch.equal(net.params_flat(), ref.params_flat())


@pytest.mark.cuda
def test_card_prefetch_trains_as_the_unwrapped_feed(card):
    r = np.random.default_rng(5)
    x = r.normal(size=(256, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 256)]

    def tiny():
        conf = (NeuralNetConfiguration(seed=12, updater=Sgd(0.1))
                .list(tl.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                      tl.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent")).build())
        return MultiLayerNetwork(conf, device=card).init()
    a = tiny().fit(iterator=_it(x, y, 16), epochs=3)
    b = tiny().fit(iterator=_it(x, y, 16), epochs=3, async_prefetch=False)
    assert torch.equal(a.params_flat(), b.params_flat())
    pre = a._solver_inst.prefetcher
    assert pre.device.type == "cuda" and pre.batches == 16
    assert pre._staging.allocations == 2 * (pre.depth + 2)   # x and y


@pytest.mark.cuda
def test_card_prefetch_ships_six_same_shape_arrays_intact(card):
    r = np.random.default_rng(6)
    data = [MultiDataSet([r.normal(size=(256, 1024)).astype(np.float32)
                          for _ in range(4)],
                         [r.normal(size=(256, 1024)).astype(np.float32)
                          for _ in range(2)]) for _ in range(8)]
    pre = DevicePrefetchIterator(ExistingDataSetIterator(data), 1,
                                 device=card)
    n = 0
    for got, want in zip(pre, data):
        for a, b in zip(got.features + got.labels,
                        want.features + want.labels):
            assert a.device.type == "cuda"
            np.testing.assert_array_equal(a.cpu().numpy(), b)
        n += 1
    assert n == 8 and pre._staging.allocations == 6
