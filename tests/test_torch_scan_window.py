"""K-step windows (``fit(steps_per_dispatch=K)``) and the iteration as a
device tensor, against the per-step fit and the JAX package.

The contract, as the reference's ``tests/test_scan_window.py``: a window
equals K single steps bit for bit, parameters and updater state, with
label and feature masks, a ragged final window, a ``ComputationGraph``
and a prefetched iterator; tBPTT ignores K; ``iter_windows`` groups
same-shape batches and lets the rest through in order. On the CPU a
window's steps run eagerly; on the card they are replays of one captured
step (``optimize/step_graph.py``; ``chip_smoke.py`` phase 4b holds that
path against the per-step fit). The six schedules and the Adam-family
rules take the iteration as a 0-dim tensor and match JAX's traced int32
iteration over 20 iterations at 1e-6, and a window fit matches the JAX
package's ``fit(steps_per_dispatch=4)`` at 1e-5. The embedding's backward
on the CPU (an index_put with accumulation) is bitwise only in its
deterministic form, which the graph cases turn on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import \
    ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as J
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       DataSetIterator,
                                                       ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.iterators import MultiDataSet
from deeplearning4j_tpu_torch.datasets.prefetch import (BatchWindow,
                                                        iter_windows)
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as P


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _tiny(updater=None, seed=12, dropout=0.0):
    conf = (NeuralNetConfiguration(seed=seed, updater=updater or P.Sgd(0.1))
            .list(tl.DenseLayer(n_in=4, n_out=8, activation="tanh",
                                dropout=dropout),
                  tl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _toy(seed=0, n=64):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[r.integers(0, 3, size=n)]


def _it(x, y, bs=8):
    return ListDataSetIterator(features=x, labels=y, batch_size=bs)


def _same(a, b):
    assert a.iteration_count == b.iteration_count
    assert torch.equal(a.params_flat(), b.params_flat())
    for n, st in a.opt_state.items():
        for k, s in st.items():
            for name, t in s.items():
                assert torch.equal(t, b.opt_state[n][k][name]), (n, k, name)


class _Rec:
    def __init__(self):
        self.seen = []

    def iteration_done(self, net, iteration, loss):
        self.seen.append((iteration, loss))


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_window_equals_single_steps_bitwise(k):
    """Params and Adam state, with dropout drawing from the step's seed."""
    x, y = _toy()
    a = _tiny(P.Adam(1e-2), dropout=0.6).fit(iterator=_it(x, y), epochs=3)
    b = _tiny(P.Adam(1e-2), dropout=0.6).fit(iterator=_it(x, y), epochs=3,
                                             steps_per_dispatch=k)
    assert a.iteration_count == 24
    _same(a, b)


def test_ragged_final_window():
    """10 batches at K=4: two windows and a 2-batch per-step tail."""
    x, y = _toy(n=80)
    a = _tiny().fit(iterator=_it(x, y), epochs=2)
    b = _tiny().fit(iterator=_it(x, y), epochs=2, steps_per_dispatch=4)
    assert a.iteration_count == b.iteration_count == 20
    _same(a, b)


def test_window_with_feature_and_label_masks():
    B, T = 4, 6
    r = np.random.default_rng(3)
    x = r.normal(size=(16, T, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, size=(16, T))]
    fmask = np.ones((16, T), np.float32)
    fmask[:, -2:] = 0.0
    lmask = np.ones((16, T), np.float32)
    lmask[:, 0] = 0.0

    def build():
        conf = (NeuralNetConfiguration(seed=21, updater=P.Sgd(0.05))
                .list(tl.LSTM(n_out=7, activation="tanh"),
                      tl.RnnOutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"))
                .set_input_type(InputType.recurrent(5, T)).build())
        return MultiLayerNetwork(conf, device="cpu").init()

    dss = [DataSet(x[i:i + B], y[i:i + B], features_mask=fmask[i:i + B],
                   labels_mask=lmask[i:i + B]) for i in range(0, 16, B)]
    a = build().fit(iterator=ListDataSetIterator(list(dss)), epochs=2)
    b = build().fit(iterator=ListDataSetIterator(list(dss)), epochs=2,
                    steps_per_dispatch=4)
    _same(a, b)


def test_window_on_a_graph(deterministic):
    """transformer_lm (token ids, attention, LayerNorm, Adam) in windows
    of 2 equals its per-step fit."""
    cfg = dict(vocab_size=32, d_model=32, n_heads=2, n_blocks=2,
               max_length=16, token_input=True)
    r = np.random.default_rng(7)
    ids = r.integers(0, 32, size=(8, 16)).astype(np.int64)
    y = np.eye(32, dtype=np.float32)[np.roll(ids, 1, axis=1)]
    a, b = (transformer_lm(**cfg, device="cpu").init() for _ in range(2))
    a.fit(ids, y, batch_size=2, async_prefetch=False)
    b.fit(ids, y, batch_size=2, steps_per_dispatch=2)
    assert a.iteration_count == 4
    _same(a, b)


def test_window_with_a_prefetched_iterator():
    x, y = _toy()
    a = _tiny().fit(iterator=_it(x, y), epochs=2, async_prefetch=False)
    b = _tiny().fit(iterator=_it(x, y).prefetch(3, device="cpu"), epochs=2,
                    steps_per_dispatch=4)
    _same(a, b)


def test_window_losses_reach_the_listeners_per_step():
    """Listeners see each step's loss (a device tensor, read by no one in
    the loop) with its iteration, in order, as the per-step fit does."""
    x, y = _toy()
    ra, rb = _Rec(), _Rec()
    _tiny().set_listeners(ra).fit(iterator=_it(x, y), epochs=2)
    _tiny().set_listeners(rb).fit(iterator=_it(x, y), epochs=2,
                                  steps_per_dispatch=4)
    assert [i for i, _ in ra.seen] == [i for i, _ in rb.seen] == \
        list(range(16))
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for _, v in rb.seen)
    assert [float(v) for _, v in ra.seen] == [float(v) for _, v in rb.seen]


def test_tbptt_ignores_the_window():
    r = np.random.default_rng(9)
    x = r.normal(size=(8, 12, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, size=(8, 12))]

    def build():
        conf = (NeuralNetConfiguration(seed=9, updater=P.Sgd(0.05))
                .list(tl.LSTM(n_out=6, activation="tanh"),
                      tl.RnnOutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"))
                .set_input_type(InputType.recurrent(5, 12))
                .tbptt_length(4).build())
        return MultiLayerNetwork(conf, device="cpu").init()

    a = build().fit(x, y, epochs=2, batch_size=4)
    b = build().fit(x, y, epochs=2, batch_size=4, steps_per_dispatch=8)
    assert a.iteration_count == 2 * 2 * 3      # epochs x batches x chunks
    _same(a, b)


def test_steps_per_dispatch_validation():
    x, y = _toy(n=16)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        _tiny().fit(iterator=_it(x, y), steps_per_dispatch=0)
    with pytest.raises(ValueError, match="skip_first_batches"):
        _tiny().fit(iterator=_it(x, y), skip_first_batches=-1)


def test_window_fit_matches_jax_window_fit():
    """Both packages' fit(steps_per_dispatch=4) from the same weights,
    Adam over 10 batches (two windows and a 2-batch per-step tail),
    parameters at 1e-5."""
    def layers(mod):
        return (mod.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                mod.OutputLayer(n_out=3, activation="softmax",
                                loss="mcxent"))
    jnet = JMLN(JConf(seed=12, updater=J.Adam(1e-2)).list(
        *layers(jl)).build()).init()
    pnet = MultiLayerNetwork(NeuralNetConfiguration(
        seed=12, updater=P.Adam(1e-2)).list(*layers(tl)).build(),
        device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    x, y = _toy(n=80)
    jnet.fit(iterator=JIter(features=x, labels=y, batch_size=8),
             steps_per_dispatch=4)
    pnet.fit(iterator=_it(x, y), steps_per_dispatch=4)
    assert pnet.iteration_count == jnet.iteration_count == 10
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), atol=1e-5)


# ------------------------------------------------- the iteration tensor
SCHEDULES = [("ExponentialSchedule", dict(decay_rate=0.97)),
             ("InverseSchedule", dict(gamma=1e-2, power=0.75)),
             ("PolySchedule", dict(power=2.0, max_iter=15)),
             ("SigmoidSchedule", dict(gamma=0.3, step_size=9)),
             ("StepSchedule", dict(decay_rate=0.5, step_size=4)),
             ("MapSchedule", dict(schedule={"0": 0.3, "5": 0.1,
                                            "12": 0.01}))]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_of_a_tensor_iteration_matches_jax(name, kw):
    js, ts = getattr(J, name)(**kw), getattr(P, name)(**kw)
    for step in range(20):
        got = ts(0.2, torch.tensor(step, dtype=torch.int64))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
        np.testing.assert_allclose(float(got), float(js(
            0.2, jnp.asarray(step, jnp.int32))), rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("rule", ["Adam", "AdaMax", "Nadam"])
def test_adam_family_with_a_tensor_iteration_matches_jax(rule):
    """20 iterations, the iteration a tensor (the port) and a traced int32
    (the reference), under an ExponentialSchedule."""
    r = np.random.default_rng(len(rule))
    p = r.normal(size=(6, 5)).astype(np.float32)
    jr = getattr(J, rule)(learning_rate=0.05,
                          schedule=J.ExponentialSchedule(0.9))
    tr = getattr(P, rule)(learning_rate=0.05,
                          schedule=P.ExponentialSchedule(0.9))
    js, ts = jr.init_one(jnp.asarray(p)), tr.init_one(torch.from_numpy(p))
    for step in range(20):
        g = r.normal(size=p.shape).astype(np.float32)
        jit = jnp.asarray(step, jnp.int32)
        tit = torch.tensor(step, dtype=torch.int64)
        jupd, js = jr.update_one(jnp.asarray(g), js, jr.lr(jit), jit)
        tupd, ts = tr.update_one(torch.from_numpy(g), ts, tr.lr(tit), tit)
        np.testing.assert_allclose(tupd.numpy(), np.asarray(jupd),
                                   rtol=1e-6, atol=1e-6, err_msg=str(step))
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-6)


def test_updater_reads_the_iteration_tensor_it_is_given():
    """One code path: the same tensor object, refilled, moves the
    bias correction as a new Python int would (the captured step's
    contract)."""
    mu = P.MultiLayerUpdater({0: tl.DenseLayer(n_out=2)}, P.Adam(0.1))
    outs = []
    for step in (0, 7):
        params = {0: {"W": torch.ones(3)}}
        state = mu.init(params)
        it = torch.zeros((), dtype=torch.int64).fill_(step)
        mu.update({0: {"W": torch.full((3,), 0.5)}}, state, params, it)
        ref = {0: {"W": torch.ones(3)}}
        ref_state = mu.init(ref)
        mu.update({0: {"W": torch.full((3,), 0.5)}}, ref_state, ref, step)
        assert torch.equal(params[0]["W"], ref[0]["W"])
        outs.append(params[0]["W"].clone())
    assert not torch.equal(outs[0], outs[1])


# --------------------------------------------------------- window maker
def test_iter_windows_groups_and_ragged_tail():
    x, y = _toy(n=72)                # 9 batches of 8
    items = list(iter_windows(_it(x, y), 4))
    assert [type(i).__name__ for i in items] == \
        ["BatchWindow", "BatchWindow", "DataSet"]
    flat = [d for i in items for d in (i.datasets
                                       if isinstance(i, BatchWindow) else [i])]
    want = list(_it(x, y))
    assert len(flat) == 9
    for g, w in zip(flat, want):
        np.testing.assert_array_equal(np.asarray(g.features), w.features)
    assert items[0].num_examples() == 32
    with pytest.raises(ValueError, match="window size"):
        list(iter_windows(_it(x, y), 0))


def test_iter_windows_fallbacks():
    """A ragged group, mask presence that differs and multi-input batches
    come out as bare batches, in order."""
    x, y = _toy(n=20)                # batches of 8, 8, 4
    items = list(iter_windows(_it(x, y), 3))
    assert [i.num_examples() for i in items] == [8, 8, 4]
    assert all(isinstance(i, DataSet) for i in items)
    m = np.ones(8, np.float32)
    mixed = [DataSet(x[:8], y[:8], labels_mask=m), DataSet(x[:8], y[:8])]
    assert all(isinstance(i, DataSet) for i in iter_windows(mixed, 2))
    mds = [MultiDataSet([x[:8]], [y[:8]]) for _ in range(4)]

    class It(DataSetIterator):
        def __iter__(self):
            return iter(mds)

    assert all(isinstance(i, MultiDataSet) for i in iter_windows(It(), 2))
