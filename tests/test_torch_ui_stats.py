"""The UI's collection side (``ui/stats.py``, ``ui/storage.py``) against
the JAX package's ``ui``.

``StatsListener`` runs on the same small float64 ``MultiLayerNetwork`` in
both packages (weights carried over by ``interop/jax_params.py``, the
same four batches, histograms, update and activation statistics on). A
float64 network keeps the two fits' parameters equal to ~1e-15, so their
float32 casts, which the statistics read, are equal, and histogram
counts must be equal exactly. The first layer's bias has learning rate 0:
a zero leaf whose histogram range is [-0.5, 0.5]. Moments compare at rel
1e-5 of the leaf's scale (its largest magnitude; the update's mean
magnitude): a mean near zero carries float32 summation error of that
scale in either package, in another order.

The storages' files cross-read both ways: a JSON-lines or SQLite file the
port wrote reads back in the JAX package, and one the JAX package wrote
reads back in the port, with equal records.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch
from _torch_flightrec import _port_flightrec_dir  # noqa: F401

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu_torch import telemetry as ptel
from deeplearning4j_tpu_torch import ui as pui
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd

R = np.random.default_rng(23)
X = R.normal(size=(64, 4)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[R.integers(0, 3, size=64)]
SAMPLE = X[:8]
CFG = dict(report_frequency=1, collect_histograms=True, histogram_bins=10,
           collect_activation_stats=True)


def _layers(L):
    return [L.DenseLayer(n_in=4, n_out=8, activation="tanh",
                         bias_learning_rate=0.0),
            L.DenseLayer(n_out=6, activation="relu"),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _pair(dtype="float64", seed=12):
    jnet = JMLN(JConf(seed=seed, updater=jupd.Sgd(0.1), dtype=dtype).list(
        *_layers(jl)).build()).init()
    pnet = MultiLayerNetwork(NeuralNetConfiguration(
        seed=seed, updater=tupd.Sgd(0.1), dtype=dtype).list(
        *_layers(tl)).build(), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def _fit_both(jstore, pstore, session="s", epochs=1):
    jnet, pnet = _pair()
    jnet.set_listeners(jui.StatsListener(
        jstore, config=jui.StatsUpdateConfiguration(**CFG),
        session_id=session, activation_sample=SAMPLE))
    pnet.set_listeners(pui.StatsListener(
        pstore, config=pui.StatsUpdateConfiguration(**CFG),
        session_id=session, activation_sample=SAMPLE))
    jnet.fit(X, Y, epochs=epochs, batch_size=16)
    pnet.fit(X, Y, epochs=epochs, batch_size=16)
    return jnet, pnet


@pytest.fixture(scope="module")
def records():
    jstore, pstore = jui.InMemoryStatsStorage(), pui.InMemoryStatsStorage()
    _fit_both(jstore, pstore)
    return ((jstore.get_static_info("s", "worker_0"),
             jstore.get_updates("s", "worker_0")),
            (pstore.get_static_info("s", "worker_0"),
             pstore.get_updates("s", "worker_0")))


def _close(got, want, scale, rel=1e-5):
    assert abs(got - want) <= rel * max(abs(want), scale), (got, want, scale)


def test_static_info_has_the_references_keys(records):
    (jst, _), (pst, _) = records
    assert set(pst) == set(jst)
    assert pst["param_names"] == jst["param_names"] == [
        "0/W", "0/b", "1/W", "1/b", "2/W", "2/b"]
    assert pst["num_params"] == jst["num_params"] == 4 * 8 + 8 + 8 * 6 \
        + 6 + 6 * 3 + 3
    assert pst["model_class"] == "MultiLayerNetwork"
    assert pst["backend"] == "cpu" and pst["device_kind"] == "cpu"
    assert pst["model_config_json"]


def test_records_have_the_references_keys(records):
    (_, jups), (_, pups) = records
    assert [u["iteration"] for u in pups] == \
        [u["iteration"] for u in jups] == [0, 1, 2, 3]
    for j, p in zip(jups, pups):
        assert set(p) == set(j)
        assert set(p["memory"]) == set(j["memory"])
        for kind in ("params", "updates"):
            if kind in j:
                assert list(p[kind]) == list(j[kind])
                for n in j[kind]:
                    assert list(p[kind][n]) == list(j[kind][n])
        assert list(p["activations"]) == list(j["activations"]) == [
            "layer_0", "layer_1", "layer_2"]
    assert "updates" not in pups[0] and "updates" in pups[1]


def test_scores_and_learning_rates_equal_the_references(records):
    (_, jups), (_, pups) = records
    for j, p in zip(jups, pups):
        _close(p["score"], j["score"], 0.0)
        assert p["learning_rates"] == j["learning_rates"] == \
            {"0": 0.1, "1": 0.1, "2": 0.1}


def test_parameter_statistics_equal_the_references(records):
    (_, jups), (_, pups) = records
    for j, p in zip(jups, pups):
        for n, want in j["params"].items():
            got = p["params"][n]
            scale = max(abs(want["min"]), abs(want["max"]))
            for k in ("mean", "stdev", "meanmag", "min", "max"):
                _close(got[k], want[k], scale)
            jh, ph = want["histogram"], got["histogram"]
            assert ph["counts"] == jh["counts"], n
            assert sum(ph["counts"]) == {"0/W": 32, "0/b": 8, "1/W": 48,
                                         "1/b": 6, "2/W": 18, "2/b": 3}[n]
            _close(ph["lo"], jh["lo"], scale)
            _close(ph["hi"], jh["hi"], scale)
    zero = pups[-1]["params"]["0/b"]
    assert zero["min"] == zero["max"] == 0.0
    assert (zero["histogram"]["lo"], zero["histogram"]["hi"]) == (-0.5, 0.5)
    # the middle edge is 3.7e-9 in float32 as XLA computes it, not 0
    assert zero["histogram"]["counts"] == [0.0] * 4 + [8.0] + [0.0] * 5


def test_update_and_activation_statistics_equal_the_references(records):
    (_, jups), (_, pups) = records
    for j, p in zip(jups[1:], pups[1:]):
        for n, want in j["updates"].items():
            got = p["updates"][n]
            for k in ("meanmag", "mean", "stdev"):
                _close(got[k], want[k], want["meanmag"])
        assert p["updates"]["0/b"] == {"meanmag": 0.0, "mean": 0.0,
                                       "stdev": 0.0}
        for n, want in j["activations"].items():
            _close(p["activations"][n], want, 0.0)


def test_one_host_read_a_report():
    """Every statistic of a report reaches the host in one copy (the
    CPU's reads are counted with ``include_cpu``)."""
    _, pnet = _pair(dtype="float32")
    lst = pui.StatsListener(pui.InMemoryStatsStorage(),
                            config=pui.StatsUpdateConfiguration(**CFG),
                            activation_sample=SAMPLE)
    pnet.set_listeners(lst)
    pnet.fit(X[:16], Y[:16], epochs=1, batch_size=16)     # the first report
    score = torch.tensor(0.5)
    with ptel.HostSyncDetector(action="count", include_cpu=True) as det:
        lst.iteration_done(pnet, 1, score)
    assert det.count == 1, det.events


def test_update_snapshot_is_a_copy():
    """A window's CUDA graph writes the parameters in place: the snapshot
    must not alias them, or every update reads 0."""
    _, pnet = _pair(dtype="float32")
    store = pui.InMemoryStatsStorage()
    lst = pui.StatsListener(store, session_id="c")
    lst.iteration_done(pnet, 0, 1.0)
    with torch.no_grad():
        pnet.param_dicts()[1]["W"].add_(0.5)        # an in-place update
    lst.iteration_done(pnet, 1, 1.0)
    upd = store.get_latest_update("c", "worker_0")["updates"]
    assert upd["1/W"]["meanmag"] == pytest.approx(0.5)
    assert upd["0/W"]["meanmag"] == 0.0


def test_listener_in_windows_reports_every_step():
    """The listener joins the window fan-out (``notify_window``): each
    step of a window reports, all with the window's last parameters, as
    the reference's do, so a window's second report reads no update."""
    _, pnet = _pair(dtype="float32")
    store = pui.InMemoryStatsStorage()
    pnet.set_listeners(pui.StatsListener(store, session_id="w"))
    pnet.fit(X, Y, epochs=1, batch_size=16, steps_per_dispatch=2)
    ups = store.get_updates("w", "worker_0")
    assert [u["iteration"] for u in ups] == [0, 1, 2, 3]
    assert [u["updates"]["2/W"]["meanmag"] > 0 for u in ups[1:]] == \
        [False, True, False]


# ---------------------------------------------------------------- storage
def _write(mod, store):
    store.put_static_info("s1", "w0", {"model_class": "M", "num_params": 7})
    for i in range(3):
        store.put_update("s1", "w0", {"iteration": i, "score": 5.0 - i,
                                      "params": {"0/W": {"mean": 0.1 * i}}})
    store.put_update("s1", "w1", {"iteration": 0, "score": 9.0})


def _read(store):
    return (store.list_session_ids(), store.list_worker_ids("s1"),
            store.get_static_info("s1", "w0"),
            store.get_updates("s1", "w0"), store.get_updates("s1", "w1"),
            store.get_updates("s1", "w0", since_iteration=0))


@pytest.mark.parametrize("kind", ["jsonl", "sqlite"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_storage_files_cross_read(kind, writer, tmp_path):
    cls = {"jsonl": "FileStatsStorage", "sqlite": "SqliteStatsStorage"}[kind]
    path = str(tmp_path / f"stats.{kind}")
    w_mod, r_mod = (pui, jui) if writer == "port" else (jui, pui)
    w = getattr(w_mod, cls)(path)
    _write(w_mod, w)
    got = _read(getattr(r_mod, cls)(path))
    want = _read(w)
    assert got == want
    assert got[0] == ["s1"] and got[1] == ["w0", "w1"]
    assert [u["iteration"] for u in got[5]] == [1, 2]
    w.close()


def test_listener_records_cross_read(tmp_path):
    """A port fit's records in both file formats read back in the JAX
    package equal to what the port reads."""
    _, pnet = _pair(dtype="float32")
    stores = [pui.FileStatsStorage(str(tmp_path / "a.jsonl")),
              pui.SqliteStatsStorage(str(tmp_path / "a.db"))]
    pnet.set_listeners(*(pui.StatsListener(
        s, config=pui.StatsUpdateConfiguration(collect_histograms=True),
        session_id="x") for s in stores))
    pnet.fit(X, Y, epochs=1, batch_size=32)
    readers = [jui.FileStatsStorage(str(tmp_path / "a.jsonl")),
               jui.SqliteStatsStorage(str(tmp_path / "a.db"))]
    for s, r in zip(stores, readers):
        assert r.get_updates("x", "worker_0") == s.get_updates("x",
                                                               "worker_0")
        assert len(r.get_updates("x", "worker_0")) == 2
        assert r.get_static_info("x", "worker_0") == \
            s.get_static_info("x", "worker_0")
    for s in stores[1:] + readers[1:]:
        s.close()


def test_storage_events_fire():
    storage = pui.InMemoryStatsStorage()
    events = []
    storage.register_listener(lambda ev: events.append(ev.kind))
    storage.put_static_info("s", "w", {"a": 1})
    storage.put_update("s", "w", {"iteration": 0, "score": 1.0})
    assert events == [pui.StatsStorageEvent.NEW_SESSION,
                      pui.StatsStorageEvent.POST_STATIC,
                      pui.StatsStorageEvent.POST_UPDATE]


def test_registry_publishes_into_a_storage():
    reg = ptel.MetricsRegistry(enabled=True)
    reg.counter("torch.warm_runs").inc(3)
    store = pui.InMemoryStatsStorage()
    snap = reg.publish(store)
    got = store.get_latest_update("telemetry", "runtime")
    assert got["counters"]["torch.warm_runs"] == 3 and got == snap
