"""The UI's rendering side (``ui/components.py``, ``ui/i18n.py``,
``ui/visual.py``, ``ui/dashboard.py``) against the JAX package's ``ui``:
the component DSL's JSON and HTML, the i18n tables, the activation grid's
pixels, the model-graph SVG and the t-SNE page equal the reference's on
the same input, and ``ConvolutionalIterationListener`` on the same small
CNN in both packages (weights carried over) renders the same layers'
grids, pixels within 1 grey level; the dashboard renders the port's records,
its Performance card carries the kernel registry's rows and draws no
"vs baseline" row unless its caller names a baseline directory, its
telemetry card heads with the port's warm runs, and ``TrainingUIServer``
serves live pages and receives a POST."""
import base64
import importlib
import io
import json
import os
import urllib.request

import numpy as np
import pytest
from _torch_flightrec import _port_flightrec_dir  # noqa: F401

from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.graph.vertices import MergeVertex as JMerge
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.ui import components as JC
from deeplearning4j_tpu.ui import dashboard as jdash
from deeplearning4j_tpu.ui import i18n as ji18n
from deeplearning4j_tpu.ui import visual as jvis
from deeplearning4j_tpu_torch import telemetry as ptel
from deeplearning4j_tpu_torch import ui as pui
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph.vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.ops import kernels
from deeplearning4j_tpu_torch.ui import components as PC
from deeplearning4j_tpu_torch.ui import dashboard as pdash
from deeplearning4j_tpu_torch.ui import i18n as pi18n
from deeplearning4j_tpu_torch.ui import visual as pvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = np.random.default_rng(5)
X = R.normal(size=(64, 4)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[R.integers(0, 3, size=64)]


def _tree(C):
    return C.ComponentDiv(components=[
        C.ComponentText("Report", size=18, bold=True),
        C.ChartLine(title="loss", x=[[0, 1, 2], [0, 1, 2]],
                    y=[[3.0, 2.0, 1.0], [2.5, float("nan"), 2.2]],
                    series_names=["train", "val"]),
        C.ChartScatter(title="emb", x=[[0.0, 1.0]], y=[[1.0, 0.0]],
                       series_names=["pts"]),
        C.ChartHistogram(title="w", lower_bounds=[0.0, 0.5],
                         upper_bounds=[0.5, 1.0], y=[3.0, 7.0]),
        C.ChartHorizontalBar(title="f1", labels=["class0", "class1"],
                             values=[0.9, 0.7]),
        C.ChartStackedArea(title="mem", x=[0, 1, 2],
                           y=[[1, 1, 1], [2, 1]],
                           series_names=["activations", "params"]),
        C.ChartTimeline(title="steps", lane_names=["device"],
                        lane_entries=[[[0, 5, "fwd"], [5, 9, "bwd"]]]),
        C.ComponentTable(header=["metric", "value"],
                         content=[["acc", "0.97"], ["f1", "0.95"]]),
        C.DecoratorAccordion(title="details", default_collapsed=False,
                             components=[C.ComponentText(
                                 "inner <txt>", color="#111' x='1")]),
    ])


# ------------------------------------------------------------- components
def test_components_json_and_html_equal_the_references():
    j = _tree(PC).to_json()
    assert j == _tree(JC).to_json()
    assert PC.from_json(j).to_json() == j
    html = PC.render_html(PC.from_json(j))
    assert html == JC.render_html(JC.from_json(j))
    assert "<svg" in html and "&lt;txt&gt;" in html and "<script" not in html
    assert "nan" not in html


def test_unknown_component_raises():
    with pytest.raises(ValueError, match="Unknown component"):
        PC.from_json('{"component_type": "ChartBogus"}')


def test_i18n_tables_equal_the_references():
    assert pi18n.languages() == ji18n.languages()
    assert sorted(pi18n.languages()) == ["de", "en", "ja", "ko", "ru", "zh"]
    keys = set(ji18n._MESSAGES["en"]) | {"no.such.key"}
    for lang in pi18n.languages():
        for key in keys:
            assert pi18n.get_message(key, lang) == \
                ji18n.get_message(key, lang)
    assert pi18n.get_message("train.model", "ja") == "モデル"


def test_dashboard_charts_delegate_as_the_references():
    series = [("a", [(0, 1.0), (1, float("nan")), (2, 2.0)])]
    assert pdash._svg_line_chart(series) == jdash._svg_line_chart(series)
    assert pdash._svg_line_chart([("a", [])]) == \
        "<p class='meta'>no data yet</p>"
    h = {"counts": [1, 3, 2], "lo": -1.0, "hi": 1.0}
    assert pdash._svg_histogram(h) == jdash._svg_histogram(h)


# --------------------------------------------------------------- visual
def _decode(b64):
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.mark.parametrize("shape,upscale", [((12, 12, 6), 1), ((5, 7, 20), 3),
                                           ((4, 4, 1), 2)])
def test_activation_grid_pixels_equal_the_references(shape, upscale):
    act = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32)
    act[..., 0] = 1.5                      # a constant channel: all black
    got = pvis.activation_grid_png(act, upscale=upscale)
    want = jvis.activation_grid_png(act, upscale=upscale)
    assert base64.b64decode(got)[:8] == b"\x89PNG\r\n\x1a\n"
    g, w = _decode(got).astype(np.int16), _decode(want).astype(np.int16)
    assert g.shape == w.shape and np.abs(g - w).max() <= 1
    with pytest.raises(ValueError, match="expected"):
        pvis.activation_grid_png(act[0])


def _graph_confs():
    def build(conf, L, Merge, IT):
        return (conf(seed=5, updater=jupd.Sgd(0.1) if L is jl
                     else tupd.Sgd(0.1)).graph_builder()
                .add_inputs("in")
                .add_layer("d1", L.DenseLayer(n_out=8, activation="tanh"),
                           "in")
                .add_layer("d2", L.DenseLayer(n_out=8, activation="relu"),
                           "in")
                .add_vertex("merge", Merge(), "d1", "d2")
                .add_layer("out", L.OutputLayer(n_out=2, activation="softmax",
                                                loss="mcxent"), "merge")
                .set_outputs("out").set_input_types(IT.feed_forward(4))
                .build())
    return (build(JConf, jl, JMerge, JInputType),
            build(NeuralNetConfiguration, tl, MergeVertex, InputType))


def test_model_graph_svg_equals_the_references():
    jconf, pconf = _graph_confs()
    svg = pvis.render_model_graph_svg(pconf)
    assert svg == jvis.render_model_graph_svg(jconf)
    assert "MergeVertex" in svg and svg.startswith("<svg")
    jlenet = importlib.import_module("deeplearning4j_tpu.models.lenet").lenet
    plenet = importlib.import_module(
        "deeplearning4j_tpu_torch.models.lenet").lenet
    chain = pvis.render_model_graph_svg(plenet(n_classes=3,
                                               device="cpu").conf)
    assert chain == jvis.render_model_graph_svg(jlenet(n_classes=3).conf)
    assert "ConvolutionLayer" in chain and "OutputLayer" in chain


def test_tsne_page_equals_the_references(tmp_path):
    rng = np.random.default_rng(5)
    coords = np.vstack([rng.normal(0, 1, (20, 2)), rng.normal(6, 1, (20, 2))])
    labels = ["a"] * 20 + ["b<"] * 20
    page = pvis.render_tsne_page(coords, labels, title="emb")
    assert page == jvis.render_tsne_page(coords, labels, title="emb")
    assert page.count("<circle") == 40 and "&#9679;" in page
    p = pvis.render_tsne(coords, str(tmp_path / "t.html"), labels)
    assert open(p).read() == pvis.render_tsne_page(coords, labels)


# -------------------------------------------------------------- dashboard
@pytest.fixture
def fresh_registry():
    reg = ptel.MetricsRegistry(enabled=True)
    prev = ptel.set_registry(reg)
    idx = ptel.ProgramCostIndex()
    prev_idx = ptel.set_cost_index(idx)
    yield reg
    ptel.set_registry(prev)
    ptel.set_cost_index(prev_idx)


def _trained(storage, session="dash", **cfg):
    net = MultiLayerNetwork(NeuralNetConfiguration(
        seed=12, updater=tupd.Sgd(0.1)).list(
        tl.DenseLayer(n_in=4, n_out=8, activation="tanh"),
        tl.OutputLayer(n_out=3, activation="softmax",
                       loss="mcxent")).build(), device="cpu").init()
    net.set_listeners(pui.StatsListener(
        storage, config=pui.StatsUpdateConfiguration(**cfg),
        session_id=session))
    net.fit(X, Y, epochs=1, batch_size=16)
    return net


def test_render_dashboard_artifact(tmp_path, fresh_registry):
    storage = pui.InMemoryStatsStorage()
    _trained(storage, collect_histograms=True)
    html = open(pui.render_dashboard(storage, str(tmp_path / "t.html"))).read()
    for s in ("<svg", "Score vs. iteration", "Parameter histograms", "dash",
              "Model graph", "DenseLayer"):
        assert s in html
    report = PC.training_report(storage)
    assert report.to_json() == JC.training_report(storage).to_json()


def test_performance_card_has_the_kernel_table(fresh_registry, monkeypatch):
    """After a fit the cost index holds the step: the card draws one row
    a registered kernel (``fallback`` here, on the CPU) and a roofline
    ratio where a timing was recorded."""
    _trained(pui.InMemoryStatsStorage())
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "67")
    monkeypatch.setenv("BENCH_HBM_GBPS", "3350")
    kernels.record_kernel_timing("lstm", "64x32x512", 4.9e-4)
    card = pdash._render_performance_card("Performance")
    table = card[card.index("<h3>Kernels</h3>"):]
    rows = table[:table.index("</table>")].split("<tr>")[2:]
    assert [r.split("<td>")[1].split("<")[0] for r in rows] == sorted(
        kernels.names())
    assert all("<td>fallback</td>" in r for r in rows)
    lstm = next(r for r in rows if r.startswith("<td>lstm"))
    assert "x bound &#9888;" in lstm and "2x8 (default)" in lstm


def test_no_baseline_row_unless_asked(fresh_registry, monkeypatch,
                                      tmp_path):
    """The reference's card loads BENCH_r*.json from the working
    directory and prints a "vs baseline" row from it; the port's draws
    that row only from a baseline directory its caller names (the
    repository's root holds a TPU's BENCH files)."""
    assert [f for f in os.listdir(ROOT) if f.startswith("BENCH_r")]
    with open(tmp_path / "BENCH_r09.json", "w") as f:
        json.dump({"parsed": {"dispatch_bound_steps_per_sec":
                              {"k8_steps_per_sec": 100.0}}}, f)
    fresh_registry.gauge("train.windowed_steps_per_sec").set(50.0)
    fresh_registry.gauge("parallel.collective_ms").set(1.0)
    from deeplearning4j_tpu import telemetry as jtel
    jreg = jtel.MetricsRegistry(enabled=True)
    jreg.gauge("train.windowed_steps_per_sec").set(50.0)
    jreg.gauge("parallel.collective_ms").set(1.0)
    jprev = jtel.set_registry(jreg)
    monkeypatch.chdir(tmp_path)
    try:
        assert "vs baseline" in jdash._render_performance_card("P")
    finally:
        jtel.set_registry(jprev)
    row = "vs baseline [dispatch_bound_steps_per_sec]"
    for cwd in (tmp_path, ROOT):
        monkeypatch.chdir(cwd)
        page = pdash.render_dashboard_html(pui.InMemoryStatsStorage())
        assert "Performance" in page and "vs baseline" not in page
    card = pdash._render_performance_card("P", baseline_root=str(tmp_path))
    assert f"<tr><th>{row}</th><td>0.50x of BENCH_r09.json</td></tr>" in card


def test_telemetry_card_heads_with_warm_runs(fresh_registry):
    ptel.note_warm_run()
    ptel.note_warm_run()
    page = pdash.render_dashboard_html(pui.InMemoryStatsStorage())
    assert "<tr><th>warm runs</th><td>2</td></tr>" in page
    assert "XLA compiles" not in page


def test_dashboard_i18n_and_multisession():
    store = pui.InMemoryStatsStorage()
    for sid in ("sessA", "sessB"):
        store.put_static_info(sid, "w0", {"model": "mlp"})
        store.put_update(sid, "w0", {"iteration": 1, "score": 1.5})
    page = pdash.render_dashboard_html(store, "sessA")
    assert "session=sessA" in page and "session=sessB" in page
    for lang in pi18n.languages():
        p = pdash.render_dashboard_html(store, "sessA", lang=lang)
        assert pi18n.get_message("train.pagetitle", lang) in p


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_training_ui_server_serves_and_receives(fresh_registry):
    storage = pui.InMemoryStatsStorage()
    _trained(storage, session="live")
    server = pui.TrainingUIServer()
    server.attach(storage)
    port = server.start()
    try:
        base = f"http://127.0.0.1:{port}"
        status, body = _get(base + "/")
        assert status == 200 and "Training overview" in body and "live" in body
        status, body = _get(base + "/?session=live&lang=ja")
        assert status == 200 and "トレーニング概要" in body
        rec = {"kind": "update", "session_id": "remote", "worker_id": "w9",
               "data": {"iteration": 4, "score": 0.25}}
        req = urllib.request.Request(
            base + "/collect", data=json.dumps(rec).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200 and json.load(r) == {"ok": True}
        assert storage.get_latest_update("remote", "w9")["score"] == 0.25
        status, body = _get(base + "/?session=remote")
        assert status == 200 and "w9" in body
        router = pui.storage.RemoteStatsStorageRouter(base)
        router.put_update("remote", "w9", {"iteration": 5, "score": 0.5})
        router.flush()
        assert router.dropped == 0
        assert storage.get_latest_update("remote", "w9")["iteration"] == 5
    finally:
        server.stop()


# --------------------------------------------- the conv listener's grids
def _lenets():
    jlenet = importlib.import_module("deeplearning4j_tpu.models.lenet").lenet
    plenet = importlib.import_module(
        "deeplearning4j_tpu_torch.models.lenet").lenet
    jnet = jlenet(n_classes=3, height=12, width=12, channels=1,
                  updater=jupd.Sgd(0.05)).init()
    pnet = plenet(n_classes=3, height=12, width=12, channels=1,
                  updater=tupd.Sgd(0.05), device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def test_conv_activation_listener_equals_the_references():
    """Grids of the same CNN's activations in both packages: the same
    layers, images of the same size, pixels within 1 grey level."""
    jnet, pnet = _lenets()
    sample = np.random.default_rng(0).normal(
        size=(2, 12, 12, 1)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(8, 12, 12, 1)).astype(
        np.float32)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(2).integers(0, 3,
                                                                      8)]
    stores = []
    for mod, net in ((jui, jnet), (pui, pnet)):
        store = mod.InMemoryStatsStorage()
        net.set_listeners(mod.ConvolutionalIterationListener(
            sample, storage=store, frequency=2, session_id="s",
            worker_id="w"))
        net.fit(x, y, epochs=4, batch_size=8)
        stores.append(store.get_updates("s", "w"))
    jups, pups = stores
    assert [u["iteration"] for u in pups] == \
        [u["iteration"] for u in jups] == [0, 2]
    for j, p in zip(jups, pups):
        assert list(p["conv_activations"]) == list(j["conv_activations"])
        assert len(p["conv_activations"]) >= 3     # input + two convs
        for n, b64 in j["conv_activations"].items():
            got = _decode(p["conv_activations"][n]).astype(np.int16)
            want = _decode(b64).astype(np.int16)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1, n
    page = pui.render_dashboard_html(_as_store(pups))
    assert "Convolutional activations" in page
    assert "data:image/png;base64," in page


def _as_store(updates):
    store = pui.InMemoryStatsStorage()
    for u in updates:
        store.put_update("s", "w", u)
    return store
