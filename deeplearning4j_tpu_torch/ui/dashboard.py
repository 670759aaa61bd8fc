"""Training dashboard: standalone HTML artifact + live stdlib HTTP server.

Counterpart of ``deeplearning4j_tpu/ui/dashboard.py``:
``render_dashboard_html``, ``render_dashboard`` and ``TrainingUIServer``
(``GET`` renders the overview for ``?session=&worker=&lang=``, ``POST
/collect`` is the remote stats receiver), with the reference's model,
score, throughput, parameter, ratio, performance, telemetry, fleet,
histogram, activation and model-graph cards.

Deliberate differences:

- The telemetry card's first headline is "warm runs", the port's
  ``torch.warm_runs`` counter (``telemetry/torchsignals.py``), where the
  reference shows "XLA compiles" from ``jax.compiles``.
- The Performance card draws its "vs baseline" rows only from a
  ``baseline_root`` the caller passes (as ``write_perf_dump`` takes one).
  The reference loads ``BENCH_r*.json`` from the working directory
  unconditionally (``dashboard.py:268``); those files hold a TPU's
  figures, and a page rendered from the repository's root would put them
  beside the card's.
- The kernel table's rows come from the port's registry
  (``ops/kernels/registry.py``): the implementation a call runs on this
  process's device (``fused`` on a card, ``fallback`` on the CPU), the
  tiling the port's kernels use, and the ``perf.kernels.<name>.*``
  roofline gauges.

Reference: deeplearning4j-ui-parent/deeplearning4j-play (UIServer.getInstance()
.attach(statsStorage) serving the train overview: score chart, param/update
ratios, histograms, system tab). The capability is reproduced with zero
dependencies: the page is a single self-contained HTML file (inline JSON +
hand-rolled SVG charts), and `TrainingUIServer` serves a live re-rendered
copy from any StatsStorage with auto-refresh.
"""
from __future__ import annotations

import html
import http.server
import json
import math
import threading
from typing import List, Optional

from . import i18n
from .storage import StatsStorage

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j_tpu_torch — training</title>
{refresh}
<style>
 body {{ font-family: -apple-system, Segoe UI, Helvetica, Arial, sans-serif;
        margin: 24px; background: #fafafa; color: #1a1a1a; }}
 h1 {{ font-size: 20px; }} h2 {{ font-size: 15px; margin: 18px 0 6px; }}
 .card {{ background: #fff; border: 1px solid #e3e3e3; border-radius: 8px;
          padding: 12px 16px; margin-bottom: 16px; }}
 table {{ border-collapse: collapse; font-size: 13px; }}
 td, th {{ padding: 3px 10px; border-bottom: 1px solid #eee; text-align: left; }}
 svg text {{ font-size: 10px; fill: #666; }}
 .meta {{ color: #666; font-size: 12px; }}
</style></head><body>
<h1>{t_pagetitle} <span class="meta">{t_session} {session} · {t_worker} {worker}</span></h1>
{nav}
<div class="card"><h2>{t_model}</h2>{static_table}</div>
<div class="card"><h2>{t_score}</h2>{score_chart}</div>
<div class="card"><h2>{t_throughput}</h2>{speed_chart}</div>
<div class="card"><h2>{t_parammag}</h2>{param_chart}</div>
<div class="card"><h2>{t_ratio}</h2>{ratio_chart}</div>
{performance_card}
{telemetry_card}
{fleet_card}
{hist_cards}
{activation_cards}
{graph_card}
<script type="application/json" id="stats-data">{data_json}</script>
</body></html>
"""


def _svg_line_chart(series: List[tuple], width=720, height=220, logy=False):
    """series: [(label, [(x, y), ...])]. Delegates to the component DSL's
    ChartLine (ui/components.py) — one palette/scale/legend implementation
    for the whole package; non-finite points are dropped there."""
    from .components import ChartLine
    pts_all = [p for _, pts in series for p in pts]
    if not pts_all:
        return "<p class='meta'>no data yet</p>"
    if not any(p[1] is not None and math.isfinite(p[1]) for p in pts_all):
        return "<p class='meta'>no finite data</p>"
    chart = ChartLine(
        x=[[p[0] for p in pts] for _, pts in series],
        y=[[p[1] for p in pts] for _, pts in series],
        series_names=[label for label, _ in series],
        width=width, height=height)
    return chart.render()


def _svg_histogram(hist: dict, width=340, height=120):
    """hist: {counts, lo, hi}. Delegates to the DSL's ChartHistogram."""
    from .components import ChartHistogram
    counts = hist.get("counts", [])
    if not counts:
        return ""
    lo, hi = hist.get("lo", 0.0), hist.get("hi", 1.0)
    n = len(counts)
    w = (hi - lo) / n if n else 1.0
    return ChartHistogram(
        lower_bounds=[lo + i * w for i in range(n)],
        upper_bounds=[lo + (i + 1) * w for i in range(n)],
        y=[float(c) for c in counts], width=width, height=height).render()


def _render_telemetry_card(title: str) -> str:
    """Runtime-telemetry card from the process-wide telemetry registry
    (telemetry/): warm runs, prefetch stall, serving p99 and the
    rest of the counters/gauges/span histograms — rendered on the train
    overview so existing TrainingUIServer users see the new signals with
    zero code changes. Empty registry (or disabled telemetry) renders
    nothing."""
    from ..telemetry import get_registry
    snap = get_registry().snapshot()
    counters, gauges = snap["counters"], snap["gauges"]
    hists = snap["histograms"]
    if not (counters or gauges or hists):
        return ""
    # headline signals first: the ones the tentpoles name
    headline = []
    if "torch.warm_runs" in counters:
        headline.append(("warm runs", counters["torch.warm_runs"]))
    # SLO watchdog (telemetry/slo.py): breached objectives by name, plus
    # the lifetime breach count and the flight-recorder evidence trail
    breached = sorted(n[len("slo."):-len(".breached")]
                      for n, g in gauges.items()
                      if n.startswith("slo.") and n.endswith(".breached")
                      and g["value"])
    if breached:
        headline.append(("SLO BREACHED", ", ".join(breached)))
    if "slo.breaches" in counters:
        headline.append(("SLO breaches (lifetime)", counters["slo.breaches"]))
    if "flightrec.dumps" in counters:
        headline.append(("flight-recorder dumps",
                         counters["flightrec.dumps"]))
    if "training_watch.unhealthy" in counters:
        headline.append(("training unhealthy steps",
                         counters["training_watch.unhealthy"]))
    pw = hists.get("prefetch.wait_ms")
    if pw:
        headline.append(("prefetch stall p95 (ms)", round(pw["p95"], 3)))
    for name, h in sorted(hists.items()):
        if name.startswith("serving.") and name.endswith(".latency_ms"):
            model = name[len("serving."):-len(".latency_ms")]
            headline.append((f"serving p99 [{model}] (ms)",
                             round(h["p99"], 3)))
    # generation prefix-cache economics: the hit rate is the
    # headline — it is the prefill work the pool sharing saved
    for name, g in sorted(gauges.items()):
        if name.startswith("generation.") and \
                name.endswith(".prefix_hit_rate"):
            model = name[len("generation."):-len(".prefix_hit_rate")]
            headline.append((f"prefix-cache hit rate [{model}]",
                             round(g["value"], 4)))
    rows = "".join(
        f"<tr><th>{html.escape(str(k))}</th><td>{html.escape(str(v))}</td></tr>"
        for k, v in headline)
    rows += "".join(
        f"<tr><th>{html.escape(n)}</th><td>{v}</td></tr>"
        for n, v in sorted(counters.items()))
    rows += "".join(
        f"<tr><th>{html.escape(n)}</th><td>{round(g['value'], 4)}"
        f" <span class='meta'>(max {round(g['max'], 4)})</span></td></tr>"
        for n, g in sorted(gauges.items()))
    hrows = "".join(
        f"<tr><th>{html.escape(n)}</th><td>{round(h['p50'], 3)}</td>"
        f"<td>{round(h['p95'], 3)}</td><td>{round(h['p99'], 3)}</td>"
        f"<td>{h['count']}</td></tr>"
        for n, h in sorted(hists.items()))
    hist_table = (
        "<table><tr><th></th><th>p50</th><th>p95</th><th>p99</th>"
        "<th>count</th></tr>" + hrows + "</table>") if hrows else ""
    return (f"<div class='card'><h2>{title}</h2>"
            f"<table>{rows}</table>{hist_table}</div>")


def _render_fleet_card(title: str) -> str:
    """Fleet card from the gauges the FleetCollector publishes into the
    local registry (``fleet.replica.<rid>.*`` — per-replica prefix-cache
    hit rate, queue depth, decode-slot occupancy) plus the fleet SLO
    burn-rate gauges the collector-made watchdog writes (``slo.<name>.
    burn_rate.*``). No collector running (no such gauges) renders
    nothing — a single-process dashboard keeps its old page."""
    from ..telemetry import get_registry
    reg = get_registry()
    if not reg.enabled:
        return ""
    prefix = "fleet.replica."
    per: dict = {}
    for name, g in reg.gauges_matching(prefix):
        rest = name[len(prefix):]
        rid, _, metric = rest.partition(".")
        if rid and metric:
            per.setdefault(rid, {})[metric] = g.value
    if not per:
        return ""
    rows = "".join(
        f"<tr><td>{html.escape(rid)}</td>"
        f"<td>{round(m_.get('prefix_hit_rate', 0.0), 4)}</td>"
        f"<td>{round(m_.get('queue_depth', 0.0), 1)}</td>"
        f"<td>{round(m_.get('slot_occupancy', 0.0), 4)}</td></tr>"
        for rid, m_ in sorted(per.items()))
    table = ("<table><tr><th>replica</th><th>prefix hit</th>"
             "<th>queue</th><th>occupancy</th></tr>" + rows + "</table>")
    burn_rows = "".join(
        f"<tr><th>{html.escape(name[len('slo.'):])}</th>"
        f"<td>{round(g.value, 3)}</td></tr>"
        for name, g in sorted(reg.gauges_matching("slo.")
                              ) if ".burn_rate." in name)
    burn_table = (f"<table>{burn_rows}</table>" if burn_rows else "")
    return (f"<div class='card'><h2>{title}</h2>{table}{burn_table}</div>")


def _render_kernels_table(reg, snap, heading: str) -> str:
    """Per-kernel rows for the Performance card: which impl a call runs
    (fused on a card, fallback on the CPU), the tiling in use (an
    autotuned decision when one is cached for this rig, else the kernel's
    default), and measured-vs-roofline from the ``perf.kernels.<name>.*``
    gauges — below-bound kernels flagged."""
    kernels = snap.get("kernels") or {}
    if not kernels:
        return ""

    def _g(name):
        g = reg.gauge_if_exists(name)
        return g.value if g is not None else None

    rows = []
    for name in sorted(kernels):
        k = kernels[name]
        choice = k.get("default_choice")
        src = "default"
        for rec in (k.get("autotune") or {}).values():
            if rec.get("choice"):
                choice, src = rec["choice"], "autotuned"
                break
        blocks = ("x".join(str(v) for v in choice) if choice else "-") \
            + (f" ({src})" if choice else "")
        base = f"perf.kernels.{name}"
        ratio = _g(f"{base}.vs_roofline")
        below = _g(f"{base}.below_roofline")
        if ratio:
            vs = f"{ratio:.2f}x bound"
            if below:
                vs += " &#9888;"          # below-roofline warning sign
        else:
            vs = "-"
        impl = k.get("impl", "?")
        rows.append(f"<tr><td>{html.escape(name)}</td>"
                    f"<td>{html.escape(impl)}</td>"
                    f"<td>{html.escape(blocks)}</td>"
                    f"<td>{vs}</td></tr>")
    return (f"<h3>{heading}</h3>"
            "<table><tr><th>kernel</th><th>impl</th><th>blocks</th>"
            "<th>vs roofline</th></tr>" + "".join(rows) + "</table>")


def _render_performance_card(title: str, kernels_heading: str = "Kernels",
                             baseline_root: Optional[str] = None) -> str:
    """Performance-observability card (telemetry/perf.py + memprof.py):
    per-program MFU/roofline rows from the cost index, the kernel table,
    the step-time decomposition, the live-memory top-K and — only when
    the caller names a ``baseline_root`` holding BENCH_r*.json files —
    the baseline-delta headline. Empty cost index AND empty decomposition
    renders nothing (a training run that predates the perf layer keeps
    its old page)."""
    from ..telemetry import get_registry
    from ..telemetry.perf import (PerfBaseline, baseline_deltas,
                                  get_cost_index, perf_snapshot)
    reg = get_registry()
    if not reg.enabled:
        return ""
    snap = perf_snapshot(reg, get_cost_index())
    programs = snap.get("programs") or []
    decomp = snap.get("step_decomposition") or {}
    if not programs and not decomp:
        return ""
    # headline: the best live MFU + a baseline delta when one is known
    headline = []
    with_mfu = [r for r in programs if r.get("mfu") is not None]
    if with_mfu:
        best = max(with_mfu, key=lambda r: r["mfu"])
        headline.append(("best MFU",
                         f"{best['mfu']:.2%} ({html.escape(best['path'])},"
                         f" {best['roofline']}-bound)"))
    if baseline_root is not None:
        baseline = PerfBaseline.load_trajectory(baseline_root)
        for d in baseline_deltas(baseline, reg):
            if d.get("ratio"):
                headline.append(
                    (f"vs baseline [{html.escape(d['row'])}]",
                     f"{d['ratio']:.2f}x of {html.escape(str(d['baseline_file']))}"))
    hrows = "".join(
        f"<tr><th>{k}</th><td>{v}</td></tr>" for k, v in headline)
    def _cell(v, pct=False):
        if v is None:
            return "-"
        return f"{v:.2%}" if pct else str(round(v, 4))

    prog_rows = "".join(
        f"<tr><td>{html.escape(str(r['path']))}</td>"
        f"<td>{r['roofline']}</td>"
        f"<td>{_cell(r['step_ms'])}</td>"
        f"<td>{_cell(r['achieved_tflops'])}</td>"
        f"<td>{_cell(r['mfu'], pct=True)}</td></tr>"
        for r in programs)
    prog_table = ("<table><tr><th>program</th><th>bound</th>"
                  "<th>step ms</th><th>TFLOP/s</th><th>MFU</th></tr>"
                  + prog_rows + "</table>") if programs else ""
    drows = "".join(
        f"<tr><th>{html.escape(k)}</th><td>{v['p50']}</td>"
        f"<td>{v['p95']}</td><td>{v['mean']}</td></tr>"
        for k, v in decomp.items() if isinstance(v, dict) and "p50" in v)
    decomp_table = ("<table><tr><th></th><th>p50 ms</th><th>p95 ms</th>"
                    "<th>mean ms</th></tr>" + drows + "</table>") \
        if drows else ""
    mem = snap.get("memory") or {}
    mrows = "".join(
        f"<tr><td>{html.escape('x'.join(str(d) for d in g['shape']) or '()')}"
        f"</td><td>{html.escape(g['dtype'])}</td>"
        f"<td>{html.escape(str(g['owner']))}</td><td>{g['count']}</td>"
        f"<td>{g['total_bytes']}</td></tr>"
        for g in (mem.get("top") or [])[:8])
    mem_table = ("<table><tr><th>shape</th><th>dtype</th><th>owner</th>"
                 "<th>count</th><th>bytes</th></tr>" + mrows + "</table>") \
        if mrows else ""
    kern_table = _render_kernels_table(reg, snap, kernels_heading)
    return (f"<div class='card'><h2>{title}</h2>"
            f"<table>{hrows}</table>{prog_table}{kern_table}"
            f"{decomp_table}{mem_table}</div>")


def render_dashboard_html(storage: StatsStorage, session_id: Optional[str] = None,
                          worker_id: Optional[str] = None,
                          auto_refresh_sec: int = 0,
                          lang: Optional[str] = None,
                          baseline_root: Optional[str] = None) -> str:
    """One overview page. Multi-session: a nav bar links every session id
    (and each session's workers) via ?session=&worker=; ``lang`` renders
    all chrome through ui/i18n (reference TrainModule.java:94-110 serves
    the same via DefaultI18N + per-language resources).
    ``baseline_root``: a directory of BENCH_r*.json files for the
    Performance card's "vs baseline" rows (none without it)."""
    def m(key):
        return i18n.get_message(key, lang)

    sessions = storage.list_session_ids()
    if session_id is None:
        session_id = sessions[-1] if sessions else ""
    workers = storage.list_worker_ids(session_id) if session_id else []
    if worker_id is None:
        worker_id = workers[0] if workers else ""
    static = storage.get_static_info(session_id, worker_id) or {}
    updates = storage.get_updates(session_id, worker_id)

    rows = "".join(f"<tr><th>{html.escape(str(k))}</th>"
                   f"<td>{html.escape(str(v))}</td></tr>"
                   for k, v in static.items() if k != "param_names")
    static_table = f"<table>{rows}</table>" if rows else "<p class='meta'>–</p>"

    score_pts = [(u["iteration"], u.get("score")) for u in updates
                 if "score" in u]
    speed_pts = [(u["iteration"], u.get("iterations_per_sec")) for u in updates
                 if "iterations_per_sec" in u]
    # per-param mean-magnitude series
    pnames = sorted({n for u in updates for n in u.get("params", {})})
    param_series = [(n, [(u["iteration"], u["params"][n]["meanmag"])
                         for u in updates if n in u.get("params", {})])
                    for n in pnames[:10]]
    ratio_series = []
    for n in pnames[:10]:
        pts = []
        for u in updates:
            if n in u.get("params", {}) and n in u.get("updates", {}):
                pm = u["params"][n]["meanmag"]
                um = u["updates"][n]["meanmag"]
                if pm > 0 and um > 0:
                    pts.append((u["iteration"], math.log10(um / pm)))
        if pts:
            ratio_series.append((n, pts))

    hist_cards = ""
    last_with_hist = next((u for u in reversed(updates)
                           if any("histogram" in d
                                  for d in u.get("params", {}).values())), None)
    if last_with_hist:
        cells = []
        for n, d in list(last_with_hist["params"].items())[:12]:
            if "histogram" in d:
                cells.append(f"<div style='display:inline-block;margin:4px'>"
                             f"<div class='meta'>{n}</div>"
                             f"{_svg_histogram(d['histogram'])}</div>")
        hist_cards = (f"<div class='card'><h2>{m('train.histograms')} "
                      f"(iteration {last_with_hist['iteration']})</h2>"
                      + "".join(cells) + "</div>")

    # conv-activation image grids (reference ConvolutionalIterationListener;
    # posted by ui/visual.ConvolutionalIterationListener as base64 PNGs)
    activation_cards = ""
    last_with_acts = next((u for u in reversed(updates)
                           if u.get("conv_activations")), None)
    if last_with_acts:
        cells = "".join(
            f"<div style='display:inline-block;margin:6px;vertical-align:top'>"
            f"<div class='meta'>{html.escape(str(n))}</div>"
            f"<img src='data:image/png;base64,{b64}' "
            f"style='image-rendering:pixelated;border:1px solid #ddd'/></div>"
            for n, b64 in last_with_acts["conv_activations"].items())
        activation_cards = (
            f"<div class='card'><h2>{m('train.activations')} (iteration "
            f"{last_with_acts['iteration']})</h2>{cells}</div>")

    # model-graph view (reference FlowIterationListener / TrainModule model
    # tab) — rendered from the config JSON the StatsListener posts
    graph_card = ""
    cfg_json = static.get("model_config_json")
    if cfg_json:
        try:
            from ..nn.conf import serde
            from .visual import render_model_graph_svg
            svg = render_model_graph_svg(serde.from_json(cfg_json))
            graph_card = (f"<div class='card'><h2>{m('train.graph')}</h2>"
                          f"<div style='overflow-x:auto'>{svg}</div></div>")
        except (KeyError, ValueError, TypeError) as e:
            graph_card = (f"<div class='card'><h2>{m('train.graph')}</h2>"
                          f"<p class='meta'>unrenderable: "
                          f"{html.escape(str(e))}</p></div>")

    refresh = (f'<meta http-equiv="refresh" content="{auto_refresh_sec}">'
               if auto_refresh_sec else "")

    # multi-session nav: every session (workers of the current one) plus a
    # language switcher — the TrainModule session-selection capability
    from urllib.parse import urlencode

    def _link(label, q, current):
        style = "font-weight:bold" if current else ""
        return (f"<a style='{style}' href='?{urlencode(q)}'>"
                f"{html.escape(str(label))}</a>")

    def _q(sid, wid=None, lg=None):
        q = {"session": sid}
        if wid:
            q["worker"] = wid
        if lg or lang:
            q["lang"] = lg or lang
        return q

    nav = ""
    if sessions:
        sess_links = " · ".join(
            _link(s_, _q(s_), s_ == session_id) for s_ in sessions)
        worker_links = " · ".join(
            _link(w, _q(session_id, w), w == worker_id) for w in workers)
        lang_links = " · ".join(
            _link(lg, _q(session_id, worker_id, lg), lg == (lang or "en"))
            for lg in i18n.languages())
        nav = (f"<div class='card meta'><b>{m('train.sessions')}:</b> "
               f"{sess_links}"
               + (f" &nbsp;|&nbsp; <b>{m('train.worker')}:</b> {worker_links}"
                  if len(workers) > 1 else "")
               + f" &nbsp;|&nbsp; <b>{m('train.language')}:</b> {lang_links}"
               "</div>")

    return _PAGE.format(
        refresh=refresh, session=html.escape(session_id or "–", quote=True),
        worker=html.escape(worker_id or "–", quote=True),
        nav=nav,
        t_pagetitle=m("train.pagetitle"), t_session=m("train.session"),
        t_worker=m("train.worker"), t_model=m("train.model"),
        t_score=m("train.score"), t_throughput=m("train.throughput"),
        t_parammag=m("train.parammag"), t_ratio=m("train.ratio"),
        static_table=static_table,
        score_chart=_svg_line_chart([("score", score_pts)]),
        speed_chart=_svg_line_chart([("it/s", speed_pts)]),
        param_chart=_svg_line_chart(param_series),
        ratio_chart=_svg_line_chart(ratio_series),
        performance_card=_render_performance_card(
            m("train.performance"), kernels_heading=m("train.kernels"),
            baseline_root=baseline_root),
        telemetry_card=_render_telemetry_card(m("train.telemetry")),
        fleet_card=_render_fleet_card(m("train.fleet")),
        hist_cards=hist_cards,
        activation_cards=activation_cards,
        graph_card=graph_card,
        data_json=json.dumps({"session": session_id, "worker": worker_id,
                              "n_updates": len(updates)}),
    )


def render_dashboard(storage: StatsStorage, path: str,
                     session_id: Optional[str] = None,
                     worker_id: Optional[str] = None,
                     baseline_root: Optional[str] = None) -> str:
    """Write the dashboard artifact to `path`; returns the path."""
    html = render_dashboard_html(storage, session_id, worker_id,
                                 baseline_root=baseline_root)
    with open(path, "w") as f:
        f.write(html)
    return path


class TrainingUIServer:
    """Live dashboard over a StatsStorage (reference UIServer.getInstance();
    play framework replaced by the stdlib ThreadingHTTPServer — the page is
    re-rendered per request and auto-refreshes). ``baseline_root`` is
    passed to every page (``render_dashboard_html``).
    """

    _instance = None

    @classmethod
    def get_instance(cls) -> "TrainingUIServer":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self, port: int = 0, baseline_root: Optional[str] = None):
        self._storages: List[StatsStorage] = []
        self._port = port
        self.baseline_root = baseline_root
        self._httpd = None
        self._thread = None

    def attach(self, storage: StatsStorage):
        self._storages.append(storage)
        return self

    def detach(self, storage: StatsStorage):
        self._storages.remove(storage)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if not server._storages:
                    body = b"<html><body>no storage attached</body></html>"
                else:
                    from urllib.parse import parse_qs, urlparse
                    q = parse_qs(urlparse(self.path).query)
                    sid = q.get("session", [None])[0]
                    wid = q.get("worker", [None])[0]
                    lng = q.get("lang", [None])[0]
                    body = render_dashboard_html(
                        server._storages[-1], sid, wid,
                        auto_refresh_sec=5, lang=lng,
                        baseline_root=server.baseline_root).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — remote stats receiver
                # reference RemoteReceiverModule: other processes POST their
                # stats records here (RemoteUIStatsStorageRouter client side
                # is RemoteStatsStorageRouter in ui/storage.py)
                if self.path != "/collect" or not server._storages:
                    self.send_error(404)
                    return
                from ..util.httpjson import read_json, write_json
                try:
                    rec = read_json(self)
                    store = server._storages[-1]
                    if rec.get("kind") == "static":
                        store.put_static_info(rec["session_id"],
                                              rec["worker_id"], rec["data"])
                    else:
                        store.put_update(rec["session_id"], rec["worker_id"],
                                         rec["data"])
                    write_json(self, 200, {"ok": True})
                except Exception as e:
                    write_json(self, 400, {"error": str(e)})

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", self._port),
                                                      Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if TrainingUIServer._instance is self:
            TrainingUIServer._instance = None
