"""Report-component DSL: a JSON-serializable chart/table/text tree.

Counterpart of ``deeplearning4j_tpu/ui/components.py``, copied unchanged
(pure Python): ``to_json`` / ``from_json`` and ``render_html`` give the
reference's output for the same tree.

Reference: deeplearning4j-ui-components — Component.java subtypes tagged by
``componentType`` and rendered by the UI (chart/ChartLine.java,
ChartScatter.java, ChartHistogram.java, ChartHorizontalBar.java,
ChartStackedArea.java, ChartTimeline.java, table/ComponentTable.java,
text/ComponentText.java, component/ComponentDiv.java,
decorator/DecoratorAccordion.java). The reference renders these client-side
(dl4j-ui.js); here ``render_html`` produces self-contained SVG/HTML
server-side — no JS dependency — and the dashboard serves assembled pages.

Build a tree, serialize with ``to_json`` (type-tagged, round-trips through
``from_json``), render with ``render_html``:

    page = ComponentDiv(components=[
        ComponentText("Training report", size=18),
        ChartLine(title="score", x=[steps], y=[scores], series_names=["loss"]),
        ComponentTable(header=["metric", "value"], content=[["acc", "0.97"]]),
    ])
    html = render_html(page)
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

_COMPONENT_REGISTRY: Dict[str, Type] = {}

_COLORS = ["#2563eb", "#dc2626", "#059669", "#d97706", "#7c3aed",
           "#0891b2", "#be185d", "#4d7c0f", "#b91c1c", "#1e40af"]


def _register(cls):
    _COMPONENT_REGISTRY[cls.__name__] = cls
    return cls


def _esc(s) -> str:
    # quotes too: rendered text lands inside single-quoted HTML attributes
    # (style/color), where an unescaped quote is an attribute breakout
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;")
            .replace("'", "&#39;"))


def _finite(v) -> bool:
    return v is not None and math.isfinite(v)


@dataclass
class Component:
    """Base: every component serializes with a ``component_type`` tag
    (reference Component.java / Jackson @JsonTypeInfo)."""

    def to_dict(self) -> dict:
        d = {"component_type": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, Component):
                d[k] = v.to_dict()
            elif isinstance(v, list) and v and isinstance(v[0], Component):
                d[k] = [c.to_dict() for c in v]
            else:
                d[k] = v
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def render(self) -> str:
        raise NotImplementedError


def from_dict(d: dict) -> Component:
    kind = d.get("component_type")
    cls = _COMPONENT_REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"Unknown component type {kind!r}; known: "
                         f"{sorted(_COMPONENT_REGISTRY)}")
    kwargs = {}
    for k, v in d.items():
        if k == "component_type":
            continue
        if isinstance(v, dict) and "component_type" in v:
            v = from_dict(v)
        elif isinstance(v, list) and v and isinstance(v[0], dict) \
                and "component_type" in v[0]:
            v = [from_dict(c) for c in v]
        kwargs[k] = v
    return cls(**kwargs)


def from_json(s: str) -> Component:
    return from_dict(json.loads(s))


def render_html(component: Component, *, standalone: bool = True) -> str:
    """Render a component tree to HTML (a full document by default)."""
    body = component.render()
    if not standalone:
        return body
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<style>body{font-family:system-ui,sans-serif;margin:16px}"
            "svg text{font-size:9px;fill:#555}"
            "table{border-collapse:collapse}"
            "td,th{border:1px solid #ddd;padding:4px 8px;font-size:13px}"
            "th{background:#f3f4f6}"
            "details{margin:6px 0;border:1px solid #ddd;border-radius:4px;"
            "padding:4px 8px}summary{cursor:pointer;font-weight:600}"
            "</style></head><body>" + body + "</body></html>")


# --------------------------------------------------------------- chart base
def _chart_frame(title, width, height, inner):
    parts = [f"<div class='chart'>"]
    if title:
        parts.append(f"<div style='font-weight:600;font-size:13px;"
                     f"margin:4px 0'>{_esc(title)}</div>")
    parts.append(f'<svg width="{width}" height="{height}" '
                 f'xmlns="http://www.w3.org/2000/svg">{inner}</svg></div>')
    return "".join(parts)


def _scales(xs, ys, width, height, pad=40):
    # one nan/inf score must not poison the whole chart (same contract as
    # the dashboard renderer): scale over the finite values only
    xs = [v for v in xs if _finite(v)]
    ys = [v for v in ys if _finite(v)]
    x0, x1 = (min(xs), max(xs)) if xs else (0.0, 1.0)
    y0, y1 = (min(ys), max(ys)) if ys else (0.0, 1.0)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y1 = y0 + (abs(y0) if y0 else 1) * 0.1 + 1e-12
    W, H = width - pad - 10, height - 30

    def sx(x):
        return pad + (x - x0) / (x1 - x0) * W

    def sy(y):
        return 5 + (1 - (y - y0) / (y1 - y0)) * H
    return sx, sy, (x0, x1, y0, y1), (pad, W, H)


def _grid(sx, sy, lims, dims, width, height):
    x0, x1, y0, y1 = lims
    pad, W, H = dims
    parts = []
    for i in range(5):
        gy = 5 + i * H / 4
        val = y1 - i * (y1 - y0) / 4
        parts.append(f'<line x1="{pad}" y1="{gy:.1f}" x2="{width-10}" '
                     f'y2="{gy:.1f}" stroke="#eee"/>')
        parts.append(f'<text x="2" y="{gy+3:.1f}">{val:.3g}</text>')
    parts.append(f'<text x="{pad}" y="{height-5}">{x0:g}</text>')
    parts.append(f'<text x="{width-60}" y="{height-5}">{x1:g}</text>')
    return parts


def _legend(names, width, height):
    parts, lx = [], 44
    if len(names) > 1:
        for i, nm in enumerate(names):
            c = _COLORS[i % len(_COLORS)]
            parts.append(f'<rect x="{lx}" y="{height-24}" width="8" '
                         f'height="8" fill="{c}"/>')
            parts.append(f'<text x="{lx+11}" y="{height-16}">{_esc(nm)}</text>')
            lx += 11 + 7 * len(str(nm)) + 14
    return parts


# ------------------------------------------------------------------- charts
@_register
@dataclass
class ChartLine(Component):
    """Multi-series line chart (reference chart/ChartLine.java)."""
    title: str = ""
    x: List[List[float]] = field(default_factory=list)   # per series
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    width: int = 640
    height: int = 240

    def render(self) -> str:
        xs = [v for s in self.x for v in s]
        ys = [v for s in self.y for v in s]
        sx, sy, lims, dims = _scales(xs, ys, self.width, self.height)
        parts = _grid(sx, sy, lims, dims, self.width, self.height)
        for i, (xr, yr) in enumerate(zip(self.x, self.y)):
            c = _COLORS[i % len(_COLORS)]
            pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}" for a, b in zip(xr, yr)
                           if _finite(a) and _finite(b))
            parts.append(f'<polyline fill="none" stroke="{c}" '
                         f'stroke-width="1.5" points="{pts}"/>')
        parts += _legend(self.series_names, self.width, self.height)
        return _chart_frame(self.title, self.width, self.height,
                            "".join(parts))


@_register
@dataclass
class ChartScatter(Component):
    """Scatter chart (reference chart/ChartScatter.java)."""
    title: str = ""
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    width: int = 640
    height: int = 240

    def render(self) -> str:
        xs = [v for s in self.x for v in s]
        ys = [v for s in self.y for v in s]
        sx, sy, lims, dims = _scales(xs, ys, self.width, self.height)
        parts = _grid(sx, sy, lims, dims, self.width, self.height)
        for i, (xr, yr) in enumerate(zip(self.x, self.y)):
            c = _COLORS[i % len(_COLORS)]
            for a, b in zip(xr, yr):
                if not (_finite(a) and _finite(b)):
                    continue
                parts.append(f'<circle cx="{sx(a):.1f}" cy="{sy(b):.1f}" '
                             f'r="2.5" fill="{c}" fill-opacity="0.7"/>')
        parts += _legend(self.series_names, self.width, self.height)
        return _chart_frame(self.title, self.width, self.height,
                            "".join(parts))


@_register
@dataclass
class ChartHistogram(Component):
    """Histogram: explicit bin edges + counts (reference
    chart/ChartHistogram.java lowerBounds/upperBounds/yValues)."""
    title: str = ""
    lower_bounds: List[float] = field(default_factory=list)
    upper_bounds: List[float] = field(default_factory=list)
    y: List[float] = field(default_factory=list)
    width: int = 640
    height: int = 200

    def render(self) -> str:
        # drop non-finite bins entirely (same contract as ChartLine)
        bins = [(lo, hi, cnt) for lo, hi, cnt in
                zip(self.lower_bounds, self.upper_bounds, self.y)
                if _finite(lo) and _finite(hi) and _finite(cnt)]
        xs = [b[0] for b in bins] + [b[1] for b in bins]
        ys = [0.0] + [b[2] for b in bins]
        sx, sy, lims, dims = _scales(xs, ys, self.width, self.height)
        parts = _grid(sx, sy, lims, dims, self.width, self.height)
        for lo, hi, cnt in bins:
            x0p, x1p = sx(lo), sx(hi)
            parts.append(
                f'<rect x="{x0p:.1f}" y="{sy(cnt):.1f}" '
                f'width="{max(x1p-x0p-1, 1):.1f}" '
                f'height="{max(sy(0)-sy(cnt), 0):.1f}" fill="#2563eb"/>')
        return _chart_frame(self.title, self.width, self.height,
                            "".join(parts))


@_register
@dataclass
class ChartHorizontalBar(Component):
    """Named horizontal bars (reference chart/ChartHorizontalBar.java)."""
    title: str = ""
    labels: List[str] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    width: int = 640
    height: int = 0            # 0 -> auto from row count

    def render(self) -> str:
        n = len(self.values)
        height = self.height or (24 * n + 30)
        vmax = max([abs(v) for v in self.values] or [1.0]) or 1.0
        pad, W = 110, self.width - 120
        parts = []
        for i, (lab, v) in enumerate(zip(self.labels, self.values)):
            yy = 8 + i * 24
            w = abs(v) / vmax * W
            parts.append(f'<text x="4" y="{yy+12}">{_esc(lab)}</text>')
            parts.append(f'<rect x="{pad}" y="{yy}" width="{w:.1f}" '
                         f'height="16" fill="{_COLORS[i % len(_COLORS)]}"/>')
            parts.append(f'<text x="{pad+w+4:.1f}" y="{yy+12}">{v:.4g}</text>')
        return _chart_frame(self.title, self.width, height, "".join(parts))


@_register
@dataclass
class ChartStackedArea(Component):
    """Stacked area chart (reference chart/ChartStackedArea.java): shared x,
    one y-series per band, cumulatively stacked."""
    title: str = ""
    x: List[float] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    width: int = 640
    height: int = 240

    def render(self) -> str:
        # a non-finite value in ANY band poisons the whole stacked column
        # (bands accumulate), so drop those columns entirely; ragged bands
        # truncate to the shortest (a mid-update dashboard feed)
        n = min([len(self.x)] + [len(band) for band in self.y]) \
            if self.y else 0
        cols = [t for t in range(n)
                if _finite(self.x[t]) and all(_finite(band[t])
                                              for band in self.y)]
        if not cols or not self.y:
            return _chart_frame(self.title, self.width, self.height, "")
        x = [self.x[t] for t in cols]
        bands = [[band[t] for t in cols] for band in self.y]
        stacked = []
        run = [0.0] * len(x)
        for band in bands:
            run = [a + b for a, b in zip(run, band)]
            stacked.append(list(run))
        sx, sy, lims, dims = _scales(x, [0.0] + stacked[-1],
                                     self.width, self.height)
        parts = _grid(sx, sy, lims, dims, self.width, self.height)
        prev = [0.0] * len(x)
        for i, top in enumerate(stacked):
            c = _COLORS[i % len(_COLORS)]
            fwd = [f"{sx(a):.1f},{sy(b):.1f}" for a, b in zip(x, top)]
            back = [f"{sx(a):.1f},{sy(b):.1f}"
                    for a, b in zip(reversed(x), reversed(prev))]
            parts.append(f'<polygon fill="{c}" fill-opacity="0.55" '
                         f'stroke="{c}" points="{" ".join(fwd + back)}"/>')
            prev = top
        parts += _legend(self.series_names, self.width, self.height)
        return _chart_frame(self.title, self.width, self.height,
                            "".join(parts))


@_register
@dataclass
class ChartTimeline(Component):
    """Lanes of [start, end, label] entries (reference
    chart/ChartTimeline.java TimelineEntry rows)."""
    title: str = ""
    lane_names: List[str] = field(default_factory=list)
    lane_entries: List[List[List]] = field(default_factory=list)
    # lane_entries[lane] = [[start_ms, end_ms, label], ...]
    width: int = 640

    def render(self) -> str:
        n = len(self.lane_entries)
        height = 28 * n + 36
        times = [t for lane in self.lane_entries for e in lane
                 for t in (e[0], e[1])]
        t0, t1 = (min(times), max(times)) if times else (0.0, 1.0)
        if t1 == t0:
            t1 = t0 + 1
        pad, W = 90, self.width - 100
        parts = []
        for i, (nm, lane) in enumerate(zip(self.lane_names,
                                           self.lane_entries)):
            yy = 8 + i * 28
            parts.append(f'<text x="4" y="{yy+14}">{_esc(nm)}</text>')
            for j, entry in enumerate(lane):
                s, e = entry[0], entry[1]
                lab = entry[2] if len(entry) > 2 else ""
                x0p = pad + (s - t0) / (t1 - t0) * W
                wpx = max((e - s) / (t1 - t0) * W, 1.5)
                c = _COLORS[j % len(_COLORS)]
                parts.append(f'<rect x="{x0p:.1f}" y="{yy}" '
                             f'width="{wpx:.1f}" height="20" fill="{c}" '
                             f'fill-opacity="0.8"/>')
                if lab:
                    parts.append(f'<text x="{x0p+2:.1f}" y="{yy+14}">'
                                 f'{_esc(lab)}</text>')
        parts.append(f'<text x="{pad}" y="{height-6}">{t0:g}</text>')
        parts.append(f'<text x="{self.width-60}" y="{height-6}">{t1:g}</text>')
        return _chart_frame(self.title, self.width, height, "".join(parts))


# ------------------------------------------------------------- table / text
@_register
@dataclass
class ComponentTable(Component):
    """Header + rows (reference table/ComponentTable.java)."""
    header: List[str] = field(default_factory=list)
    content: List[List] = field(default_factory=list)

    def render(self) -> str:
        parts = ["<table>"]
        if self.header:
            parts.append("<tr>" + "".join(f"<th>{_esc(h)}</th>"
                                          for h in self.header) + "</tr>")
        for row in self.content:
            parts.append("<tr>" + "".join(f"<td>{_esc(v)}</td>"
                                          for v in row) + "</tr>")
        parts.append("</table>")
        return "".join(parts)


@_register
@dataclass
class ComponentText(Component):
    """Styled text (reference text/ComponentText.java)."""
    text: str = ""
    size: int = 13
    bold: bool = False
    color: str = "#111"

    def render(self) -> str:
        w = "600" if self.bold else "400"
        return (f"<div style='font-size:{int(self.size)}px;font-weight:{w};"
                f"color:{_esc(self.color)};margin:4px 0'>"
                f"{_esc(self.text)}</div>")


# --------------------------------------------------------- div / decorator
@_register
@dataclass
class ComponentDiv(Component):
    """Container laying out children vertically (reference
    component/ComponentDiv.java)."""
    components: List[Component] = field(default_factory=list)
    style: str = ""

    def render(self) -> str:
        inner = "".join(c.render() for c in self.components)
        st = f" style='{_esc(self.style)}'" if self.style else ""
        return f"<div{st}>{inner}</div>"


@_register
@dataclass
class DecoratorAccordion(Component):
    """Collapsible section (reference decorator/DecoratorAccordion.java);
    rendered as <details>/<summary> — no JS needed."""
    title: str = ""
    components: List[Component] = field(default_factory=list)
    default_collapsed: bool = True

    def render(self) -> str:
        inner = "".join(c.render() for c in self.components)
        op = "" if self.default_collapsed else " open"
        return (f"<details{op}><summary>{_esc(self.title)}</summary>"
                f"{inner}</details>")


# ------------------------------------------------- stats -> report assembly
def training_report(storage, session_id: Optional[str] = None,
                    worker_id: Optional[str] = None) -> ComponentDiv:
    """Assemble a component-tree training report from a StatsStorage
    session — the DSL's load-bearing consumer (the reference builds the
    same kind of report pages from its components; train/module.js renders
    them). Returns a ComponentDiv; ``render_html`` it or serialize with
    ``to_json`` for a remote renderer."""
    sessions = storage.list_session_ids()
    if session_id is None:
        session_id = sessions[-1] if sessions else ""
    workers = storage.list_worker_ids(session_id) if session_id else []
    if worker_id is None:
        worker_id = workers[0] if workers else ""
    static = storage.get_static_info(session_id, worker_id) or {}
    updates = storage.get_updates(session_id, worker_id)

    kids: List[Component] = [
        ComponentText(f"Training report — session {session_id}",
                      size=18, bold=True)]
    if static:
        kids.append(ComponentTable(
            header=["property", "value"],
            content=[[k, str(v)] for k, v in sorted(static.items())
                     if k != "param_names"]))
    score = [(u["iteration"], u["score"]) for u in updates if "score" in u]
    if score:
        kids.append(ChartLine(title="score vs iteration",
                              x=[[p[0] for p in score]],
                              y=[[p[1] for p in score]],
                              series_names=["score"]))
    pnames = sorted({n for u in updates for n in u.get("params", {})})
    if pnames:
        series_x, series_y = [], []
        for n in pnames[:10]:
            pts = [(u["iteration"], u["params"][n]["meanmag"])
                   for u in updates if n in u.get("params", {})]
            series_x.append([p[0] for p in pts])
            series_y.append([p[1] for p in pts])
        kids.append(DecoratorAccordion(
            title="parameter mean magnitudes",
            components=[ChartLine(title="", x=series_x, y=series_y,
                                  series_names=pnames[:10])]))
    # histograms from the latest update, when collected
    if updates:
        last = updates[-1]
        hists = []
        for n, d in sorted(last.get("params", {}).items()):
            h = d.get("histogram")
            if h:
                counts = h["counts"]
                lo, hi = h["lo"], h["hi"]
                width = (hi - lo) / max(len(counts), 1)
                hists.append(ChartHistogram(
                    title=n,
                    lower_bounds=[lo + i * width
                                  for i in range(len(counts))],
                    upper_bounds=[lo + (i + 1) * width
                                  for i in range(len(counts))],
                    y=[float(c) for c in counts], height=140))
        if hists:
            kids.append(DecoratorAccordion(title="parameter histograms",
                                           components=hists))
    return ComponentDiv(components=kids)
