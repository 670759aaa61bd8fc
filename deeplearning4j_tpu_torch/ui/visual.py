"""Visual listeners + renderers: conv-activation grids, model-graph view,
t-SNE page.

Counterpart of ``deeplearning4j_tpu/ui/visual.py``:
``activation_grid_png``, ``ConvolutionalIterationListener``,
``render_model_graph_svg`` / ``render_model_graph`` and
``render_tsne_page`` / ``render_tsne``, the same pages and images.

Deliberate differences:

- ``activation_grid_png`` writes its PNG with the standard library
  (``zlib``, one IDAT chunk, 8-bit greyscale, no filter) instead of PIL,
  which the card's machine does not have; the pixels are the reference's
  (each channel min-max scaled to 0-255 and truncated, the same grid).
- The listener's activations come from ``model.feed_forward(sample)``
  with no gradient; the port's convolution activations are NHWC
  (``nn/layers/conv.py``), as the reference's, so a grid needs no
  transpose. The first ``max_layers`` 4-D activations of example 0 are
  read to the host in one copy a report.
- ``render_model_graph_svg`` works from the port's configuration objects
  (a ``ComputationGraphConfiguration``'s vertices, a
  ``MultiLayerConfiguration``'s layers).

Reference:
- deeplearning4j-ui/.../ConvolutionalIterationListener.java — every N
  iterations, renders each convolutional layer's activation maps as a grid
  image for the UI.
- FlowIterationListener.java + deeplearning4j-play TrainModule model tab
  (TrainModule.java:94-110) — the model-graph/flow view: the network DAG
  drawn with per-layer boxes.
- deeplearning4j-play `tsne` module — serves a 2-D scatter page of t-SNE
  coordinates.
"""
from __future__ import annotations

import base64
import html as _html
import math
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..optimize.listeners import TrainingListener
from .storage import InMemoryStatsStorage, StatsStorage


# ------------------------------------------------------------ image helpers
def _png_gray(canvas: np.ndarray) -> bytes:
    """An 8-bit greyscale PNG of a 2-D uint8 array."""
    h, w = canvas.shape
    raw = b"".join(b"\x00" + canvas[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def activation_grid_png(act: np.ndarray, max_channels: int = 16,
                        upscale: int = 1) -> str:
    """[H, W, C] activation -> base64 PNG of a sqrt-ish channel grid
    (reference ConvolutionalIterationListener's per-layer grid image).
    Each channel is min-max normalized to 8-bit grayscale."""
    act = np.asarray(act)
    if act.ndim != 3:
        raise ValueError(f"expected [H,W,C] activation, got {act.shape}")
    H, W, C = act.shape
    C = min(C, max_channels)
    cols = int(math.ceil(math.sqrt(C)))
    rows = int(math.ceil(C / cols))
    pad = 1
    canvas = np.zeros((rows * (H + pad) + pad, cols * (W + pad) + pad),
                      np.uint8)
    for c in range(C):
        a = act[:, :, c].astype(np.float64)
        lo, hi = float(a.min()), float(a.max())
        img = ((a - lo) / (hi - lo) * 255.0 if hi > lo
               else np.zeros_like(a)).astype(np.uint8)
        r, col = divmod(c, cols)
        y0 = pad + r * (H + pad)
        x0 = pad + col * (W + pad)
        canvas[y0:y0 + H, x0:x0 + W] = img
    if upscale > 1:
        canvas = np.repeat(np.repeat(canvas, upscale, axis=0), upscale,
                           axis=1)
    return base64.b64encode(_png_gray(canvas)).decode("ascii")


class ConvolutionalIterationListener(TrainingListener):
    """Render conv-layer activation grids into the StatsStorage every
    ``frequency`` iterations (reference ConvolutionalIterationListener).

    ``sample``: one input batch (the FIRST example's activations are
    rendered). Works for MultiLayerNetwork (feed_forward list) and
    ComputationGraph (feed_forward dict); every 4-D [B,H,W,C] activation is
    treated as a conv layer output.
    """

    def __init__(self, sample, storage: Optional[StatsStorage] = None,
                 frequency: int = 10, session_id: Optional[str] = None,
                 worker_id: str = "worker_0", max_channels: int = 16,
                 max_layers: int = 8):
        import uuid
        self.storage = storage if storage is not None else InMemoryStatsStorage()
        # only example 0's activations are rendered — don't pay a full-batch
        # forward per report
        self.sample = np.asarray(sample)[:1]
        self.frequency = max(1, frequency)
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        self.max_channels = max_channels
        self.max_layers = max_layers

    def _named_activations(self, model) -> List[tuple]:
        """(name, [H, W, C] numpy) of example 0 for the first
        ``max_layers`` 4-D activations, read to the host in one copy."""
        with torch.no_grad():
            acts = model.feed_forward(self.sample)
        if isinstance(acts, dict):
            named = list(acts.items())
        else:
            named = [(f"layer_{i}", a) for i, a in enumerate(acts)]
        named = [(n, a[0]) for n, a in named
                 if getattr(a, "ndim", 0) == 4][:self.max_layers]
        if not named:
            return []
        flat = torch.cat([a.reshape(-1).float() for _, a in named]).cpu()
        out, at = [], 0
        for n, a in named:
            out.append((n, flat[at:at + a.numel()].reshape(
                a.shape).numpy()))
            at += a.numel()
        return out

    def iteration_done(self, model, iteration: int, score):
        if iteration % self.frequency != 0:
            return
        images: Dict[str, str] = {}
        for name, act in self._named_activations(model):
            images[name] = activation_grid_png(act, self.max_channels)
        if images:
            self.storage.put_update(self.session_id, self.worker_id, {
                "iteration": int(iteration),
                "conv_activations": images,
            })


# ------------------------------------------------------------- model graph
def _graph_layout(names: List[str], inputs_of: Dict[str, List[str]],
                  network_inputs: List[str]):
    """Longest-path depth per node -> columns of boxes."""
    depth = {n: 0 for n in network_inputs}
    for n in names:                      # names are topo-ordered
        ins = [i for i in inputs_of.get(n, [])]
        depth[n] = 1 + max((depth.get(i, 0) for i in ins), default=0)
    cols: Dict[int, List[str]] = {}
    for n in network_inputs + list(names):
        cols.setdefault(depth[n], []).append(n)
    return depth, cols


def render_model_graph_svg(conf) -> str:
    """SVG DAG of a network configuration (reference FlowIterationListener /
    TrainModule model tab). Accepts a ComputationGraphConfiguration (full
    DAG) or a MultiLayerConfiguration (rendered as a chain)."""
    if hasattr(conf, "vertex_names"):          # ComputationGraph
        names = list(conf.vertex_names)
        inputs_of = {n: list(conf.vertex_inputs[n]) for n in names}
        net_inputs = list(conf.network_inputs)
        outputs = set(conf.network_outputs)

        def label(n):
            if n in net_inputs:
                return "Input"
            v = conf.vertices[n]
            layer = getattr(v, "layer", None)
            return type(layer).__name__ if layer is not None else type(v).__name__
    else:                                      # MultiLayerConfiguration chain
        names = [f"{i}: {type(l).__name__}" for i, l in enumerate(conf.layers)]
        inputs_of = {names[i]: ([names[i - 1]] if i else ["input"])
                     for i in range(len(names))}
        net_inputs = ["input"]
        outputs = {names[-1]} if names else set()

        def label(n):
            return "Input" if n == "input" else n.split(": ", 1)[1]

    depth, cols = _graph_layout(names, inputs_of, net_inputs)
    BOX_W, BOX_H, XGAP, YGAP = 148, 34, 50, 14
    pos = {}
    max_rows = max(len(v) for v in cols.values()) if cols else 1
    height = max_rows * (BOX_H + YGAP) + YGAP + 20
    for d in sorted(cols):
        col_nodes = cols[d]
        y0 = (height - len(col_nodes) * (BOX_H + YGAP)) / 2
        for i, n in enumerate(col_nodes):
            pos[n] = (10 + d * (BOX_W + XGAP), y0 + i * (BOX_H + YGAP))
    width = 10 + (max(depth.values(), default=0) + 1) * (BOX_W + XGAP)

    parts = [f'<svg width="{width}" height="{height:.0f}" '
             f'xmlns="http://www.w3.org/2000/svg">'
             '<defs><marker id="arr" markerWidth="8" markerHeight="8" '
             'refX="7" refY="3" orient="auto"><path d="M0,0 L7,3 L0,6 z" '
             'fill="#94a3b8"/></marker></defs>']
    for n in names:
        for i in inputs_of.get(n, []):
            if i not in pos or n not in pos:
                continue
            x1, y1 = pos[i][0] + BOX_W, pos[i][1] + BOX_H / 2
            x2, y2 = pos[n][0], pos[n][1] + BOX_H / 2
            parts.append(f'<path d="M{x1:.0f},{y1:.0f} C{x1+25:.0f},{y1:.0f} '
                         f'{x2-25:.0f},{y2:.0f} {x2:.0f},{y2:.0f}" fill="none" '
                         f'stroke="#94a3b8" marker-end="url(#arr)"/>')
    for n, (x, y) in pos.items():
        is_in = n in net_inputs
        is_out = n in outputs
        fill = "#dbeafe" if is_in else ("#dcfce7" if is_out else "#f8fafc")
        parts.append(f'<rect x="{x:.0f}" y="{y:.0f}" width="{BOX_W}" '
                     f'height="{BOX_H}" rx="6" fill="{fill}" '
                     f'stroke="#64748b"/>')
        disp = n if len(str(n)) <= 18 else str(n)[:17] + "…"
        parts.append(f'<text x="{x+6:.0f}" y="{y+14:.0f}" font-size="10" '
                     f'fill="#0f172a">{_html.escape(str(disp))}</text>')
        parts.append(f'<text x="{x+6:.0f}" y="{y+27:.0f}" font-size="9" '
                     f'fill="#64748b">{_html.escape(label(n))}</text>')
    parts.append("</svg>")
    return "".join(parts)


def render_model_graph(conf, path: str) -> str:
    """Write the model-graph SVG to ``path``; returns the path."""
    with open(path, "w") as f:
        f.write(render_model_graph_svg(conf))
    return path


# ------------------------------------------------------------------- t-SNE
def render_tsne_page(coords, labels=None, *, title: str = "t-SNE",
                     width: int = 760, height: int = 640) -> str:
    """HTML page with an SVG scatter of 2-D embedding coordinates
    (reference deeplearning4j-play `tsne` module page). ``coords``: [N, 2];
    ``labels``: optional N strings/ints used for color groups + text."""
    coords = np.asarray(coords, np.float64)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(f"expected [N,2] coords, got {coords.shape}")
    labels = list(labels) if labels is not None else [None] * len(coords)
    groups = sorted({str(l) for l in labels if l is not None})
    palette = ["#2563eb", "#dc2626", "#059669", "#d97706", "#7c3aed",
               "#0891b2", "#be185d", "#4d7c0f", "#64748b", "#1e40af"]
    color_of = {g: palette[i % len(palette)] for i, g in enumerate(groups)}
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    pad = 30
    parts = [f'<svg width="{width}" height="{height}" '
             f'xmlns="http://www.w3.org/2000/svg">']
    for (x, y), l in zip(coords, labels):
        sx = pad + (x - lo[0]) / span[0] * (width - 2 * pad)
        sy = pad + (1 - (y - lo[1]) / span[1]) * (height - 2 * pad)
        c = color_of.get(str(l), "#334155")
        parts.append(f'<circle cx="{sx:.1f}" cy="{sy:.1f}" r="3" fill="{c}" '
                     f'fill-opacity="0.75"/>')
        if l is not None and len(coords) <= 200:
            parts.append(f'<text x="{sx+4:.1f}" y="{sy+3:.1f}" font-size="9" '
                         f'fill="#475569">{_html.escape(str(l))}</text>')
    legend = "".join(
        f'<span style="color:{color_of[g]}">&#9679;</span> '
        f'{_html.escape(g)} &nbsp; ' for g in groups[:12])
    parts.append("</svg>")
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title></head>"
            f"<body style=\"font-family:sans-serif\"><h1>{_html.escape(title)}"
            f"</h1><div>{legend}</div>{''.join(parts)}</body></html>")


def render_tsne(coords, path: str, labels=None, **kw) -> str:
    with open(path, "w") as f:
        f.write(render_tsne_page(coords, labels, **kw))
    return path
