"""EvaluationTools: export ROC / calibration results as standalone HTML.

A copy of ``deeplearning4j_tpu/eval/tools.py`` (numpy only, no JAX): the
port's networks hand it their outputs as numpy arrays.

Reference: deeplearning4j-core evaluation/EvaluationTools.java —
exportRocChartsToHtmlFile / exportevaluationCalibrationToHtmlFile render the
curves with the ui-components chart DSL; here the charts are dependency-free
inline SVG (as the JAX package's ``ui/dashboard.py`` draws its charts).
"""
from __future__ import annotations

import html as _html
from typing import List, Optional, Sequence, Tuple

W, H, PAD = 420, 300, 40


def _polyline(xs, ys, color):
    pts = " ".join(
        f"{PAD + x * (W - 2 * PAD):.1f},{H - PAD - y * (H - 2 * PAD):.1f}"
        for x, y in zip(xs, ys))
    return (f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>')


def _chart(title, series, diagonal=False):
    """series: [(label, xs, ys, color)] with xs/ys in [0,1]."""
    parts = [f'<svg width="{W}" height="{H}" xmlns="http://www.w3.org/2000/svg">',
             f'<text x="{W//2}" y="16" text-anchor="middle" font-size="13">'
             f'{_html.escape(title)}</text>',
             f'<rect x="{PAD}" y="{PAD}" width="{W-2*PAD}" height="{H-2*PAD}" '
             f'fill="none" stroke="#ccc"/>']
    if diagonal:
        parts.append(_polyline([0, 1], [0, 1], "#bbb"))
    legend_y = PAD + 4
    for label, xs, ys, color in series:
        parts.append(_polyline(xs, ys, color))
        parts.append(f'<text x="{W-PAD-4}" y="{legend_y + 10}" font-size="10" '
                     f'text-anchor="end" fill="{color}">'
                     f'{_html.escape(label)}</text>')
        legend_y += 12
    for v, anchor in [(0.0, "start"), (0.5, "middle"), (1.0, "end")]:
        x = PAD + v * (W - 2 * PAD)
        parts.append(f'<text x="{x:.0f}" y="{H-PAD+14}" font-size="9" '
                     f'text-anchor="middle">{v:g}</text>')
        y = H - PAD - v * (H - 2 * PAD)
        parts.append(f'<text x="{PAD-6}" y="{y:.0f}" font-size="9" '
                     f'text-anchor="end">{v:g}</text>')
    parts.append("</svg>")
    return "".join(parts)


_COLORS = ["#3366cc", "#dc3912", "#ff9900", "#109618", "#990099", "#0099c6"]


def _page(title, charts):
    body = "".join(f'<div style="display:inline-block;margin:10px">{c}</div>'
                   for c in charts)
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title></head>"
            f"<body><h2>{_html.escape(title)}</h2>{body}</body></html>")


def roc_chart_html(roc, title: str = "ROC") -> str:
    """HTML for a fitted ROC / ROCBinary / ROCMultiClass (reference
    EvaluationTools.exportRocChartsToHtmlFile)."""
    charts = []
    if hasattr(roc, "get_roc_curve"):       # plain ROC
        fpr, tpr, _ = roc.get_roc_curve()
        charts.append(_chart(f"{title} (AUC={roc.calculate_auc():.4f})",
                             [("ROC", fpr, tpr, _COLORS[0])], diagonal=True))
    else:                                   # ROCBinary/ROCMultiClass family
        per = getattr(roc, "_rocs", None) or []
        series = []
        for i, r in enumerate(per):
            fpr, tpr, _ = r.get_roc_curve()
            series.append((f"class {i} ({r.calculate_auc():.3f})",
                           fpr, tpr, _COLORS[i % len(_COLORS)]))
        charts.append(_chart(title, series, diagonal=True))
    return _page(title, charts)


def calibration_chart_html(cal, title: str = "Calibration") -> str:
    """HTML reliability diagrams + residual histogram (reference
    EvaluationTools.exportevaluationCalibrationToHtmlFile)."""
    charts = []
    c = cal._bin_counts.shape[0] if cal._bin_counts is not None else 0
    series = []
    for ci in range(c):
        mean_pred, frac_pos, counts = cal.reliability_diagram(ci)
        keep = counts > 0
        series.append((f"class {ci} (ECE={cal.expected_calibration_error(ci):.3f})",
                       mean_pred[keep], frac_pos[keep],
                       _COLORS[ci % len(_COLORS)]))
    charts.append(_chart("Reliability diagram", series, diagonal=True))
    edges, counts = cal.residual_plot()
    if counts.max() > 0:
        xs = (edges[:-1] + edges[1:]) / 2.0
        ys = counts / counts.max()
        charts.append(_chart("Residual histogram |label - p|",
                             [("residuals", xs, ys, _COLORS[0])]))
    return _page(title, charts)


def export_roc_charts(path: str, roc, title: str = "ROC") -> None:
    with open(path, "w") as f:
        f.write(roc_chart_html(roc, title))


def export_calibration_charts(path: str, cal, title: str = "Calibration") -> None:
    with open(path, "w") as f:
        f.write(calibration_chart_html(cal, title))
