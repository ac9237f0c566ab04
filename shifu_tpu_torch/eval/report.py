"""Eval HTML report — ROC / PR / gain charts + summary + per-bucket table;
the port's copy of ``shifu_tpu.eval.report`` (pure Python).

The reference renders `EvalPerformance` through Highcharts templates
(``core/eval/GainChart.java``, ``ConfusionMatrix.java:553`` HTML path);
here the report is one dependency-free standalone HTML file with inline
SVG curves, built from the full-resolution sweep (not just the 10 buckets).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .metrics import PerformanceResult, SweepCurves

_W, _H, _PAD = 420, 300, 42


def _downsample(xs: np.ndarray, ys: np.ndarray,
                max_pts: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    if len(xs) <= max_pts:
        return xs, ys
    idx = np.unique(np.linspace(0, len(xs) - 1, max_pts).astype(int))
    return xs[idx], ys[idx]


def _polyline(xs: np.ndarray, ys: np.ndarray, color: str) -> str:
    xs, ys = _downsample(np.asarray(xs, float), np.asarray(ys, float))
    px = _PAD + xs * (_W - 2 * _PAD)
    py = _H - _PAD - ys * (_H - 2 * _PAD)
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(px, py))
    return (f'<polyline fill="none" stroke="{color}" stroke-width="2" '
            f'points="{pts}"/>')


def _svg_chart(title: str, xlabel: str, ylabel: str,
               curves: Sequence[Tuple[np.ndarray, np.ndarray, str, str]],
               diagonal: bool = False) -> str:
    parts = [f'<svg width="{_W}" height="{_H}" '
             'style="background:#fff;border:1px solid #ccc">']
    # axes
    parts.append(f'<line x1="{_PAD}" y1="{_H - _PAD}" x2="{_W - _PAD}" '
                 f'y2="{_H - _PAD}" stroke="#444"/>')
    parts.append(f'<line x1="{_PAD}" y1="{_PAD}" x2="{_PAD}" '
                 f'y2="{_H - _PAD}" stroke="#444"/>')
    for t in (0.0, 0.25, 0.5, 0.75, 1.0):
        x = _PAD + t * (_W - 2 * _PAD)
        y = _H - _PAD - t * (_H - 2 * _PAD)
        parts.append(f'<text x="{x:.0f}" y="{_H - _PAD + 14}" '
                     f'font-size="9" text-anchor="middle">{t:g}</text>')
        parts.append(f'<text x="{_PAD - 6}" y="{y + 3:.0f}" font-size="9" '
                     f'text-anchor="end">{t:g}</text>')
    if diagonal:
        parts.append(f'<line x1="{_PAD}" y1="{_H - _PAD}" '
                     f'x2="{_W - _PAD}" y2="{_PAD}" stroke="#bbb" '
                     'stroke-dasharray="4"/>')
    legend_y = _PAD - 24
    for i, (xs, ys, color, label) in enumerate(curves):
        parts.append(_polyline(xs, ys, color))
        lx = _PAD + i * 130
        parts.append(f'<rect x="{lx}" y="{legend_y + 16}" width="10" '
                     f'height="3" fill="{color}"/>')
        parts.append(f'<text x="{lx + 14}" y="{legend_y + 21}" '
                     f'font-size="10">{label}</text>')
    parts.append(f'<text x="{_W / 2}" y="{_PAD - 24}" font-size="12" '
                 f'text-anchor="middle" font-weight="bold">{title}</text>')
    parts.append(f'<text x="{_W / 2}" y="{_H - 8}" font-size="10" '
                 f'text-anchor="middle">{xlabel}</text>')
    parts.append(f'<text x="12" y="{_H / 2}" font-size="10" '
                 f'text-anchor="middle" transform="rotate(-90 12 '
                 f'{_H / 2})">{ylabel}</text>')
    parts.append("</svg>")
    return "".join(parts)


def html_report(name: str, c: SweepCurves,
                result: PerformanceResult) -> str:
    """Render from the SAME SweepCurves evaluate_curves consumed — one sort
    over the eval set, two consumers."""
    if c.pos_total == 0 or c.neg_total == 0:
        return (f"<html><body><h1>Eval {name}</h1><p>degenerate eval set "
                "(single class) — no curves</p></body></html>")
    tpr = c.tp / c.pos_total
    fpr = c.fp / c.neg_total
    wtpr = c.wtp / max(c.wpos_total, 1e-12)
    precision = c.tp / np.maximum(c.tp + c.fp, 1e-12)
    total = c.pos_total + c.neg_total
    action = (c.tp + c.fp) / total
    waction = (c.wtp + c.wfp) / max(c.wpos_total + c.wneg_total, 1e-12)

    roc = _svg_chart("ROC", "false positive rate", "catch rate",
                     [(fpr, tpr, "#d4712b", "unit"),
                      (c.wfp / max(c.wneg_total, 1e-12), wtpr, "#3b6fb0",
                       "weighted")], diagonal=True)
    pr = _svg_chart("Precision-Recall", "recall", "precision",
                    [(tpr, precision, "#d4712b", "unit")])
    gain = _svg_chart("Gain chart", "action rate", "catch rate",
                      [(action, tpr, "#d4712b", "unit"),
                       (waction, wtpr, "#3b6fb0", "weighted")],
                      diagonal=True)

    def fmt(v):
        return "n/a" if v is None or (isinstance(v, float) and np.isnan(v)) \
            else f"{v:.6f}" if isinstance(v, float) else str(v)

    rows = []
    cols = ["binLowestScore", "actionRate", "recall", "precision", "fpr",
            "liftUnit", "tp", "fp", "fn", "tn"]
    for p in result.points:
        rows.append("<tr>" + "".join(
            f"<td>{getattr(p, col):.4f}</td>" if isinstance(
                getattr(p, col), float) else f"<td>{getattr(p, col)}</td>"
            for col in cols) + "</tr>")
    table = ("<table border='1' cellspacing='0' cellpadding='3' "
             "style='border-collapse:collapse;font-size:12px'>"
             "<tr>" + "".join(f"<th>{col}</th>" for col in cols) + "</tr>"
             + "".join(rows) + "</table>")

    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Eval {name}</title></head>
<body style="font-family:sans-serif;max-width:960px;margin:auto">
<h1>Eval report — {name}</h1>
<table border="0" cellpadding="4" style="font-size:14px">
<tr><td>records</td><td>{result.recordCount}</td>
<td>positives</td><td>{result.posCount:g}</td>
<td>negatives</td><td>{result.negCount:g}</td>
<td>models</td><td>{result.modelCount}</td></tr>
<tr><td>AUC</td><td><b>{fmt(result.areaUnderRoc)}</b></td>
<td>weighted AUC</td><td><b>{fmt(result.weightedAuc)}</b></td>
<td>PR AUC</td><td><b>{fmt(result.areaUnderPr)}</b></td><td></td><td></td></tr>
</table>
<div>{roc} {pr}</div>
<div>{gain}</div>
<h2>Per-bucket confusion</h2>
{table}
</body></html>
"""
