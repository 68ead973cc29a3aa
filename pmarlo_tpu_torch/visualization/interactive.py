"""Interactive HTML plots — first-party replacement for the reference's
plotly backend (src/pmarlo/markov_state_model/_plots.py:45: plotly Contour
with hover readout + write_html). Plotly is not available in this
environment, so the same capability is built from scratch: self-contained
HTML (inline SVG + a small JS hover layer, zero external assets) that any
browser renders with live cursor readout of CV values / free energies /
timescales.

Entry points mirror the plotly surface:
  fes_html(fes)          -> contour-style FES with hover F(x, y) readout
  lines_html(x, ys, ...) -> multi-series line plot with nearest-point hover
  its_html(its)          -> implied-timescales wrapper over lines_html
All return the HTML string and optionally write it to a file.

Host copy of ``pmarlo_tpu/visualization/interactive.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import base64
import io
import json
import math
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PALETTE = (
    "#4C78A8", "#F58518", "#54A24B", "#E45756", "#72B7B2",
    "#B279A2", "#FF9DA6", "#9D755D", "#BAB0AC", "#EECA3B",
)

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: -apple-system, "Segoe UI", Helvetica, Arial, sans-serif;
        background: #fff; color: #222; margin: 16px; }}
 .tooltip {{ position: absolute; pointer-events: none; background: #222;
            color: #fff; padding: 4px 8px; border-radius: 4px;
            font-size: 12px; display: none; white-space: pre; z-index: 10; }}
 .plotwrap {{ position: relative; display: inline-block; }}
 text {{ font-size: 11px; fill: #444; }}
 .title {{ font-size: 14px; font-weight: 600; fill: #222; }}
</style></head>
<body>
{body}
</body></html>
"""


def _save(html: str, path) -> str:
    if path is not None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(html)
    return html


def _nice_ticks(lo: float, hi: float, n: int = 6):
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        return [lo]
    span = hi - lo
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    first = math.ceil(lo / step) * step
    ticks = []
    t = first
    while t <= hi + 1e-12 * span:
        ticks.append(round(t, 12))
        t += step
    return ticks


def _log_ticks(lo: float, hi: float):
    lo_e = math.floor(math.log10(lo))
    hi_e = math.ceil(math.log10(hi))
    return [10.0 ** e for e in range(lo_e, hi_e + 1)]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1e4 or a < 1e-3:
        return f"{v:.1e}"
    return f"{v:.4g}"


def _viridis_png(values: np.ndarray, vmin: float, vmax: float) -> str:
    """Rasterize a 2D array (NaN transparent) to a base64 PNG, viridis."""
    import matplotlib

    matplotlib.use("Agg")

    norm = (values - vmin) / max(vmax - vmin, 1e-12)
    rgba = matplotlib.colormaps["viridis"](np.clip(norm, 0, 1))
    rgba[..., 3] = np.where(np.isfinite(values), 1.0, 0.0)
    buf = io.BytesIO()
    import matplotlib.image as mimage

    mimage.imsave(buf, rgba, format="png", origin="lower")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def fes_html(
    fes,
    path: Optional["str | Path"] = None,
    *,
    max_kj: float = 30.0,
    width: int = 640,
    height: int = 520,
) -> str:
    """Interactive FES: heatmap + hover readout of (cv1, cv2, F).

    Mirrors reference _plots.py:45-66 (plotly Contour + write_html).
    """
    F = np.asarray(fes.free_energy, dtype=float)
    xe = np.asarray(fes.xedges, dtype=float)
    ye = np.asarray(fes.yedges, dtype=float)
    cv1, cv2 = fes.cv_names[0], fes.cv_names[1]
    finite = F[np.isfinite(F)]
    vmin = float(finite.min()) if finite.size else 0.0
    vmax = float(min(finite.max(), vmin + max_kj)) if finite.size else 1.0
    Fc = np.where(np.isfinite(F), np.minimum(F, vmax), np.nan)
    png = _viridis_png(Fc.T, vmin, vmax)  # rows = cv2 for image orientation

    ml, mr, mt, mb = 64, 96, 36, 48
    pw, ph = width - ml - mr, height - mt - mb
    x0, x1 = float(xe[0]), float(xe[-1])
    y0, y1 = float(ye[0]), float(ye[-1])

    def sx(v):
        return ml + (v - x0) / (x1 - x0) * pw

    def sy(v):
        return mt + ph - (v - y0) / (y1 - y0) * ph

    parts = [
        f'<svg id="fes" width="{width}" height="{height}">',
        f'<text class="title" x="{ml}" y="18">FES @ {fes.temperature_K:g} K '
        f"({cv1} vs {cv2})</text>",
        f'<image x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
        f'preserveAspectRatio="none" '
        f'href="data:image/png;base64,{png}"/>',
        f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
        'fill="none" stroke="#999"/>',
    ]
    for t in _nice_ticks(x0, x1):
        X = sx(t)
        parts.append(f'<line x1="{X:.1f}" y1="{mt + ph}" x2="{X:.1f}" '
                     f'y2="{mt + ph + 4}" stroke="#444"/>')
        parts.append(f'<text x="{X:.1f}" y="{mt + ph + 16}" '
                     f'text-anchor="middle">{_fmt(t)}</text>')
    for t in _nice_ticks(y0, y1):
        Y = sy(t)
        parts.append(f'<line x1="{ml - 4}" y1="{Y:.1f}" x2="{ml}" '
                     f'y2="{Y:.1f}" stroke="#444"/>')
        parts.append(f'<text x="{ml - 7}" y="{Y + 3:.1f}" '
                     f'text-anchor="end">{_fmt(t)}</text>')
    parts.append(f'<text x="{ml + pw / 2}" y="{height - 8}" '
                 f'text-anchor="middle">{cv1}</text>')
    parts.append(f'<text x="14" y="{mt + ph / 2}" text-anchor="middle" '
                 f'transform="rotate(-90 14 {mt + ph / 2})">{cv2}</text>')
    # colorbar
    cb_x = ml + pw + 16
    grad_id = "fesgrad"
    stops = "".join(
        f'<stop offset="{p * 100:.0f}%" stop-color="{c}"/>'
        for p, c in ((0, "#440154"), (0.25, "#3b528b"), (0.5, "#21918c"),
                     (0.75, "#5ec962"), (1, "#fde725"))
    )
    parts.append(
        f'<defs><linearGradient id="{grad_id}" x1="0" y1="1" x2="0" y2="0">'
        f"{stops}</linearGradient></defs>"
        f'<rect x="{cb_x}" y="{mt}" width="14" height="{ph}" '
        f'fill="url(#{grad_id})" stroke="#999"/>'
    )
    for frac in (0.0, 0.5, 1.0):
        v = vmin + frac * (vmax - vmin)
        Y = mt + ph - frac * ph
        parts.append(f'<text x="{cb_x + 18}" y="{Y + 3:.1f}">{_fmt(v)}</text>')
    parts.append(f'<text x="{cb_x}" y="{mt - 8}">F (kJ/mol)</text>')
    parts.append("</svg>")
    svg = "".join(parts)

    data = {
        "F": [[None if not np.isfinite(v) else round(float(v), 4) for v in row]
              for row in F],
        "xe": [float(v) for v in xe],
        "ye": [float(v) for v in ye],
        "ml": ml, "mt": mt, "pw": pw, "ph": ph,
        "x0": x0, "x1": x1, "y0": y0, "y1": y1,
        "cv1": cv1, "cv2": cv2,
    }
    body = (
        f'<div class="plotwrap">{svg}'
        f'<div class="tooltip" id="tip"></div></div>\n'
        f"<script>\nconst D = {json.dumps(data)};\n"
        """
const svg = document.getElementById('fes');
const tip = document.getElementById('tip');
svg.addEventListener('mousemove', (ev) => {
  const r = svg.getBoundingClientRect();
  const px = ev.clientX - r.left, py = ev.clientY - r.top;
  if (px < D.ml || px > D.ml + D.pw || py < D.mt || py > D.mt + D.ph) {
    tip.style.display = 'none'; return;
  }
  const x = D.x0 + (px - D.ml) / D.pw * (D.x1 - D.x0);
  const y = D.y0 + (D.mt + D.ph - py) / D.ph * (D.y1 - D.y0);
  let i = D.xe.findIndex((e, k) => k + 1 < D.xe.length && x >= e && x <= D.xe[k + 1]);
  let j = D.ye.findIndex((e, k) => k + 1 < D.ye.length && y >= e && y <= D.ye[k + 1]);
  let f = (i >= 0 && j >= 0) ? D.F[i][j] : null;
  tip.textContent = D.cv1 + ' = ' + x.toFixed(3) + '\\n' + D.cv2 + ' = '
      + y.toFixed(3) + '\\nF = ' + (f === null ? 'unsampled' : f + ' kJ/mol');
  tip.style.left = (px + 14) + 'px';
  tip.style.top = (py + 14) + 'px';
  tip.style.display = 'block';
});
svg.addEventListener('mouseleave', () => { tip.style.display = 'none'; });
</script>"""
    )
    html = _PAGE.format(title=f"FES {cv1} vs {cv2}", body=body)
    return _save(html, path)


def lines_html(
    x: Sequence[float],
    ys: Sequence[Sequence[float]],
    labels: Optional[Sequence[str]] = None,
    *,
    title: str = "",
    xlabel: str = "",
    ylabel: str = "",
    logx: bool = False,
    logy: bool = False,
    bands: Optional[Sequence] = None,
    extra_diagonal: bool = False,
    path: Optional["str | Path"] = None,
    width: int = 640,
    height: int = 440,
) -> str:
    """Multi-series line plot with nearest-point hover readout.

    ``bands`` is an optional list of (lower, upper) arrays per series
    (confidence intervals). ``extra_diagonal`` draws the y=x reference
    (the ITS tau diagonal).
    """
    x = np.asarray(x, dtype=float)
    series = [np.asarray(y, dtype=float) for y in ys]
    labels = list(labels) if labels else [f"series {i}" for i in range(len(series))]

    ml, mr, mt, mb = 72, 120, 36, 52
    pw, ph = width - ml - mr, height - mt - mb
    allv = np.concatenate([s[np.isfinite(s)] for s in series]) if series else np.array([1.0])
    if bands:
        for b in bands:
            if b is not None:
                lo, hi = np.asarray(b[0], float), np.asarray(b[1], float)
                allv = np.concatenate([allv, lo[np.isfinite(lo)], hi[np.isfinite(hi)]])
    xv = x[np.isfinite(x)]
    if logx:
        xv = xv[xv > 0]
    if logy:
        allv = allv[allv > 0]
    x0, x1 = (float(xv.min()), float(xv.max())) if xv.size else (0.0, 1.0)
    y0, y1 = (float(allv.min()), float(allv.max())) if allv.size else (0.0, 1.0)
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1.0

    def sx(v):
        if logx:
            return ml + (math.log10(v) - math.log10(x0)) / (
                math.log10(x1) - math.log10(x0)) * pw
        return ml + (v - x0) / (x1 - x0) * pw

    def sy(v):
        if logy:
            return mt + ph - (math.log10(v) - math.log10(y0)) / (
                math.log10(y1) - math.log10(y0)) * ph
        return mt + ph - (v - y0) / (y1 - y0) * ph

    parts = [f'<svg id="lp" width="{width}" height="{height}">']
    if title:
        parts.append(f'<text class="title" x="{ml}" y="18">{title}</text>')
    parts.append(f'<rect x="{ml}" y="{mt}" width="{pw}" height="{ph}" '
                 'fill="none" stroke="#999"/>')
    xticks = _log_ticks(x0, x1) if logx else _nice_ticks(x0, x1)
    for t in xticks:
        if t < x0 or t > x1:
            continue
        X = sx(t)
        parts.append(f'<line x1="{X:.1f}" y1="{mt}" x2="{X:.1f}" '
                     f'y2="{mt + ph}" stroke="#eee"/>')
        parts.append(f'<text x="{X:.1f}" y="{mt + ph + 16}" '
                     f'text-anchor="middle">{_fmt(t)}</text>')
    yticks = _log_ticks(y0, y1) if logy else _nice_ticks(y0, y1)
    for t in yticks:
        if t < y0 or t > y1:
            continue
        Y = sy(t)
        parts.append(f'<line x1="{ml}" y1="{Y:.1f}" x2="{ml + pw}" '
                     f'y2="{Y:.1f}" stroke="#eee"/>')
        parts.append(f'<text x="{ml - 7}" y="{Y + 3:.1f}" '
                     f'text-anchor="end">{_fmt(t)}</text>')
    if xlabel:
        parts.append(f'<text x="{ml + pw / 2}" y="{height - 8}" '
                     f'text-anchor="middle">{xlabel}</text>')
    if ylabel:
        parts.append(f'<text x="16" y="{mt + ph / 2}" text-anchor="middle" '
                     f'transform="rotate(-90 16 {mt + ph / 2})">{ylabel}</text>')
    if extra_diagonal:
        lo = max(x0, y0) if not (logx or logy) else max(x0, y0)
        hi = min(x1, y1)
        if hi > lo:
            parts.append(
                f'<line x1="{sx(lo):.1f}" y1="{sy(lo):.1f}" x2="{sx(hi):.1f}" '
                f'y2="{sy(hi):.1f}" stroke="#666" stroke-dasharray="5 4"/>'
            )
    # CI bands under the lines
    if bands:
        for i, b in enumerate(bands):
            if b is None:
                continue
            lo, hi = np.asarray(b[0], float), np.asarray(b[1], float)
            pts_up, pts_dn = [], []
            for xi, l, h in zip(x, lo, hi):
                if not (np.isfinite(xi) and np.isfinite(l) and np.isfinite(h)):
                    continue
                if (logx and xi <= 0) or (logy and (l <= 0 or h <= 0)):
                    continue
                pts_up.append(f"{sx(xi):.1f},{sy(h):.1f}")
                pts_dn.append(f"{sx(xi):.1f},{sy(l):.1f}")
            if pts_up:
                poly = " ".join(pts_up + pts_dn[::-1])
                parts.append(f'<polygon points="{poly}" '
                             f'fill="{_PALETTE[i % len(_PALETTE)]}" opacity="0.15"/>')
    for i, s in enumerate(series):
        pts = []
        for xi, yi in zip(x, s):
            if not (np.isfinite(xi) and np.isfinite(yi)):
                continue
            if (logx and xi <= 0) or (logy and yi <= 0):
                continue
            pts.append(f"{sx(xi):.1f},{sy(yi):.1f}")
        color = _PALETTE[i % len(_PALETTE)]
        if pts:
            parts.append(f'<polyline points="{" ".join(pts)}" fill="none" '
                         f'stroke="{color}" stroke-width="1.8"/>')
            for p in pts:
                cx, cy = p.split(",")
                parts.append(f'<circle cx="{cx}" cy="{cy}" r="2.4" '
                             f'fill="{color}"/>')
        ly = mt + 14 + i * 16
        parts.append(f'<rect x="{ml + pw + 12}" y="{ly - 8}" width="10" '
                     f'height="10" fill="{color}"/>')
        parts.append(f'<text x="{ml + pw + 26}" y="{ly + 1}">{labels[i]}</text>')
    parts.append(f'<line id="xh" x1="0" y1="{mt}" x2="0" y2="{mt + ph}" '
                 'stroke="#aaa" stroke-dasharray="3 3" visibility="hidden"/>')
    parts.append("</svg>")
    svg = "".join(parts)

    data = {
        "x": [None if not np.isfinite(v) else float(v) for v in x],
        "ys": [[None if not np.isfinite(v) else float(v) for v in s]
               for s in series],
        "labels": labels,
        "ml": ml, "mt": mt, "pw": pw, "ph": ph,
        "x0": x0, "x1": x1, "logx": logx,
    }
    body = (
        f'<div class="plotwrap">{svg}'
        f'<div class="tooltip" id="tip"></div></div>\n'
        f"<script>\nconst D = {json.dumps(data)};\n"
        """
const svg = document.getElementById('lp');
const tip = document.getElementById('tip');
const xh = document.getElementById('xh');
function toData(px) {
  const f = (px - D.ml) / D.pw;
  if (D.logx) {
    const l0 = Math.log10(D.x0), l1 = Math.log10(D.x1);
    return Math.pow(10, l0 + f * (l1 - l0));
  }
  return D.x0 + f * (D.x1 - D.x0);
}
svg.addEventListener('mousemove', (ev) => {
  const r = svg.getBoundingClientRect();
  const px = ev.clientX - r.left, py = ev.clientY - r.top;
  if (px < D.ml || px > D.ml + D.pw || py < D.mt || py > D.mt + D.ph) {
    tip.style.display = 'none'; xh.setAttribute('visibility', 'hidden');
    return;
  }
  const xv = toData(px);
  let best = -1, bd = Infinity;
  for (let k = 0; k < D.x.length; k++) {
    if (D.x[k] === null) continue;
    const d = Math.abs(D.x[k] - xv);
    if (d < bd) { bd = d; best = k; }
  }
  if (best < 0) return;
  let lines = ['x = ' + D.x[best].toPrecision(5)];
  for (let s = 0; s < D.ys.length; s++) {
    const v = D.ys[s][best];
    lines.push(D.labels[s] + ' = ' + (v === null ? 'n/a' : v.toPrecision(5)));
  }
  tip.textContent = lines.join('\\n');
  tip.style.left = (px + 14) + 'px';
  tip.style.top = (py + 14) + 'px';
  tip.style.display = 'block';
  const fx = D.logx
    ? D.ml + (Math.log10(D.x[best]) - Math.log10(D.x0)) /
      (Math.log10(D.x1) - Math.log10(D.x0)) * D.pw
    : D.ml + (D.x[best] - D.x0) / (D.x1 - D.x0) * D.pw;
  xh.setAttribute('x1', fx); xh.setAttribute('x2', fx);
  xh.setAttribute('visibility', 'visible');
});
svg.addEventListener('mouseleave', () => {
  tip.style.display = 'none'; xh.setAttribute('visibility', 'hidden');
});
</script>"""
    )
    html = _PAGE.format(title=title or "plot", body=body)
    return _save(html, path)


def its_html(
    its, path: Optional["str | Path"] = None, dt_label: str = "steps"
) -> str:
    """Interactive implied timescales (log-log, CI bands, tau diagonal)."""
    if its is None:
        raise ValueError("no ITS to plot")
    k = its.timescales.shape[1]
    ys = [its.timescales[:, i] for i in range(k)]
    bands = [(its.ci_lower[:, i], its.ci_upper[:, i]) for i in range(k)]
    return lines_html(
        its.lags, ys, [f"t{i + 1}" for i in range(k)],
        title="Implied timescales",
        xlabel=f"lag ({dt_label})", ylabel=f"timescale ({dt_label})",
        logx=True, logy=True, bands=bands, extra_diagonal=True, path=path,
    )


__all__ = ["fes_html", "lines_html", "its_html"]
