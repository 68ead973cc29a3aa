"""Run-directory dashboard: load artifacts -> one HTML page -> serve.

Renders the artifact set written by ``EnhancedMSM.save_analysis_results``
(pmarlo_tpu/msm/enhanced.py:345): analysis_summary.json, fes.json,
its.json, ck.json, state_table.json, transition_matrix.npy,
stationary_distribution.npy — the same content the reference webapp's
MSM/FES tab exposed (reference CHANGELOG.md: pmarlo_webapp/app/tabs/
msm_fes.py shows transition probabilities + min/max stationary values).

Host copy of ``pmarlo_tpu/webapp/app.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import base64
import dataclasses
import html
import io
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RunArtifacts:
    """Lazily-loaded contents of one analysis run directory."""

    run_dir: Path
    summary: Optional[Dict] = None
    fes: Optional[object] = None      # msm.free_energy.FESResult
    its: Optional[object] = None      # msm.its.ITSResult
    ck: Optional[Dict] = None
    state_table: Optional[List[Dict]] = None
    transition_matrix: Optional[np.ndarray] = None
    stationary: Optional[np.ndarray] = None

    @classmethod
    def load(cls, run_dir: "str | Path") -> "RunArtifacts":
        run_dir = Path(run_dir)
        if not run_dir.is_dir():
            raise FileNotFoundError(f"run directory not found: {run_dir}")
        art = cls(run_dir=run_dir)

        def _json(name):
            p = run_dir / name
            return json.loads(p.read_text()) if p.exists() else None

        art.summary = _json("analysis_summary.json")
        art.ck = _json("ck.json")
        art.state_table = _json("state_table.json")
        fes_path = run_dir / "fes.json"
        if fes_path.exists():
            from ..msm.free_energy import FESResult

            art.fes = FESResult.load(fes_path)
        its_d = _json("its.json")
        if its_d is not None:
            from ..msm.its import ITSResult

            def _f64(v):
                # JSON writers sanitize NaN to null; object arrays break
                # the isfinite masking downstream
                arr = np.asarray(v, dtype=object)
                return np.where(
                    np.equal(arr, None), np.nan, arr
                ).astype(np.float64)

            art.its = ITSResult(
                lags=_f64(its_d["lags"]),
                timescales=_f64(its_d["timescales"]),
                ci_lower=_f64(its_d["ci_lower"]),
                ci_upper=_f64(its_d["ci_upper"]),
                n_samples=int(its_d.get("n_samples", 0)),
                plateau_lag=its_d.get("plateau_lag"),
                dt=float(its_d.get("dt", 1.0)),
            )
        tm = run_dir / "transition_matrix.npy"
        if tm.exists():
            art.transition_matrix = np.load(tm)
        pi = run_dir / "stationary_distribution.npy"
        if pi.exists():
            art.stationary = np.load(pi)
        return art


def _fig_to_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _img(b64: str, alt: str) -> str:
    return f'<img alt="{alt}" src="data:image/png;base64,{b64}"/>'


def _card(title: str, body: str) -> str:
    return (
        f'<div class="card"><h2>{html.escape(title)}</h2>{body}</div>'
    )


def _kv_table(rows: Dict) -> str:
    cells = "".join(
        f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(str(v))}</td></tr>"
        for k, v in rows.items()
    )
    return f"<table>{cells}</table>"


_STYLE = """
body { font-family: system-ui, sans-serif; margin: 0; background: #f4f5f7; }
header { background: #1a2433; color: #fff; padding: 14px 28px; }
header h1 { margin: 0; font-size: 20px; }
header span { color: #9fb3d1; font-size: 13px; }
main { display: flex; flex-wrap: wrap; gap: 18px; padding: 22px; }
.card { background: #fff; border-radius: 10px; padding: 16px 20px;
        box-shadow: 0 1px 4px rgba(0,0,0,.12); max-width: 680px; }
.card h2 { margin-top: 0; font-size: 16px; color: #1a2433; }
.card img { max-width: 100%; }
table { border-collapse: collapse; font-size: 13px; }
td, th { border: 1px solid #dbe0e8; padding: 4px 10px; text-align: left; }
th { background: #eef1f6; }
.missing { color: #8a93a3; font-style: italic; }
"""


def render_html(art: RunArtifacts) -> str:
    """One self-contained HTML page from the loaded artifacts."""
    import matplotlib

    matplotlib.use("Agg")

    from ..visualization import plots as P

    cards: List[str] = []

    if art.summary:
        cards.append(_card("Run summary", _kv_table(art.summary)))

    if art.fes is not None:
        cards.append(_card(
            "Free-energy surface", _img(_fig_to_b64(P.plot_fes(art.fes)), "FES")
        ))
    if art.its is not None:
        cards.append(_card(
            "Implied timescales", _img(_fig_to_b64(P.plot_its(art.its)), "ITS")
        ))
    if art.ck:
        rows = {
            f"RMS @ k={k}": round(v, 5)
            for k, v in sorted(art.ck.get("rms", {}).items(), key=lambda kv: int(kv[0]))
        }
        rows["max error"] = round(art.ck.get("max_error", float("nan")), 5)
        rows["insufficient data"] = art.ck.get("insufficient_data", False)
        cards.append(_card(f"Chapman-Kolmogorov (lag {art.ck.get('lag')})",
                           _kv_table(rows)))

    if art.stationary is not None:
        pi = art.stationary
        rows = {
            "n states": len(pi),
            "min pi": f"{pi.min():.3e}",
            "max pi": f"{pi.max():.3e}",
            "entropy (nats)": f"{-(pi * np.log(np.maximum(pi, 1e-300))).sum():.3f}",
        }
        if art.transition_matrix is not None:
            T = art.transition_matrix
            rows["min self-transition"] = f"{np.diag(T).min():.4f}"
            rows["max self-transition"] = f"{np.diag(T).max():.4f}"
        cards.append(_card("MSM", _kv_table(rows)))

    if art.state_table:
        head = list(art.state_table[0])
        body = "".join(
            "<tr>" + "".join(
                f"<td>{html.escape(f'{row.get(c):.4g}' if isinstance(row.get(c), float) else str(row.get(c)))}</td>"
                for c in head
            ) + "</tr>"
            for row in art.state_table[:25]
        )
        tbl = ("<table><tr>" + "".join(f"<th>{html.escape(c)}</th>" for c in head)
               + f"</tr>{body}</table>")
        note = ("" if len(art.state_table) <= 25
                else f"<p class='missing'>showing 25 of {len(art.state_table)} states</p>")
        cards.append(_card("State table", tbl + note))

    if not cards:
        cards.append(_card("No artifacts", (
            "<p class='missing'>run EnhancedMSM.save_analysis_results() "
            "into this directory first</p>"
        )))

    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>pmarlo_tpu dashboard</title><style>{_STYLE}</style></head>"
        "<body><header><h1>pmarlo_tpu analysis dashboard</h1>"
        f"<span>{html.escape(str(art.run_dir))}</span></header>"
        f"<main>{''.join(cards)}</main></body></html>"
    )


def export_static(run_dir: "str | Path", out_path: "str | Path") -> Path:
    """Render the run directory to a standalone HTML file."""
    out_path = Path(out_path)
    out_path.write_text(render_html(RunArtifacts.load(run_dir)))
    return out_path


def serve(run_dir: "str | Path", port: int = 8501, open_browser: bool = False):
    """Serve the dashboard; artifacts are re-read on every request so a
    running analysis can be watched live (the Streamlit rerun model)."""
    import http.server

    run_dir = Path(run_dir)
    if not run_dir.is_dir():
        raise FileNotFoundError(f"run directory not found: {run_dir}")

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API)
            try:
                page = render_html(RunArtifacts.load(run_dir)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
            except Exception as exc:  # surface the error in the browser
                msg = f"<pre>{html.escape(str(exc))}</pre>".encode()
                self.send_response(500)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(msg)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    if open_browser:
        import webbrowser

        webbrowser.open(f"http://localhost:{port}")
    print(f"pmarlo_tpu dashboard on http://localhost:{port} (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return server


__all__ = ["RunArtifacts", "render_html", "export_static", "serve"]
