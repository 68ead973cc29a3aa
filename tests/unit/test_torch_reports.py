"""The port's reports against the JAX package's on the CPU: the sampling
benchmark (``benchmark/``), the matplotlib plots and the first-party
interactive HTML (``visualization/``) and the dashboard (``webapp/``).

Mirrors of ``test_webapp.py``, ``test_interactive_plots.py`` and the plot
tests of ``test_deploy_visualization.py`` run on the port's modules. Every
plot is drawn from the port's own results (FES, PMF, ITS, CK, TPT, REMD
acceptance) by both packages' functions, which must write the same PNG
bytes; the HTML pages are string-equal to JAX's on the same data, and the
dashboard renders one run directory, written by the port's
``EnhancedMSM.save_analysis_results``, into JAX's page.
"""

import json
import re
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

import pmarlo_tpu.benchmark as jbench
from pmarlo_tpu.visualization import interactive as jI
from pmarlo_tpu.visualization import plots as jP
from pmarlo_tpu.webapp import RunArtifacts as JRunArtifacts
from pmarlo_tpu.webapp import render_html as jrender_html
from pmarlo_tpu_torch import benchmark as bench
from pmarlo_tpu_torch.msm.free_energy import FESResult, generate_1d_pmf, generate_2d_fes
from pmarlo_tpu_torch.msm.its import ITSResult
from pmarlo_tpu_torch.visualization import interactive as I
from pmarlo_tpu_torch.visualization import plots as P
from pmarlo_tpu_torch.webapp import RunArtifacts, export_static, render_html

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --- benchmark -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cvs():
    rng = np.random.default_rng(4)
    t = np.cumsum(rng.normal(0, 0.3, 3000))
    return np.sin(t) + rng.normal(0, 0.1, 3000), np.cos(0.7 * t) + rng.normal(0, 0.1, 3000)


def test_coverage_and_transitions_equal_jax(cvs):
    x, y = cvs
    for kw in ({}, {"bins": 8}, {"bins": 16, "ranges": ((-2.0, 2.0), (-3.0, 3.0))}):
        c = bench.coverage_2d(x, y, **kw)
        assert c == jbench.coverage_2d(x, y, **kw) and 0.0 < c <= 1.0
    for thr in (0.0, 0.5, float(np.median(x))):
        n = bench.sign_change_transitions(x, thr)
        assert n == jbench.sign_change_transitions(x, thr) and n >= 0
    assert bench.sign_change_transitions(np.array([1.0, 0.0, -1.0, 0.0, 2.0])) == 2


@pytest.mark.parametrize("weighted", [False, True])
def test_run_benchmark_equals_jax(cvs, weighted):
    x, y = cvs
    w = np.random.default_rng(0).uniform(0.5, 1.5, len(x)) if weighted else None
    r = bench.run_benchmark(x, y, bins=24, weights=w)
    j = jbench.run_benchmark(x, y, bins=24, weights=w)
    assert r.keys() == j.keys()
    for k in r:
        if k == "fes":
            np.testing.assert_array_equal(r[k].free_energy, j[k].free_energy)
            assert isinstance(r[k], FESResult)
        else:
            assert r[k] == j[k], k
    assert 0.0 < r["coverage"] <= 1.0 and r["n_frames"] == len(x)


@pytest.mark.parametrize("experiment,measured", [
    ("muller_brown_active_bias", {"kl_ref_reweighted": 4.4, "xy_coverage": 0.04,
                                  "test_vamp2": 0.97}),
    ("muller_brown_active_bias", {"kl_ref_reweighted": 9.0, "xy_coverage": 0.2}),
    ("adaptive_retraining", {"kl_ref_est": 0.1, "coverage": 0.2, "retrain_count": 4.0}),
    ("adaptive_retraining", {"kl_ref_est": None, "coverage": 0.33}),
])
def test_compare_to_anchor_equals_jax(experiment, measured):
    assert bench.REFERENCE_ANCHORS == jbench.REFERENCE_ANCHORS
    out = bench.compare_to_anchor(experiment, measured)
    assert out == jbench.compare_to_anchor(experiment, measured)
    assert out["verdict"] in ("agree_or_beats", "disagree")


# --- plots -----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results():
    """The port's own results, each a plot's input."""
    from pmarlo_tpu_torch.msm.ck import ck_test
    from pmarlo_tpu_torch.msm.its import compute_implied_timescales
    from pmarlo_tpu_torch.msm.tpt import reactive_flux
    from pmarlo_tpu_torch.remd.remd import RemdResult

    rng = np.random.default_rng(1)
    T = np.array([[0.90, 0.07, 0.02, 0.01], [0.06, 0.90, 0.03, 0.01],
                  [0.01, 0.03, 0.90, 0.06], [0.01, 0.02, 0.07, 0.90]])
    dtrajs = []
    for _ in range(2):
        s = [0]
        for _ in range(1499):
            s.append(rng.choice(4, p=T[s[-1]]))
        dtrajs.append(np.asarray(s, dtype=np.int64))
    fes = generate_2d_fes(rng.normal(size=3000), rng.normal(size=3000), temperature_K=300.0,
                          bins=20, cv_names=("phi", "psi"))
    cv = np.concatenate([rng.normal(-1, 0.2, 3000), rng.normal(1, 0.2, 3000)])
    acc = np.array([0.41, 0.38, 0.35, 0.30, 0.28])
    remd = RemdResult(positions=np.zeros((2, 6, 1, 3), np.float32),
                      potential_energy=np.zeros((2, 6)),
                      temperatures=np.linspace(300.0, 450.0, 6),
                      replica_ids=np.tile(np.arange(6), (2, 1)), acceptance_matrix=acc,
                      exchange_attempts=1, n_steps=200, dt_ps=0.002)
    return {
        "fes": fes, "pmf": generate_1d_pmf(cv, temperature_K=300.0, bins=40),
        "its": compute_implied_timescales(dtrajs, [1, 2, 5], n_states=4, n_samples=20,
                                          device="cpu"),
        "ck": ck_test(dtrajs, 2, (2, 3), n_states=4),
        "tpt": reactive_flux(T, [0], [3]), "T": T, "pi": np.full(4, 0.25), "remd": remd,
        "phi": rng.uniform(-180, 180, 500), "psi": rng.uniform(-180, 180, 500),
        "features": [rng.normal(size=(300, 2)), rng.normal(size=(200, 2))],
    }


PLOTS = {
    "plot_fes": lambda r: (r["fes"],),
    "plot_fes_1d": lambda r: (r["pmf"],),
    "plot_its": lambda r: (r["its"],),
    "plot_implied_rates": lambda r: (r["its"],),
    "plot_ck": lambda r: (r["ck"],),
    "plot_ramachandran": lambda r: (r["phi"], r["psi"]),
    "plot_committors": lambda r: (r["tpt"],),
    "plot_flux_network": lambda r: (r["tpt"],),
    "plot_rates": lambda r: (r["T"], r["pi"]),
    "plot_pathways": lambda r: (r["tpt"],),
    "plot_tpt_summary": lambda r: (r["tpt"],),
    "plot_pcca_on_fes": lambda r: (r["fes"], np.array([[-1.0, -1.0], [1.0, 1.0]]),
                                   np.array([0, 1])),
    "plot_acceptance_matrix": lambda r: (r["remd"],),
    "plot_sampling_validation": lambda r: (r["features"],),
    "plot_frames_per_shard": lambda r: ([120, 340, 200, 90, 410],),
}


def test_every_plot_is_tested():
    public = {n for n in dir(P) if n.startswith("plot_")}
    assert public == set(PLOTS) == {n for n in dir(jP) if n.startswith("plot_")}
    assert P.__all__ == jP.__all__


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plot_writes_jax_png(results, name, tmp_path):
    args = PLOTS[name](results)
    fig = getattr(P, name)(*args, tmp_path / "port.png")
    getattr(jP, name)(*args, tmp_path / "jax.png")
    assert isinstance(fig, Figure)
    png = (tmp_path / "port.png").read_bytes()
    assert png[:8] == PNG and len(png) > 2000
    assert png == (tmp_path / "jax.png").read_bytes()
    # without a path the Figure comes back open, nothing written
    assert isinstance(getattr(P, name)(*args), Figure)


def test_plots_require_data():
    with pytest.raises(ValueError):
        P.plot_fes(None)
    with pytest.raises(ValueError):
        P.plot_its(None)


# --- interactive HTML (test_interactive_plots.py) --------------------------------------------


@pytest.fixture
def fes_grid():
    x = np.linspace(-np.pi, np.pi, 21)
    y = np.linspace(-np.pi, np.pi, 16)
    xc = 0.5 * (x[:-1] + x[1:])[:, None]
    yc = 0.5 * (y[:-1] + y[1:])[None, :]
    F = 3.0 * (1 - np.cos(xc)) + 2.0 * (1 - np.cos(yc))
    F[0, 0] = np.nan  # unsampled bin
    return FESResult(free_energy=F, xedges=x, yedges=y, counts=np.exp(-F / 2.5),
                     temperature_K=300.0, cv_names=("phi", "psi"))


@pytest.fixture
def its_curves():
    lags = np.array([1, 2, 5, 10, 20, 50])
    ts = np.stack([100.0 / (1 + 5.0 / lags), 30.0 / (1 + 2.0 / lags)], axis=1)
    return ITSResult(lags=lags, timescales=ts, ci_lower=ts * 0.8, ci_upper=ts * 1.25,
                     n_samples=100, plateau_lag=20)


def _data(html):
    return json.loads(re.search(r"const D = (\{.*?\});\n", html, re.S).group(1))


def test_fes_html_equals_jax(tmp_path, fes_grid):
    out = tmp_path / "fes.html"
    html = I.fes_html(fes_grid, out)
    assert out.read_text() == html == jI.fes_html(fes_grid)
    assert "<svg" in html and "data:image/png;base64," in html and "mousemove" in html
    data = _data(html)
    assert data["F"][0][0] is None
    assert data["F"][3][4] == pytest.approx(fes_grid.free_energy[3, 4], abs=1e-3)
    assert "http://" not in html and "https://" not in html  # self-contained


def test_its_html_equals_jax(tmp_path, its_curves):
    html = I.its_html(its_curves, tmp_path / "its.html")
    assert html == jI.its_html(its_curves)
    assert "Implied timescales" in html and "<polygon" in html
    data = _data(html)
    assert data["logx"] is True
    assert data["ys"][0][0] == pytest.approx(its_curves.timescales[0, 0], rel=1e-6)
    assert "http://" not in html and "https://" not in html


def test_lines_html_equals_jax(tmp_path):
    x = np.array([1.0, 2.0, 3.0, 4.0])
    ys = [np.array([1.0, np.nan, 3.0, 4.0]), np.array([2.0, 2.5, 2.0, 1.0])]
    html = I.lines_html(x, ys, ["a", "b"], path=tmp_path / "l.html")
    assert html == jI.lines_html(x, ys, ["a", "b"])
    assert _data(html)["ys"][0][1] is None  # NaN serializes as null


def test_enhanced_msm_interactive_flag(tmp_path, fes_grid, its_curves):
    from pmarlo_tpu_torch.msm.enhanced import EnhancedMSM

    msm = EnhancedMSM(output_dir=tmp_path, device="cpu")
    msm.fes, msm.its = fes_grid, its_curves
    assert msm.plot_free_energy_surface(interactive=True) == jI.fes_html(fes_grid)
    assert msm.plot_implied_timescales(interactive=True) == jI.its_html(its_curves)
    assert (tmp_path / "fes.html").exists() and (tmp_path / "its.html").exists()


# --- the dashboard (test_webapp.py) ---------------------------------------------------------


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, double_well_dtrajs):
    """A run directory written by the port's ``EnhancedMSM``: every
    artifact the dashboard reads."""
    from pmarlo_tpu_torch.msm.enhanced import EnhancedMSM

    _, xs = double_well_dtrajs
    out = tmp_path_factory.mktemp("run")
    m = EnhancedMSM(output_dir=out, device="cpu")
    m.features = [np.stack([x, np.roll(x, 3)], axis=1).astype(np.float32) for x in xs]
    m.cluster_features(n_states=6, seed=0)
    m.build_msm(lag_time=5)
    m.compute_implied_timescales(lags=[1, 2, 5, 10], n_samples=20)
    m.compute_ck_test(factors=[2, 3])
    m.generate_free_energy_surface(0, 1, bins=16)
    m.create_state_table()
    m.save_analysis_results()
    return out


CARDS = ("Run summary", "Free-energy surface", "Implied timescales", "Chapman-Kolmogorov",
         "MSM", "State table")


def _titles(page):
    return re.findall(r"<h2>(.*?)</h2>", page)


def test_render_html_equals_jax(run_dir):
    page = render_html(RunArtifacts.load(run_dir))
    assert page == jrender_html(JRunArtifacts.load(run_dir))
    titles = _titles(page)
    for card in CARDS:
        assert any(t.startswith(card) for t in titles), card
    assert "base64" in page


def test_artifacts_load_as_jax_loads_them(run_dir):
    art, jart = RunArtifacts.load(run_dir), JRunArtifacts.load(run_dir)
    assert isinstance(art.its, ITSResult) and isinstance(art.fes, FESResult)
    for field in ("lags", "timescales", "ci_lower", "ci_upper"):
        np.testing.assert_array_equal(getattr(art.its, field), getattr(jart.its, field))
    assert art.its.plateau_lag == jart.its.plateau_lag and art.its.dt == jart.its.dt
    np.testing.assert_array_equal(art.transition_matrix, jart.transition_matrix)
    assert art.summary == jart.summary and art.state_table == jart.state_table


def test_export_static(run_dir, tmp_path):
    out = export_static(run_dir, tmp_path / "dash.html")
    assert out.exists() and out.stat().st_size > 10_000
    assert out.read_text() == render_html(RunArtifacts.load(run_dir))


def test_partial_artifacts_render(tmp_path):
    (tmp_path / "analysis_summary.json").write_text(json.dumps({"temperature_K": 300.0}))
    page = render_html(RunArtifacts.load(tmp_path))
    assert "Run summary" in page and "Free-energy surface" not in page
    assert page == jrender_html(JRunArtifacts.load(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert "No artifacts" in render_html(RunArtifacts.load(empty))


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        RunArtifacts.load(tmp_path / "nope")
    with pytest.raises(FileNotFoundError):
        export_static(tmp_path / "nope", tmp_path / "out.html")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_round_trip(run_dir, capsys):
    from pmarlo_tpu_torch.webapp.app import serve

    port = _free_port()
    threading.Thread(target=lambda: serve(run_dir, port=port), daemon=True).start()
    deadline = time.time() + 20
    page = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}", timeout=5) as resp:
                status, page = resp.status, resp.read().decode()
            break
        except OSError:
            time.sleep(0.2)
    assert page is not None and status == 200
    assert "pmarlo_tpu analysis dashboard" in page
    assert _titles(page) == _titles(render_html(RunArtifacts.load(run_dir)))


def test_webapp_module_exports(run_dir, tmp_path, monkeypatch, capsys):
    """``python -m pmarlo_tpu_torch.webapp RUN_DIR --export OUT`` writes the
    page (run in the process through the module's ``main``)."""
    import sys

    from pmarlo_tpu_torch.webapp.__main__ import main

    out = tmp_path / "cli.html"
    monkeypatch.setattr(sys, "argv", ["pmarlo_tpu_torch.webapp", str(run_dir), "--export",
                                      str(out)])
    main()
    assert f"wrote {out}" in capsys.readouterr().out
    assert out.read_text() == render_html(RunArtifacts.load(run_dir))
