"""Plotting helpers. All functions accept an optional save path and return
the matplotlib Figure; they use the Agg backend so they run headless.

Reference surface: _plots.py:30 (FES/ITS/rates/CK), _tpt_viz.py:24
(committor/flux/pathways), visualization/diagnostics.py:12-41 (sampling
validation, frames-per-shard histogram).

Host copy of ``pmarlo_tpu/visualization/plots.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _finish(fig, path):
    fig.tight_layout()
    if path is not None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_fes(fes, path: Optional["str | Path"] = None, max_kj: float = 30.0):
    """2D free-energy surface heat map with masked unsampled bins."""
    if fes is None:
        raise ValueError("no FES to plot")
    fig, ax = plt.subplots(figsize=(6, 5))
    F = np.ma.masked_invalid(fes.free_energy.T)
    mesh = ax.pcolormesh(
        fes.xedges, fes.yedges, np.clip(F, 0, max_kj), cmap="viridis", shading="auto"
    )
    fig.colorbar(mesh, ax=ax, label="F (kJ/mol)")
    ax.set_xlabel(fes.cv_names[0])
    ax.set_ylabel(fes.cv_names[1])
    ax.set_title(f"FES @ {fes.temperature_K:g} K")
    return _finish(fig, path)


def plot_fes_1d(
    pmf,
    path: Optional["str | Path"] = None,
    max_kj: float = 30.0,
):
    """1D free-energy profile (reference _plots.py:84
    plot_free_energy_profile): PMF vs CV with unsampled bins masked."""
    if pmf is None:
        raise ValueError("no PMF to plot")
    fig, ax = plt.subplots(figsize=(6, 4))
    centers = 0.5 * (np.asarray(pmf.edges[:-1]) + np.asarray(pmf.edges[1:]))
    F = np.ma.masked_invalid(np.asarray(pmf.free_energy))
    ax.plot(centers, np.clip(F, 0, max_kj), lw=1.5)
    ax.fill_between(centers, 0, np.clip(F, 0, max_kj), alpha=0.15)
    ax.set_xlabel("CV")
    ax.set_ylabel("F (kJ/mol)")
    ax.set_title(f"PMF @ {pmf.temperature_K:g} K")
    return _finish(fig, path)


def plot_its(its, path: Optional["str | Path"] = None, dt_label: str = "steps"):
    """Implied timescales vs lag with CI bands and the tau=t diagonal."""
    if its is None:
        raise ValueError("no ITS to plot")
    fig, ax = plt.subplots(figsize=(6, 4.5))
    k = its.timescales.shape[1]
    for i in range(k):
        ax.plot(its.lags, its.timescales[:, i], "o-", ms=3, label=f"t{i + 1}")
        ax.fill_between(its.lags, its.ci_lower[:, i], its.ci_upper[:, i], alpha=0.2)
    ax.plot(its.lags, its.lags, "k--", lw=1, label="tau")
    if its.plateau_lag is not None:
        ax.axvline(its.plateau_lag, color="r", ls=":", label=f"plateau @ {its.plateau_lag}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(f"lag ({dt_label})")
    ax.set_ylabel(f"implied timescale ({dt_label})")
    ax.legend(fontsize=8)
    return _finish(fig, path)


def plot_implied_rates(its, path: Optional["str | Path"] = None,
                       dt_label: str = "steps"):
    """Implied rates 1/t_i vs lag with CI bands (reference
    _plots.py:188 plot_implied_rates; CIs invert and swap bounds)."""
    if its is None:
        raise ValueError("no ITS to plot")
    fig, ax = plt.subplots(figsize=(6, 4.5))
    k = its.timescales.shape[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = 1.0 / np.asarray(its.timescales)
        r_lo = 1.0 / np.asarray(its.ci_upper)   # slow timescale -> low rate
        r_hi = 1.0 / np.asarray(its.ci_lower)
    for i in range(k):
        ax.plot(its.lags, rates[:, i], "o-", ms=3, label=f"k{i + 1}")
        ax.fill_between(its.lags, r_lo[:, i], r_hi[:, i], alpha=0.2)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(f"lag ({dt_label})")
    ax.set_ylabel(f"implied rate (1/{dt_label})")
    ax.legend(fontsize=8)
    return _finish(fig, path)


def plot_ck(ck, path: Optional["str | Path"] = None, max_states: int = 4):
    """Predicted vs estimated long-lag self-transition probabilities."""
    if ck is None or not ck.predicted:
        raise ValueError("no CK data to plot")
    states = list(range(min(len(ck.states), max_states)))
    factors = sorted(ck.predicted)
    fig, axes = plt.subplots(1, len(states), figsize=(3 * len(states), 3), squeeze=False)
    for col, s in enumerate(states):
        ax = axes[0][col]
        pred = [1.0] + [ck.predicted[f][s, s] for f in factors]
        est = [1.0] + [ck.estimated[f][s, s] for f in factors]
        xs = [1] + factors
        ax.plot(xs, pred, "o--", label="T(tau)^k")
        ax.plot(xs, est, "s-", label="T(k tau)")
        ax.set_title(f"state {ck.states[s]}")
        ax.set_xlabel("k")
        ax.set_ylim(0, 1.05)
        if col == 0:
            ax.set_ylabel("P(self)")
            ax.legend(fontsize=7)
    return _finish(fig, path)


def plot_ramachandran(
    phi_deg, psi_deg, path: Optional["str | Path"] = None, bins: int = 72
):
    from ..features.ramachandran import periodic_hist2d

    H, xe, ye = periodic_hist2d(phi_deg, psi_deg, bins=bins)
    fig, ax = plt.subplots(figsize=(5.5, 5))
    mesh = ax.pcolormesh(xe, ye, np.log1p(H.T), cmap="magma", shading="auto")
    fig.colorbar(mesh, ax=ax, label="log(1+count)")
    ax.set_xlabel("phi (deg)")
    ax.set_ylabel("psi (deg)")
    return _finish(fig, path)


def plot_committors(tpt, path: Optional["str | Path"] = None):
    fig, ax = plt.subplots(figsize=(6, 4))
    n = len(tpt.forward_committor)
    ax.bar(np.arange(n) - 0.2, tpt.forward_committor, 0.4, label="q+")
    ax.bar(np.arange(n) + 0.2, tpt.backward_committor, 0.4, label="q-")
    ax.set_xlabel("state")
    ax.set_ylabel("committor")
    ax.legend()
    return _finish(fig, path)


def plot_flux_network(
    tpt, path: Optional["str | Path"] = None, top_edges: int = 20
):
    """Net-flux network: states on a committor axis, edges by flux."""
    fig, ax = plt.subplots(figsize=(7, 5))
    q = tpt.forward_committor
    n = len(q)
    rng = np.random.default_rng(0)
    ys = rng.uniform(0, 1, n)
    F = tpt.net_flux
    order = np.dstack(np.unravel_index(np.argsort(-F, axis=None), F.shape))[0]
    fmax = F.max() if F.max() > 0 else 1.0
    for i, j in order[:top_edges]:
        if F[i, j] <= 0:
            continue
        ax.annotate(
            "", xy=(q[j], ys[j]), xytext=(q[i], ys[i]),
            arrowprops=dict(arrowstyle="->", alpha=0.6, lw=2.5 * F[i, j] / fmax),
        )
    ax.scatter(q, ys, s=80, c=q, cmap="coolwarm", zorder=3, edgecolors="k")
    for s in tpt.source_states:
        ax.scatter([q[s]], [ys[s]], s=160, facecolors="none", edgecolors="b", zorder=4)
    for s in tpt.sink_states:
        ax.scatter([q[s]], [ys[s]], s=160, facecolors="none", edgecolors="r", zorder=4)
    ax.set_xlabel("forward committor q+")
    ax.set_yticks([])
    ax.set_title(f"net flux (rate={tpt.rate:.3g})")
    return _finish(fig, path)


def plot_rates(
    T: np.ndarray, pi: np.ndarray, path: Optional["str | Path"] = None,
    top_n: int = 15,
):
    """Largest off-diagonal transition rates pi_i T_ij (reference
    _plots.py rates panel)."""
    T = np.asarray(T)
    pi = np.asarray(pi)
    flux = pi[:, None] * T
    np.fill_diagonal(flux, 0.0)
    order = np.dstack(np.unravel_index(np.argsort(-flux, axis=None), flux.shape))[0]
    fig, ax = plt.subplots(figsize=(7, 3.5))
    labels, values = [], []
    for i, j in order[:top_n]:
        labels.append(f"{i}->{j}")
        values.append(flux[i, j])
    ax.bar(range(len(values)), values)
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=60, fontsize=7)
    ax.set_ylabel("pi_i T_ij")
    return _finish(fig, path)


def plot_pathways(tpt, path: Optional["str | Path"] = None, max_paths: int = 8):
    """Pathway flux decomposition bars (reference conformations
    visualizations pathway plot)."""
    fig, ax = plt.subplots(figsize=(7, 3.5))
    paths = tpt.pathways[:max_paths]
    if not paths:
        raise ValueError("TPT result has no pathways")
    labels = ["-".join(map(str, p)) for p, _ in paths]
    values = [f for _, f in paths]
    ax.barh(range(len(values)), values)
    ax.set_yticks(range(len(labels)))
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("pathway flux")
    ax.invert_yaxis()
    return _finish(fig, path)


def plot_tpt_summary(tpt, path: Optional["str | Path"] = None):
    """Committors + flux network + pathways in one figure (reference
    conformations/visualizations TPT summary)."""
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    n = len(tpt.forward_committor)
    axes[0].bar(np.arange(n) - 0.2, tpt.forward_committor, 0.4, label="q+")
    axes[0].bar(np.arange(n) + 0.2, tpt.backward_committor, 0.4, label="q-")
    axes[0].set_title("committors")
    axes[0].legend(fontsize=7)
    im = axes[1].imshow(tpt.net_flux, cmap="Reds")
    fig.colorbar(im, ax=axes[1], fraction=0.046)
    axes[1].set_title(f"net flux (rate={tpt.rate:.3g})")
    if tpt.pathways:
        values = [f for _, f in tpt.pathways[:8]]
        labels = ["-".join(map(str, p)) for p, _ in tpt.pathways[:8]]
        axes[2].barh(range(len(values)), values)
        axes[2].set_yticks(range(len(labels)))
        axes[2].set_yticklabels(labels, fontsize=6)
        axes[2].invert_yaxis()
    axes[2].set_title("pathways")
    return _finish(fig, path)


def plot_pcca_on_fes(
    fes, centers: np.ndarray, assignments: np.ndarray,
    path: Optional["str | Path"] = None,
):
    """Macrostate assignments of microstate centers over the FES
    (reference conformations/visualizations PCCA-on-FES plot).

    ``centers`` (n_states, 2) microstate centers in the FES CV plane.
    """
    fig, ax = plt.subplots(figsize=(6.5, 5))
    F = np.ma.masked_invalid(fes.free_energy.T)
    ax.pcolormesh(fes.xedges, fes.yedges, F, cmap="Greys", shading="auto")
    centers = np.asarray(centers)
    ax.scatter(
        centers[:, 0], centers[:, 1], c=np.asarray(assignments),
        cmap="tab10", s=60, edgecolors="k", zorder=3,
    )
    ax.set_xlabel(fes.cv_names[0])
    ax.set_ylabel(fes.cv_names[1])
    ax.set_title("PCCA+ macrostates on FES")
    return _finish(fig, path)


def plot_acceptance_matrix(remd_result, path: Optional["str | Path"] = None):
    """REMD per-pair swap acceptance (sampling-validation diagnostic)."""
    fig, ax = plt.subplots(figsize=(6, 3.5))
    acc = remd_result.acceptance_matrix
    ax.bar(np.arange(len(acc)), acc)
    ax.axhline(0.2, color="r", ls="--", lw=1, label="0.2 floor")
    ax.set_xlabel("neighbor pair")
    ax.set_ylabel("acceptance")
    ax.set_ylim(0, 1)
    ax.legend()
    return _finish(fig, path)


def plot_sampling_validation(
    features: Sequence[np.ndarray], path: Optional["str | Path"] = None
):
    """Coverage of the first two feature dimensions per trajectory
    (reference visualization/diagnostics.py:12)."""
    fig, ax = plt.subplots(figsize=(6, 5))
    for i, X in enumerate(features):
        X = np.asarray(X)
        ax.scatter(X[:, 0], X[:, 1], s=2, alpha=0.3, label=f"traj {i}" if i < 8 else None)
    ax.set_xlabel("CV1")
    ax.set_ylabel("CV2")
    ax.legend(fontsize=7, markerscale=3)
    return _finish(fig, path)


def plot_frames_per_shard(
    shard_lengths: Sequence[int], path: Optional["str | Path"] = None
):
    """(reference visualization/diagnostics.py:41)."""
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.hist(list(shard_lengths), bins=20)
    ax.set_xlabel("frames per shard")
    ax.set_ylabel("count")
    return _finish(fig, path)


__all__ = [
    "plot_fes", "plot_fes_1d", "plot_its", "plot_ck", "plot_ramachandran",
    "plot_committors",
    "plot_flux_network", "plot_acceptance_matrix", "plot_sampling_validation",
    "plot_frames_per_shard",
]
