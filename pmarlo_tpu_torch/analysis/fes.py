"""FES input preparation over datasets
(reference: src/pmarlo/analysis/fes.py:20 highest-variance CV selection,
:91 weight normalization + ESS).

Port of ``pmarlo_tpu/analysis/fes.py``: the KDE surface's two kernel
factors and their weighted product are float32 tensors on ``device``, as
JAX's are float32 arrays; the rest is numpy, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from .._device import default_device
from ..msm.free_energy import FESResult, generate_2d_fes


def select_fes_columns(X: np.ndarray, n: int = 2) -> Tuple[int, ...]:
    """Pick the n highest-variance CV columns (reference fes.py:20)."""
    X = np.asarray(X)
    var = X.var(axis=0)
    order = np.argsort(var)[::-1]
    return tuple(int(i) for i in order[:n])


def normalize_weights(
    weights: Optional[np.ndarray], n: int
) -> Tuple[np.ndarray, float]:
    """Normalized weights + effective sample size (reference fes.py:91)."""
    if weights is None:
        return np.full(n, 1.0 / n), float(n)
    w = np.asarray(weights, dtype=np.float64)
    if w.shape[0] != n:
        raise ValueError(f"weights length {w.shape[0]} != {n}")
    if (w < 0).any():
        raise ValueError("weights must be non-negative")
    total = w.sum()
    if total <= 0:
        raise ValueError("weights sum to zero")
    w = w / total
    ess = float(1.0 / np.sum(w * w))
    return w, ess


def compute_bandwidth(
    coord: np.ndarray,
    weights: np.ndarray,
    ess: float,
    selector: "str | float" = "scott",
) -> float:
    """Scott/Silverman (d=2) or explicit bandwidth
    (reference fes.py:142)."""
    if isinstance(selector, (int, float)):
        value = float(selector)
        if value <= 0:
            raise ValueError("bandwidth must be positive")
        return value
    mean = float(np.average(coord, weights=weights))
    var = float(np.average((coord - mean) ** 2, weights=weights))
    if var <= 0:
        raise ValueError("coordinate variance must be positive")
    std = float(np.sqrt(var))
    n_eff = max(float(ess), 1.0)
    d = 2.0
    sel = str(selector).lower()
    if sel == "scott":
        factor = n_eff ** (-1.0 / (d + 4.0))
    elif sel == "silverman":
        factor = (n_eff * (d + 2.0) / 4.0) ** (-1.0 / (d + 4.0))
    else:
        raise ValueError(
            "bandwidth must be 'scott', 'silverman', or a positive float"
        )
    bw = std * factor
    if not np.isfinite(bw) or bw <= 0:
        raise ValueError("computed bandwidth must be finite and positive")
    return bw


def compute_kde_fes(
    cv1: np.ndarray,
    cv2: np.ndarray,
    *,
    temperature_K: float = 300.0,
    bins: "int | Tuple[int, int]" = 64,
    bandwidth: "str | float" = "scott",
    weights: Optional[np.ndarray] = None,
    cv_names: Tuple[str, str] = ("CV1", "CV2"),
    device=None,
) -> FESResult:
    """Gaussian-KDE FES (reference fes.py:176 _compute_kde_surface): the
    separable kernel contraction density = Kx @ diag(w) @ Ky^T over
    (bins, n_frames) float32 factors on ``device`` (``None``:
    ``_device.default_device()``), one matmul rather than a host einsum."""
    dev = torch.device(device) if device is not None else default_device()

    x = np.asarray(cv1, np.float64).ravel()
    y = np.asarray(cv2, np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError("cv1/cv2 length mismatch")
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise ValueError("KDE FES requires finite coordinates")
    n = x.shape[0]
    w, ess = normalize_weights(weights, n)
    if isinstance(bins, (tuple, list)):
        nx, ny = int(bins[0]), int(bins[1])
    else:
        nx = ny = int(bins)
    if nx < 2 or ny < 2:
        raise ValueError("KDE FES requires at least two bins per dimension")
    bw_x = compute_bandwidth(x, w, ess, bandwidth)
    bw_y = compute_bandwidth(y, w, ess, bandwidth)

    xedges = np.linspace(x.min() - 3 * bw_x, x.max() + 3 * bw_x, nx + 1)
    yedges = np.linspace(y.min() - 3 * bw_y, y.max() + 3 * bw_y, ny + 1)
    xc = 0.5 * (xedges[:-1] + xedges[1:])
    yc = 0.5 * (yedges[:-1] + yedges[1:])

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    Kx = torch.exp(-0.5 * ((on_device(xc)[:, None] - on_device(x)[None, :]) / bw_x) ** 2)
    Ky = torch.exp(-0.5 * ((on_device(yc)[:, None] - on_device(y)[None, :]) / bw_y) ** 2)
    density = ((Kx * on_device(w)[None, :]) @ Ky.T).cpu().numpy().astype(np.float64)
    density /= 2.0 * np.pi * bw_x * bw_y

    kB = 0.00831446261815324  # kJ/mol/K
    kT = kB * temperature_K
    pos = density > 0
    F = np.full_like(density, np.nan)
    F[pos] = -kT * np.log(density[pos])
    if np.isfinite(F).any():
        F -= np.nanmin(F)
    return FESResult(
        free_energy=F, xedges=xedges, yedges=yedges,
        counts=density * n, temperature_K=temperature_K,
        cv_names=cv_names, smoothing_mode="kde",
        finite_fraction=float(np.isfinite(F).mean()),
    )


def fes_from_dataset(
    dataset: Sequence[Dict],
    *,
    temperature_K: float = 300.0,
    columns: Optional[Tuple[int, int]] = None,
    weights_key: str = "weights",
    bins: Optional[int] = None,
    smoothing_mode: str = "auto",
    method: str = "histogram",
    bandwidth: "str | float" = "scott",
    device=None,
) -> FESResult:
    """Pool shard features (and per-frame weights if present) into one FES.

    ``method``: "histogram" (adaptive grid + uncertainty-gated smoothing)
    or "kde" (Gaussian kernel surface, reference fes.py:176, on
    ``device``)."""
    feats, weights, have_weights = [], [], False
    for shard in dataset:
        X = np.asarray(shard["features"] if isinstance(shard, dict) else shard)
        feats.append(X)
        if isinstance(shard, dict) and weights_key in shard:
            weights.append(np.asarray(shard[weights_key]))
            have_weights = True
        else:
            weights.append(np.ones(X.shape[0]))
    X = np.concatenate(feats, axis=0)
    w = np.concatenate(weights) if have_weights else None
    if columns is None:
        columns = select_fes_columns(X, 2)
    c1, c2 = columns
    if w is not None:
        w, _ = normalize_weights(w, X.shape[0])
    if method == "kde":
        return compute_kde_fes(
            X[:, c1], X[:, c2], temperature_K=temperature_K,
            bins=bins or 64, bandwidth=bandwidth, weights=w,
            cv_names=(f"CV{c1}", f"CV{c2}"), device=device,
        )
    if method != "histogram":
        raise ValueError(f"unknown FES method {method!r}")
    return generate_2d_fes(
        X[:, c1], X[:, c2], temperature_K=temperature_K, bins=bins,
        weights=w, smoothing_mode=smoothing_mode,
        cv_names=(f"CV{c1}", f"CV{c2}"),
    )


__all__ = [
    "select_fes_columns",
    "normalize_weights",
    "compute_bandwidth",
    "compute_kde_fes",
    "fes_from_dataset",
]
