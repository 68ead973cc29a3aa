"""FES smoothing: Dirichlet-posterior uncertainty and adaptive Gaussian blur.

Reference: src/pmarlo/markov_state_model/fes_smoothing.py:13-110 —
SD[F] = kT sqrt(psi'(n + a) + psi'(N + a0)) per-bin uncertainty from the
Dirichlet posterior of histogram counts, ESS-adaptive bandwidth, and a
sigma-bank blended Gaussian smoother. polygamma(1, .) is evaluated via a
recurrence + asymptotic series (no scipy dependency needed on device, and
the host path mirrors it).

Host copy of ``pmarlo_tpu/msm/fes_smoothing.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def trigamma(x: np.ndarray) -> np.ndarray:
    """psi'(x) via recurrence to x >= 6 then asymptotic series."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    # recurrence psi'(x) = psi'(x+1) + 1/x^2
    xs = x.copy()
    while True:
        small = xs < 6.0
        if not small.any():
            break
        out[small] += 1.0 / xs[small] ** 2
        xs[small] += 1.0
    inv = 1.0 / xs
    inv2 = inv * inv
    series = inv + 0.5 * inv2 + inv2 * inv * (1.0 / 6.0 - inv2 * (1.0 / 30.0 - inv2 / 42.0))
    return out + series


def fes_uncertainty(
    counts: np.ndarray,
    kT: float,
    alpha: float = 0.5,
) -> np.ndarray:
    """Per-bin SD of F = -kT ln p under a Dirichlet(alpha) posterior
    (reference fes_smoothing.py:13): SD[F] = kT sqrt(psi'(n+a) - psi'(N+a0))."""
    counts = np.asarray(counts, dtype=np.float64)
    N = counts.sum()
    a0 = alpha * counts.size
    var_log = trigamma(counts + alpha) - trigamma(N + a0)
    return kT * np.sqrt(np.maximum(var_log, 0.0))


def ess_adaptive_sigma(
    weights: Optional[np.ndarray],
    n_samples: int,
    base_sigma: float = 0.6,
    ref_ess: float = 1000.0,
) -> float:
    """Bandwidth grows as effective sample size shrinks
    (reference fes_smoothing.py:49)."""
    if weights is None:
        ess = float(n_samples)
    else:
        w = np.asarray(weights, dtype=np.float64)
        s = w.sum()
        ess = float(s * s / np.maximum((w * w).sum(), 1e-300))
    if ess <= 0:
        return base_sigma * 2.0
    factor = np.clip(np.sqrt(ref_ess / ess), 1.0, 4.0)
    return float(base_sigma * factor)


def gaussian_smooth_2d(
    H: np.ndarray,
    sigma: "float | Tuple[float, float]",
    periodic: Tuple[bool, bool] = (False, False),
) -> np.ndarray:
    """Separable Gaussian blur; wraps on periodic axes, reflects otherwise."""
    H = np.asarray(H, dtype=np.float64)
    if np.isscalar(sigma):
        sigma = (float(sigma), float(sigma))
    out = H
    for axis, (s, per) in enumerate(zip(sigma, periodic)):
        if s <= 0:
            continue
        radius = max(int(np.ceil(3 * s)), 1)
        x = np.arange(-radius, radius + 1)
        kern = np.exp(-0.5 * (x / s) ** 2)
        kern /= kern.sum()
        size = out.shape[axis]
        if per:
            idx = np.arange(-radius, size + radius) % size
        else:
            idx = np.clip(np.arange(-radius, size + radius), 0, size - 1)
        padded = np.take(out, idx, axis=axis)
        out = np.apply_along_axis(
            lambda v: np.convolve(v, kern, mode="valid"), axis, padded
        )
    return out


def sigma_bank_smooth(
    H: np.ndarray,
    uncertainty: np.ndarray,
    kT: float,
    sigmas: Sequence[float] = (0.0, 0.6, 1.2, 2.4),
    periodic: Tuple[bool, bool] = (False, False),
    uncertainty_scale: float = 1.0,
) -> np.ndarray:
    """Blend a bank of Gaussian-smoothed histograms per-bin by uncertainty
    (reference fes_smoothing.py:72): well-sampled bins stay sharp, noisy
    bins take the wider kernels."""
    bank = np.stack([gaussian_smooth_2d(H, s, periodic) for s in sigmas])
    # map uncertainty (in kT) to a fractional index into the bank
    u = np.asarray(uncertainty) / max(kT, 1e-300) * uncertainty_scale
    idx = np.clip(u, 0.0, len(sigmas) - 1.0)
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, len(sigmas) - 1)
    frac = idx - lo
    ii, jj = np.meshgrid(
        np.arange(H.shape[0]), np.arange(H.shape[1]), indexing="ij"
    )
    return bank[lo, ii, jj] * (1 - frac) + bank[hi, ii, jj] * frac


__all__ = [
    "trigamma",
    "fes_uncertainty",
    "ess_adaptive_sigma",
    "gaussian_smooth_2d",
    "sigma_bank_smooth",
]
