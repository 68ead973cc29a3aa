"""Isotropic long-range LJ dispersion (tail) correction.

Port of ``pmarlo_tpu/md/dispersion.py`` (host numpy; the per-atom
parameters come off the system's device first). OpenMM's
``NonbondedForce.setUseDispersionCorrection(True)`` adds the mean-field
energy of the truncated LJ tail, assuming uniform density (g(r) = 1)
beyond the cutoff:

  E_tail = (2 pi / V) * sum_{i,j} 4 eps_ij [ sig_ij^12 / (9 rc^9)
           - sig_ij^6 / (3 rc^3) ]

over all N^2 ordered pairs (the O(N) excluded pairs are a vanishing
fraction; OpenMM makes the same approximation), computed over LJ classes:
amber systems have tens of distinct (sigma, eps) combinations. The
correction carries no position dependence: forces are untouched; its 1/V
dependence matters under a barostat.
"""

from __future__ import annotations

import numpy as np

from .cells import _np


def dispersion_coefficient(system) -> float:
    """C such that ``E_tail(V) = 2 pi C / V`` (kJ/mol * nm^3).

    C = sum_{i,j} 4 eps_ij [ sig_ij^12/(9 rc^9) - sig_ij^6/(3 rc^3) ]
    over all N^2 ordered (i, j) with Lorentz-Berthelot combination,
    computed via LJ-class pair sums."""
    rc = float(system.cutoff)
    sig = _np(system.lj_sigma).astype(np.float64)
    eps = _np(system.lj_eps).astype(np.float64)
    pairs, counts = np.unique(
        np.stack([sig, eps], axis=1), axis=0, return_counts=True
    )
    s_a = pairs[:, 0][:, None]
    s_b = pairs[:, 0][None, :]
    e_a = pairs[:, 1][:, None]
    e_b = pairs[:, 1][None, :]
    n_ab = counts[:, None].astype(np.float64) * counts[None, :]
    sig_ab = 0.5 * (s_a + s_b)
    eps_ab = np.sqrt(np.maximum(e_a * e_b, 0.0))
    integral = 4.0 * eps_ab * (
        sig_ab**12 / (9.0 * rc**9) - sig_ab**6 / (3.0 * rc**3)
    )
    r_sw = getattr(system, "switch_distance", None)
    if r_sw is not None:
        # with the switching function active (md/forces.py lj_switch)
        # the potential also misses (1 - S(r)) * E_LJ(r) on [r_sw, rc];
        # OpenMM's tail correction integrates this region numerically —
        # 64-point Gauss-Legendre is overkill-exact for a smooth
        # polynomial-in-1/r integrand
        r_sw = float(r_sw)
        xg, wg = np.polynomial.legendre.leggauss(64)
        r = 0.5 * (rc - r_sw) * xg + 0.5 * (rc + r_sw)      # (G,)
        w = 0.5 * (rc - r_sw) * wg
        x = (r - r_sw) / (rc - r_sw)
        s_of_r = 1.0 + x**3 * (-10.0 + x * (15.0 - 6.0 * x))
        sr6 = (sig_ab[..., None] / r) ** 6                   # (K, K, G)
        e_r = 4.0 * eps_ab[..., None] * (sr6 * sr6 - sr6)
        integral = integral + np.sum(
            (1.0 - s_of_r) * e_r * r * r * w, axis=-1
        )
    return float(np.sum(n_ab * integral))


__all__ = ["dispersion_coefficient"]
