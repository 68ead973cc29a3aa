"""The GBn2 neck integral and its d0 / m0 tables, worked out from the
definition (Mongan, Svrcek-Seiler & Onufriev 2007, J. Chem. Theory Comput.
3, 156), not read from any table.

Atom 1 (offset radius ``rho1``) at the origin, atom 2 (``rho2``) at
distance ``d`` on the axis, a water probe of radius ``rw``. The neck is
the space outside both atoms that no probe overlapping neither atom
can reach: in the half-plane through the axis, the triangle of the two
centres and the probe's centre ``C`` where it touches both, less the two
atoms and the probe. Its integral, as atom 1's Born integral counts it,

    I(d) = (1 / 4 pi) \\int_neck |x|^-4 dV     (x from atom 1's centre)
         = (1 / 2) \\int_0^theta_C sin(theta) \\int_neck(theta) r^-2 dr dtheta,

is exact along each ray from atom 1 (the neck is an interval of the ray
less two sub-intervals, the atom 2 and probe disks) and Gauss-Legendre in
the angle. ``m0`` is its largest value over d in [rho1 + rho2, rho1 +
rho2 + 2 rw] and ``d0`` where it lies. The table is not symmetric: entry
[i, j] is the neck that atom i's Born integral takes from a partner j, so
it is measured from atom i (the published GBn2 tables, Amber's and
OpenMM's, are indexed the same way).

Plain NumPy, float64; a table entry takes about 20 milliseconds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .params import PROBE_RADIUS

#: the offset radii of the table's nodes (nm): 0.10 to 0.20 in steps of 0.005
TABLE_RADII = 0.10 + 0.005 * np.arange(21)

_GL_X, _GL_W = np.polynomial.legendre.leggauss(8)


def _r2_integral(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """\\int_a^b r^-2 dr, nought where b <= a."""
    ok = b > a
    return np.where(ok, 1.0 / np.where(ok, a, 1.0) - 1.0 / np.where(ok, b, 1.0), 0.0)


def neck_integral(d, rho1: float, rho2: float, rw: float = PROBE_RADIUS,
                  panels: int = 64) -> np.ndarray:
    """I(d) (1/nm) for an array of distances ``d`` (nm)."""
    d = np.atleast_1d(np.asarray(d, np.float64))[:, None]
    R1, R2 = rho1 + rw, rho2 + rw
    inside = d < R1 + R2
    d = np.where(inside, d, 0.5 * (R1 + R2))                   # any geometry; zeroed below
    zc = (d * d + R1 * R1 - R2 * R2) / (2.0 * d)
    sc = np.sqrt(np.maximum(R1 * R1 - zc * zc, 0.0))
    theta_c = np.arctan2(sc, zc)
    # the angles at which a ray grazes atom 2 or the probe split (0, theta_C)
    # into pieces on which the integrand is smooth; Gauss-Legendre panels on each
    cuts = np.concatenate([
        np.zeros_like(d), np.arcsin(np.minimum(rho2 / d, 1.0)),
        theta_c - np.arcsin(min(rw / R1, 1.0)), theta_c + np.arcsin(min(rw / R1, 1.0)),
        theta_c], axis=1)
    cuts = np.sort(np.clip(cuts, 0.0, theta_c), axis=1)               # (n_d, 5)
    u = (np.arange(panels)[:, None] + 0.5 * (_GL_X[None, :] + 1.0)).ravel() / panels
    wu = np.tile(_GL_W, panels) * 0.5 / panels
    width = np.diff(cuts, axis=1)                                     # (n_d, 4)
    theta = (cuts[:, :-1, None] + width[:, :, None] * u[None, None, :]).reshape(len(d), -1)
    w = (width[:, :, None] * wu[None, None, :]).reshape(len(d), -1)
    c, s = np.cos(theta), np.sin(theta)
    # the ray leaves the triangle through its side from atom 2 to C
    r_out = d * sc / (c * sc - s * (zc - d))

    def disk(cx, cy, rad):
        p = c * cx + s * cy
        disc = rad * rad - (cx * cx + cy * cy) + p * p
        sq = np.sqrt(np.maximum(disc, 0.0))
        return np.where(disc > 0, p - sq, np.inf), np.where(disc > 0, p + sq, -np.inf)

    lo2, hi2 = disk(d, 0.0, rho2)
    loc, hic = disk(zc, sc, rw)
    a, b = np.full_like(r_out, rho1), r_out
    per_ray = (_r2_integral(a, b)
               - _r2_integral(np.maximum(a, lo2), np.minimum(b, hi2))
               - _r2_integral(np.maximum(a, loc), np.minimum(b, hic))
               + _r2_integral(np.maximum(np.maximum(a, lo2), loc),
                              np.minimum(np.minimum(b, hi2), hic)))
    out = 0.5 * (w * s * per_ray).sum(-1)
    return np.where(inside[:, 0], out, 0.0)


def neck_maximum(rho1: float, rho2: float, rw: float = PROBE_RADIUS) -> Tuple[float, float]:
    """(d0, m0): where the neck integral of atom 1 against atom 2 is largest,
    and its value there (nm, 1/nm): the best of 57 distances, then a golden
    section search between its neighbours to 1e-9 nm."""
    lo, hi = rho1 + rho2, rho1 + rho2 + 2.0 * rw
    grid = np.linspace(lo, hi, 57)
    k = int(np.argmax(neck_integral(grid, rho1, rho2, rw, panels=16)))
    a, b = grid[max(k - 1, 0)], grid[min(k + 1, len(grid) - 1)]
    f = lambda x: float(neck_integral(x, rho1, rho2, rw)[0])  # noqa: E731
    g = 0.5 * (np.sqrt(5.0) - 1.0)
    x1, x2 = b - g * (b - a), a + g * (b - a)
    f1, f2 = f(x1), f(x2)
    while b - a > 1e-9:
        if f1 > f2:
            b, x2, f2 = x2, x1, f1
            x1 = b - g * (b - a)
            f1 = f(x1)
        else:
            a, x1, f1 = x1, x2, f2
            x2 = a + g * (b - a)
            f2 = f(x2)
    d0 = 0.5 * (a + b)
    return d0, f(d0)


def neck_tables(nodes) -> Tuple[np.ndarray, np.ndarray]:
    """d0 and m0 at the table nodes ``TABLE_RADII[nodes]`` (entry [a, b]:
    atom ``nodes[a]`` against partner ``nodes[b]``)."""
    D0 = np.zeros((len(nodes), len(nodes)))
    M0 = np.zeros_like(D0)
    for a, i in enumerate(nodes):
        for b, j in enumerate(nodes):
            D0[a, b], M0[a, b] = neck_maximum(float(TABLE_RADII[i]), float(TABLE_RADII[j]))
    return D0, M0


def lookup_neck(rho: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, N) d0 and m0 for atoms of offset radii ``rho`` (nm), entry [i, j]
    the neck of atom i against partner j: bilinear between the table's
    nodes (clamped to the table), each node worked out above, only the
    nodes these radii need."""
    rho = np.asarray(rho, np.float64)
    t = np.clip((rho - TABLE_RADII[0]) / 0.005, 0.0, len(TABLE_RADII) - 1.000001)
    k = np.floor(t).astype(int)
    f = t - k
    nodes = np.unique(np.concatenate([k, k + 1]))
    D0, M0 = neck_tables(nodes)
    at = {int(n): m for m, n in enumerate(nodes)}
    lo = np.asarray([at[int(x)] for x in k])
    hi = np.asarray([at[int(x) + 1] for x in k])

    def bilinear(T):
        fi, fj = f[:, None], f[None, :]
        return ((1 - fi) * (1 - fj) * T[lo[:, None], lo[None, :]]
                + fi * (1 - fj) * T[hi[:, None], lo[None, :]]
                + (1 - fi) * fj * T[lo[:, None], hi[None, :]]
                + fi * fj * T[hi[:, None], hi[None, :]])

    return bilinear(D0), bilinear(M0)


__all__ = ["neck_integral", "neck_maximum", "neck_tables", "lookup_neck", "TABLE_RADII"]
