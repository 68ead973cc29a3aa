"""GBn2 (GB-neck2, igb=8) implicit-solvent parameters and neck tables.

The reference runs MD with ``amber14 + implicit/gbn2.xml``
(src/pmarlo/simulation/__init__.py:64-71). GBn2 (Nguyen, Roe & Simmerling
2013) extends the HCT/OBC pairwise-descreening Born-radius model with:

1. per-ELEMENT alpha/beta/gamma rescaling coefficients (OBC uses one
   global triple),
2. per-element optimized screening factors,
3. a larger dielectric offset (0.0195141 nm vs OBC's 0.009 nm),
4. a "neck" correction: the solvent-excluded toroidal region between two
   nearby atoms (where a water probe cannot fit) contributes to the
   descreening integral. Following Mongan, Svrcek-Seiler & Onufriev 2007,
   the neck integral is approximated as

       I_neck(d) ~= m0 / (1 + 100 (d - d0)^2 + 0.3e6 (d - d0)^6)

   with m0/d0 the value/position of the numerically computed maximum per
   radius pair.

The published d0/m0 tables are not redistributable data we have access to
in this environment, so this module computes them FROM THE DEFINITION: the
neck region of two spheres is resolved analytically (axisymmetric
probe-accessibility test) and the integral (1/4pi) \\int_neck x^-4 dV is
evaluated on a cylindrical grid. Tables are cached on disk keyed by the
generator version. This reproduces the construction, not the exact
published fit; deviations from Amber's tables are expected at the few-%
level and are documented in ROUND2_NOTES.

Host copy of ``pmarlo_tpu/md/gbn2.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# --- GBn2 (igb=8) parameter set (Nguyen et al. 2013 defaults) ---------------

#: dielectric offset (nm)
GBN2_OFFSET = 0.0195141

#: neck integral global scale
GBN2_NECK_SCALE = 0.826836

#: per-element (alpha, beta, gamma) for the tanh rescaling
GBN2_ALPHA_BETA_GAMMA: Dict[str, Tuple[float, float, float]] = {
    "H": (0.788440, 0.798699, 0.437334),
    "C": (0.733756, 0.506378, 0.205844),
    "N": (0.503364, 0.316828, 0.192915),
    "O": (0.867814, 0.876635, 0.387882),
    "S": (0.867814, 0.876635, 0.387882),
}
GBN2_ABG_DEFAULT = (1.0, 0.8, 4.851)  # OBC-like fallback for exotic elements

#: per-element screening factors (replace the HCT ones under GBn2)
GBN2_SCREEN: Dict[str, float] = {
    "H": 1.425952,
    "C": 1.058554,
    "N": 0.733599,
    "O": 1.061039,
    "S": -0.703469,
    "P": 0.500000,
}
GBN2_SCREEN_DEFAULT = 0.5

#: water probe radius (nm)
PROBE_RADIUS = 0.14

#: neck interaction cutoff: no neck beyond rho_i + rho_j + 2 rw; the table
#: covers intrinsic radii 0.10-0.20 nm (the mbondi2/3 range)
TABLE_RADII = np.round(np.arange(0.10, 0.2001, 0.005), 5)  # 21 values

_TABLE_VERSION = 2


def _neck_accessible(z: np.ndarray, s: np.ndarray, d: float,
                     rho1: float, rho2: float, rw: float) -> np.ndarray:
    """Probe accessibility of axisymmetric points (z, s).

    Atom 1 at origin, atom 2 at (d, 0). A point p is solvent-ACCESSIBLE if
    a probe center c exists with |c - p| <= rw, |c - a1| >= rho1 + rw and
    |c - a2| >= rho2 + rw. By axisymmetry the optimal c lies in the (z, s)
    half-plane; candidates are p itself, the projections of p onto each
    enlarged sphere, and the circle where the enlarged spheres intersect.
    """
    R1, R2 = rho1 + rw, rho2 + rw
    p = np.stack([z, s], axis=-1)
    a1 = np.array([0.0, 0.0])
    a2 = np.array([d, 0.0])

    d1 = np.linalg.norm(p - a1, axis=-1)
    d2 = np.linalg.norm(p - a2, axis=-1)
    outside_both = (d1 >= R1) & (d2 >= R2)

    best = np.full(z.shape, np.inf)

    # candidate: projection onto enlarged sphere 1, valid if outside ball 2
    with np.errstate(invalid="ignore", divide="ignore"):
        c1 = a1 + (p - a1) * (R1 / np.maximum(d1, 1e-12))[..., None]
        ok1 = np.linalg.norm(c1 - a2, axis=-1) >= R2 - 1e-12
        dist1 = np.where(ok1, np.linalg.norm(c1 - p, axis=-1), np.inf)
        best = np.minimum(best, dist1)
        # projection onto enlarged sphere 2, valid if outside ball 1
        c2 = a2 + (p - a2) * (R2 / np.maximum(d2, 1e-12))[..., None]
        ok2 = np.linalg.norm(c2 - a1, axis=-1) >= R1 - 1e-12
        dist2 = np.where(ok2, np.linalg.norm(c2 - p, axis=-1), np.inf)
        best = np.minimum(best, dist2)

    # candidate: the intersection circle of the two enlarged spheres
    if d < R1 + R2 and d > abs(R1 - R2):
        zc = (d * d + R1 * R1 - R2 * R2) / (2.0 * d)
        sc2 = R1 * R1 - zc * zc
        if sc2 > 0:
            cc = np.array([zc, np.sqrt(sc2)])
            best = np.minimum(best, np.linalg.norm(p - cc, axis=-1))

    return outside_both | (best <= rw + 1e-12)


def neck_integral(d: float, rho1: float, rho2: float,
                  rw: float = PROBE_RADIUS, n_grid: int = 220) -> float:
    """(1/4pi) \\int_neck x^-4 dV, x measured from atom 1 (units 1/nm).

    The neck region: solvent-INACCESSIBLE points outside both atom
    spheres. Evaluated on a cylindrical (z, s) grid spanning the region
    where a neck can exist.
    """
    if d >= rho1 + rho2 + 2.0 * rw:
        return 0.0
    z_lo, z_hi = -rho1 - 2 * rw, d + rho2 + 2 * rw
    s_hi = max(rho1, rho2) + 2 * rw
    z = np.linspace(z_lo, z_hi, n_grid)
    s = np.linspace(1e-6, s_hi, n_grid)
    dz = z[1] - z[0]
    ds = s[1] - s[0]
    Z, S = np.meshgrid(z, s, indexing="ij")
    r1sq = Z * Z + S * S
    r2sq = (Z - d) ** 2 + S * S
    outside_atoms = (r1sq > rho1 * rho1) & (r2sq > rho2 * rho2)
    accessible = _neck_accessible(Z, S, d, rho1, rho2, rw)
    neck = outside_atoms & ~accessible
    if not neck.any():
        return 0.0
    integrand = np.where(neck, S / np.maximum(r1sq, 1e-12) ** 2, 0.0)
    # dV = 2 pi s ds dz; I = (1/4pi) * integral of x^-4 dV
    return float(0.5 * np.sum(integrand) * dz * ds)


def _fit_neck_maximum(rho1: float, rho2: float,
                      rw: float = PROBE_RADIUS) -> Tuple[float, float]:
    """(d0, m0): position and value of the neck integral maximum."""
    d_contact = rho1 + rho2
    d_end = rho1 + rho2 + 2.0 * rw
    ds = np.linspace(d_contact, d_end - 1e-4, 25)
    vals = np.array([neck_integral(d, rho1, rho2, rw) for d in ds])
    k = int(np.argmax(vals))
    # parabolic refinement around the coarse maximum
    lo = max(k - 1, 0)
    hi = min(k + 1, len(ds) - 1)
    d_fine = np.linspace(ds[lo], ds[hi], 15)
    v_fine = np.array([neck_integral(d, rho1, rho2, rw) for d in d_fine])
    j = int(np.argmax(v_fine))
    return float(d_fine[j]), float(v_fine[j])


def _cache_path() -> Path:
    base = os.environ.get("PMARLO_CACHE_DIR") or os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    key = hashlib.sha256(
        f"v{_TABLE_VERSION}:rw={PROBE_RADIUS}:{TABLE_RADII.tobytes().hex()}".encode()
    ).hexdigest()[:12]
    return Path(base) / "pmarlo_tpu" / f"gbn2_neck_{key}.npz"


def neck_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(radii, D0, M0): d0/m0 tables over the TABLE_RADII x TABLE_RADII
    grid (nm and 1/nm).

    Resolution order: versioned package data (pmarlo_tpu/data/
    gbn2_neck_tables.npz, regenerated by this module and pinned by
    tests/unit/test_gbn2.py::test_shipped_neck_tables_match_generator) ->
    user cache -> compute (~2.5 min) + cache.
    """
    shipped = Path(__file__).resolve().parents[1] / "data" / "gbn2_neck_tables.npz"
    if shipped.exists():
        data = np.load(shipped)
        if (data["radii"].shape == TABLE_RADII.shape
                and np.allclose(data["radii"], TABLE_RADII)):
            return data["radii"], data["d0"], data["m0"]
    path = _cache_path()
    if path.exists():
        data = np.load(path)
        return data["radii"], data["d0"], data["m0"]
    n = len(TABLE_RADII)
    D0 = np.zeros((n, n))
    M0 = np.zeros((n, n))
    for i, r1 in enumerate(TABLE_RADII):
        for j in range(i, n):
            r2 = TABLE_RADII[j]
            d0, m0 = _fit_neck_maximum(float(r1), float(r2))
            D0[i, j] = D0[j, i] = d0
            M0[i, j] = M0[j, i] = m0
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, radii=TABLE_RADII, d0=D0, m0=M0)
    return TABLE_RADII, D0, M0


def lookup_neck(rho_i: np.ndarray, rho_j: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear d0/m0 lookup for arrays of intrinsic radii (nm)."""
    radii, D0, M0 = neck_tables()
    lo, hi, step = radii[0], radii[-1], radii[1] - radii[0]

    def interp1(r):
        t = np.clip((r - lo) / step, 0.0, len(radii) - 1.000001)
        k = np.floor(t).astype(int)
        f = t - k
        return k, f

    ki, fi = interp1(np.asarray(rho_i))
    kj, fj = interp1(np.asarray(rho_j))

    def bilerp(T):
        return ((1 - fi) * (1 - fj) * T[ki, kj]
                + fi * (1 - fj) * T[ki + 1, kj]
                + (1 - fi) * fj * T[ki, kj + 1]
                + fi * fj * T[ki + 1, kj + 1])

    return bilerp(D0), bilerp(M0)


def neck_value_and_derivative(r, d0, m0):
    """I_neck(r) and dI_neck/dr for the fitted functional form."""
    u = r - d0
    denom = 1.0 + 100.0 * u * u + 0.3e6 * u ** 6
    val = m0 / denom
    dval = -m0 * (200.0 * u + 1.8e6 * u ** 5) / (denom * denom)
    return val, dval


__all__ = [
    "GBN2_OFFSET", "GBN2_NECK_SCALE", "GBN2_ALPHA_BETA_GAMMA",
    "GBN2_ABG_DEFAULT", "GBN2_SCREEN", "GBN2_SCREEN_DEFAULT",
    "PROBE_RADIUS", "neck_integral", "neck_tables", "lookup_neck",
    "neck_value_and_derivative",
]
