"""Free-energy surfaces and PMFs with adaptive gridding and smart smoothing.

Reference: src/pmarlo/markov_state_model/free_energy.py —
FESResult/PMFResult versioned dataclasses (:42,:26),
free_energy_from_density (:257), generate_1d_pmf (:363), generate_2d_fes
(:417 — adaptive grid via q1-q99 crop + Freedman-Diaconis/sqrt-N bin rule,
iterative bin reduction until >=60% finite bins :593-636, periodic wrapping
:648-665, Dirichlet-uncertainty-gated smoothing never/auto/always, sparse
guardrail >50% :846).

Host copy of ``pmarlo_tpu/msm/free_energy.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..constants import (
    FES_DEFAULT_BINS,
    FES_MIN_FINITE_FRACTION,
    FES_SPARSE_WARN_FRACTION,
)
from ..utils.thermodynamics import kT_kJ_per_mol
from .fes_smoothing import ess_adaptive_sigma, fes_uncertainty, sigma_bank_smooth

logger = logging.getLogger("pmarlo_tpu")

_SCHEMA_VERSION = 2


@dataclasses.dataclass
class PMFResult:
    """(reference free_energy.py:26)."""

    free_energy: np.ndarray
    edges: np.ndarray
    counts: np.ndarray
    temperature_K: float
    periodic: bool = False
    version: int = _SCHEMA_VERSION

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "free_energy": self.free_energy.tolist(),
            "edges": self.edges.tolist(),
            "counts": self.counts.tolist(),
            "temperature_K": self.temperature_K,
            "periodic": self.periodic,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "PMFResult":
        if d.get("version", 1) > _SCHEMA_VERSION:
            raise ValueError(f"unsupported PMFResult version {d.get('version')}")
        return cls(
            free_energy=np.asarray(d["free_energy"]),
            edges=np.asarray(d["edges"]),
            counts=np.asarray(d["counts"]),
            temperature_K=float(d["temperature_K"]),
            periodic=bool(d.get("periodic", False)),
            version=_SCHEMA_VERSION,
        )


@dataclasses.dataclass
class FESResult:
    """(reference free_energy.py:42)."""

    free_energy: np.ndarray       # (bx, by), kJ/mol, NaN = unsampled
    xedges: np.ndarray
    yedges: np.ndarray
    counts: np.ndarray
    temperature_K: float
    cv_names: Tuple[str, str] = ("CV1", "CV2")
    periodic: Tuple[bool, bool] = (False, False)
    smoothing_mode: str = "auto"
    finite_fraction: float = 1.0
    sparse_warning: Optional[str] = None
    uncertainty: Optional[np.ndarray] = None
    version: int = _SCHEMA_VERSION

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "free_energy": np.where(
                np.isfinite(self.free_energy), self.free_energy, None
            ).tolist(),
            "xedges": self.xedges.tolist(),
            "yedges": self.yedges.tolist(),
            "counts": self.counts.tolist(),
            "temperature_K": self.temperature_K,
            "cv_names": list(self.cv_names),
            "periodic": list(self.periodic),
            "smoothing_mode": self.smoothing_mode,
            "finite_fraction": self.finite_fraction,
            "sparse_warning": self.sparse_warning,
            # keep the per-bin Dirichlet uncertainty: the JSON artifact
            # must round-trip the same fields the pickle path preserves
            "uncertainty": (
                np.where(np.isfinite(self.uncertainty),
                         self.uncertainty, None).tolist()
                if self.uncertainty is not None else None
            ),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FESResult":
        if d.get("version", 1) > _SCHEMA_VERSION:
            raise ValueError(f"unsupported FESResult version {d.get('version')}")
        fe = np.asarray(
            [[np.nan if v is None else v for v in row] for row in d["free_energy"]],
            dtype=np.float64,
        )
        return cls(
            free_energy=fe,
            xedges=np.asarray(d["xedges"]),
            yedges=np.asarray(d["yedges"]),
            counts=np.asarray(d["counts"]),
            temperature_K=float(d["temperature_K"]),
            cv_names=tuple(d.get("cv_names", ("CV1", "CV2"))),
            periodic=tuple(d.get("periodic", (False, False))),
            smoothing_mode=d.get("smoothing_mode", "auto"),
            finite_fraction=float(d.get("finite_fraction", 1.0)),
            sparse_warning=d.get("sparse_warning"),
            uncertainty=(
                np.asarray(
                    [[np.nan if v is None else v for v in row]
                     for row in d["uncertainty"]], dtype=np.float64,
                )
                if d.get("uncertainty") is not None else None
            ),
        )

    def save(self, path: "str | Path") -> Path:
        path = Path(path)
        if path.suffix == ".json":
            path.write_text(json.dumps(self.to_dict()))
        else:
            path.write_bytes(pickle.dumps(self))
        return path

    @classmethod
    def load(cls, path: "str | Path") -> "FESResult":
        path = Path(path)
        if path.suffix == ".json":
            return cls.from_dict(json.loads(path.read_text()))
        obj = pickle.loads(path.read_bytes())
        if not isinstance(obj, cls):
            raise TypeError(f"{path} did not contain a FESResult")
        return obj


def free_energy_from_density(
    density: np.ndarray,
    temperature_K: float,
    mask_empty: bool = True,
    inpaint: bool = False,
) -> np.ndarray:
    """F = -kT ln p with empty-bin masking / optional neighbor inpainting
    (reference free_energy.py:257)."""
    kT = kT_kJ_per_mol(temperature_K)
    p = np.asarray(density, dtype=np.float64)
    total = p.sum()
    if total <= 0:
        raise ValueError("density has zero mass")
    p = p / total
    with np.errstate(divide="ignore"):
        F = -kT * np.log(p)
    if mask_empty:
        F = np.where(p > 0, F, np.nan)
        if inpaint:
            F = _inpaint_nans(F)
    finite = np.isfinite(F)
    if finite.any():
        F = F - np.nanmin(F[finite])
    return F


def _inpaint_nans(F: np.ndarray, n_iter: int = 50) -> np.ndarray:
    out = F.copy()
    for _ in range(n_iter):
        nans = ~np.isfinite(out)
        if not nans.any():
            break
        padded = np.pad(out, 1, mode="edge")
        neigh = np.stack([
            padded[:-2, 1:-1], padded[2:, 1:-1], padded[1:-1, :-2], padded[1:-1, 2:]
        ])
        with np.errstate(invalid="ignore"):
            fill = np.nanmean(neigh, axis=0)
        out = np.where(nans & np.isfinite(fill), fill, out)
    return out


def _adaptive_edges(
    x: np.ndarray,
    bins: Optional[int],
    periodic: bool,
    period: Tuple[float, float] = (-np.pi, np.pi),
) -> np.ndarray:
    """Adaptive 1D grid: q1-q99 crop + FD/sqrt-N bin rule for aperiodic CVs,
    fixed periodic box for periodic ones (reference free_energy.py:593-665)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if periodic:
        nb = bins or FES_DEFAULT_BINS
        return np.linspace(period[0], period[1], nb + 1)
    lo, hi = np.quantile(x, [0.01, 0.99])
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        lo, hi = float(np.min(x)), float(np.max(x))
        if hi <= lo:
            hi = lo + 1e-6
    if bins is None:
        iqr = np.subtract(*np.quantile(x, [0.75, 0.25]))
        if iqr > 0:
            width = 2.0 * iqr / np.cbrt(n)           # Freedman-Diaconis
            nb = int(np.clip(np.ceil((hi - lo) / width), 8, 128))
        else:
            nb = int(np.clip(np.sqrt(n), 8, 128))    # sqrt-N fallback
    else:
        nb = int(bins)
    return np.linspace(lo, hi, nb + 1)


def _wrap_periodic(x: np.ndarray, period: Tuple[float, float]) -> np.ndarray:
    lo, hi = period
    width = hi - lo
    return (np.asarray(x) - lo) % width + lo


def generate_2d_fes(
    cv1: np.ndarray,
    cv2: np.ndarray,
    *,
    temperature_K: float = 300.0,
    bins: "int | Tuple[int, int] | None" = None,
    weights: Optional[np.ndarray] = None,
    periodic: Tuple[bool, bool] = (False, False),
    period: Tuple[float, float] = (-np.pi, np.pi),
    smoothing_mode: str = "auto",
    cv_names: Tuple[str, str] = ("CV1", "CV2"),
    min_finite_fraction: float = FES_MIN_FINITE_FRACTION,
) -> FESResult:
    """2D FES with adaptive gridding and uncertainty-gated smoothing
    (reference free_energy.py:417 generate_2d_fes).

    smoothing_mode: "never" | "auto" | "always". In "auto" smoothing is
    applied only where the Dirichlet-posterior uncertainty warrants it
    (sigma-bank blend); "always" applies the full blend; "never" leaves
    raw -kT ln p.
    """
    if smoothing_mode not in ("never", "auto", "always"):
        raise ValueError(f"smoothing_mode must be never|auto|always, got {smoothing_mode!r}")
    cv1 = np.asarray(cv1, dtype=np.float64).ravel()
    cv2 = np.asarray(cv2, dtype=np.float64).ravel()
    if cv1.shape != cv2.shape:
        raise ValueError(f"cv shapes differ: {cv1.shape} vs {cv2.shape}")
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float64).ravel()
        if weights.shape != cv1.shape:
            raise ValueError("weights shape mismatch")

    if isinstance(bins, tuple):
        bx, by = bins
    else:
        bx = by = bins
    if periodic[0]:
        cv1 = _wrap_periodic(cv1, period)
    if periodic[1]:
        cv2 = _wrap_periodic(cv2, period)

    # iterative bin reduction until the finite fraction is acceptable
    # (reference free_energy.py:593-636)
    for attempt in range(6):
        xe = _adaptive_edges(cv1, bx, periodic[0], period)
        ye = _adaptive_edges(cv2, by, periodic[1], period)
        H, xe, ye = np.histogram2d(cv1, cv2, bins=[xe, ye], weights=weights)
        finite_fraction = float((H > 0).mean())
        if finite_fraction >= min_finite_fraction:
            break
        bx = max((len(xe) - 1) * 2 // 3, 8)
        by = max((len(ye) - 1) * 2 // 3, 8)
        if bx <= 8 and by <= 8:
            xe = _adaptive_edges(cv1, bx, periodic[0], period)
            ye = _adaptive_edges(cv2, by, periodic[1], period)
            H, xe, ye = np.histogram2d(cv1, cv2, bins=[xe, ye], weights=weights)
            finite_fraction = float((H > 0).mean())
            break

    kT = kT_kJ_per_mol(temperature_K)
    uncertainty = fes_uncertainty(H, kT)
    H_smooth = H
    if smoothing_mode != "never":
        sigma = ess_adaptive_sigma(weights, cv1.size)
        sigmas = (0.0, sigma, 2 * sigma, 4 * sigma)
        if smoothing_mode == "always":
            sigmas = (sigma, 2 * sigma, 4 * sigma, 8 * sigma)
        H_smooth = sigma_bank_smooth(H, uncertainty, kT, sigmas, periodic)

    F = free_energy_from_density(
        np.maximum(H_smooth, 0.0), temperature_K, mask_empty=True
    )

    sparse_warning = None
    empty_fraction = float((H == 0).mean())
    if empty_fraction > FES_SPARSE_WARN_FRACTION:
        sparse_warning = (
            f"{empty_fraction:.0%} of FES bins are empty — surface is sparse; "
            "consider more sampling or fewer bins"
        )
        logger.warning(sparse_warning)

    return FESResult(
        free_energy=F,
        xedges=xe,
        yedges=ye,
        counts=H,
        temperature_K=temperature_K,
        cv_names=cv_names,
        periodic=periodic,
        smoothing_mode=smoothing_mode,
        finite_fraction=finite_fraction,
        sparse_warning=sparse_warning,
        uncertainty=uncertainty,
    )


def generate_1d_pmf(
    cv: np.ndarray,
    *,
    temperature_K: float = 300.0,
    bins: Optional[int] = None,
    weights: Optional[np.ndarray] = None,
    periodic: bool = False,
    period: Tuple[float, float] = (-np.pi, np.pi),
) -> PMFResult:
    """1D PMF (reference free_energy.py:363)."""
    cv = np.asarray(cv, dtype=np.float64).ravel()
    if periodic:
        cv = _wrap_periodic(cv, period)
    edges = _adaptive_edges(cv, bins, periodic, period)
    H, edges = np.histogram(cv, bins=edges, weights=weights)
    F = free_energy_from_density(np.maximum(H, 0), temperature_K)
    return PMFResult(
        free_energy=F, edges=edges, counts=H,
        temperature_K=temperature_K, periodic=periodic,
    )


def periodic_kde_2d(
    x: np.ndarray,
    y: np.ndarray,
    bins: int = 60,
    bandwidth: float = 0.25,
    period: Tuple[float, float] = (-np.pi, np.pi),
    weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Toroidal KDE via histogram + wrapped Gaussian blur
    (reference free_energy.py:321)."""
    from .fes_smoothing import gaussian_smooth_2d

    lo, hi = period
    xe = np.linspace(lo, hi, bins + 1)
    H, xe, ye = np.histogram2d(
        _wrap_periodic(x, period), _wrap_periodic(y, period),
        bins=[xe, xe], weights=weights,
    )
    bin_width = (hi - lo) / bins
    sigma_bins = bandwidth / bin_width
    return gaussian_smooth_2d(H, sigma_bins, periodic=(True, True)), xe, ye


__all__ = [
    "FESResult",
    "PMFResult",
    "free_energy_from_density",
    "generate_2d_fes",
    "generate_1d_pmf",
    "periodic_kde_2d",
]
