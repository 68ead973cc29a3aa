"""Ramachandran analysis: phi/psi extraction, periodic histograms, FES.

Port of ``pmarlo_tpu/features/ramachandran.py``: the dihedrals are
``features.builtins.compute_dihedrals`` on the frames' device; the
histograms and the wrapped smoothing are numpy, as in JAX. Angles are
reported in degrees; histograms wrap periodically.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from ..constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from .base import TopologyInfo
from .builtins import compute_dihedrals, phi_psi_indices


def compute_ramachandran(
    traj,
    top: TopologyInfo,
    residue_ids: Optional[Sequence[int]] = None,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """(phi_deg, psi_deg, residue_labels), each (T, R). A tensor ``traj``
    is read on its own device, host frames on ``device`` (``None``:
    ``_device.default_device()``)."""
    phi_q, psi_q, labels = phi_psi_indices(top.atom_names, top.residue_ids, top.chain_ids)
    if residue_ids is not None:
        keep = [i for i, r in enumerate(labels) if r in set(residue_ids)]
        phi_q, psi_q = phi_q[keep], psi_q[keep]
        labels = [labels[i] for i in keep]
    if phi_q.shape[0] == 0:
        raise ValueError("no phi/psi dihedrals available for selection")
    if not isinstance(traj, torch.Tensor):
        dev = torch.device(device) if device is not None else default_device()
        traj = torch.as_tensor(np.asarray(traj), dtype=torch.float32, device=dev)
    phi = np.degrees(compute_dihedrals(traj, phi_q).cpu().numpy())
    psi = np.degrees(compute_dihedrals(traj, psi_q).cpu().numpy())
    return phi, psi, labels


def periodic_hist2d(
    x: np.ndarray,
    y: np.ndarray,
    bins: int = 60,
    range_deg: Tuple[float, float] = (-180.0, 180.0),
    weights: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2D histogram on the torus: samples wrap into the periodic box
    (reference features/__init__.py:44-50)."""
    lo, hi = range_deg
    width = hi - lo
    xw = (np.asarray(x).ravel() - lo) % width + lo
    yw = (np.asarray(y).ravel() - lo) % width + lo
    H, xe, ye = np.histogram2d(
        xw, yw, bins=bins, range=[[lo, hi], [lo, hi]], weights=weights
    )
    return H, xe, ye


def compute_ramachandran_fes(
    phi_deg: np.ndarray,
    psi_deg: np.ndarray,
    *,
    temperature_K: float = 300.0,
    bins: int = 60,
    weights: Optional[np.ndarray] = None,
    smooth_sigma: float = 1.0,
) -> dict:
    """Free-energy surface -kT ln p over the (phi, psi) torus.

    Smoothing is a periodic (wrapped) Gaussian filter — the reference's
    wrapped-KDE behavior (ramachandran.py compute_ramachandran_fes).
    """
    H, xe, ye = periodic_hist2d(phi_deg, psi_deg, bins=bins, weights=weights)
    if smooth_sigma > 0:
        H = _periodic_gaussian_smooth(H, smooth_sigma)
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temperature_K
    p = H / max(H.sum(), 1e-12)
    with np.errstate(divide="ignore"):
        F = -kT * np.log(p)
    F -= np.nanmin(F[np.isfinite(F)]) if np.isfinite(F).any() else 0.0
    return {
        "free_energy": F,
        "histogram": H,
        "xedges": xe,
        "yedges": ye,
        "temperature_K": temperature_K,
    }


def _periodic_gaussian_smooth(H: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with wraparound boundary (torus)."""
    radius = max(int(np.ceil(3 * sigma)), 1)
    x = np.arange(-radius, radius + 1)
    kernel = np.exp(-0.5 * (x / sigma) ** 2)
    kernel /= kernel.sum()
    out = H
    for axis in (0, 1):
        padded = np.take(
            out,
            np.arange(-radius, out.shape[axis] + radius) % out.shape[axis],
            axis=axis,
        )
        out = np.apply_along_axis(
            lambda v: np.convolve(v, kernel, mode="valid"), axis, padded
        )
    return out


__all__ = ["compute_ramachandran", "periodic_hist2d", "compute_ramachandran_fes"]
