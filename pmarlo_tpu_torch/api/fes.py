"""FES API: phi/psi-aware CV pair selection + minima picking.

Reference: src/pmarlo/api/fes.py:71 (pair selection), :238
(generate_fes_and_pick_minima), markov_state_model/picker.py:12,40
(find_local_minima_2d, pick_frames_around_minima).

Host copy of ``pmarlo_tpu/api/fes.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..msm.free_energy import FESResult, generate_2d_fes


def select_fes_pair(
    columns: Sequence[str], periodic: Optional[np.ndarray] = None
) -> Tuple[int, int]:
    """Pick a CV pair for FES: prefer a (phi, psi) pair, else the first two
    columns (reference api/fes.py:71 phi/psi-aware selection)."""
    phi = [i for i, c in enumerate(columns) if "phi" in c.lower()]
    psi = [i for i, c in enumerate(columns) if "psi" in c.lower()]
    if phi and psi:
        return phi[0], psi[0]
    if len(columns) < 2:
        raise ValueError("need at least two feature columns for a 2D FES")
    return 0, 1


def find_local_minima_2d(F: np.ndarray, connectivity: int = 8) -> List[Tuple[int, int]]:
    """Local minima of a 2D surface via neighborhood comparison
    (reference picker.py:12). NaN bins never count."""
    F = np.asarray(F, dtype=np.float64)
    Fp = np.where(np.isfinite(F), F, np.inf)
    padded = np.pad(Fp, 1, constant_values=np.inf)
    center = padded[1:-1, 1:-1]
    is_min = np.isfinite(center)
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    for di, dj in offsets:
        neighbor = padded[1 + di : padded.shape[0] - 1 + di,
                          1 + dj : padded.shape[1] - 1 + dj]
        is_min &= center <= neighbor
    # deduplicate plateaus: keep strict minima against at least one neighbor
    strict = np.zeros_like(is_min)
    for di, dj in offsets:
        neighbor = padded[1 + di : padded.shape[0] - 1 + di,
                          1 + dj : padded.shape[1] - 1 + dj]
        strict |= center < neighbor
    is_min &= strict
    return [(int(i), int(j)) for i, j in zip(*np.where(is_min))]


def pick_frames_around_minima(
    cv1: np.ndarray,
    cv2: np.ndarray,
    fes: FESResult,
    *,
    delta_f_kj: float = 2.5,
    max_frames_per_minimum: int = 50,
) -> Dict[int, np.ndarray]:
    """Frame indices whose FES bin lies within delta_F of each local
    minimum (reference picker.py:40)."""
    minima = find_local_minima_2d(fes.free_energy)
    xi = np.clip(np.digitize(cv1, fes.xedges) - 1, 0, fes.free_energy.shape[0] - 1)
    yi = np.clip(np.digitize(cv2, fes.yedges) - 1, 0, fes.free_energy.shape[1] - 1)
    frame_f = fes.free_energy[xi, yi]
    out: Dict[int, np.ndarray] = {}
    for m, (i, j) in enumerate(minima):
        f_min = fes.free_energy[i, j]
        sel = np.where(np.isfinite(frame_f) & (frame_f <= f_min + delta_f_kj))[0]
        # restrict to the basin: frames whose bin is near this minimum get
        # assigned to the closest minimum in bin space
        if len(minima) > 1:
            d_all = np.stack([
                (xi - mi) ** 2 + (yi - mj) ** 2 for mi, mj in minima
            ])
            closest = np.argmin(d_all, axis=0)
            sel = sel[closest[sel] == m]
        out[m] = sel[:max_frames_per_minimum]
    return out


def generate_fes_and_pick_minima(
    cv1: np.ndarray,
    cv2: np.ndarray,
    *,
    temperature_K: float = 300.0,
    bins: Optional[int] = 32,
    weights: Optional[np.ndarray] = None,
    periodic: Tuple[bool, bool] = (False, False),
    delta_f_kj: float = 2.5,
    cv_names: Tuple[str, str] = ("CV1", "CV2"),
) -> Tuple[FESResult, Dict[int, np.ndarray]]:
    """(reference api/fes.py:238)."""
    fes = generate_2d_fes(
        cv1, cv2, temperature_K=temperature_K, bins=bins, weights=weights,
        periodic=periodic, cv_names=cv_names,
    )
    picks = pick_frames_around_minima(cv1, cv2, fes, delta_f_kj=delta_f_kj)
    return fes, picks


def generate_free_energy_surface(
    cv1: np.ndarray,
    cv2: np.ndarray,
    bins: "int | Tuple[int, int] | None" = None,
    temperature: float = 300.0,
    periodic: Tuple[bool, bool] = (False, False),
    *,
    weights: Optional[np.ndarray] = None,
    smoothing_mode: str = "auto",
    cv_names: Tuple[str, str] = ("CV1", "CV2"),
) -> FESResult:
    """Standalone 2D FES entry point with the reference's api-level
    argument names (reference: src/pmarlo/api/fes.py:119
    generate_free_energy_surface); delegates to
    msm.free_energy.generate_2d_fes (adaptive grid + uncertainty-gated
    smoothing)."""
    return generate_2d_fes(
        cv1, cv2, temperature_K=temperature, bins=bins, weights=weights,
        periodic=periodic, smoothing_mode=smoothing_mode, cv_names=cv_names,
    )


__all__ = [
    "select_fes_pair",
    "find_local_minima_2d",
    "pick_frames_around_minima",
    "generate_fes_and_pick_minima",
    "generate_free_energy_surface",
]
