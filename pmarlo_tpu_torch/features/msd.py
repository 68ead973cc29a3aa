"""Mean-squared displacement and self-diffusion on the trajectory's device.

Port of ``pmarlo_tpu/features/msd.py``: MSD(t) from minimum-image
unwrapped frames, averaged over atoms and time origins, and the Einstein
relation D = MSD / (6 t).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _tensor(positions) -> torch.Tensor:
    x = positions if isinstance(positions, torch.Tensor) else torch.as_tensor(
        np.asarray(positions))
    return x if x.is_floating_point() else x.float()


def unwrap_trajectory(positions, box, tilt=None) -> torch.Tensor:
    """Undo periodic wrapping by accumulating minimum-image frame-to-frame
    displacements (valid while no atom moves more than half the smallest
    perpendicular width between frames). With ``tilt`` (``md/box.py``) the
    deltas are rounded in fractional coordinates, which undoes wraps along
    any lattice vector. Returns a tensor on the positions' device."""
    x = _tensor(positions)
    deltas = x[1:] - x[:-1]
    if tilt is None:
        box_arr = torch.as_tensor(np.asarray(box, np.float64), dtype=x.dtype, device=x.device)
        deltas = deltas - box_arr * torch.round(deltas / box_arr)
    else:
        from ..md.box import box_matrix

        Hn = np.asarray(box_matrix(box, tilt))
        H = torch.as_tensor(Hn, dtype=x.dtype, device=x.device)
        Hinv = torch.as_tensor(np.linalg.inv(Hn), dtype=x.dtype, device=x.device)
        deltas = deltas - torch.round(deltas @ Hinv) @ H
    return torch.cat([x[:1], x[:1] + torch.cumsum(deltas, dim=0)], dim=0)


def mean_squared_displacement(
    positions,
    box=None,
    idx: Optional[np.ndarray] = None,
    *,
    max_lag: Optional[int] = None,
    remove_com: bool = False,
    masses: Optional[np.ndarray] = None,
    tilt=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """MSD(t) averaged over atoms and every time origin.

    ``positions (F, N, 3)``; ``box`` (3,) unwraps by the minimum image
    first (None for unwrapped or non-periodic data); ``idx`` selects atoms
    (default all). Returns ``(lags (L,), msd (L,))`` with lag 0 included.
    ``remove_com=True`` subtracts the per-frame centre of mass of all atoms
    (weights ``masses``, default equal) before the selection: a Langevin
    thermostat random-walks the whole box's centre, which would otherwise
    add its own diffusion to every atom's."""
    x = _tensor(positions)
    if box is not None:
        x = unwrap_trajectory(x, box, tilt=tilt)
    if remove_com:
        if masses is not None:
            w = torch.as_tensor(np.asarray(masses), dtype=x.dtype, device=x.device)
            w = w / w.sum()
        else:
            w = torch.full((x.shape[1],), 1.0 / x.shape[1], dtype=x.dtype, device=x.device)
        x = x - torch.einsum("fnd,n->fd", x, w)[:, None, :]
    if idx is not None:
        x = x[:, torch.as_tensor(np.asarray(idx, np.int64), device=x.device)]
    F = x.shape[0]
    L = int(max_lag) if max_lag is not None else F - 1
    L = max(min(L, F - 1), 0)
    if L == 0:
        # one frame (or max_lag=0): only the trivial lag exists
        return np.array([0]), np.array([0.0])
    # a lag's origins count differs from the next's: a loop over the
    # (report-resolution) lags, one device read at the end
    msd = torch.stack([((x[lag:] - x[:F - lag]) ** 2).sum(-1).mean()
                       for lag in range(1, L + 1)])
    return np.arange(0, L + 1), np.concatenate([[0.0], msd.cpu().numpy()])


def diffusion_coefficient(
    lags: np.ndarray,
    msd: np.ndarray,
    dt_per_lag_ps: float,
    *,
    fit_start_frac: float = 0.2,
    fit_end_frac: float = 0.8,
) -> float:
    """Einstein relation: D = slope(MSD vs t) / 6, least squares over the
    linear regime (the defaults skip the ballistic onset and the noisy
    tail). Returns D in nm^2/ps (1 nm^2/ps = 1e-2 cm^2/s)."""
    t = np.asarray(lags, float) * dt_per_lag_ps
    lo = int(len(t) * fit_start_frac)
    hi = max(int(len(t) * fit_end_frac), lo + 2)
    slope = np.polyfit(t[lo:hi], np.asarray(msd, float)[lo:hi], 1)[0]
    return float(slope / 6.0)


__all__ = ["diffusion_coefficient", "mean_squared_displacement", "unwrap_trajectory"]
