"""Radial distribution function g(r) on the trajectory's device.

Port of ``pmarlo_tpu/features/rdf.py``: the minimum-image distances of
the two selections, frame by frame, counted into shells and normalised by
the ideal-gas shell occupancy

    g(r) = <n_pairs(r, r+dr)> / (N_a * rho_b * 4 pi r^2 dr)

with rho_b the partner density an a-atom sees (atoms in both selections
are excluded as self-pairs and taken out of rho_b). The frames go through
in chunks whose (frames, A, B) distances stay within a fixed budget, and
each chunk's counts are one ``bincount`` over its frames' bins.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: bytes of (frames, A, B, 3) float32 displacements a chunk of frames may hold
_CHUNK_BYTES = 1 << 28


def _positions(positions) -> torch.Tensor:
    x = positions if isinstance(positions, torch.Tensor) else torch.as_tensor(
        np.asarray(positions))
    if not x.is_floating_point():
        x = x.float()
    return x[None] if x.dim() == 2 else x


def radial_distribution(
    positions,
    box,
    idx_a,
    idx_b: Optional[np.ndarray] = None,
    *,
    r_max: float = 1.0,
    n_bins: int = 100,
    tilt: Optional[Tuple[float, float, float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """g(r) between selections ``idx_a`` and ``idx_b`` (default: a-a).

    ``positions (F, N, 3)`` (a tensor on any device, or an array); ``box``
    the (3,) lattice diagonal, with ``tilt`` the triclinic off-diagonals
    (``md/box.py``); ``r_max`` at most half the smallest perpendicular
    width, so that minimum-image distances are unambiguous. Overlapping
    selections are handled: identical-atom pairs are excluded and the
    partner density discounted, so ``idx_b`` equal to ``idx_a`` gives the
    a-a result. Returns ``(r_centers (n_bins,), g (n_bins,))`` as numpy
    arrays."""
    x = _positions(positions)
    dev, dtype = x.device, x.dtype
    box_arr = torch.as_tensor(np.asarray(box, np.float64), dtype=dtype, device=dev)
    if tilt is None:
        half_width = float(box_arr.min()) / 2
        H = Hinv = None
    else:
        from ..md.box import box_matrix, perp_widths

        Hn = box_matrix(box, tilt)
        half_width = float(np.min(perp_widths(Hn))) / 2
        H = torch.as_tensor(Hn, dtype=dtype, device=dev)
        Hinv = torch.as_tensor(np.linalg.inv(Hn), dtype=dtype, device=dev)
    if float(r_max) > half_width + 1e-9:
        raise ValueError(
            f"r_max {r_max} exceeds half the smallest perpendicular "
            f"cell width {half_width:.4f} — min-image ambiguous"
        )
    ia = np.asarray(idx_a, np.int64)
    ib = ia if idx_b is None else np.asarray(idx_b, np.int64)
    self_np = ia[:, None] == ib[None, :]
    n_overlap = int(self_np.sum())
    a_t = torch.as_tensor(ia, device=dev)
    b_t = torch.as_tensor(ib, device=dev)
    self_mask = torch.as_tensor(self_np, device=dev)
    dr = float(r_max) / n_bins

    F = x.shape[0]
    chunk = max(1, _CHUNK_BYTES // max(1, 12 * len(ia) * len(ib)))
    hist = torch.zeros(n_bins + 1, dtype=torch.float64, device=dev)
    for s in range(0, F, chunk):
        xs = x[s:s + chunk]
        d = xs[:, a_t, None, :] - xs[:, None, b_t, :]            # (f, A, B, 3)
        if H is None:
            d = d - box_arr * torch.round(d / box_arr)
        else:
            # rounded fractional minimum image: exact below half the
            # smallest perpendicular width, which bounds r_max
            d = d - torch.round(d @ Hinv) @ H
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        r = torch.where(self_mask, torch.full_like(r, 2.0 * r_max), r)
        bins = torch.clamp((r / dr).to(torch.int64), 0, n_bins)
        # bin n_bins collects everything past r_max and is dropped
        hist += torch.bincount(bins.reshape(-1), minlength=n_bins + 1).double()
    hist = hist[:n_bins].cpu().numpy()

    n_a, n_b = len(ia), len(ib)
    vol = float(torch.prod(box_arr))
    # partner density seen by an average a-atom: the excluded self-partners
    # (n_overlap over the A selection) do not count
    rho_b = (n_b - n_overlap / max(n_a, 1)) / vol
    edges = np.linspace(0.0, r_max, n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    shell = 4.0 * np.pi * centers**2 * dr
    ideal = F * n_a * rho_b * shell
    g = hist / np.maximum(ideal, 1e-30)
    return centers, g


def coordination_number(
    r: np.ndarray, g: np.ndarray, rho: float, r_cut: float
) -> float:
    """Running coordination number n(r_cut) = rho * int_0^rcut g 4 pi r^2 dr
    (trapezoid). For water O-O with r_cut at the first minimum (~0.35 nm)
    this is ~4.5-5."""
    m = np.asarray(r) <= r_cut
    integrand = 4.0 * np.pi * np.asarray(r)[m] ** 2 * np.asarray(g)[m]
    trapz = getattr(np, "trapezoid", None) or np.trapz
    return float(rho * trapz(integrand, np.asarray(r)[m]))


__all__ = ["coordination_number", "radial_distribution"]
