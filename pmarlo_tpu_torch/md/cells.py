"""Index-band exclusions for the O(N)-memory implicit pair path.

Port of three host functions of ``pmarlo_tpu/md/cells.py``:
``_scaled_pair_list``, ``exclusion_band_width`` and ``banded_scales``
(numpy, the same arithmetic); the cell-list machinery of that module is
explicit solvent, ROADMAP queue A12.

The pair kernels (``md/pair_force.py``) mask every LJ/Coulomb pair whose
atom indices differ by at most the band width D, and the band is added
back in plain PyTorch at its wanted (scaled) value: excluded pairs then
contribute an exact zero instead of a large kernel term minus a large
correction. Scaled pairs farther apart in index than D (disulfides) go to a
sparse far list, corrected by subtraction at their moderate distances.
``ExclusionBand`` carries these arrays; ``ExclusionBand.from_numpy`` takes
the JAX package's own arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .ff_params import SCEE, SCNB


def _np(a) -> np.ndarray:
    """Host numpy view of a torch tensor or any array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _scaled_pair_list(system) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx (P, 2) i<j, se (P,), sl (P,)) for every pair with a scale
    below 1, built from the sparse exclusion lists (no (N, N) matrix)."""
    parts_idx, parts_se, parts_sl = [], [], []
    e12 = _np(system.excl12_idx).reshape(-1, 2)
    if e12.size:
        e12 = np.sort(e12, axis=1)
        parts_idx.append(e12)
        parts_se.append(np.zeros(e12.shape[0], np.float32))
        parts_sl.append(np.zeros(e12.shape[0], np.float32))
    p14 = _np(system.pair14_idx).reshape(-1, 2)
    if p14.size:
        p14 = np.sort(p14, axis=1)
        parts_idx.append(p14)
        parts_se.append(np.full(p14.shape[0], SCEE, np.float32))
        parts_sl.append(np.full(p14.shape[0], SCNB, np.float32))
    if not parts_idx:
        return (np.zeros((0, 2), np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.float32))
    idx = np.concatenate(parts_idx).astype(np.int32)
    se = np.concatenate(parts_se)
    sl = np.concatenate(parts_sl)
    # dedupe (1-4 lists never overlap 1-2/1-3 by construction, but be safe)
    key = idx[:, 0].astype(np.int64) * (idx.max() + 1) + idx[:, 1]
    _, first = np.unique(key, return_index=True)
    return idx[first], se[first], sl[first]


def exclusion_band_width(system, cap: int = 64) -> int:
    """Smallest D covering the scaled/excluded pairs by index distance,
    capped at ``cap`` (pairs beyond it go to the sparse far list)."""
    idx, _, _ = _scaled_pair_list(system)
    if idx.shape[0] == 0:
        return 1
    dist = idx[:, 1] - idx[:, 0]
    return int(min(int(dist.max()), cap))


def banded_scales(
    system, D: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(band_se (N, D), band_sl (N, D), far_idx (P, 2), far_se, far_sl):
    band_se[i, k-1] is the scale of pair (i, i+k) (1.0 when unscaled or
    past the end); the far list holds scaled pairs with index distance
    > D. O(N*D) memory."""
    idx, se, sl = _scaled_pair_list(system)
    n = system.n_atoms
    band_se = np.ones((n, D), np.float32)
    band_sl = np.ones((n, D), np.float32)
    dist = idx[:, 1] - idx[:, 0] if idx.size else np.zeros(0, np.int64)
    near = dist <= D
    if idx.size:
        band_se[idx[near, 0], dist[near] - 1] = se[near]
        band_sl[idx[near, 0], dist[near] - 1] = sl[near]
    far_idx = idx[~near] if idx.size else np.zeros((0, 2), np.int32)
    far_se = se[~near] if idx.size else np.zeros(0, np.float32)
    far_sl = sl[~near] if idx.size else np.zeros(0, np.float32)
    return band_se, band_sl, far_idx.astype(np.int32), far_se, far_sl


@dataclasses.dataclass(frozen=True)
class ExclusionBand:
    """The band width and the arrays of ``banded_scales``."""

    width: int                 # D: pairs with |i - j| <= D are masked
    band_se: np.ndarray        # (N, D) Coulomb scale of pair (i, i+k)
    band_sl: np.ndarray        # (N, D) LJ scale of pair (i, i+k)
    far_idx: np.ndarray        # (P, 2) scaled pairs beyond the band
    far_se: np.ndarray         # (P,)
    far_sl: np.ndarray         # (P,)

    @classmethod
    def from_system(cls, system, width: "int | None" = None) -> "ExclusionBand":
        D = exclusion_band_width(system) if width is None else int(width)
        return cls(D, *banded_scales(system, D))

    @classmethod
    def from_numpy(cls, width, band_se, band_sl, far_idx, far_se,
                   far_sl) -> "ExclusionBand":
        """From the JAX package's ``exclusion_band_width`` and
        ``banded_scales`` outputs."""
        return cls(
            int(width), np.asarray(band_se, np.float32),
            np.asarray(band_sl, np.float32),
            np.asarray(far_idx, np.int32).reshape(-1, 2),
            np.asarray(far_se, np.float32), np.asarray(far_sl, np.float32),
        )

    def correction_pairs(self):
        """(i, j, c_el, c_lj) for the add-back pass: every band pair at
        its wanted scale, then every far pair at (scale - 1), which turns
        the kernel's full-strength term into the wanted one. Pairs whose
        two coefficients are both zero (the excluded band pairs) add
        nothing and are left out."""
        n, D = self.band_se.shape
        i = np.repeat(np.arange(n), D)
        k = np.tile(np.arange(1, D + 1), n)
        inside = i + k < n
        i, j = i[inside], (i + k)[inside]
        c_el = self.band_se.reshape(-1)[inside].astype(np.float64)
        c_lj = self.band_sl.reshape(-1)[inside].astype(np.float64)
        i = np.concatenate([i, self.far_idx[:, 0]])
        j = np.concatenate([j, self.far_idx[:, 1]])
        c_el = np.concatenate([c_el, self.far_se.astype(np.float64) - 1.0])
        c_lj = np.concatenate([c_lj, self.far_sl.astype(np.float64) - 1.0])
        keep = (c_el != 0.0) | (c_lj != 0.0)
        return i[keep], j[keep], c_el[keep], c_lj[keep]


__all__ = [
    "ExclusionBand", "banded_scales", "exclusion_band_width",
]
