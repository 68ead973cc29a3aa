"""Harmonic-expansion bias: E = k * sum(cv^2).

Port of ``pmarlo_tpu/bias/harmonic.py``: features -> scale -> DeepTICA
CVs -> E = k sum cv^2, forces by autograd. Every function takes positions
``(..., N, 3)``; leading dimensions (replicas) batch and the energy comes
back with shape ``(...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HarmonicExpansionBias:
    """E(cv) = strength * sum_i cv_i^2: pushes sampling outward along the
    learned slow modes (the reference's exploration bias)."""

    strength: float = 1.0  # kJ/mol per cv^2 unit

    def __call__(self, cv: torch.Tensor) -> torch.Tensor:
        return self.strength * (cv * cv).sum(-1)


def make_cv_bias_fn(
    cv_from_positions: Callable[[torch.Tensor], torch.Tensor],
    bias_on_cv: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Compose positions -> CV -> bias energy into one function that plugs
    into ``make_force_fn(system, bias_fn)``."""

    def bias_fn(positions: torch.Tensor) -> torch.Tensor:
        return bias_on_cv(cv_from_positions(positions))

    return bias_fn


def make_feature_cv_fn(
    feature_fn: Callable[[torch.Tensor], torch.Tensor],
    model_fn: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[torch.Tensor], torch.Tensor]:
    """positions (..., N, 3) -> features (..., K) -> cv (..., n_out).
    ``model_fn`` is ``DeepTICAModel.as_function()`` (scaler + MLP +
    whitening inside)."""

    def cv_fn(positions: torch.Tensor) -> torch.Tensor:
        return model_fn(feature_fn(positions))

    return cv_fn


def make_phi_psi_feature_fn(
    atom_names: Sequence[str],
    residue_ids: Sequence[int],
    cos_sin: bool = True,
    chain_ids: Optional[Sequence[str]] = None,
):
    """phi/psi feature function for CV bias composition:
    ``feature_fn(positions (..., N, 3)) -> (..., K)`` with K = 2 n_dihedrals
    when ``cos_sin`` (the bias-safe smooth embedding) else n_dihedrals."""
    from ..features.builtins import phi_psi_indices
    from ..md.forces import dihedral_angles

    phi_q, psi_q, _ = phi_psi_indices(atom_names, residue_ids, chain_ids)
    quads_np = np.concatenate([phi_q, psi_q], axis=0)
    if quads_np.shape[0] == 0:
        raise ValueError("system has no phi/psi dihedrals for a CV bias")

    def feature_fn(positions: torch.Tensor) -> torch.Tensor:
        quads = torch.as_tensor(quads_np, dtype=torch.int64, device=positions.device)
        angles = dihedral_angles(positions, quads)
        if cos_sin:
            return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
        return angles

    return feature_fn


__all__ = [
    "HarmonicExpansionBias",
    "make_cv_bias_fn",
    "make_feature_cv_fn",
    "make_phi_psi_feature_fn",
]
