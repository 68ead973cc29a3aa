"""Holonomic X-H bond constraints: parallel SHAKE and RATTLE.

Port of the H-bond part of ``pmarlo_tpu/md/constraints.py``: the same
Jacobi-style iteration (every constraint computes its correction from one
iterate, corrections add up), a fixed iteration count, and positions or
velocities with leading replica dimensions ``(..., N, 3)``. The TPU
layouts (one-hot scatter matmuls, rolled groups) become index gathers
and one ``index_add_`` an iteration. X-H constraints form stars (a heavy
atom with 1-3 hydrogens), on which Jacobi converges in a few sweeps.

Rigid water (the exact 3x3 solver) is explicit solvent, ROADMAP queue
A12: ``build_h_constraints`` raises for systems with waters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .ff_params import TYPE_ELEMENTS
from .system import System
from .topology import _WATER_NAMES


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Distance constraints ``|x[idx1] - x[idx2]| = d0``."""

    idx1: torch.Tensor          # (C,) int64 first atoms
    idx2: torch.Tensor          # (C,) int64 second atoms
    d0: torch.Tensor            # (C,) target lengths (nm)
    inv_m1: torch.Tensor        # (C,) 1/m of the first atoms
    inv_m2: torch.Tensor        # (C,)
    inv_mass_sum: torch.Tensor  # (C,)
    n_iter: int = 30

    def __post_init__(self):
        # gather and scatter indices of both atoms, and the -1/m1, +1/m2
        # weights of the corrections, built once (the iterations are
        # host-bound on a card: every saved op counts ~120 times a step)
        object.__setattr__(self, "idx_both", torch.cat([self.idx1, self.idx2]))
        object.__setattr__(self, "weights", torch.cat([-self.inv_m1, self.inv_m2]))

    @property
    def n_constraints(self) -> int:
        return int(self.d0.shape[0])

    def to(self, device) -> "ConstraintSpec":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    @classmethod
    def from_numpy(cls, spec, device="cpu") -> "ConstraintSpec":
        """From the JAX package's one-hot ``ConstraintSpec`` (arrays
        ``s1``, ``s2`` (C, N), ``d0``, ``inv_m1``, ``inv_m2``,
        ``inv_mass_sum``, and ``n_iter``)."""
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        def idx(onehot):
            return torch.tensor(np.argmax(np.asarray(onehot), axis=1),
                                   dtype=torch.long, device=device)

        return cls(idx1=idx(spec.s1), idx2=idx(spec.s2), d0=f32(spec.d0),
                   inv_m1=f32(spec.inv_m1), inv_m2=f32(spec.inv_m2),
                   inv_mass_sum=f32(spec.inv_mass_sum), n_iter=int(spec.n_iter))


def _is_hydrogen(system: System) -> np.ndarray:
    """Hydrogens by their force-field type (HMR may have raised masses)."""
    return np.asarray([TYPE_ELEMENTS.get(t, "X") == "H" for t in system.atom_types])


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_h_constraints(system: System, n_iter: int = 30) -> Optional[ConstraintSpec]:
    """Constraints for every bond involving a hydrogen (OpenMM HBonds), or
    ``None`` when there is none."""
    if any(rn in _WATER_NAMES for rn in system.residue_names):
        raise NotImplementedError(
            "rigid-water constraints (explicit solvent) are ROADMAP queue A12"
        )
    bonds = _host(system.bond_idx).reshape(-1, 2)
    masses = _host(system.masses).astype(np.float64)
    is_h = _is_hydrogen(system)
    keep = is_h[bonds[:, 0]] | is_h[bonds[:, 1]]
    pairs = bonds[keep].astype(np.int64)
    if pairs.shape[0] == 0:
        return None
    if np.any(masses[pairs.reshape(-1)] <= 0.0):
        raise ValueError("constraint pair references a massless atom")
    r0 = _host(system.bond_r0).astype(np.float64)[keep]
    inv_m = 1.0 / masses
    dev = system.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return ConstraintSpec(
        idx1=torch.as_tensor(pairs[:, 0], device=dev),
        idx2=torch.as_tensor(pairs[:, 1], device=dev),
        d0=f32(r0),
        inv_m1=f32(inv_m[pairs[:, 0]]),
        inv_m2=f32(inv_m[pairs[:, 1]]),
        inv_mass_sum=f32(inv_m[pairs[:, 0]] + inv_m[pairs[:, 1]]),
        n_iter=int(n_iter),
    )


def _pair_vectors(spec: ConstraintSpec, x: torch.Tensor) -> torch.Tensor:
    """x[idx1] - x[idx2], ``(..., C, 3)``."""
    both = x.index_select(-2, spec.idx_both)
    return both[..., :spec.n_constraints, :] - both[..., spec.n_constraints:, :]


def _scatter(spec: ConstraintSpec, x: torch.Tensor, k: torch.Tensor,
             weighted: torch.Tensor) -> torch.Tensor:
    """x + k * weighted scattered onto (first atoms, second atoms), where
    ``weighted (..., 2C, 3)`` holds a bond vector times -1/m1 then +1/m2.
    The corrections of an atom are summed before they are added to it, as
    the JAX scatter matmuls sum them."""
    corr = torch.cat([k, k], -1)[..., None] * weighted
    return x + torch.zeros_like(x).index_add_(-2, spec.idx_both, corr)


def _weighted(spec: ConstraintSpec, d: torch.Tensor) -> torch.Tensor:
    return torch.cat([d, d], -2) * spec.weights[:, None]


def shake(spec: ConstraintSpec, x_new: torch.Tensor, x_ref: torch.Tensor,
          omega: float = 1.0) -> torch.Tensor:
    """Project positions onto the constraint manifold (parallel SHAKE):
    corrections act along the reference (pre-step) bond vectors."""
    d_ref = _pair_vectors(spec, x_ref)
    weighted = _weighted(spec, d_ref)
    d0sq = spec.d0 * spec.d0
    two_ims = 2.0 * spec.inv_mass_sum
    x = x_new
    for _ in range(spec.n_iter):
        d_new = _pair_vectors(spec, x)
        diff = torch.linalg.vecdot(d_new, d_new) - d0sq
        denom = two_ims * torch.linalg.vecdot(d_new, d_ref)
        g = diff / torch.where(denom.abs() > 1e-12, denom, 1e-12)
        if omega != 1.0:
            g = omega * g
        x = _scatter(spec, x, g, weighted)
    return x


def rattle(spec: ConstraintSpec, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Remove velocity components along constrained bonds (parallel
    RATTLE), ``max(n_iter // 2, 5)`` sweeps."""
    d = _pair_vectors(spec, x)
    weighted = _weighted(spec, d)
    denom = torch.linalg.vecdot(d, d) * spec.inv_mass_sum + 1e-12
    for _ in range(max(spec.n_iter // 2, 5)):
        k = torch.linalg.vecdot(d, _pair_vectors(spec, v)) / denom
        v = _scatter(spec, v, k, weighted)
    return v


def constraint_violation(spec: ConstraintSpec, x: torch.Tensor) -> torch.Tensor:
    """Max |r - d0| over constraints and leading dimensions."""
    d = _pair_vectors(spec, x)
    r = torch.sqrt((d * d).sum(-1) + 1e-12)
    return (r - spec.d0).abs().max()


def strip_constrained_bonded(system: System) -> System:
    """System copy without the bonded terms the constraints replace
    (OpenMM ``createSystem(constraints=HBonds)``): bonds to hydrogen carry
    no force, and water H-O-H angles none. Keep the full system for
    unconstrained minimization."""
    bonds = _host(system.bond_idx).reshape(-1, 2)
    is_h = _is_hydrogen(system)
    changes = {}
    if bonds.shape[0]:
        keep_b = torch.as_tensor(~(is_h[bonds[:, 0]] | is_h[bonds[:, 1]]),
                                 device=system.device)
        if not bool(keep_b.all()):
            changes.update(bond_idx=system.bond_idx[keep_b],
                           bond_k=system.bond_k[keep_b],
                           bond_r0=system.bond_r0[keep_b])
    water = np.asarray([rn in _WATER_NAMES for rn in system.residue_names])
    angles = _host(system.angle_idx).reshape(-1, 3)
    if angles.shape[0] and water.any():
        keep_a = torch.as_tensor(
            ~(water[angles[:, 0]] & water[angles[:, 1]] & water[angles[:, 2]]),
            device=system.device)
        if not bool(keep_a.all()):
            changes.update(angle_idx=system.angle_idx[keep_a],
                           angle_k=system.angle_k[keep_a],
                           angle_t0=system.angle_t0[keep_a])
    return dataclasses.replace(system, **changes) if changes else system


def n_constraints(spec: Optional[ConstraintSpec]) -> int:
    return 0 if spec is None else spec.n_constraints


__all__ = [
    "ConstraintSpec", "build_h_constraints", "constraint_violation",
    "n_constraints", "rattle", "shake", "strip_constrained_bonded",
]
