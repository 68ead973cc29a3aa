"""Holonomic constraints: parallel SHAKE/RATTLE for X-H bonds and the
exact rigid-water solver.

Port of ``pmarlo_tpu/md/constraints.py``. X-H bonds: the same
Jacobi-style iteration (every constraint computes its correction from one
iterate, corrections add up), a fixed iteration count, and positions or
velocities with leading replica dimensions ``(..., N, 3)``. The TPU
layouts (one-hot scatter matmuls, rolled groups) become index gathers
and one ``index_add_`` an iteration. X-H constraints form stars (a heavy
atom with 1-3 hydrogens), on which Jacobi converges in a few sweeps.

Rigid water (``RigidWaterSpec``): the three coupled distance constraints
of a water triangle make Jacobi SHAKE/RATTLE unstable in dynamics, so each
water's cluster is solved exactly: Newton iterations with a closed-form
3x3 solve for positions (``shake_water``), one linear 3x3 solve for
velocities (``rattle_water``), batched over waters and replicas.
``build_h_constraints`` returns a ``CompositeConstraintSpec`` (X-H
constraints of the solute + the water block) for systems with waters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .._device import default_device
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
    def from_numpy(cls, spec, device=None) -> "ConstraintSpec":
        """From the JAX package's one-hot ``ConstraintSpec`` (arrays
        ``s1``, ``s2`` (C, N), ``d0``, ``inv_m1``, ``inv_m2``,
        ``inv_mass_sum``, and ``n_iter``), on ``device`` (``None``:
        ``_device.default_device()``)."""
        device = torch.device(device) if device is not None else default_device()
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


def build_h_constraints(
    system: System, n_iter: int = 30,
) -> "Union[ConstraintSpec, CompositeConstraintSpec, None]":
    """Constraints for every bond involving a hydrogen (OpenMM HBonds), or
    ``None`` when there is none. A system with waters gets a
    ``CompositeConstraintSpec``: the waters (one contiguous block of
    (O, H1, H2) residues) go to the exact rigid solver, every other X-H
    bond to the Jacobi iteration."""
    bonds = _host(system.bond_idx).reshape(-1, 2)
    masses = _host(system.masses).astype(np.float64)
    is_h = _is_hydrogen(system)
    keep = is_h[bonds[:, 0]] | is_h[bonds[:, 1]]
    pairs = bonds[keep].astype(np.int64)
    r0 = _host(system.bond_r0).astype(np.float64)[keep]
    water_atoms = np.asarray([rn in _WATER_NAMES for rn in system.residue_names])
    water_spec = None
    if water_atoms.any():
        water_spec = _build_water_spec(system, water_atoms, masses)
        in_water = water_atoms[pairs[:, 0]] | water_atoms[pairs[:, 1]]
        pairs, r0 = pairs[~in_water], r0[~in_water]
    protein_spec = None
    if pairs.shape[0]:
        if np.any(masses[pairs.reshape(-1)] <= 0.0):
            raise ValueError("constraint pair references a massless atom")
        inv_m = 1.0 / masses
        dev = system.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        protein_spec = ConstraintSpec(
            idx1=torch.as_tensor(pairs[:, 0], device=dev),
            idx2=torch.as_tensor(pairs[:, 1], device=dev),
            d0=f32(r0),
            inv_m1=f32(inv_m[pairs[:, 0]]),
            inv_m2=f32(inv_m[pairs[:, 1]]),
            inv_mass_sum=f32(inv_m[pairs[:, 0]] + inv_m[pairs[:, 1]]),
            n_iter=int(n_iter),
        )
    if water_spec is None:
        return protein_spec
    return CompositeConstraintSpec(protein=protein_spec, water=water_spec)


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
    corrections act along the reference (pre-step) bond vectors. A
    composite spec runs the X-H iteration, then the exact water solve
    (the clusters are disjoint)."""
    if isinstance(spec, CompositeConstraintSpec):
        if spec.protein is not None:
            x_new = shake(spec.protein, x_new, x_ref, omega)
        return shake_water(spec.water, x_new, x_ref)
    if isinstance(spec, RigidWaterSpec):
        return shake_water(spec, x_new, x_ref)
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
    RATTLE), ``max(n_iter // 2, 5)`` sweeps; one exact solve a water."""
    if isinstance(spec, CompositeConstraintSpec):
        if spec.protein is not None:
            v = rattle(spec.protein, v, x)
        return rattle_water(spec.water, v, x)
    if isinstance(spec, RigidWaterSpec):
        return rattle_water(spec, v, x)
    d = _pair_vectors(spec, x)
    weighted = _weighted(spec, d)
    denom = torch.linalg.vecdot(d, d) * spec.inv_mass_sum + 1e-12
    for _ in range(max(spec.n_iter // 2, 5)):
        k = torch.linalg.vecdot(d, _pair_vectors(spec, v)) / denom
        v = _scatter(spec, v, k, weighted)
    return v


def constraint_violation(spec: ConstraintSpec, x: torch.Tensor) -> torch.Tensor:
    """Max |r - d0| over constraints and leading dimensions."""
    if isinstance(spec, CompositeConstraintSpec):
        parts = [constraint_violation(spec.water, x)]
        if spec.protein is not None:
            parts.append(constraint_violation(spec.protein, x))
        return torch.stack(parts).max()
    if isinstance(spec, RigidWaterSpec):
        d = _water_dvec(_water_block(spec, x))
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        return (r - spec.d0).abs().max()
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


def n_constraints(spec) -> int:
    """Constraint count of any spec (``None``: 0)."""
    return 0 if spec is None else spec.n_constraints


# --- rigid water ---------------------------------------------------------------

#: TIP3P H-H distance (nm); the O-H length comes from the water's bond term
_TIP3P_HH = 0.15139
_TIP3P_OH = 0.09572
#: constraint pair slots within one water: (O,H1), (O,H2), (H1,H2)
_W_PAIRS = ((0, 1), (0, 2), (1, 2))
#: _W_SGN[c, a] = +1 if atom a is i(c), -1 if j(c), else 0
_W_SGN = np.zeros((3, 3), np.float32)
for _c, (_i, _j) in enumerate(_W_PAIRS):
    _W_SGN[_c, _i] = 1.0
    _W_SGN[_c, _j] = -1.0


@dataclasses.dataclass(frozen=True)
class RigidWaterSpec:
    """Exact rigid-water (TIP3P) constraints for one contiguous block of
    waters laid out (O, H1, H2) per residue, so the block is a reshape,
    not a gather."""

    start: int                  # first atom of the block
    n_waters: int
    inv_m: torch.Tensor         # (3,) 1/m of (O, H1, H2)
    d0: torch.Tensor            # (3,) targets of (O-H1, O-H2, H1-H2)
    n_newton: int = 6

    def __post_init__(self):
        sgn = torch.as_tensor(_W_SGN, dtype=self.inv_m.dtype, device=self.inv_m.device)
        # sgn (constraint, atom): bond vectors d = sgn @ x; sgn_im: the
        # displacement of atom a by the multiplier of constraint c;
        # coef[c, cp] = sgn[cp, i_c] / m[i_c] - sgn[cp, j_c] / m[j_c]
        object.__setattr__(self, "sgn", sgn)
        object.__setattr__(self, "sgn_im", sgn * self.inv_m[None, :])
        object.__setattr__(self, "coef", (sgn * self.inv_m[None, :]) @ sgn.T)
        object.__setattr__(self, "d0sq", self.d0 * self.d0)

    @property
    def n_constraints(self) -> int:
        return 3 * self.n_waters

    def to(self, device) -> "RigidWaterSpec":
        return dataclasses.replace(self, inv_m=self.inv_m.to(device),
                                   d0=self.d0.to(device))

    @classmethod
    def from_numpy(cls, spec, device=None) -> "RigidWaterSpec":
        """From the JAX package's ``RigidWaterSpec`` (3-site water), on
        ``device`` (``None``: ``_device.default_device()``)."""
        device = torch.device(device) if device is not None else default_device()
        if int(getattr(spec, "stride", 3)) != 3:
            raise NotImplementedError(
                "4- and 5-site water (virtual sites) is ROADMAP queue A11")
        return cls(start=int(spec.start), n_waters=int(spec.n_waters),
                   inv_m=torch.tensor(np.asarray(spec.inv_m, np.float32), device=device),
                   d0=torch.tensor(np.asarray(spec.d0, np.float32), device=device),
                   n_newton=int(spec.n_newton))


@dataclasses.dataclass(frozen=True)
class CompositeConstraintSpec:
    """X-H constraints of the solute (Jacobi) + the rigid-water block
    (exact); the clusters are disjoint, so the two solvers compose."""

    protein: Optional[ConstraintSpec]
    water: RigidWaterSpec

    @property
    def n_constraints(self) -> int:
        return n_constraints(self.protein) + self.water.n_constraints

    def to(self, device) -> "CompositeConstraintSpec":
        return CompositeConstraintSpec(
            protein=None if self.protein is None else self.protein.to(device),
            water=self.water.to(device))


def _build_water_spec(system: System, water_atoms: np.ndarray,
                      masses: np.ndarray) -> RigidWaterSpec:
    idx = np.flatnonzero(water_atoms)
    start, stop = int(idx[0]), int(idx[-1]) + 1
    names = list(system.atom_names[start:stop])
    if len(names) >= 4 and names[3] in ("M", "L1"):
        raise NotImplementedError(
            "4- and 5-site water (TIP4P-Ew, TIP5P: virtual sites) is not "
            "ported yet (ROADMAP queue A11)")
    n_w = (stop - start) // 3
    if (stop - start != 3 * n_w or not water_atoms[start:stop].all()
            or names != ["O", "H1", "H2"] * n_w):
        raise ValueError(
            "rigid-water constraints need one contiguous (O, H1, H2)-ordered "
            "water block (the canonical solvate/topology layout)")
    # O-H target from the first water O's bond term; a topology whose
    # water bonds were already stripped falls back to the TIP3P geometry
    b_idx = _host(system.bond_idx).reshape(-1, 2)
    b_r0 = _host(system.bond_r0)
    oh_rows = np.flatnonzero(
        ((b_idx[:, 0] == start) | (b_idx[:, 1] == start)) & (b_r0 > 0.08))
    d_oh = float(b_r0[oh_rows[0]]) if oh_rows.size else _TIP3P_OH
    dev = system.device
    return RigidWaterSpec(
        start=start, n_waters=n_w,
        inv_m=torch.as_tensor(1.0 / masses[start:start + 3], dtype=torch.float32,
                              device=dev),
        d0=torch.as_tensor([d_oh, d_oh, _TIP3P_HH], dtype=torch.float32, device=dev),
    )


def _water_block(spec: RigidWaterSpec, x: torch.Tensor) -> torch.Tensor:
    """The water block as ``(..., W, 3 atoms, 3 xyz)`` (a view)."""
    stop = spec.start + 3 * spec.n_waters
    return x[..., spec.start:stop, :].unflatten(-2, (spec.n_waters, 3))


def _water_dvec(xw: torch.Tensor) -> torch.Tensor:
    """``(..., W, 3 constraints, 3 xyz)`` bond vectors of the three pairs."""
    return torch.stack([xw[..., i, :] - xw[..., j, :] for i, j in _W_PAIRS], -2)


def _solve33(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 solve ``A x = b`` (``A (..., 3, 3)``,
    ``b (..., 3)``) through the adjugate written as cross products of the
    rows; a vanishing determinant is floored at 1e-20 as in the JAX
    solver."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c12 = torch.linalg.cross(r1, r2)
    c20 = torch.linalg.cross(r2, r0)
    c01 = torch.linalg.cross(r0, r1)
    det = (r0 * c12).sum(-1, keepdim=True)
    det = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    return (c12 * b[..., 0:1] + c20 * b[..., 1:2] + c01 * b[..., 2:3]) / det


def _with_water_block(spec: RigidWaterSpec, full: torch.Tensor,
                      block: torch.Tensor) -> torch.Tensor:
    out = full.clone()
    stop = spec.start + 3 * spec.n_waters
    out[..., spec.start:stop, :] = block.flatten(-3, -2)
    return out


def shake_water(spec: RigidWaterSpec, x_new: torch.Tensor,
                x_ref: torch.Tensor) -> torch.Tensor:
    """Exact SHAKE of the water block: x = x_unc + M^-1 J_ref^T lam, with
    ``n_newton`` Newton iterations on sigma_c(lam) = |d_c|^2 - d0_c^2
    (quadratic convergence; a 3x3 solve a water and iteration)."""
    xb = _water_block(spec, x_new)                        # (..., W, 3a, 3x)
    d_ref = _water_dvec(_water_block(spec, x_ref))        # (..., W, 3c, 3x)
    # dx[a] = sum_c lam_c sgn[c, a] / m[a] d_ref[c]
    lift = spec.sgn_im.T                                  # (a, c)

    def displaced(lam):
        return xb + lift @ (lam[..., None] * d_ref)

    lam = torch.zeros(xb.shape[:-1], dtype=xb.dtype, device=xb.device)
    for _ in range(spec.n_newton):
        d = spec.sgn @ displaced(lam)                     # (..., W, 3c, 3x)
        sigma = (d * d).sum(-1) - spec.d0sq
        # Newton Jacobian G[c, cp] = dsigma_c / dlam_cp = 2 coef[c, cp] d_c . d_ref_cp
        G = 2.0 * spec.coef * (d @ d_ref.transpose(-1, -2))
        lam = lam - _solve33(G, sigma)
    return _with_water_block(spec, x_new, displaced(lam))


def rattle_water(spec: RigidWaterSpec, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact RATTLE of the water block: (J M^-1 J^T) lam = -J v, one 3x3
    solve a water."""
    d = _water_dvec(_water_block(spec, x))                # (..., W, 3c, 3x)
    vb = _water_block(spec, v)
    dv = spec.sgn @ vb
    rhs = -(d * dv).sum(-1)
    A = spec.coef * (d @ d.transpose(-1, -2))
    lam = _solve33(A, rhs)
    return _with_water_block(spec, v, vb + spec.sgn_im.T @ (lam[..., None] * d))


__all__ = [
    "CompositeConstraintSpec", "ConstraintSpec", "RigidWaterSpec",
    "build_h_constraints", "constraint_violation", "n_constraints", "rattle",
    "rattle_water", "shake", "shake_water", "strip_constrained_bonded",
]
