"""Holonomic constraints: parallel SHAKE/RATTLE for X-H bonds and the
exact rigid-water solver.

Port of ``pmarlo_tpu/md/constraints.py``. X-H bonds: the same
Jacobi-style iteration (every constraint computes its correction from one
iterate, corrections add up), a fixed iteration count, and positions or
velocities with leading replica dimensions ``(..., N, 3)``. X-H
constraints form stars (a heavy atom with 1-3 hydrogens), on which Jacobi
converges in a few sweeps. Two layouts (``build_h_constraints(layout=)``):

- ``"onehot"`` (the port's default): JAX's one-hot scatter matmuls become
  index gathers and, an iteration, one fixed-order sum of each atom's
  corrections (``analytic.RowSums``), so the step paths add in one order
  whatever the batch (``ConstraintSpec``);
- ``"rolled"`` (JAX's default): JAX's ``RolledConstraintSpec``, the
  constraints grouped by index offset into ``(G, N)`` masks, field for
  field. Its solve is the index layout's: the spec reads its pairs
  ``(i, i + delta_g)`` off the masks once into a ``ConstraintSpec``, which
  ``shake_rolled`` / ``rattle_rolled`` (and ``shake`` / ``rattle``) run; a
  card gathers natively, so the roll passes would be a second, slower
  solver of the same iteration.

Rigid water (``RigidWaterSpec``): the three coupled distance constraints
of a water triangle make Jacobi SHAKE/RATTLE unstable in dynamics, so each
water's cluster is solved exactly: Newton iterations with a closed-form
3x3 solve for positions (``shake_water``), one linear 3x3 solve for
velocities (``rattle_water``), batched over waters and replicas.
``build_h_constraints`` returns a ``CompositeConstraintSpec`` (X-H
constraints of the solute + the water block) for systems with waters.
Four- and five-site waters (TIP4P-Ew's M, TIP5P's L1 / L2 after O, H1, H2)
are a block of stride 4 or 5: the solve takes O, H1 and H2 of each
residue, and the massless site rows ride along unconstrained
(``md/vsites.py`` re-derives them after every solve).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .._device import default_device
from .analytic import RowSums
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

    def rows(self, n: int) -> RowSums:
        """The fixed-order sums of each atom's correction rows
        (``analytic.RowSums`` over ``idx_both`` onto ``n`` atoms): the same
        bits from call to call and for any batch. Built at the first use
        (one host read) and kept."""
        rows = self.__dict__.get("_rows")
        if rows is None or rows.shape[1] != n:
            rows = RowSums(self.idx_both, n)
            object.__setattr__(self, "_rows", rows)
        return rows

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
    system: System, n_iter: int = 30, layout: str = "onehot",
) -> "Union[ConstraintSpec, RolledConstraintSpec, CompositeConstraintSpec, None]":
    """Constraints for every bond involving a hydrogen (OpenMM HBonds), or
    ``None`` when there is none. A system with waters gets a
    ``CompositeConstraintSpec``: the waters (one contiguous block of
    (O, H1, H2[, M | L1, L2]) residues) go to the exact rigid solver, every
    other X-H bond to the Jacobi iteration, in the index layout
    (``layout="onehot"``, ``ConstraintSpec``) or the roll layout
    (``"rolled"``, ``RolledConstraintSpec``). The port keeps ``"onehot"``
    as its default, where JAX defaults to ``"rolled"``; both give the same
    constrained positions."""
    if layout not in ("rolled", "onehot"):
        raise ValueError(f"unknown constraint layout {layout!r}")
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
    if pairs.shape[0] and layout == "rolled":
        # float32 masses, as JAX takes 1/m
        protein_spec = _build_rolled_spec(pairs, r0, _host(system.masses), n_iter,
                                          device=system.device)
    elif pairs.shape[0]:
        if np.any(masses[pairs.reshape(-1)] <= 0.0):
            raise ValueError("constraint pair references a massless (virtual-site) atom")
        # massless rows are virtual sites, whose 1/m no constraint reads
        inv_m = np.divide(1.0, masses, out=np.zeros_like(masses), where=masses > 0.0)
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


def _corrections(spec: ConstraintSpec, d: torch.Tensor, n: int):
    """The row sums onto ``n`` atoms and each atom's bond vectors ``d``
    weighted by -1/m1 (first atom) or +1/m2 (second), ``(..., D, n, 3)``:
    an iteration then adds ``(k_rows * weighted).sum(-3)``, each atom's
    corrections summed before they are added to it, as the JAX scatter
    matmuls sum them, in one fixed order."""
    rows = spec.rows(n)
    return rows, rows.gather(torch.cat([d, d], -2) * spec.weights[:, None])


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
    if isinstance(spec, RolledConstraintSpec):
        spec = spec.indexed
    d_ref = _pair_vectors(spec, x_ref)
    rows, weighted = _corrections(spec, d_ref, x_new.shape[-2])
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
        g = g[..., None]
        x = x + (rows.gather(g, g) * weighted).sum(-3)
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
    if isinstance(spec, RolledConstraintSpec):
        spec = spec.indexed
    d = _pair_vectors(spec, x)
    rows, weighted = _corrections(spec, d, v.shape[-2])
    denom = torch.linalg.vecdot(d, d) * spec.inv_mass_sum + 1e-12
    for _ in range(max(spec.n_iter // 2, 5)):
        k = (torch.linalg.vecdot(d, _pair_vectors(spec, v)) / denom)[..., None]
        v = v + (rows.gather(k, k) * weighted).sum(-3)
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
    if isinstance(spec, RolledConstraintSpec):
        spec = spec.indexed
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


# --- roll layout ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RolledConstraintSpec:
    """X-H constraints in JAX's roll layout: constraint c = (i, i + delta_g).

    H constraints are intra-residue, so their index offsets are small;
    JAX groups them by offset (layered where a base atom repeats) into
    ``(G, N)`` tensors defined at each constraint's base atom. Fields as
    JAX's: the distinct offsets, each group's row among them, and those
    tensors. ``indexed`` is the same constraints as an index
    ``ConstraintSpec`` (group by group, base atoms ascending), which the
    solvers run."""

    deltas: Tuple[int, ...]
    #: per group, the index into ``deltas`` of its offset
    d_idx: Tuple[int, ...]
    mask: torch.Tensor          # (G, N)
    d0: torch.Tensor            # (G, N)
    inv_m1: torch.Tensor        # (G, N) 1/m_i at base slots
    inv_m2: torch.Tensor        # (G, N) 1/m_j at base slots
    inv_mass_sum: torch.Tensor  # (G, N)
    n_iter: int = 30

    def __post_init__(self):
        # each set mask entry (g, i) is the pair (i, (i + delta_g) mod N),
        # the partner torch.roll(x, -delta_g) puts at i; read off once
        on = self.mask > 0
        g, i = np.nonzero(on.cpu().numpy())
        offset = np.asarray(self.deltas, np.int64)[np.asarray(self.d_idx, np.int64)[g]]
        dev = self.mask.device
        object.__setattr__(self, "indexed", ConstraintSpec(
            idx1=torch.as_tensor(i, device=dev),
            idx2=torch.as_tensor((i + offset) % on.shape[1], device=dev),
            d0=self.d0[on], inv_m1=self.inv_m1[on], inv_m2=self.inv_m2[on],
            inv_mass_sum=self.inv_mass_sum[on], n_iter=self.n_iter,
        ))

    @property
    def n_constraints(self) -> int:
        return self.indexed.n_constraints

    def to(self, device) -> "RolledConstraintSpec":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def _build_rolled_spec(pairs: np.ndarray, r0: np.ndarray, masses: np.ndarray,
                       n_iter: int, device=None) -> RolledConstraintSpec:
    """The roll-layout spec of constraint ``pairs`` (C, 2) with targets
    ``r0``, on ``device`` (``None``: ``_device.default_device()``); the
    numpy of the JAX package's ``_build_rolled_spec``, copied."""
    from .bonded_roll import _layered_groups

    device = torch.device(device) if device is not None else default_device()
    n = masses.shape[0]
    # massless rows are virtual sites: they never carry constraints
    # (positions are parent-derived), so their 1/m is never consumed,
    # but a bare divide would warn for every site row
    if np.any(masses[pairs.reshape(-1)] <= 0.0):
        raise ValueError(
            "constraint pair references a massless (virtual-site) atom"
        )
    safe = np.where(masses > 0.0, masses, 1.0)
    inv_m = np.where(masses > 0.0, 1.0 / safe, 0.0)
    # layered offset groups; params carried per-constraint
    groups = _layered_groups(
        pairs, [r0, inv_m[pairs[:, 0]], inv_m[pairs[:, 1]],
                inv_m[pairs[:, 0]] + inv_m[pairs[:, 1]]], n,
    )
    deltas = sorted({sig[0] for sig, _, _ in groups})
    d_index = {d: i for i, d in enumerate(deltas)}
    d_idx = np.asarray([d_index[sig[0]] for sig, _, _ in groups], np.int32)
    mask = np.stack([m for _, m, _ in groups])
    p0 = np.stack([ps[0] for _, _, ps in groups])
    p1 = np.stack([ps[1] for _, _, ps in groups])
    p2 = np.stack([ps[2] for _, _, ps in groups])
    p3 = np.stack([ps[3] for _, _, ps in groups])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return RolledConstraintSpec(
        deltas=tuple(int(d) for d in deltas),
        d_idx=tuple(int(i) for i in d_idx),
        mask=f32(mask), d0=f32(p0), inv_m1=f32(p1), inv_m2=f32(p2),
        inv_mass_sum=f32(p3), n_iter=int(n_iter),
    )


def shake_rolled(spec: RolledConstraintSpec, x_new: torch.Tensor, x_ref: torch.Tensor,
                 omega: float = 1.0) -> torch.Tensor:
    """Parallel SHAKE of positions ``(..., N, 3)`` under a roll-layout
    spec: ``shake`` of its index form."""
    return shake(spec.indexed, x_new, x_ref, omega)


def rattle_rolled(spec: RolledConstraintSpec, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Parallel RATTLE of velocities ``(..., N, 3)`` under a roll-layout
    spec: ``rattle`` of its index form."""
    return rattle(spec.indexed, v, x)


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
    """Exact rigid-water constraints for one contiguous block of waters laid
    out (O, H1, H2) per residue, followed by their virtual sites (``stride``
    4: TIP4P-Ew's M; 5: TIP5P's L1, L2), so the block is a reshape, not a
    gather."""

    start: int                  # first atom of the block
    n_waters: int
    inv_m: torch.Tensor         # (3,) 1/m of (O, H1, H2)
    d0: torch.Tensor            # (3,) targets of (O-H1, O-H2, H1-H2)
    n_newton: int = 6
    #: atoms a water residue: 3 (TIP3P), 4 (TIP4P-Ew) or 5 (TIP5P); the
    #: site rows after O, H1, H2 are left to ``md/vsites.py``
    stride: int = 3

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
        """From the JAX package's ``RigidWaterSpec`` (3-, 4- or 5-site
        water), on ``device`` (``None``: ``_device.default_device()``)."""
        device = torch.device(device) if device is not None else default_device()
        return cls(start=int(spec.start), n_waters=int(spec.n_waters),
                   inv_m=torch.tensor(np.asarray(spec.inv_m, np.float32), device=device),
                   d0=torch.tensor(np.asarray(spec.d0, np.float32), device=device),
                   n_newton=int(spec.n_newton), stride=int(getattr(spec, "stride", 3)))


@dataclasses.dataclass(frozen=True)
class CompositeConstraintSpec:
    """X-H constraints of the solute (Jacobi) + the rigid-water block
    (exact); the clusters are disjoint, so the two solvers compose."""

    protein: Optional[Union[ConstraintSpec, RolledConstraintSpec]]
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
    # 3-site (TIP3P), 4-site (TIP4P-Ew: a trailing massless M) or 5-site
    # (TIP5P: trailing L1 / L2 lone pairs)
    if len(names) >= 5 and names[3] == "L1":
        stride = 5
    elif len(names) >= 4 and names[3] == "M":
        stride = 4
    else:
        stride = 3
    n_w = (stop - start) // stride
    want = ["O", "H1", "H2"] + {3: [], 4: ["M"], 5: ["L1", "L2"]}[stride]
    if (stop - start != stride * n_w or not water_atoms[start:stop].all()
            or names != want * n_w):
        raise ValueError(
            "rigid-water constraints need one contiguous (O, H1, H2[, M | L1, L2])-"
            "ordered water block (the canonical solvate/topology layout)")
    # O-H target from the first water O's bond term (rows under 0.08 nm are
    # the zero-stiffness O-M / O-L site bonds); a topology whose water
    # bonds were already stripped falls back to the TIP3P geometry
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
        stride=stride,
    )


def _residues(spec: RigidWaterSpec, x: torch.Tensor) -> torch.Tensor:
    """The water block as ``(..., W, stride, 3 xyz)`` (a view)."""
    stop = spec.start + spec.stride * spec.n_waters
    return x[..., spec.start:stop, :].unflatten(-2, (spec.n_waters, spec.stride))


def _water_block(spec: RigidWaterSpec, x: torch.Tensor) -> torch.Tensor:
    """O, H1 and H2 of every water as ``(..., W, 3 atoms, 3 xyz)`` (a view)."""
    return _residues(spec, x)[..., :3, :]


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
    _residues(spec, out)[..., :3, :] = block
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
    "CompositeConstraintSpec", "ConstraintSpec", "RigidWaterSpec", "RolledConstraintSpec",
    "build_h_constraints", "constraint_violation", "n_constraints", "rattle",
    "rattle_rolled", "rattle_water", "shake", "shake_rolled", "shake_water",
    "strip_constrained_bonded",
]
