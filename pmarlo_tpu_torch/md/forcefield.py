"""System assembly: topology + parameter tables -> the port's ``System``.

Port of ``pmarlo_tpu/md/forcefield.py``. The parameter tables are built by
the same host numpy helpers over the copied topology, ``ff_params`` and
``gbn2`` modules, then placed on ``device`` as tensors. Only the implicit
solvent / vacuum path is ported: a periodic box is ROADMAP queue A12.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..io.pdb import PDBStructure, read_pdb
from ..utils.errors import ForceFieldError
from . import ff_params as ff
from .system import System, hydrogen_mass_repartition
from .topology import Topology, build_topology

_ANG_TO_NM = 0.1
_KCAL = ff.KCAL_TO_KJ


def _bond_arrays(topology: Topology):
    idx, ks, r0s = [], [], []
    errors = []
    for a, b in topology.bonds:
        ta, tb = topology.atom_types[int(a)], topology.atom_types[int(b)]
        try:
            k_amber, r0_ang = ff.lookup_bond(ta, tb)
        except KeyError as exc:
            errors.append(str(exc))
            continue
        idx.append((int(a), int(b)))
        # amber E = k (r-r0)^2  ->  ours E = 0.5 k' (r-r0)^2, k' = 2 k
        ks.append(2.0 * k_amber * _KCAL / (_ANG_TO_NM**2))
        r0s.append(r0_ang * _ANG_TO_NM)
    if errors:
        raise ForceFieldError("missing bond parameters:\n  " + "\n  ".join(sorted(set(errors))))
    return np.asarray(idx, dtype=np.int32).reshape(-1, 2), np.asarray(ks), np.asarray(r0s)


def _angle_arrays(topology: Topology):
    idx, ks, t0s = [], [], []
    errors = []
    for i, j, k in topology.angles():
        ti, tj, tk = (topology.atom_types[int(x)] for x in (i, j, k))
        try:
            k_amber, t0_deg = ff.lookup_angle(ti, tj, tk)
        except KeyError as exc:
            errors.append(str(exc))
            continue
        idx.append((int(i), int(j), int(k)))
        ks.append(2.0 * k_amber * _KCAL)
        t0s.append(math.radians(t0_deg))
    if errors:
        raise ForceFieldError("missing angle parameters:\n  " + "\n  ".join(sorted(set(errors))))
    return np.asarray(idx, dtype=np.int32).reshape(-1, 3), np.asarray(ks), np.asarray(t0s)


def _torsion_arrays(topology: Topology):
    idx, ks, ns, phases = [], [], [], []
    errors = []
    for i, j, k, l in topology.proper_dihedrals():
        ti, tj, tk, tl = (topology.atom_types[int(x)] for x in (i, j, k, l))
        try:
            terms = ff.lookup_dihedral(ti, tj, tk, tl)
        except KeyError as exc:
            errors.append(str(exc))
            continue
        for divider, pk, phase_deg, periodicity in terms:
            if pk == 0.0:
                continue
            idx.append((int(i), int(j), int(k), int(l)))
            ks.append(pk / divider * _KCAL)
            ns.append(float(periodicity))
            phases.append(math.radians(phase_deg))
    if errors:
        raise ForceFieldError(
            "missing dihedral parameters:\n  " + "\n  ".join(sorted(set(errors)))
        )
    # impropers: trivalent centers, central atom third
    for a, b, c, d in topology.improper_candidates():
        nbrs = [a, b, d]
        matched = None
        for li in range(3):
            l = nbrs[li]
            i, j = (nbrs[x] for x in range(3) if x != li)
            params = ff.lookup_improper(
                topology.atom_types[i], topology.atom_types[j],
                topology.atom_types[c], topology.atom_types[l],
            )
            if params is not None:
                matched = ((i, j, c, l), params)
                break
        if matched is None:
            continue  # many trivalent centers legitimately carry no improper
        (i, j, cc, l), (pk, phase_deg, periodicity) = matched
        idx.append((int(i), int(j), int(cc), int(l)))
        ks.append(pk * _KCAL)
        ns.append(float(periodicity))
        phases.append(math.radians(phase_deg))
    return (
        np.asarray(idx, dtype=np.int32).reshape(-1, 4),
        np.asarray(ks),
        np.asarray(ns),
        np.asarray(phases),
    )


def _nonbonded_arrays(topology: Topology, dense_scales: bool = True):
    n = topology.n_atoms
    sigma = np.zeros(n)
    eps = np.zeros(n)
    for i, t in enumerate(topology.atom_types):
        try:
            rmin_half, eps_kcal = ff.TYPE_LJ[t]
        except KeyError:
            raise ForceFieldError(f"no LJ parameters for atom type {t!r}")
        sigma[i] = 2.0 * rmin_half * (2.0 ** (-1.0 / 6.0)) * _ANG_TO_NM
        eps[i] = eps_kcal * _KCAL
    if not dense_scales:
        # large systems: the sparse excl12/pair14 lists carry the same
        # information (md/cells.py builds its banded scales from them);
        # a 25k-atom solvated box would need 2 x 2.5 GB here otherwise
        return sigma, eps, None, None
    excl, pairs14 = topology.exclusion_maps()
    scale_e = np.ones((n, n))
    scale_l = np.ones((n, n))
    np.fill_diagonal(scale_e, 0.0)
    np.fill_diagonal(scale_l, 0.0)
    for i, j in excl:
        scale_e[i, j] = scale_e[j, i] = 0.0
        scale_l[i, j] = scale_l[j, i] = 0.0
    for i, j in pairs14:
        scale_e[i, j] = scale_e[j, i] = ff.SCEE
        scale_l[i, j] = scale_l[j, i] = ff.SCNB
    return sigma, eps, scale_e, scale_l


def _gb_arrays(topology: Topology, gb_model: str = "obc2",
               dense_tables: bool = True):
    """Per-atom GB radii + screening, plus GBn2 extras.

    obc2: mbondi2 radii + HCT element screening.
    gbn2: mbondi3 radii (mbondi2 with carboxylate O at 1.4 A and ARG
    guanidinium H at 1.17 A), GBn2-optimized screening, per-element
    alpha/beta/gamma, and the pairwise neck d0/m0 lookup (md/gbn2.py).
    """
    n = topology.n_atoms
    radii = np.zeros(n)
    screen = np.zeros(n)
    neighbors = topology.neighbor_sets()
    carboxylate_o = {"OD1", "OD2", "OE1", "OE2", "OXT"}
    arg_h = {"HE", "HH11", "HH12", "HH21", "HH22"}
    for i in range(n):
        elem = topology.elements[i]
        if elem not in ff.GB_RADII_BY_ELEMENT:
            raise ForceFieldError(f"no GB radius for element {elem!r}")
        r = ff.GB_RADII_BY_ELEMENT[elem]
        if elem == "H":
            # mbondi2: hydrogens on nitrogen get 1.3 A
            heavy = next(iter(neighbors[i]), None)
            if heavy is not None and topology.elements[heavy] == "N":
                r = ff.GB_RADIUS_H_ON_N
        if gb_model == "gbn2":
            name = topology.atom_names[i]
            resn = topology.residue_names[i]
            if elem == "O" and name in carboxylate_o and resn in (
                "ASP", "GLU", "CASP", "CGLU",
            ) or (elem == "O" and name == "OXT"):
                r = 1.40  # mbondi3
            if elem == "H" and resn == "ARG" and name in arg_h:
                r = 1.17  # mbondi3
        radii[i] = r * _ANG_TO_NM
        if gb_model == "gbn2":
            from .gbn2 import GBN2_SCREEN, GBN2_SCREEN_DEFAULT

            screen[i] = GBN2_SCREEN.get(elem, GBN2_SCREEN_DEFAULT)
        else:
            screen[i] = ff.GB_SCREEN_BY_ELEMENT[elem]
    if gb_model != "gbn2":
        return radii, screen, None
    from .gbn2 import (
        GBN2_ABG_DEFAULT,
        GBN2_ALPHA_BETA_GAMMA,
        GBN2_OFFSET,
        lookup_neck,
    )

    abg = np.array([
        GBN2_ALPHA_BETA_GAMMA.get(e, GBN2_ABG_DEFAULT)
        for e in topology.elements
    ])
    rho = radii - GBN2_OFFSET  # neck tables are indexed by offset radii
    extras = {
        "alpha": abg[:, 0], "beta": abg[:, 1], "gamma": abg[:, 2],
        "neck_d0": None, "neck_m0": None,
    }
    if dense_tables:
        # (N, N) lookup for the dense XLA/fused paths; the tiled pair
        # kernel derives (C, C) radius-class matrices instead and large
        # systems skip this build entirely (2 x N^2 floats)
        d0, m0 = lookup_neck(
            rho[:, None].repeat(n, 1), rho[None, :].repeat(n, 0)
        )
        extras["neck_d0"] = d0
        extras["neck_m0"] = m0
    return radii, screen, extras



def build_system(
    source: "str | Path | PDBStructure | Topology",
    *,
    hydrogen_mass: Optional[float] = 3.0,
    implicit_solvent: bool = True,
    gb_model: str = "obc2",
    box: Optional[Tuple[float, float, float]] = None,
    tilt: Optional[Tuple[float, float, float]] = None,
    device="cpu",
    dtype=torch.float32,
) -> Tuple[System, torch.Tensor]:
    """Build a ``System`` and initial positions (nm) from a PDB path,
    structure or topology, as ``pmarlo_tpu.md.forcefield.build_system``
    does on its implicit path. ``gb_model`` is "obc2" or "gbn2";
    ``implicit_solvent=False`` gives vacuum. Returns ``(system, positions)``
    with every tensor on ``device``."""
    if box is not None or tilt is not None:
        raise NotImplementedError(
            "periodic boxes (explicit solvent) are not ported yet "
            "(ROADMAP queue A12)"
        )
    if gb_model not in ("obc2", "gbn2"):
        raise ValueError(f"gb_model must be obc2|gbn2, got {gb_model!r}")
    if isinstance(source, Topology):
        topology = source
    else:
        structure = source if isinstance(source, PDBStructure) else read_pdb(source)
        topology = build_topology(structure, keep_waters=False)
    if topology.vsites is not None:
        raise NotImplementedError(
            "virtual sites are not ported yet (ROADMAP queue A11)"
        )

    bond_idx, bond_k, bond_r0 = _bond_arrays(topology)
    angle_idx, angle_k, angle_t0 = _angle_arrays(topology)
    torsion_idx, torsion_k, torsion_n, torsion_phase = _torsion_arrays(topology)
    sigma, eps, scale_e, scale_l = _nonbonded_arrays(topology, dense_scales=True)
    if implicit_solvent:
        gb_radii, gb_screen, gb_extras = _gb_arrays(
            topology, gb_model=gb_model, dense_tables=True
        )
    else:
        gb_radii = np.full(topology.n_atoms, 0.15)
        gb_screen = np.zeros(topology.n_atoms)
        gb_extras = None

    masses = np.asarray([ff.TYPE_MASSES[t] for t in topology.atom_types])
    if hydrogen_mass is not None:
        is_h = np.asarray(
            [ff.TYPE_ELEMENTS.get(t, "X") == "H" for t in topology.atom_types]
        )
        masses = hydrogen_mass_repartition(
            masses, topology.bonds, hydrogen_mass, is_hydrogen=is_h
        )

    excl, pairs14 = topology.exclusion_maps()
    excl12_idx = np.asarray(sorted(excl), dtype=np.int32).reshape(-1, 2)
    pair14_idx = np.asarray(sorted(pairs14), dtype=np.int32).reshape(-1, 2)

    net_charge = float(topology.charges.sum())
    if abs(net_charge - round(net_charge)) > 5e-3:
        raise ForceFieldError(
            f"non-integer net charge {net_charge:.4f}; template charges inconsistent"
        )

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    def extra(name):
        if gb_extras is None or gb_extras[name] is None:
            return None
        return f(gb_extras[name])

    system = System(
        masses=f(masses),
        charges=f(topology.charges),
        bond_idx=i32(bond_idx),
        bond_k=f(bond_k),
        bond_r0=f(bond_r0),
        angle_idx=i32(angle_idx),
        angle_k=f(angle_k),
        angle_t0=f(angle_t0),
        torsion_idx=i32(torsion_idx),
        torsion_k=f(torsion_k),
        torsion_n=f(torsion_n),
        torsion_phase=f(torsion_phase),
        lj_sigma=f(sigma),
        lj_eps=f(eps),
        scale_elec=f(scale_e),
        scale_lj=f(scale_l),
        gb_radii=f(gb_radii),
        gb_screen=f(gb_screen),
        gb_alpha=extra("alpha"),
        gb_beta=extra("beta"),
        gb_gamma=extra("gamma"),
        gb_neck_d0=extra("neck_d0"),
        gb_neck_m0=extra("neck_m0"),
        excl12_idx=i32(excl12_idx),
        pair14_idx=i32(pair14_idx),
        atom_names=tuple(topology.atom_names),
        atom_types=tuple(topology.atom_types),
        residue_names=tuple(topology.residue_names),
        residue_ids=tuple(topology.residue_ids),
        use_gb=implicit_solvent,
        gb_model=gb_model,
        gb_offset=(0.009 if gb_model == "obc2" else 0.0195141),
        gb_neck_scale=(0.0 if gb_model == "obc2" else 0.826836),
    )
    return system, f(topology.positions)


__all__ = ["build_system"]
