"""Force-field parameters of an input structure, derived from the frozen
tables alone: amber bonds, angles, proper and improper torsions, LJ 12-6 and
Coulomb with amber 1-4 scaling, generalized Born (OBC2: mbondi2 radii, HCT
screening, one alpha / beta / gamma; GBn2: mbondi3 radii, per-element
screening and alpha / beta / gamma, the neck, whose d0 / m0 ``reference/
neck.py`` works out), hydrogen mass repartitioning. Every array is host
float64 (indices int64); nothing here touches a device.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np

from .frozen import ff_params as ff
from .frozen.gbn2 import (GBN2_ABG_DEFAULT, GBN2_ALPHA_BETA_GAMMA, GBN2_NECK_SCALE,
                          GBN2_OFFSET, GBN2_SCREEN, GBN2_SCREEN_DEFAULT)
from .frozen.pdb import read_pdb
from .frozen.topology import build_topology

_NM = 0.1                      # Angstrom -> nm
_KCAL = ff.KCAL_TO_KJ
#: OpenMM's GBSAOBCForce / GBn2 constants (nm, kJ/mol)
SOLVENT_DIELECTRIC = 78.5
SOLUTE_DIELECTRIC = 1.0
SURFACE_TENSION = 28.3919551
PROBE_RADIUS = 0.14            # the water probe (nm)
COULOMB = 138.93545764438198


def _torsions(topology):
    idx, k, n, phase = [], [], [], []
    for quad in topology.proper_dihedrals():
        types = [topology.atom_types[int(a)] for a in quad]
        for divider, pk, phase_deg, periodicity in ff.lookup_dihedral(*types):
            if pk != 0.0:
                idx.append([int(a) for a in quad])
                k.append(pk / divider * _KCAL)
                n.append(float(periodicity))
                phase.append(math.radians(phase_deg))
    for a, b, c, d in topology.improper_candidates():
        outer = [a, b, d]
        for li in range(3):
            i, j = (outer[x] for x in range(3) if x != li)
            l = outer[li]
            p = ff.lookup_improper(topology.atom_types[i], topology.atom_types[j],
                                   topology.atom_types[c], topology.atom_types[l])
            if p is not None:
                pk, phase_deg, periodicity = p
                idx.append([int(i), int(j), int(c), int(l)])
                k.append(pk * _KCAL)
                n.append(float(periodicity))
                phase.append(math.radians(phase_deg))
                break
    return (np.asarray(idx, np.int64).reshape(-1, 4), np.asarray(k), np.asarray(n),
            np.asarray(phase))


def _gb(topology, gb_model: str):
    """Radii (nm), screening, (N, 3) alpha / beta / gamma, the dielectric
    offset (nm) and the neck's scale of ``gb_model``."""
    if gb_model not in ("obc2", "gbn2"):
        raise ValueError(f"gb_model must be obc2 or gbn2, not {gb_model!r}")
    gbn2 = gb_model == "gbn2"
    n = topology.n_atoms
    radii = np.zeros(n)
    neighbors = topology.neighbor_sets()
    for i in range(n):
        elem = topology.elements[i]
        r = ff.GB_RADII_BY_ELEMENT[elem]                 # mbondi2
        if elem == "H":
            heavy = next(iter(neighbors[i]), None)
            if heavy is not None and topology.elements[heavy] == "N":
                r = ff.GB_RADIUS_H_ON_N
        name, resn = topology.atom_names[i], topology.residue_names[i]
        if gbn2 and elem == "O" and (name == "OXT" or (
                name in {"OD1", "OD2", "OE1", "OE2"} and resn in ("ASP", "GLU", "CASP", "CGLU"))):
            r = 1.40                                     # mbondi3
        if gbn2 and elem == "H" and resn == "ARG" and name in {"HE", "HH11", "HH12", "HH21",
                                                               "HH22"}:
            r = 1.17                                     # mbondi3
        radii[i] = r * _NM
    if gbn2:
        screen = np.asarray([GBN2_SCREEN.get(e, GBN2_SCREEN_DEFAULT) for e in topology.elements])
        abg = np.asarray([GBN2_ALPHA_BETA_GAMMA.get(e, GBN2_ABG_DEFAULT)
                          for e in topology.elements])
        return radii, screen, abg, GBN2_OFFSET, GBN2_NECK_SCALE
    screen = np.asarray([ff.GB_SCREEN_BY_ELEMENT[e] for e in topology.elements])
    abg = np.tile([ff.OBC2_ALPHA, ff.OBC2_BETA, ff.OBC2_GAMMA], (n, 1))
    return radii, screen, abg, ff.GB_DIELECTRIC_OFFSET, 0.0


def _hmr(masses, bonds, is_h, hydrogen_mass):
    masses = masses.copy()
    for a, b in bonds:
        h, heavy = (a, b) if is_h[a] else (b, a)
        if is_h[h] and not is_h[heavy]:
            delta = hydrogen_mass - masses[h]
            masses[h] += delta
            masses[heavy] -= delta
    return masses


def system_params(pdb: "str | Path", hydrogen_mass: float = 3.0,
                  gb_model: str = "gbn2") -> Dict[str, np.ndarray]:
    """Every parameter of the implicit-solvent system of ``pdb`` under
    ``gb_model`` (``"obc2"`` or ``"gbn2"``), and its positions (nm). The
    GBn2 neck's d0 / m0 are not here: ``Reference`` works them out, so that
    a run's set-up, which reads the topology from here, does not pay for
    them."""
    topology = build_topology(read_pdb(pdb))
    n = topology.n_atoms
    t = topology.atom_types
    bonds = np.asarray(topology.bonds, np.int64).reshape(-1, 2)
    bond_k, bond_r0 = [], []
    for a, b in bonds:
        k, r0 = ff.lookup_bond(t[a], t[b])
        bond_k.append(2.0 * k * _KCAL / _NM ** 2)       # E = k (r - r0)^2 -> 0.5 k' (..)^2
        bond_r0.append(r0 * _NM)
    angles = np.asarray([list(a) for a in topology.angles()], np.int64).reshape(-1, 3)
    angle_k, angle_t0 = [], []
    for i, j, k in angles:
        ka, t0 = ff.lookup_angle(t[i], t[j], t[k])
        angle_k.append(2.0 * ka * _KCAL)
        angle_t0.append(math.radians(t0))
    tors_idx, tors_k, tors_n, tors_phase = _torsions(topology)
    lj = np.asarray([ff.TYPE_LJ[x] for x in t])
    sigma = 2.0 * lj[:, 0] * 2.0 ** (-1.0 / 6.0) * _NM
    eps = lj[:, 1] * _KCAL
    scale_e, scale_l = np.ones((n, n)), np.ones((n, n))
    np.fill_diagonal(scale_e, 0.0)
    np.fill_diagonal(scale_l, 0.0)
    excl, pairs14 = topology.exclusion_maps()
    for i, j in excl:
        scale_e[i, j] = scale_e[j, i] = scale_l[i, j] = scale_l[j, i] = 0.0
    for i, j in pairs14:
        scale_e[i, j] = scale_e[j, i] = ff.SCEE
        scale_l[i, j] = scale_l[j, i] = ff.SCNB
    radii, screen, abg, offset, neck_scale = _gb(topology, gb_model)
    masses = np.asarray([ff.TYPE_MASSES[x] for x in t], np.float64)
    is_h = np.asarray([ff.TYPE_ELEMENTS.get(x, "X") == "H" for x in t])
    if hydrogen_mass is not None:
        masses = _hmr(masses, bonds, is_h, hydrogen_mass)
    return {
        "positions": np.asarray(topology.positions, np.float64),
        "masses": masses, "charges": np.asarray(topology.charges, np.float64),
        "bond_idx": bonds, "bond_k": np.asarray(bond_k), "bond_r0": np.asarray(bond_r0),
        "angle_idx": angles, "angle_k": np.asarray(angle_k),
        "angle_t0": np.asarray(angle_t0),
        "tors_idx": tors_idx, "tors_k": tors_k, "tors_n": tors_n, "tors_phase": tors_phase,
        "sigma": sigma, "eps": eps, "scale_e": scale_e, "scale_l": scale_l,
        "gb_radii": radii, "gb_screen": screen, "gb_alpha": abg[:, 0],
        "gb_beta": abg[:, 1], "gb_gamma": abg[:, 2], "gb_model": gb_model,
        "gb_offset": offset, "gb_neck_scale": neck_scale,
        "atom_names": list(topology.atom_names), "residue_ids": list(topology.residue_ids),
    }


__all__ = ["system_params", "COULOMB",
           "SOLUTE_DIELECTRIC", "SOLVENT_DIELECTRIC", "SURFACE_TENSION", "PROBE_RADIUS"]
