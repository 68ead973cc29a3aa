"""Idealized B-DNA single-strand builder (test/demo geometry).

No DNA structure ships with the reference's assets, so DNA-capable tests
need a generator. This builds APPROXIMATE coordinates — planar idealized
bases, a planar sugar pentagon, helically stacked nucleotides (rise
3.38 A, twist 36 deg) — good enough for ``minimize_energy`` to relax
into a proper conformation; it is a test asset, not a modeling tool
(the prep layer accepts real PDB/mmCIF DNA the same as protein).

Geometry recipe per nucleotide: the sugar ring is a regular pentagon in
the xy-plane around the helix axis at radius ~0.59 nm, C5'/O5'/P extend
backbone-ward (toward the previous nucleotide's O3'), and the base is a
planar ring system pointing inward (toward the axis). Hydrogens are NOT
generated — ``Protein.prepare()``/``add_hydrogens`` places them from the
templates, exercising the same path real structures take.

Host copy of ``pmarlo_tpu/data/dna.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure

#: planar base-frame coordinates (Angstrom, base plane = local xy).
#: Rings built as regular polygons with ~1.37 A aromatic bonds and
#: exocyclic substituents radially outward at ~1.35 A; minimization
#: relaxes to the force-field geometry.


def _ring(n: int, bond: float, start_angle: float = 0.0):
    R = bond / (2.0 * math.sin(math.pi / n))
    return [
        (R * math.cos(start_angle + 2.0 * math.pi * k / n),
         R * math.sin(start_angle + 2.0 * math.pi * k / n))
        for k in range(n)
    ]


def _purine() -> Dict[str, Tuple[float, float]]:
    """Fused 6+5 ring: N1 C2 N3 C4 C5 C6 (hexagon), N7 C8 N9 (pentagon
    fused on C4-C5). Returns 2D coordinates keyed by atom name."""
    hexagon = _ring(6, 1.38)
    names6 = ["N1", "C2", "N3", "C4", "C5", "C6"]
    pos = {n: hexagon[i] for i, n in enumerate(names6)}
    c4 = np.asarray(pos["C4"]); c5 = np.asarray(pos["C5"])
    mid = 0.5 * (c4 + c5)
    out = mid / np.linalg.norm(mid)    # outward from hexagon center
    # pentagon apex chain N9 (bonded C4), C8, N7 (bonded C5)
    pos["N9"] = tuple(c4 + 1.37 * (out * 0.81 + (c4 - c5) * 0.31))
    pos["N7"] = tuple(c5 + 1.37 * (out * 0.81 + (c5 - c4) * 0.31))
    pos["C8"] = tuple(mid + out * 2.15)
    return pos


def _pyrimidine() -> Dict[str, Tuple[float, float]]:
    hexagon = _ring(6, 1.38)
    names = ["N1", "C2", "N3", "C4", "C5", "C6"]
    return {n: hexagon[i] for i, n in enumerate(names)}


def _subst(pos, parent, other_a, other_b, dist):
    """Place a substituent on ``parent`` opposite the bisector of its
    ring neighbors."""
    p = np.asarray(pos[parent])
    u = p - 0.5 * (np.asarray(pos[other_a]) + np.asarray(pos[other_b]))
    u = u / np.linalg.norm(u)
    return tuple(p + dist * u)


def _base_atoms(resname: str) -> Dict[str, Tuple[float, float]]:
    if resname in ("DA", "DG", "A", "G"):
        pos = _purine()
        if resname in ("DA", "A"):
            pos["N6"] = _subst(pos, "C6", "N1", "C5", 1.34)
        else:
            pos["O6"] = _subst(pos, "C6", "N1", "C5", 1.23)
            pos["N2"] = _subst(pos, "C2", "N1", "N3", 1.34)
        return pos
    pos = _pyrimidine()
    pos["O2"] = _subst(pos, "C2", "N1", "N3", 1.23)
    if resname in ("DC", "C"):
        pos["N4"] = _subst(pos, "C4", "N3", "C5", 1.34)
    else:  # DT / U (uracil = thymine minus the C7 methyl)
        pos["O4"] = _subst(pos, "C4", "N3", "C5", 1.23)
        if resname == "DT":
            pos["C7"] = _subst(pos, "C5", "C4", "C6", 1.50)
    return pos


#: glycosidic nitrogen per base
_GLYCO = {"DA": "N9", "DG": "N9", "DC": "N1", "DT": "N1",
          "A": "N9", "G": "N9", "C": "N1", "U": "N1"}

_RISE = 3.38       # A
_TWIST = math.radians(36.0)


def _nucleotide_atoms(resname: str, k: int, first: bool) -> List[Tuple[str, np.ndarray]]:
    """Heavy atoms of nucleotide k on an ideal helix (Angstrom)."""
    # sugar: regular pentagon C1'-C2'-C3'-C4'-O4' in a plane tilted off
    # the helix axis, centered at radius 5.9 A
    theta = k * _TWIST
    z = k * _RISE
    rot = np.array([[math.cos(theta), -math.sin(theta), 0.0],
                    [math.sin(theta), math.cos(theta), 0.0],
                    [0.0, 0.0, 1.0]])

    def place(local):
        return rot @ (np.asarray(local, float)) + np.array([0.0, 0.0, z])

    ring = _ring(5, 1.50)
    sugar_names = ["C1'", "C2'", "C3'", "C4'", "O4'"]
    atoms: List[Tuple[str, np.ndarray]] = []
    # sugar plane: xz-ish plane at y = 5.9, ring slightly tilted
    for name, (a, b) in zip(sugar_names, ring):
        local = np.array([a, 5.9, 0.55 * b])
        atoms.append((name, place(local)))
    sugar = dict(atoms)
    # backbone branch: C5' off C4', O5' up-chain (toward k-1), O3' down
    c4 = sugar["C4'"]; c3 = sugar["C3'"]
    axis_dir = np.array([0.0, 0.0, 1.0])
    outward = np.array([math.cos(theta) * 0.0 - math.sin(theta) * 1.0,
                        math.sin(theta) * 0.0 + math.cos(theta) * 1.0,
                        0.0])
    atoms.append(("C5'", c4 + 1.51 * (0.55 * outward - 0.76 * axis_dir
                                      + 0.34 * np.cross(outward, axis_dir))))
    c5 = dict(atoms)["C5'"]
    atoms.append(("O5'", c5 + 1.42 * (0.42 * outward - 0.82 * axis_dir
                                      - 0.39 * np.cross(outward, axis_dir))))
    o5 = dict(atoms)["O5'"]
    if not first:
        atoms.append(("P", o5 + 1.60 * (0.10 * outward - 0.90 * axis_dir
                                        + 0.42 * np.cross(outward, axis_dir))))
        p = dict(atoms)["P"]
        atoms.append(("OP1", p + 1.48 * (0.95 * outward
                                         + 0.31 * np.cross(outward, axis_dir))))
        atoms.append(("OP2", p + 1.48 * (-0.40 * outward - 0.35 * axis_dir
                                         - 0.85 * np.cross(outward, axis_dir))))
    atoms.append(("O3'", c3 + 1.42 * (0.25 * outward + 0.91 * axis_dir
                                      + 0.33 * np.cross(outward, axis_dir))))
    if resname in ("A", "G", "C", "U"):
        # ribose 2'-hydroxyl: off C2', away from the ring centroid and
        # tilted out of the sugar plane on the side OPPOSITE the base
        # (which points inward); minimization relaxes the exact pucker
        ring_pts = np.stack([sugar[n] for n in sugar_names])
        centroid = ring_pts.mean(axis=0)
        c2 = sugar["C2'"]
        u = c2 - centroid
        u = u / np.linalg.norm(u)
        nrm = np.cross(ring_pts[1] - ring_pts[0], ring_pts[2] - ring_pts[0])
        nrm = nrm / max(np.linalg.norm(nrm), 1e-9)
        inward = -outward
        if float(np.dot(nrm, inward)) > 0.0:
            nrm = -nrm
        atoms.append(("O2'", c2 + 1.41 * (0.7 * u + 0.714 * nrm)))
    # base: planar system attached at the glycosidic N, pointing inward
    base2d = _base_atoms(resname)
    glyco = _GLYCO[resname]
    g2 = np.asarray(base2d[glyco])
    c1 = sugar["C1'"]
    inward = -outward
    side = np.cross(inward, axis_dir)
    origin = c1 + 1.47 * inward
    for name, (a, b) in base2d.items():
        rel = np.asarray([a, b]) - g2
        atoms.append((name, origin + rel[0] * inward + rel[1] * side))
    return atoms


def dna_single_strand(sequence: str = "GATC", chain: str = "X",
                      resid_start: int = 1) -> PDBStructure:
    """Idealized single-strand B-DNA (heavy atoms only, nm units)."""
    seq = [f"D{b.upper()}" for b in sequence]
    for r in seq:
        if r not in _GLYCO:
            raise ValueError(f"unknown base {r!r} (use A/C/G/T)")
    return _strand(seq, chain, resid_start)


def rna_single_strand(sequence: str = "GACU", chain: str = "X",
                      resid_start: int = 1) -> PDBStructure:
    """Idealized single-strand RNA (heavy atoms incl. O2', nm units).

    Same idealized-helix recipe as :func:`dna_single_strand` (the
    B-form rise/twist is only a starting guess — A-form parameters
    would relax identically under minimization); ribose gains the
    2'-hydroxyl oxygen, uracil is thymine minus the methyl."""
    seq = [b.upper() for b in sequence]
    for r in seq:
        if r not in ("A", "C", "G", "U"):
            raise ValueError(f"unknown base {r!r} (use A/C/G/U)")
    return _strand(seq, chain, resid_start)


def _strand(seq, chain: str, resid_start: int) -> PDBStructure:
    per_res: List[List[Tuple[str, np.ndarray]]] = [
        _nucleotide_atoms(resname, k, first=(k == 0))
        for k, resname in enumerate(seq)
    ]
    # chain the backbone: phosphate k sits ON the O3'(k-1) -> O5'(k)
    # segment 1.6 A from O3', guaranteeing a bondable O3'-P distance
    # regardless of the idealized helix parameters (the template matcher
    # links segments by O3'->P proximity; minimization relaxes the rest)
    for k in range(1, len(per_res)):
        prev = dict(per_res[k - 1])
        cur = dict(per_res[k])
        o3 = prev["O3'"]
        o5 = cur["O5'"]
        d = o5 - o3
        u = d / np.linalg.norm(d)
        p = o3 + 1.60 * u
        perp = np.cross(u, [0.0, 0.0, 1.0])
        perp = perp / max(np.linalg.norm(perp), 1e-9)
        perp2 = np.cross(u, perp)
        repl = {"P": p, "OP1": p + 1.48 * (0.82 * perp + 0.50 * perp2),
                "OP2": p + 1.48 * (-0.82 * perp + 0.50 * perp2)}
        per_res[k] = [(n, repl.get(n, x)) for n, x in per_res[k]]
    residues = []
    for k, resname in enumerate(seq):
        resid = resid_start + k
        residues.append(PDBResidue(
            name=resname, resid=resid, chain=chain,
            atoms=[PDBAtom(name=n, resname=resname, resid=resid,
                           chain=chain, xyz=tuple(np.asarray(x) / 10.0),
                           element=("P" if n == "P" else n[0]))
                   for n, x in per_res[k]],
        ))
    return PDBStructure(residues=residues)


__all__ = ["dna_single_strand", "rna_single_strand"]
