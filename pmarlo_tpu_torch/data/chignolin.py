"""Chignolin from the repository's own solvated structure.

``examples/outputs/explicit_solvent/chignolin_solvated.pdb`` holds
chignolin (10 residues) after ``Protein.prepare`` (hydrogens and termini
added) in a water box with counter-ions. Its protein residues are the
138-atom implicit-solvent test protein, and ``chignolin_assembly`` tiles
them into a multi-chain protein-scale system the way the JAX package
builds its large implicit-solvent stand-ins (``replicate_structure`` with
a 0.6 nm gap; 3 x 3 x 3 copies give 3,726 atoms). ``raw_chignolin_assembly``
strips the assembly of what ``Protein.prepare`` rebuilds, as a raw X-ray
entry would lack it: the raw input of structure preparation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure, read_pdb
from . import replicate_structure

CHIGNOLIN_SOLVATED = (
    Path(__file__).resolve().parents[2]
    / "examples" / "outputs" / "explicit_solvent" / "chignolin_solvated.pdb"
)
_SOLVENT = frozenset({"HOH", "WAT", "TIP3", "SOL", "NA", "CL", "NA+", "CL-"})


def chignolin_structure() -> PDBStructure:
    """The protein residues of the solvated chignolin PDB, without box."""
    if not CHIGNOLIN_SOLVATED.exists():
        raise FileNotFoundError(
            f"{CHIGNOLIN_SOLVATED} is missing; chignolin is read from the "
            "repository's examples/outputs"
        )
    solvated = read_pdb(CHIGNOLIN_SOLVATED)
    residues = [r for r in solvated.residues if r.name not in _SOLVENT]
    return PDBStructure(residues=residues)


def chignolin_assembly(n: Tuple[int, int, int] = (3, 3, 3),
                       gap: float = 0.6) -> PDBStructure:
    """``n`` translated copies of chignolin (138 atoms each)."""
    return replicate_structure(chignolin_structure(), n=n, gap=gap)


#: side-chain atoms stripped from every TYR (all past CB) and TRP (all past
#: CG: with CG gone too, repair threads the rebuilt ring through the
#: backbone in 3 of the 27 copies, a tangle no minimization undoes)
_STRIPPED = {
    "TRP": ("CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
    "TYR": ("CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
}
PHOSPHO_RESIDUE = 8              # THR 8 of every copy becomes TPO
GAP_CHAIN, GAP_RESIDUES = "A", (2, 3)   # TYR 2 and ASP 3 of chain A taken out


def _phosphate(residue: PDBResidue) -> List[PDBAtom]:
    """P on OG1 away from CB (0.16 nm) and three oxygens around it (0.15 nm)."""
    pos = {a.name: np.asarray(a.xyz) for a in residue.atoms}
    u = pos["OG1"] - pos["CB"]
    u /= np.linalg.norm(u)
    w = np.cross(u, [0.0, 0.0, 1.0] if abs(u[2]) < 0.9 else [1.0, 0.0, 0.0])
    w /= np.linalg.norm(w)
    v = np.cross(u, w)
    p = pos["OG1"] + 0.16 * u
    out = [("P", p)]
    for k in range(3):
        t = 2.0 * np.pi * k / 3.0
        d = 0.33 * u + 0.94 * (np.cos(t) * w + np.sin(t) * v)
        out.append((f"O{k + 1}P", p + 0.15 * d / np.linalg.norm(d)))
    return [PDBAtom(name=n, resname="TPO", resid=residue.resid, chain=residue.chain,
                    xyz=tuple(float(c) for c in x), element=n[0]) for n, x in out]


def shifted_residues(residues, shift=(2.5, 0.0, 0.0)) -> List[PDBResidue]:
    """Copies of ``residues`` translated by ``shift`` (nm), as
    ``examples/23_protein_dna_complex.py`` sets a strand beside a protein."""
    return [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=tuple(c + d for c, d in zip(a.xyz, shift)), element=a.element)
        for a in r.atoms]) for r in residues]


def raw_chignolin_assembly(
    n: Tuple[int, int, int] = (3, 3, 3),
) -> Tuple[PDBStructure, Dict[Tuple[str, int, int], List[str]]]:
    """``chignolin_assembly(n)`` stripped of what preparation rebuilds.

    Every hydrogen and every OXT goes, every side-chain atom past CB of each
    TYR and past CG of each TRP; THR 8 of every copy is renamed TPO and
    carries a phosphate (P, O1P-O3P) that ``replace_nonstandard`` drops;
    TYR 2 and ASP 3 of chain A are taken out. Every atom left keeps its
    assembly position. Returns the structure and the gap as
    ``Protein.add_missing_residues`` takes it: {(chain, resid before, resid
    after): [residue names]}."""
    template = chignolin_structure()
    # replicate_structure offsets each copy's resids by this much
    stride = max(r.resid for r in template.residues) + 1
    residues, gap = [], {}
    for r in chignolin_assembly(n).residues:
        first = r.resid - (r.resid - 1) % stride      # the copy's resid 1
        local = r.resid - first + 1
        if r.chain == GAP_CHAIN and local in GAP_RESIDUES:
            key = (r.chain, first + GAP_RESIDUES[0] - 2, first + GAP_RESIDUES[-1])
            gap.setdefault(key, []).append(r.name)
            continue
        drop = _STRIPPED.get(r.name, ())
        atoms = [a for a in r.atoms
                 if a.element != "H" and a.name != "OXT" and a.name not in drop]
        name = r.name
        if local == PHOSPHO_RESIDUE:
            name = "TPO"
            atoms = [PDBAtom(name=a.name, resname=name, resid=a.resid, chain=a.chain,
                             xyz=a.xyz, element=a.element) for a in atoms]
            atoms += _phosphate(PDBResidue(name=name, resid=r.resid, chain=r.chain,
                                           atoms=atoms))
        residues.append(PDBResidue(name=name, resid=r.resid, chain=r.chain, atoms=atoms))
    return PDBStructure(residues=residues), gap


__all__ = ["CHIGNOLIN_SOLVATED", "chignolin_assembly", "chignolin_structure",
           "raw_chignolin_assembly", "shifted_residues"]
