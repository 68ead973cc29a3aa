"""Chignolin from the repository's own solvated structure.

``examples/outputs/explicit_solvent/chignolin_solvated.pdb`` holds
chignolin (10 residues) after ``Protein.prepare`` (hydrogens and termini
added) in a water box with counter-ions. Its protein residues are the
138-atom implicit-solvent test protein, and ``chignolin_assembly`` tiles
them into a multi-chain protein-scale system the way the JAX package
builds its large implicit-solvent stand-ins (``replicate_structure`` with
a 0.6 nm gap; 3 x 3 x 3 copies give 3,726 atoms).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

from ..io.pdb import PDBStructure, read_pdb
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


__all__ = ["CHIGNOLIN_SOLVATED", "chignolin_assembly", "chignolin_structure"]
