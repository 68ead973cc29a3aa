"""A TIP3P water box built in code: the explicit-solvent test system.

The recipe of the JAX package's ``bench.py bench_cells_25k`` and of its
water-box tests: ``n_side``^3 rigid TIP3P waters on a cubic lattice of
``spacing`` nm in a cubic box of ``n_side * spacing + 0.1`` nm. 21 a side
gives the 27,783-atom box at which the cell list is the only path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure

#: TIP3P geometry in the lattice frame (nm): O, H1, H2
_TIP3P_SITES = (("O", (0.0, 0.0, 0.0), "O"),
                ("H1", (0.09572, 0.0, 0.0), "H"),
                ("H2", (-0.02399, 0.09266, 0.0), "H"))


def water_box_structure(
    n_side: int, spacing: float = 0.31, margin: float = 0.1,
) -> Tuple[PDBStructure, Tuple[float, float, float]]:
    """``(structure, box)``: ``n_side``^3 waters (residues ``HOH``, atoms
    O, H1, H2, chain W) and the cubic box lengths in nm; the structure's
    ``box`` is set, so the entry points take it for a solvated input."""
    residues = []
    rid = 1
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                origin = 0.15 + spacing * np.array([i, j, k], np.float64)
                residues.append(PDBResidue(name="HOH", resid=rid, chain="W", atoms=[
                    PDBAtom(name=name, resname="HOH", resid=rid, chain="W",
                            xyz=tuple(float(v) for v in origin + np.array(off)),
                            element=element)
                    for name, off, element in _TIP3P_SITES]))
                rid += 1
    length = n_side * spacing + margin
    box = (length, length, length)
    return PDBStructure(residues=residues, box=box), box


__all__ = ["water_box_structure"]
