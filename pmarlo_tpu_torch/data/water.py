"""A water box built in code: the explicit-solvent test system.

The recipe of the JAX package's ``bench.py bench_cells_25k`` and of its
water-box tests: ``n_side``^3 rigid waters on a cubic lattice of
``spacing`` nm in a cubic box of ``n_side * spacing + 0.1`` nm. 21 a side
gives the 27,783-atom box at which the cell list is the only path.
``water_model`` adds the virtual sites of TIP4P-Ew (M) or TIP5P (L1, L2)
at their template positions (``md/residues.py``); ``seed`` turns every
water by its own random rotation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure

#: TIP3P geometry in the lattice frame (nm): O, H1, H2
_TIP3P_SITES = (("O", (0.0, 0.0, 0.0), "O"),
                ("H1", (0.09572, 0.0, 0.0), "H"),
                ("H2", (-0.02399, 0.09266, 0.0), "H"))


#: TIP4P-Ew's M: the HOH4 template's three-particle average weights
_TIP4PEW_M = (0.786646558, 0.106676721, 0.106676721)


def _site_rows(xyz: np.ndarray, water_model: str):
    """The virtual-site rows ``[(name, xyz)]`` of one water ``xyz (3, 3)``
    (O, H1, H2)."""
    if water_model == "tip3p":
        return []
    if water_model == "tip4pew":
        return [("M", _TIP4PEW_M @ xyz)]
    from ..md.residues import _TIP5P_W, _TIP5P_WC

    d12, d13 = xyz[1] - xyz[0], xyz[2] - xyz[0]
    cr = np.cross(d12, d13)
    return [(name, xyz[0] + _TIP5P_W * (d12 + d13) + sgn * _TIP5P_WC * cr)
            for name, sgn in (("L1", 1.0), ("L2", -1.0))]


def _rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform random rotation (a normalised Gaussian quaternion)."""
    q = rng.normal(size=4)
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def water_box_structure(
    n_side: int, spacing: float = 0.31, margin: float = 0.1, *,
    water_model: str = "tip3p", seed: Optional[int] = None,
) -> Tuple[PDBStructure, Tuple[float, float, float]]:
    """``(structure, box)``: ``n_side``^3 waters (residues ``HOH``, atoms
    O, H1, H2 and, by ``water_model``, M (``"tip4pew"``) or L1, L2
    (``"tip5p"``), chain W) and the cubic box lengths in nm; the
    structure's ``box`` is set, so the entry points take it for a solvated
    input. ``seed`` turns each water by a random rotation about its O."""
    if water_model not in ("tip3p", "tip4pew", "tip5p"):
        raise ValueError(f"water_model must be tip3p|tip4pew|tip5p, got {water_model!r}")
    rng = None if seed is None else np.random.default_rng(seed)
    base = np.array([off for _, off, _ in _TIP3P_SITES], np.float64)
    residues = []
    rid = 1
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                origin = 0.15 + spacing * np.array([i, j, k], np.float64)
                xyz = origin + (base if rng is None else base @ _rotation(rng).T)
                rows = [(name, xyz[a], element)
                        for a, (name, _, element) in enumerate(_TIP3P_SITES)]
                rows += [(name, p, "M") for name, p in _site_rows(xyz, water_model)]
                residues.append(PDBResidue(name="HOH", resid=rid, chain="W", atoms=[
                    PDBAtom(name=name, resname="HOH", resid=rid, chain="W",
                            xyz=tuple(float(v) for v in p), element=element)
                    for name, p, element in rows]))
                rid += 1
    length = n_side * spacing + margin
    box = (length, length, length)
    return PDBStructure(residues=residues, box=box), box


__all__ = ["water_box_structure"]
