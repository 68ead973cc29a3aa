"""Bundled test systems.

The reference ships ``data/alanine-dipeptide.pdb`` and ``data/chignolin.pdb``
(README.md:125-126). Here the alanine dipeptide (ACE-ALA-NME, 22 atoms, the
canonical MD benchmark molecule) is embedded as coordinates; chignolin
(PDB 1UAO) is located on disk if available.

Host copy of ``pmarlo_tpu/data/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure

# (atom name, residue name, residue id, element, x, y, z) in Angstrom.
# Standard extended-conformation alanine dipeptide geometry.
_ALANINE_ATOMS = [
    ("HH31", "ACE", 1, "H", 2.000, 1.000, -0.000),
    ("CH3", "ACE", 1, "C", 2.000, 2.090, 0.000),
    ("HH32", "ACE", 1, "H", 1.486, 2.454, 0.890),
    ("HH33", "ACE", 1, "H", 1.486, 2.454, -0.890),
    ("C", "ACE", 1, "C", 3.427, 2.641, -0.000),
    ("O", "ACE", 1, "O", 4.391, 1.877, -0.000),
    ("N", "ALA", 2, "N", 3.555, 3.970, -0.000),
    ("H", "ALA", 2, "H", 2.733, 4.556, -0.000),
    ("CA", "ALA", 2, "C", 4.853, 4.614, -0.000),
    ("HA", "ALA", 2, "H", 5.408, 4.316, 0.890),
    ("CB", "ALA", 2, "C", 5.661, 4.221, -1.232),
    ("HB1", "ALA", 2, "H", 5.123, 4.521, -2.131),
    ("HB2", "ALA", 2, "H", 6.630, 4.719, -1.206),
    ("HB3", "ALA", 2, "H", 5.809, 3.141, -1.241),
    ("C", "ALA", 2, "C", 4.713, 6.129, 0.000),
    ("O", "ALA", 2, "O", 3.601, 6.653, 0.000),
    ("N", "NME", 3, "N", 5.846, 6.835, 0.000),
    ("H", "NME", 3, "H", 6.737, 6.359, -0.000),
    ("CH3", "NME", 3, "C", 5.846, 8.284, 0.000),
    ("HH31", "NME", 3, "H", 4.819, 8.648, 0.000),
    ("HH32", "NME", 3, "H", 6.360, 8.648, 0.890),
    ("HH33", "NME", 3, "H", 6.360, 8.648, -0.890),
]


def alanine_dipeptide_structure() -> PDBStructure:
    """The bundled ACE-ALA-NME system as a parsed structure (nm units)."""
    residues = []
    index = {}
    for name, resname, resid, elem, x, y, z in _ALANINE_ATOMS:
        key = (resname, resid)
        if key not in index:
            res = PDBResidue(name=resname, resid=resid, chain="A", atoms=[])
            index[key] = res
            residues.append(res)
        index[key].atoms.append(
            PDBAtom(
                name=name, resname=resname, resid=resid, chain="A",
                xyz=(x / 10.0, y / 10.0, z / 10.0), element=elem,
            )
        )
    return PDBStructure(residues=residues)


def replicate_structure(
    structure: PDBStructure,
    n: "tuple[int, int, int]" = (2, 2, 2),
    spacing: "Optional[tuple[float, float, float]]" = None,
    gap: float = 0.5,
) -> PDBStructure:
    """Tile a structure on an ``n`` grid of translated copies (nm).

    Builds large multi-chain assemblies from a single-molecule template —
    the benchmark geometry for the tile-culled implicit-solvent path
    (pallas_pair gb_cutoff) and a stand-in for multi-protein complexes.
    ``spacing`` defaults to the template's bounding-box extent plus
    ``gap`` per axis. Copies get fresh chain letters and offset resids so
    each copy parameterizes independently (own termini)."""
    xyz = np.asarray(
        [a.xyz for r in structure.residues for a in r.atoms], np.float64
    )
    if spacing is None:
        ext = xyz.max(axis=0) - xyz.min(axis=0)
        spacing = tuple(float(e + gap) for e in ext)
    max_resid = max(r.resid for r in structure.residues) + 1
    chains = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    residues = []
    copy = 0
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                off = (i * spacing[0], j * spacing[1], k * spacing[2])
                ch = chains[copy % len(chains)]
                roff = copy * max_resid
                for r in structure.residues:
                    residues.append(PDBResidue(
                        name=r.name, resid=r.resid + roff, chain=ch,
                        atoms=[PDBAtom(
                            name=a.name, resname=a.resname,
                            resid=a.resid + roff, chain=ch,
                            xyz=(a.xyz[0] + off[0], a.xyz[1] + off[1],
                                 a.xyz[2] + off[2]),
                            element=a.element,
                        ) for a in r.atoms],
                    ))
                copy += 1
    return PDBStructure(residues=residues)


def chignolin_path() -> Optional[Path]:
    """Locate a chignolin PDB (1UAO) if one is available on this host."""
    candidates = [
        os.environ.get("PMARLO_CHIGNOLIN_PDB"),
        Path(__file__).parent / "chignolin.pdb",
        Path("data/chignolin.pdb"),
    ]
    for c in candidates:
        if c and Path(c).exists():
            return Path(c)
    return None


__all__ = [
    "alanine_dipeptide_structure", "chignolin_path", "replicate_structure",
]
