"""The structure records the frozen topology builder reads, and a reader of
the benchmark's input PDB files (ATOM / HETATM records, coordinates in nm).

The dataclasses are a frozen copy of ``pmarlo_tpu_torch/io/pdb.py``
(pmarlo_tpu_torch at commit be358b3); the reader is the benchmark's own.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


class TopologyError(Exception):
    """A structure that cannot be matched to force-field templates."""


@dataclasses.dataclass
class PDBAtom:
    name: str
    resname: str
    resid: int
    chain: str
    xyz: Tuple[float, float, float]  # nm
    element: str


@dataclasses.dataclass
class PDBResidue:
    name: str
    resid: int
    chain: str
    atoms: List[PDBAtom]


@dataclasses.dataclass
class PDBStructure:
    residues: List[PDBResidue]
    n_models: int = 1
    box: "Tuple[float, float, float] | None" = None
    tilt: "Tuple[float, float, float] | None" = None
    seqres: "Dict[str, List[str]] | None" = None

    @property
    def n_atoms(self) -> int:
        return sum(len(r.atoms) for r in self.residues)

    def coordinates(self) -> np.ndarray:
        return np.asarray(
            [a.xyz for r in self.residues for a in r.atoms], dtype=np.float64
        )

    def sequence(self) -> List[str]:
        return [r.name for r in self.residues]


def read_pdb(path: "str | Path") -> PDBStructure:
    """ATOM / HETATM records by the PDB's fixed columns; the element from
    columns 77-78 (the inputs carry it)."""
    residues: List[PDBResidue] = []
    index: Dict[Tuple[str, int, str], PDBResidue] = {}
    for line in Path(path).read_text().splitlines():
        if line[:6] not in ("ATOM  ", "HETATM"):
            continue
        name = line[12:16].strip()
        resname = line[17:21].strip()
        chain = line[21].strip() or "A"
        resid = int(line[22:26])
        xyz = tuple(float(line[c:c + 8]) / 10.0 for c in (30, 38, 46))
        element = line[76:78].strip().capitalize()
        if not element:
            raise ValueError(f"{path}: atom {name} of residue {resid} has no element")
        key = (chain, resid, resname)
        if key not in index:
            index[key] = PDBResidue(name=resname, resid=resid, chain=chain, atoms=[])
            residues.append(index[key])
        index[key].atoms.append(PDBAtom(name=name, resname=resname, resid=resid,
                                        chain=chain, xyz=xyz, element=element))
    if not residues:
        raise ValueError(f"no ATOM records in {path}")
    return PDBStructure(residues=residues)
