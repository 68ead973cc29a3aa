"""Minimal, dependency-free PDB reading/writing.

Replaces the reference's mdtraj/PDBFixer structure loading for the prep
path (reference: src/pmarlo/protein/protein.py:288 loads PDBs via OpenMM
app / PDBFixer). Coordinates are returned in nanometers.

Host copy of ``pmarlo_tpu/io/pdb.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("pmarlo_tpu")

# --- hybrid-36 numbering (wwPDB convention for wide serial/resid fields) ---
_H36_UPPER = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_H36_LOWER = "0123456789abcdefghijklmnopqrstuvwxyz"


def _h36_encode(value: int, width: int) -> str:
    """Encode an integer in the hybrid-36 convention for a fixed-width
    PDB column (width 4 for resSeq, 5 for serial). Plain decimal up to
    10^width - 1, then base-36 blocks starting 'A000…' (upper) and
    'a000…' (lower) — the standard large-system extension, so solvated
    exports with >9999 residues survive a write/read round trip."""
    if value < 10 ** width:
        return f"{value:>{width}d}"
    base = 36 ** (width - 1)
    upper_start = 10 ** width
    upper_span = 26 * base
    if value < upper_start + upper_span:
        v = value - upper_start + 10 * base
        digits = []
        for _ in range(width):
            v, r = divmod(v, 36)
            digits.append(_H36_UPPER[r])
        return "".join(reversed(digits))
    lower_start = upper_start + upper_span
    lower_span = 26 * base
    if value < lower_start + lower_span:
        v = value - lower_start + 10 * base
        digits = []
        for _ in range(width):
            v, r = divmod(v, 36)
            digits.append(_H36_LOWER[r])
        return "".join(reversed(digits))
    raise ValueError(f"value {value} out of hybrid-36 range for width {width}")


def _h36_decode(field: str, width: int) -> int:
    """Decode a hybrid-36 fixed-width field back to an integer."""
    s = field.strip()
    try:
        return int(s)
    except ValueError:
        pass
    if not s:
        raise ValueError("empty hybrid-36 field")
    base = 36 ** (width - 1)
    if s[0] in _H36_UPPER[10:]:
        v = int(s, 36)
        return v - 10 * base + 10 ** width
    if s[0] in _H36_LOWER[10:]:
        v = int(s.upper(), 36)
        return v - 10 * base + 10 ** width + 26 * base
    raise ValueError(f"not a hybrid-36 field: {field!r}")


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
    #: lattice-diagonal box lengths (nm) from CRYST1, when present
    box: "Tuple[float, float, float] | None" = None
    #: triclinic off-diagonals (bx, cx, cy) nm in GROMACS reduced form
    #: (md/box.py), from CRYST1 angles; None -> orthorhombic
    tilt: "Tuple[float, float, float] | None" = None
    #: chain -> SEQRES residue names (loop modeling, protein/loops.py)
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


_ELEMENT_FALLBACK = {"C": "C", "N": "N", "O": "O", "S": "S", "H": "H", "P": "P"}


def _guess_element(atom_name: str, element_field: str) -> str:
    element_field = element_field.strip()
    if element_field:
        return element_field.capitalize()
    name = atom_name.strip()
    # strip leading digits ("1HH3")
    stripped = name.lstrip("0123456789")
    if not stripped:
        return "X"
    first = stripped[0].upper()
    return _ELEMENT_FALLBACK.get(first, first)


def read_pdb(path: "str | Path", model: int = 1) -> PDBStructure:
    """Parse ATOM/HETATM records of the given MODEL (1-based).

    Column-based parsing per the PDB v3 fixed-width spec. Waters and
    non-protein heterogens are kept (callers filter); altlocs other than
    ''/'A' are dropped.
    """
    path = Path(path)
    residues: List[PDBResidue] = []
    index: Dict[Tuple[str, int, str], PDBResidue] = {}
    n_models = 0
    current_model = 1
    in_wanted_model = True
    box = None
    tilt = None

    seqres: Dict[str, List[str]] = {}
    for line in path.read_text().splitlines():
        record = line[:6]
        if record.startswith("SEQRES"):
            chain_id = line[11].strip() or "A"
            seqres.setdefault(chain_id, []).extend(line[19:].split())
            continue
        if record.startswith("CRYST1"):
            try:
                a = float(line[6:15]) / 10.0
                b = float(line[15:24]) / 10.0
                c = float(line[24:33]) / 10.0
                try:
                    alpha = float(line[33:40])
                    beta = float(line[40:47])
                    gamma = float(line[47:54])
                except (ValueError, IndexError):
                    alpha = beta = gamma = 90.0
                if a > 0 and b > 0 and c > 0:
                    if max(abs(alpha - 90.0), abs(beta - 90.0),
                           abs(gamma - 90.0)) > 1e-3:
                        # triclinic cell (GROMACS/CHARMM-GUI prep):
                        # convert to the reduced lattice form the cell
                        # engine runs on (md/box.py)
                        from ..md.box import from_lengths_angles

                        try:
                            box, tilt = from_lengths_angles(
                                a, b, c, alpha, beta, gamma
                            )
                        except ValueError:
                            logger.warning(
                                "CRYST1 cell in %s is degenerate "
                                "(angles %.2f/%.2f/%.2f); ignoring box",
                                path, alpha, beta, gamma,
                            )
                    else:
                        box = (a, b, c)
            except ValueError:
                pass
            continue
        if record.startswith("MODEL"):
            n_models += 1
            current_model = int(line.split()[1]) if len(line.split()) > 1 else n_models
            in_wanted_model = current_model == model
            continue
        if record.startswith("ENDMDL"):
            in_wanted_model = False if n_models >= model else in_wanted_model
            continue
        if not in_wanted_model:
            continue
        if record not in ("ATOM  ", "HETATM"):
            continue
        altloc = line[16]
        if altloc not in (" ", "A"):
            continue
        name = line[12:16].strip()
        # columns 18-21: standard resnames sit in 18-20, CHARMM-style
        # 4-char names (TIP3) extend into 21 — always take the 4-char
        # window (a 3-char name leaves column 21 blank, strip handles it)
        resname = line[17:21].strip()
        chain = line[21].strip() or "A"
        try:
            resid = _h36_decode(line[22:26], 4)
        except ValueError:
            continue
        x = float(line[30:38]) / 10.0
        y = float(line[38:46]) / 10.0
        z = float(line[46:54]) / 10.0
        element = _guess_element(name, line[76:78] if len(line) >= 78 else "")
        key = (chain, resid, resname)
        if key not in index:
            res = PDBResidue(name=resname, resid=resid, chain=chain, atoms=[])
            index[key] = res
            residues.append(res)
        index[key].atoms.append(
            PDBAtom(name=name, resname=resname, resid=resid, chain=chain,
                    xyz=(x, y, z), element=element)
        )
    if not residues:
        raise ValueError(f"no ATOM records found in {path} (model {model})")
    return PDBStructure(residues=residues, n_models=max(n_models, 1),
                        box=box, tilt=tilt, seqres=seqres or None)


def write_pdb(
    path: "str | Path",
    coordinates: np.ndarray,
    atom_names: Sequence[str],
    residue_names: Sequence[str],
    residue_ids: Sequence[int],
    elements: Optional[Sequence[str]] = None,
    chain: str = "A",
    chains: Optional[Sequence[str]] = None,
    box: Optional[Sequence[float]] = None,
    tilt: Optional[Sequence[float]] = None,
) -> Path:
    """Write one model. ``coordinates`` (N, 3) in nm.

    ``chains`` (per-atom) overrides the single ``chain``; ``box`` (nm, 3
    lengths) emits a CRYST1 record (solvated exports), with ``tilt``
    (bx, cx, cy — md/box.py) encoded as cell angles for triclinic cells.
    Serials and resids use hybrid-36 numbering past their PDB field
    widths (99999 / 9999) so large solvated systems round-trip with
    unique residue ids (wrapping would merge distinct waters on read)."""
    path = Path(path)
    coords = np.asarray(coordinates, dtype=np.float64) * 10.0  # nm -> A
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coordinates must be (N, 3), got {coords.shape}")
    n = coords.shape[0]
    if not (len(atom_names) == len(residue_names) == len(residue_ids) == n):
        raise ValueError("metadata length mismatch with coordinates")
    if elements is None:
        elements = [_guess_element(a, "") for a in atom_names]
    lines = []
    if box is not None:
        if tilt is not None:
            from ..md.box import to_lengths_angles

            a, b, c, al, be, ga = to_lengths_angles(box, tilt)
            a, b, c = a * 10.0, b * 10.0, c * 10.0  # nm -> A
        else:
            a, b, c = (float(x) * 10.0 for x in box)
            al = be = ga = 90.0
        lines.append(
            f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}"
            f"{al:7.2f}{be:7.2f}{ga:7.2f} P 1           1"
        )
    for i in range(n):
        name = atom_names[i]
        pdb_name = f" {name:<3s}" if len(name) < 4 else f"{name:<4s}"
        ch = (chains[i] if chains is not None else chain)[:1]
        # resname occupies columns 18-20, with 4-char names (TIP3, SOL
        # variants) extending into the conventionally-blank column 21 —
        # ':>3s' would NOT truncate a 4-char name and would shift every
        # following fixed-width field (chain, resid, coordinates) by one
        lines.append(
            f"ATOM  {_h36_encode(i + 1, 5)} {pdb_name}"
            f"{'':1s}{residue_names[i][:4]:<4s}{ch}"
            f"{_h36_encode(int(residue_ids[i]), 4)}    "
            f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}{coords[i, 2]:8.3f}"
            f"{1.00:6.2f}{0.00:6.2f}          {elements[i]:>2s}"
        )
    lines.append("TER")
    lines.append("END")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def write_pdb_trajectory(
    path: "str | Path",
    frames: np.ndarray,
    atom_names: Sequence[str],
    residue_names: Sequence[str],
    residue_ids: Sequence[int],
    chain: str = "A",
) -> Path:
    """Write a multi-MODEL PDB trajectory. ``frames`` (T, N, 3) in nm."""
    path = Path(path)
    frames = np.asarray(frames, dtype=np.float64)
    chunks = []
    for m, frame in enumerate(frames, start=1):
        chunks.append(f"MODEL     {m:>4d}")
        coords = frame * 10.0
        for i in range(coords.shape[0]):
            name = atom_names[i]
            pdb_name = f" {name:<3s}" if len(name) < 4 else f"{name:<4s}"
            chunks.append(
                f"ATOM  {_h36_encode(i + 1, 5)} {pdb_name}"
                f"{'':1s}{residue_names[i][:4]:<4s}{chain[:1]}"
                f"{_h36_encode(int(residue_ids[i]), 4)}    "
                f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}{coords[i, 2]:8.3f}"
                f"{1.00:6.2f}{0.00:6.2f}"
            )
        chunks.append("ENDMDL")
    chunks.append("END")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(chunks) + "\n")
    return path


__all__ = ["PDBStructure", "PDBAtom", "PDBResidue", "read_pdb", "write_pdb",
           "write_pdb_trajectory"]
