"""Protein preparation: structure cleanup, properties, System creation.

Port of ``pmarlo_tpu/protein/protein.py``.

Rebuild of src/pmarlo/protein/protein.py:70 (Protein), :288 (prepare), :506
(_compute_protein_metrics — sequence-based charge/pI via bisection), :628
(get_properties), :733 (create_system). The PDBFixer/RDKit dependencies are
replaced by first-party implementations of exactly the used surface:
heterogen/water removal, hydrogen addition + pH protonation (reference
protein.py:334-373 via PDBFixer addMissingHydrogens), terminal-variant
detection, sequence-derived physico-chemical metrics (MW, charge vs pH
from pKa tables, isoelectric point by bisection), and force-field System
creation via md.forcefield.

Hydrogens missing from the input (the normal case for X-ray structures)
are reconstructed geometrically by protein.hydrogens.add_hydrogens with
protonation states chosen for the requested pH. Missing HEAVY atoms still
raise TopologyError (side-chain repair is out of scope; fail fast).

One thing differs from the JAX class: ``Protein.create_system(...,
device=None)`` passes ``device`` to the port's ``build_system``, so the
System lands on ``_device.default_device()`` (the card when there is one)
unless the caller names a device. Everything else, from ``prepare`` to
``save_structure``, is its source's text on the port's host modules
(tests/unit/test_torch_host_copies.py holds each function equal to it).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

import logging

from ..io.pdb import PDBStructure, read_pdb, write_pdb
from ..md.forcefield import build_system
from ..md.topology import Topology, build_topology
from ..utils.errors import TopologyError
from .descriptors import compute_descriptors

logger = logging.getLogger("pmarlo_tpu")

# --- sequence property tables -------------------------------------------------

_RESIDUE_MASS = {  # average residue masses (Da), water subtracted
    "ALA": 71.08, "ARG": 156.19, "ASN": 114.10, "ASP": 115.09, "CYS": 103.14,
    "GLN": 128.13, "GLU": 129.12, "GLY": 57.05, "HIS": 137.14, "ILE": 113.16,
    "LEU": 113.16, "LYS": 128.17, "MET": 131.19, "PHE": 147.18, "PRO": 97.12,
    "SER": 87.08, "THR": 101.10, "TRP": 186.21, "TYR": 163.18, "VAL": 99.13,
    "ACE": 43.04, "NME": 30.07,
}

#: side-chain pKa values (EMBOSS set) and charge signs
_PKA_SIDECHAIN = {
    "ASP": (3.9, -1), "GLU": (4.1, -1), "CYS": (8.5, -1), "TYR": (10.1, -1),
    "HIS": (6.5, +1), "LYS": (10.8, +1), "ARG": (12.5, +1),
}
_PKA_NTERM = 8.6
_PKA_CTERM = 3.6

_HYDROPHOBIC = {"ALA", "VAL", "LEU", "ILE", "PHE", "MET", "TRP", "PRO"}
_AROMATIC = {"PHE", "TYR", "TRP", "HIS"}

_ONE_LETTER = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
}

_WATER_NAMES = {"HOH", "WAT", "TIP3", "SOL"}

#: protonation variants -> canonical residue (sequence/property reporting);
#: CYX/CYM (disulfide/deprotonated cysteine) must canonicalize too or every
#: bridged cysteine silently vanishes from sequence, MW, and pI
_CANONICAL = {
    "ASH": "ASP", "GLH": "GLU", "LYN": "LYS",
    "HID": "HIS", "HIE": "HIS", "HIP": "HIS",
    "CYX": "CYS", "CYM": "CYS",
}


def _canonical(resname: str) -> str:
    return _CANONICAL.get(resname, resname)


def charge_at_pH(sequence: List[str], pH: float) -> float:
    """Henderson-Hasselbalch net charge (reference protein.py:506 uses the
    same construction for its bisection pI)."""
    charge = 1.0 / (1.0 + 10 ** (pH - _PKA_NTERM))            # N-terminus
    charge -= 1.0 / (1.0 + 10 ** (_PKA_CTERM - pH))           # C-terminus
    for res in sequence:
        if res in _PKA_SIDECHAIN:
            pka, sign = _PKA_SIDECHAIN[res]
            if sign > 0:
                charge += 1.0 / (1.0 + 10 ** (pH - pka))
            else:
                charge -= 1.0 / (1.0 + 10 ** (pka - pH))
    return charge


def isoelectric_point(sequence: List[str], tol: float = 1e-4) -> float:
    """pI via bisection on the net-charge curve (reference :506)."""
    lo, hi = 0.0, 14.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        q = charge_at_pH(sequence, mid)
        if abs(q) < tol:
            return mid
        if q > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class Protein:
    """Prepared protein: cleaned structure + topology + properties.

    Usage (mirrors reference Protein):
        p = Protein("input.pdb").prepare()
        system, positions = p.create_system()
        props = p.get_properties()
    """

    source: "str | Path | PDBStructure"
    ph: float = 7.0
    structure: Optional[PDBStructure] = None
    topology: Optional[Topology] = None
    box: Optional[Tuple[float, float, float]] = None  # nm, set by solvate
    #: triclinic off-diagonals (md/box.py), set by dodecahedron solvate
    #: or adopted from a triclinic CRYST1
    tilt: Optional[Tuple[float, float, float]] = None
    _prepared: bool = False

    def prepare(
        self,
        *,
        remove_heterogens: bool = True,
        keep_waters: bool = False,
        model: int = 1,
        replace_nonstandard_residues: bool = True,
        add_missing_atoms: bool = True,
        add_missing_hydrogens: bool = True,
        his_variant: str = "HIE",
        solvate: bool = False,
        solvent_padding: float = 1.0,
        box_shape: str = "rectangular",
        positive_ion: str = "NA",
        water_model: str = "tip3p",
    ) -> "Protein":
        """Load + clean + repair + protonate + template-match
        (reference :288).

        ``replace_nonstandard_residues`` maps modified residues to their
        standard parents (PDBFixer findNonstandardResidues/
        replaceNonstandardResidues, reference protein.py:345-348);
        ``add_missing_atoms`` rebuilds missing heavy atoms from force-field
        equilibrium geometry (the PDBFixer findMissingAtoms/addMissingAtoms
        role, reference protein.py:334-373); ``add_missing_hydrogens``
        reconstructs template hydrogens (and C-terminal OXT) geometrically
        and picks protonation variants for ``self.ph``. With repair
        disabled, missing heavy atoms raise TopologyError.
        ``solvate`` adds a TIP3P water box with ``solvent_padding`` nm of
        padding plus neutralizing ions when no waters are present
        (reference :366-372 via PDBFixer.addSolvent); the box lengths are
        recorded in ``self.box``. Waters never enter the implicit-solvent
        MD topology. ``box_shape="dodecahedron"`` solvates in a rhombic-
        dodecahedron cell (~29% less water for the same image clearance;
        triclinic off-diagonals recorded in ``self.tilt``).
        """
        if isinstance(self.source, PDBStructure):
            structure = self.source
        else:
            # format dispatch by suffix: .pdb fixed-width or .cif/.mmcif
            # (reference protein.py:137 accepts both on the constructor)
            from ..io.cif import read_structure

            structure = read_structure(self.source, model=model)
        if self.box is None and getattr(structure, "box", None) is not None:
            # adopt CRYST1 as the periodic box only when the input is
            # actually solvated (contains waters): nearly every raw X-ray
            # PDB carries a real crystallographic CRYST1, and adopting it
            # would let explicit_solvent MD run in a meaningless crystal
            # cell with zero waters instead of raising
            if any(r.name in _WATER_NAMES for r in structure.residues):
                self.box = structure.box  # CRYST1 from a solvated input
                self.tilt = getattr(structure, "tilt", None)
        if replace_nonstandard_residues:
            from .nonstandard import replace_nonstandard

            structure = replace_nonstandard(structure)
        if remove_heterogens:
            from ..md.residues import NONPOLYMER, TEMPLATES

            structure = PDBStructure(
                residues=[
                    r for r in structure.residues
                    if ((r.name in _RESIDUE_MASS or r.name in _ONE_LETTER
                         or r.name in TEMPLATES or r.name in ("ACE", "NME"))
                        and r.name not in NONPOLYMER)
                    or (keep_waters and (r.name in _WATER_NAMES
                                         or r.name in NONPOLYMER))
                ],
                n_models=structure.n_models,
                box=structure.box,
                seqres=structure.seqres,
            )
        if not structure.residues:
            raise TopologyError("no protein residues after cleanup")
        if add_missing_atoms:
            from .repair import repair_missing_atoms

            structure = repair_missing_atoms(structure)
        if add_missing_hydrogens:
            from .hydrogens import add_hydrogens

            structure = add_hydrogens(
                structure, ph=self.ph, his_variant=his_variant
            )
        if solvate and not any(
            r.name in _WATER_NAMES for r in structure.residues
        ):
            from .solvate import solvate_structure

            structure, self.box = solvate_structure(
                structure, padding=solvent_padding, box_shape=box_shape,
                positive_ion=positive_ion, water_model=water_model,
            )
            self.tilt = structure.tilt
        self.structure = structure
        # the MD topology is always protein-only: waters/ions are
        # structure-level artifacts (the engine is implicit-solvent)
        self.topology = build_topology(structure, keep_waters=False)
        self._prepared = True
        gaps = self.find_missing_residues()
        if gaps:
            import logging

            logging.getLogger("pmarlo_tpu").warning(
                "chain gaps detected (topology split into fragments, "
                "loop modeling not performed): %s",
                {f"{c}:{a}-{b}": n for (c, a, b), n in gaps.items()},
            )
        return self

    def _require_prepared(self):
        if not self._prepared:
            raise RuntimeError("call prepare() first")

    # --- properties (reference :506,:628) -------------------------------------

    def sequence(self) -> List[str]:
        self._require_prepared()
        return [
            _canonical(r) for r in self.structure.sequence()
            if _canonical(r) in _RESIDUE_MASS
        ]

    def sequence_one_letter(self) -> str:
        return "".join(_ONE_LETTER.get(r, "X") for r in self.sequence()
                       if r not in ("ACE", "NME"))

    def get_properties(self) -> Dict:
        """Physico-chemical property table (reference :628: MW, charge, pI,
        hydrophobic/aromatic fractions, atom counts)."""
        self._require_prepared()
        seq = [r for r in self.sequence() if r not in ("ACE", "NME")]
        mw = sum(_RESIDUE_MASS.get(r, 110.0) for r in self.sequence()) + 18.02
        return {
            "n_residues": len(seq),
            "n_atoms": self.topology.n_atoms,
            "sequence": self.sequence_one_letter(),
            "molecular_weight": round(mw, 2),
            "net_charge_at_pH": round(charge_at_pH(seq, self.ph), 3),
            "ph": self.ph,
            "isoelectric_point": round(isoelectric_point(seq), 2),
            "hydrophobic_fraction": round(
                sum(r in _HYDROPHOBIC for r in seq) / max(len(seq), 1), 3
            ),
            "aromatic_fraction": round(
                sum(r in _AROMATIC for r in seq) / max(len(seq), 1), 3
            ),
            "formal_charge": int(round(float(self.topology.charges.sum()))),
            # structural descriptor subset (reference protein.py:605-617
            # via RDKit; first-party from the topology graph — see
            # protein/descriptors.py for the MolLogP->GRAVY substitution)
            **compute_descriptors(self.topology),
        }

    # --- system creation (reference :733) ---------------------------------------

    def create_system(
        self,
        *,
        hydrogen_mass: Optional[float] = 3.0,
        implicit_solvent: bool = True,
        gb_model: str = "gbn2",
        explicit_solvent: bool = False,
        cutoff: float = 0.9,
        switch_distance: Optional[float] = None,
        device=None,
    ):
        """Build the MD System + positions from the prepared topology, on
        ``device`` (``None``: the card when there is one).

        ``gb_model`` defaults to "gbn2", matching the reference's
        amber14 + implicit/gbn2.xml (simulation/__init__.py:64-71).

        ``explicit_solvent=True`` requires a prior
        ``prepare(solvate=True)``: the periodic system keeps the TIP3P
        waters and ions, uses min-image LJ + reaction-field
        electrostatics at ``cutoff`` (OpenMM CutoffPeriodic), and
        disables GB — a capability BEYOND the reference, whose MD is
        implicit-solvent only. ``switch_distance`` enables the
        OpenMM-parity LJ switching function on the periodic path
        (``NonbondedForce.setSwitchingDistance`` semantics; see
        md/forces.py lj_switch).
        """
        self._require_prepared()
        if explicit_solvent:
            if self.box is None:
                raise ValueError(
                    "explicit_solvent requires prepare(solvate=True) "
                    "(no box on this Protein)"
                )
            from ..md.topology import build_topology

            topo = build_topology(self.structure, keep_waters=True)
            return build_system(
                topo, hydrogen_mass=hydrogen_mass,
                box=self.box, tilt=self.tilt, cutoff=cutoff,
                switch_distance=switch_distance, device=device,
            )
        if switch_distance is not None:
            raise ValueError(
                "switch_distance applies to the explicit-solvent "
                "periodic path only (pass explicit_solvent=True)"
            )
        return build_system(
            self.topology,
            hydrogen_mass=hydrogen_mass,
            implicit_solvent=implicit_solvent,
            gb_model=gb_model,
            device=device,
        )

    def find_missing_residues(self) -> Dict[Tuple[str, int, int], int]:
        """Chain gaps: (chain, resid before, resid after) -> estimated
        number of absent residues (PDBFixer findMissingResidues surface,
        reference protein.py:354-356).

        Detection combines residue numbering discontinuities with broken
        peptide geometry (C->N beyond 2.4 A). ``add_missing_residues``
        then rebuilds the absent residues (PDBFixer addMissingResidues
        parity via CCD loop closure, protein/loops.py); unrepaired gaps
        split the topology into fragments at each break."""
        self._require_prepared()
        gaps: Dict[Tuple[str, int, int], int] = {}
        by_chain: Dict[str, List] = {}
        from ..md.residues import NONPOLYMER

        for r in self.structure.residues:
            if r.name in _WATER_NAMES or r.name in NONPOLYMER:
                continue
            by_chain.setdefault(r.chain, []).append(r)
        for chain, residues in by_chain.items():
            for prev, nxt in zip(residues, residues[1:]):
                c = next((np.asarray(a.xyz) for a in prev.atoms
                          if a.name.strip() == "C"), None)
                n = next((np.asarray(a.xyz) for a in nxt.atoms
                          if a.name.strip() == "N"), None)
                broken = (c is not None and n is not None
                          and float(np.linalg.norm(c - n)) > 0.24)
                n_gap = nxt.resid - prev.resid - 1
                if broken or n_gap > 0:
                    gaps[(chain, prev.resid, nxt.resid)] = max(n_gap, 1)
        return gaps

    def add_missing_residues(
        self,
        sequences: Optional[Dict[Tuple[str, int, int], List[str]]] = None,
        *,
        tol_nm: float = 0.005,
    ) -> Dict[Tuple[str, int, int], float]:
        """Build the residues absent from every numbering gap (PDBFixer
        findMissingResidues/addMissingResidues, reference
        protein.py:354-365) by CCD loop closure (protein/loops.py).

        Residue names per gap come from ``sequences``, else the PDB's
        SEQRES records when alignable, else poly-ALA. Backbones are
        built here; run ``prepare()`` afterwards so the standard repair
        machinery fills side chains and hydrogens. Returns the per-gap
        final anchor RMSD (nm)."""
        from .loops import build_missing_loops

        self._require_prepared()
        gaps = self.find_missing_residues()
        if not gaps:
            return {}
        new_structure, closures = build_missing_loops(
            self.structure, gaps,
            sequences=sequences, seqres=self.structure.seqres,
            tol_nm=tol_nm,
        )
        bad = {k: v for k, v in closures.items() if v > 3 * tol_nm}
        if bad:
            logger.warning(
                "loop closure above tolerance for gaps %s (RMSD nm)", bad
            )
        self.structure = new_structure
        # the new residues carry backbone only: re-run preparation so
        # side chains/hydrogens/template matching cover them (prepare
        # restarts from ``source``, so point it at the rebuilt structure)
        self.source = new_structure
        self._prepared = False
        return closures

    def save_prepared(self, path: "str | Path") -> Path:
        """Write the cleaned, canonically-ordered structure."""
        self._require_prepared()
        return write_pdb(
            path,
            self.topology.positions,
            self.topology.atom_names,
            self.topology.residue_names,
            self.topology.residue_ids,
            elements=self.topology.elements,
        )

    def save_structure(self, path: "str | Path") -> Path:
        """Write the FULL prepared structure, waters and ions included
        (the solvated-export counterpart of save_prepared; emits a
        CRYST1 record when prepare(solvate=True) set a box)."""
        self._require_prepared()
        atoms = [a for r in self.structure.residues for a in r.atoms]
        return write_pdb(
            path,
            np.asarray([a.xyz for a in atoms]),
            [a.name for a in atoms],
            [a.resname for a in atoms],
            [a.resid for a in atoms],
            elements=[a.element for a in atoms],
            chains=[a.chain or "A" for a in atoms],
            box=self.box,
            tilt=self.tilt,
        )


__all__ = ["Protein", "charge_at_pH", "isoelectric_point"]
