"""Nonstandard-residue replacement (PDBFixer parity).

The reference maps modified residues onto their standard parents via
PDBFixer findNonstandardResidues/replaceNonstandardResidues
(src/pmarlo/protein/protein.py:345-348). Here the same capability is a
rename + atom-mapping pass over the common PDB modifications: atoms with
a positional counterpart in the parent keep their coordinates (renamed
where chemistry allows, e.g. MSE Se -> MET SD), extra modification atoms
(phosphates, methyls, oxidized oxygens) are dropped, and any atoms the
parent still lacks are rebuilt by protein.repair during prepare().

Host copy of ``pmarlo_tpu/protein/nonstandard.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..io.pdb import PDBResidue, PDBStructure

#: modified residue -> (parent, atom renames, atoms to drop)
_SUBSTITUTIONS: Dict[str, Tuple[str, Dict[str, str], Tuple[str, ...]]] = {
    # selenomethionine: Se takes the SD slot
    "MSE": ("MET", {"SE": "SD"}, ()),
    # phosphorylated Ser/Thr/Tyr: drop the phosphate, restore the hydroxyl
    "SEP": ("SER", {}, ("P", "O1P", "O2P", "O3P", "OP1", "OP2", "OP3")),
    "TPO": ("THR", {}, ("P", "O1P", "O2P", "O3P", "OP1", "OP2", "OP3")),
    "PTR": ("TYR", {}, ("P", "O1P", "O2P", "O3P", "OP1", "OP2", "OP3")),
    # hydroxyproline: drop the ring hydroxyl
    "HYP": ("PRO", {}, ("OD1", "OD", "HD1", "HO")),
    # S-hydroxy / S,S-dioxide cysteines: drop the oxidation oxygens
    "CSO": ("CYS", {}, ("OD",)),
    "CSD": ("CYS", {}, ("OD1", "OD2")),
    # S-methylcysteine / S,S-(2-hydroxyethyl)thiocysteine
    "SCM": ("CYS", {}, ("CM", "SD", "CE", "OZ")),
    "CME": ("CYS", {}, ("SD", "CE", "CZ", "OH")),
    # methyllysines: drop the methyls, restore NZ
    "MLY": ("LYS", {}, ("CH1", "CH2", "CM")),
    "M3L": ("LYS", {}, ("CM1", "CM2", "CM3")),
    # N-formyl / pyroglutamate mappings used by PDBFixer
    "FME": ("MET", {}, ("CN", "O1")),
    "PCA": ("GLU", {}, ("OE",)),
    # protonation-ambiguous aliases occasionally present in files
    "HSD": ("HIS", {}, ()),
    "HSE": ("HIS", {}, ()),
    "HSP": ("HIS", {}, ()),
}


def substitution_for(resname: str) -> Optional[str]:
    """Parent residue name for a known modification, else None."""
    sub = _SUBSTITUTIONS.get(resname)
    return sub[0] if sub else None


def replace_nonstandard(structure: PDBStructure) -> PDBStructure:
    """Return a structure with known modified residues mapped to their
    standard parents (a no-op when none are present)."""
    if not any(r.name in _SUBSTITUTIONS for r in structure.residues):
        return structure
    out = []
    for res in structure.residues:
        sub = _SUBSTITUTIONS.get(res.name)
        if sub is None:
            out.append(res)
            continue
        parent, renames, drops = sub
        atoms = []
        for a in res.atoms:
            name = a.name.strip()
            if name in drops:
                continue
            new_name = renames.get(name, name)
            import dataclasses

            # renamed heteroatoms adopt the parent's element
            # (MSE Se -> MET S)
            element = "S" if (name == "SE" and new_name == "SD") else a.element
            atoms.append(dataclasses.replace(
                a, name=new_name, resname=parent, element=element,
            ))
        out.append(PDBResidue(
            name=parent, resid=res.resid, chain=res.chain, atoms=atoms,
        ))
    return PDBStructure(residues=out, n_models=structure.n_models,
                        box=structure.box,
                        tilt=getattr(structure, "tilt", None),
                        seqres=structure.seqres)


__all__ = ["replace_nonstandard", "substitution_for"]
