"""Template/geometry-based hydrogen addition and pH protonation.

First-party replacement for PDBFixer's ``addMissingHydrogens(pH)`` +
variant selection (reference src/pmarlo/protein/protein.py:334-373): most
real inputs are X-ray structures with no hydrogens, so the prep path must
reconstruct them. Placement is purely geometric from the heavy-atom frame
(the standard Reduce/PDBFixer approach); rotameric ambiguities (hydroxyl
dihedrals, methyl phases) are resolved to staggered/anti conformers — the
energy minimizer that precedes any MD run relaxes them.

Protonation states at the requested pH follow the side-chain pKa table
(EMBOSS values, shared with protein.charge_at_pH): ASP->ASH / GLU->GLH
below their pKa, LYS->LYN above, HIS->HIP below 6.0 and the epsilon
tautomer HIE otherwise (PDBFixer's default rule). Explicit HID/HIE/HIP
names in the input are respected.

Host copy of ``pmarlo_tpu/protein/hydrogens.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure
from ..md.residues import (
    NUCLEIC_RESNAMES,
    TEMPLATES,
    get_template,
    normalize_atom_name,
)
from ..utils.errors import TopologyError

# bond lengths to hydrogen by parent element (nm)
_H_BOND_LENGTH = {"C": 0.109, "N": 0.101, "O": 0.096, "S": 0.134}
_OXT_BOND_LENGTH = 0.125  # carboxylate C-O

_TET = math.radians(109.471)  # tetrahedral angle
_HALF_TET = math.radians(54.735)

#: protonation thresholds (pKa) for variant selection
_VARIANT_RULES = (
    ("ASP", "ASH", "below", 3.9),
    ("GLU", "GLH", "below", 4.1),
    ("LYS", "LYN", "above", 10.8),
    ("HIS", "HIP", "below", 6.0),
)

_PROTEIN_VARIANTS = {"ASH", "GLH", "LYN", "HIP", "HID", "HIE"}


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    if n < 1e-10:
        raise ValueError("degenerate geometry (zero-length bond vector)")
    return v / n


def _any_perpendicular(u: np.ndarray) -> np.ndarray:
    ref = np.array([1.0, 0.0, 0.0]) if abs(u[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    return _unit(np.cross(u, ref))


def assign_protonation_states(
    structure: PDBStructure, ph: float = 7.0, his_variant: str = "HIE"
) -> PDBStructure:
    """Rename titratable residues to their variant templates for the pH."""
    if his_variant not in ("HID", "HIE", "HIP"):
        raise ValueError(f"his_variant must be HID|HIE|HIP, got {his_variant!r}")
    renamed: List[PDBResidue] = []
    for res in structure.residues:
        name = res.name
        if name in _PROTEIN_VARIANTS:
            pass  # explicit variant in the input wins
        else:
            for base, variant, side, pka in _VARIANT_RULES:
                if name != base:
                    continue
                if side == "below" and ph < pka:
                    name = variant
                elif side == "above" and ph > pka:
                    name = variant
            if name == "HIS":
                name = his_variant
        if name != res.name:
            res = PDBResidue(
                name=name, resid=res.resid, chain=res.chain,
                atoms=[
                    PDBAtom(a.name, name, a.resid, a.chain, a.xyz, a.element)
                    for a in res.atoms
                ],
            )
        renamed.append(res)
    return PDBStructure(residues=renamed, n_models=structure.n_models,
                        box=structure.box,
                        tilt=getattr(structure, "tilt", None),
                        seqres=structure.seqres)


def _template_graph(tmpl) -> Dict[str, List[str]]:
    nbrs: Dict[str, List[str]] = {n: [] for n in tmpl["atoms"]}
    for a, b in tmpl["bonds"]:
        nbrs[a].append(b)
        nbrs[b].append(a)
    return nbrs


def _place_on_parent(
    parent: np.ndarray,
    known: List[np.ndarray],
    n_missing: int,
    n_total: int,
    length: float,
    grandparent: Optional[np.ndarray],
) -> List[np.ndarray]:
    """Positions for ``n_missing`` substituents on ``parent``.

    ``known``: positions of the parent's already-placed neighbors.
    ``n_total``: the parent's total substituent count per the template
    (sets sp3 vs sp2 geometry). ``grandparent``: a placed neighbor of
    known[0], used as the torsion reference for rotameric cases.
    """
    k = len(known)
    units = [_unit(q - parent) for q in known]

    if n_total >= 4:  # sp3
        if k == 3 and n_missing == 1:
            return [parent + length * _unit(-(units[0] + units[1] + units[2]))]
        if k == 2 and n_missing == 2:
            bis = _unit(-(units[0] + units[1]))
            perp = _unit(np.cross(units[0], units[1]))
            c, s = math.cos(_HALF_TET), math.sin(_HALF_TET)
            return [parent + length * (c * bis + s * perp),
                    parent + length * (c * bis - s * perp)]
        if k == 1 and n_missing >= 1:  # methyl / NH3+ (staggered)
            d = -units[0]  # away from the lone neighbor
            if grandparent is not None:
                w = _unit(grandparent - known[0])
                e1 = w - np.dot(w, d) * d
                e1 = _unit(e1) if np.linalg.norm(e1) > 1e-6 else _any_perpendicular(d)
            else:
                e1 = _any_perpendicular(d)
            e2 = np.cross(d, e1)
            out = []
            for i in range(n_missing):
                # 60/180/300 degrees: anti + gauche pair = staggered rotamer
                phi = math.radians(60.0 + 120.0 * i)
                m = math.cos(phi) * e1 + math.sin(phi) * e2
                out.append(parent + length * (math.cos(_TET) * units[0]
                                              + math.sin(_TET) * m))
            return out
    if n_total == 3:  # sp2
        if k == 2 and n_missing == 1:
            return [parent + length * _unit(-(units[0] + units[1]))]
        if k == 1 and n_missing == 2:  # planar NH2
            d = units[0]
            if grandparent is not None:
                w = _unit(grandparent - known[0])
                normal = np.cross(d, w)
                normal = (_unit(normal) if np.linalg.norm(normal) > 1e-6
                          else _any_perpendicular(d))
            else:
                normal = _any_perpendicular(d)
            e = np.cross(normal, d)
            c, s = math.cos(math.radians(120.0)), math.sin(math.radians(120.0))
            return [parent + length * (c * d + s * e),
                    parent + length * (c * d - s * e)]
    if n_total == 2 and k == 1 and n_missing == 1:  # hydroxyl / thiol
        u = units[0]
        if grandparent is not None:
            w = _unit(grandparent - known[0])
            e = w - np.dot(w, u) * u
            e = _unit(e) if np.linalg.norm(e) > 1e-6 else _any_perpendicular(u)
        else:
            e = _any_perpendicular(u)
        # anti (dihedral 180 deg) to the grandparent, 109.5 deg bond angle
        return [parent + length * (math.cos(_TET) * u - math.sin(_TET) * e)]
    raise TopologyError(
        f"unsupported hydrogen geometry: {k} placed neighbors, "
        f"{n_missing} missing, coordination {n_total}"
    )


def _assign_disulfides(structure: PDBStructure) -> PDBStructure:
    """Rename CYS -> CYX when two SG atoms sit within 2.5 A (the
    PDBFixer/amber convention); the SG-SG bond itself is added by
    md.topology.build_topology. Any HG on a bridged cysteine is dropped."""
    sgs = []
    for ri, res in enumerate(structure.residues):
        if res.name == "CYS":
            for a in res.atoms:
                if a.name.strip() == "SG":
                    sgs.append((ri, np.asarray(a.xyz)))
    bridged = set()
    for i in range(len(sgs)):
        for j in range(i + 1, len(sgs)):
            if np.linalg.norm(sgs[i][1] - sgs[j][1]) < 0.25:
                bridged.add(sgs[i][0])
                bridged.add(sgs[j][0])
    if not bridged:
        return structure
    out = []
    for ri, res in enumerate(structure.residues):
        if ri in bridged:
            res = PDBResidue(
                name="CYX", resid=res.resid, chain=res.chain,
                atoms=[
                    PDBAtom(a.name, "CYX", a.resid, a.chain, a.xyz, a.element)
                    for a in res.atoms if a.name.strip() != "HG"
                ],
            )
        out.append(res)
    return PDBStructure(residues=out, n_models=structure.n_models,
                        box=structure.box,
                        tilt=getattr(structure, "tilt", None),
                        seqres=structure.seqres)


def add_hydrogens(
    structure: PDBStructure,
    *,
    ph: float = 7.0,
    his_variant: str = "HIE",
    add_oxt: bool = True,
) -> PDBStructure:
    """Return a copy of ``structure`` with all template hydrogens placed.

    Existing hydrogens are kept (only missing ones are added). Terminal
    residues get their NH3+/COO- variants: H1/H2/H3 on the N-terminal
    nitrogen and OXT on the C-terminal carboxylate. Missing HEAVY atoms
    (other than OXT) raise TopologyError — side-chain repair is out of
    scope; fix the model upstream.
    """
    structure = assign_protonation_states(structure, ph=ph, his_variant=his_variant)
    structure = _assign_disulfides(structure)
    chains: Dict[str, List[PDBResidue]] = {}
    for res in structure.residues:
        if res.name in TEMPLATES:
            chains.setdefault(res.chain, []).append(res)

    new_residues: List[PDBResidue] = []
    for res in structure.residues:
        if res.name not in TEMPLATES:
            new_residues.append(res)
            continue
        chain = chains[res.chain]
        idx = chain.index(res)
        is_nterm = idx == 0 and res.name != "ACE"
        is_cterm = idx == len(chain) - 1 and res.name != "NME"
        if is_nterm and res.name in NUCLEIC_RESNAMES:
            # Amber DX5/RX5 termini are 5'-hydroxyl: a crystallographic
            # 5'-phosphate has no template and is stripped LOUDLY here
            # (the template-filter below would otherwise drop it
            # silently, changing the strand's net charge by +1)
            stripped = [
                a.name for a in res.atoms
                if normalize_atom_name(a.name, res.name)
                in ("P", "OP1", "OP2")
            ]
            if stripped:
                warnings.warn(
                    f"stripping 5'-terminal phosphate {stripped} from "
                    f"{res.name}{res.resid} chain {res.chain}: the Amber "
                    "5' terminus is 5'-hydroxyl (DX5/RX5)",
                    stacklevel=2,
                )
        tmpl = get_template(res.name, is_nterm=is_nterm, is_cterm=is_cterm)
        nbrs = _template_graph(tmpl)

        pos: Dict[str, np.ndarray] = {}
        kept: List[PDBAtom] = []
        for a in res.atoms:
            name = normalize_atom_name(a.name, res.name)
            if name in tmpl["atoms"]:
                pos[name] = np.asarray(a.xyz, dtype=np.float64)
                kept.append(a)
        # neighbor-residue bond partners give the N/C atoms full frames
        context: Dict[str, np.ndarray] = {}
        # link-atom names come from the NEIGHBOR templates' tail/head
        # (peptide C/N, nucleic O3'/P) so DNA chains get full frames too
        if not is_nterm and idx > 0:
            prev_tail = get_template(chain[idx - 1].name).get("tail")
            for a in chain[idx - 1].atoms:
                if prev_tail and normalize_atom_name(a.name, chain[idx - 1].name) == prev_tail:
                    context["-C"] = np.asarray(a.xyz, dtype=np.float64)
        if not is_cterm and idx < len(chain) - 1:
            next_head = get_template(chain[idx + 1].name).get("head")
            for a in chain[idx + 1].atoms:
                if next_head and normalize_atom_name(a.name, chain[idx + 1].name) == next_head:
                    context["+N"] = np.asarray(a.xyz, dtype=np.float64)

        missing = [n for n in tmpl["atoms"] if n not in pos]
        missing_heavy = [n for n in missing if not n.startswith("H")
                         and n != "OXT"]
        if missing_heavy:
            raise TopologyError(
                f"residue {res.name} {res.resid} is missing heavy atoms "
                f"{missing_heavy}; hydrogen addition cannot repair heavy "
                "atoms — provide a complete model"
            )

        def neighbor_positions(parent: str) -> Tuple[List[np.ndarray], int]:
            known = [pos[n] for n in nbrs[parent] if n in pos]
            n_total = len(nbrs[parent])
            if parent == tmpl.get("head") and "-C" in context:
                known.append(context["-C"])
                n_total += 1
            if parent == tmpl.get("tail") and "+N" in context:
                known.append(context["+N"])
                n_total += 1
            return known, n_total

        def grandparent_for(parent: str) -> Optional[np.ndarray]:
            for r in nbrs[parent]:
                if r in pos:
                    for g in nbrs[r]:
                        if g != parent and g in pos:
                            return pos[g]
                    if r == tmpl.get("head") and "-C" in context:
                        return context["-C"]
                    if r == tmpl.get("tail") and "+N" in context:
                        return context["+N"]
            return None

        # group missing atoms by parent, place each group at once
        by_parent: Dict[str, List[str]] = {}
        for name in missing:
            parents = [n for n in nbrs[name] if not n.startswith("H")]
            if not parents:
                raise TopologyError(f"{name} has no heavy parent in template")
            by_parent.setdefault(parents[0], []).append(name)

        added: List[PDBAtom] = []
        for parent, names in by_parent.items():
            if parent not in pos:
                raise TopologyError(
                    f"cannot place {names}: parent {parent} missing in "
                    f"{res.name} {res.resid}"
                )
            known, n_total = neighbor_positions(parent)
            is_oxt = names == ["OXT"]
            length = (_OXT_BOND_LENGTH if is_oxt
                      else _H_BOND_LENGTH.get(parent[0], 0.109))
            placed = _place_on_parent(
                pos[parent], known, len(names), n_total, length,
                grandparent_for(parent),
            )
            for name, p in zip(names, placed):
                pos[name] = p
                added.append(PDBAtom(
                    name=name, resname=res.name, resid=res.resid,
                    chain=res.chain, xyz=tuple(float(v) for v in p),
                    element="O" if is_oxt else "H",
                ))
        new_residues.append(PDBResidue(
            name=res.name, resid=res.resid, chain=res.chain,
            atoms=kept + added,
        ))
    return PDBStructure(residues=new_residues, n_models=structure.n_models,
                        box=structure.box,
                        tilt=getattr(structure, "tilt", None),
                        seqres=structure.seqres)


__all__ = ["add_hydrogens", "assign_protonation_states"]
