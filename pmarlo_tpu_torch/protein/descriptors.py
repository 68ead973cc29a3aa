"""Molecular descriptors from the topology graph (the RDKit subset).

The reference computes MolWt / HBD / HBA / TPSA / LogP via RDKit
(src/pmarlo/protein/protein.py:605-617). Here the structural descriptors
are first-party, derived from the matched topology:

- h_bond_donors:    N-H / O-H / S-H bond count (RDKit Lipinski.NumHDonors
  counts donor ATOMS; both are reported).
- h_bond_acceptors: N + O atom count (RDKit Lipinski.NumHAcceptors
  convention).
- tpsa:             Ertl 2000 additive polar surface area over the N/O
  fragment classes that occur in proteins (amide NH, NH2, NH3+, aromatic
  n/nH, ether/hydroxyl O, carbonyl O). Sulfur contributes 0, matching
  RDKit's default TPSA. Charged guanidinium/ammonium nitrogens use the
  Ertl [NH+]/[NH2+]/[NH3+] values — a documented approximation for the
  resonance-delocalized cases.
- gravy:            Kyte-Doolittle grand average of hydropathy — the
  protein-appropriate hydrophobicity scalar (kept alongside logp).
- logp:             Wildman-Crippen (1999) additive atomic logP over the
  atom classes that occur in proteins (see _crippen_type). Parameter
  values transcribed from the published Table 1; a regression test pins
  per-residue sums so any retyping is intentional.
- rotatable_bonds:  single non-ring bonds between heavy atoms of degree
  >= 2, excluding amide C-N bonds (the RDKit strict-ish convention).
- aromatic_rings:   PHE/TYR/HIS-family 1, TRP 2 (structural count).
- heavy_atoms, exact_molecular_weight: counts / monoisotopic masses.

Host copy of ``pmarlo_tpu/protein/descriptors.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Set

#: Ertl et al. 2000 TPSA contributions (A^2) for protein N/O environments
_TPSA = {
    "N_3heavy": 3.24,      # tertiary amine / PRO backbone N
    "NH_2heavy": 12.03,    # secondary amine / backbone amide N-H
    "NH2_1heavy": 26.02,   # primary amide NH2 (ASN/GLN), neutral
    "NH3_plus": 27.64,     # protonated primary amine (LYS NZ, N-term)
    "NH2_plus": 16.61,     # =NH2+ guanidinium terminal N
    "NH_plus_2heavy": 13.97,  # protonated secondary (HIP ring N-H approx)
    "n_arom": 12.89,       # aromatic N, no H (HIS ND1/NE2 unprotonated)
    "nH_arom": 15.79,      # aromatic N-H (TRP NE1, HIS N-H)
    "O_2heavy": 9.23,      # ether O (none in standard residues)
    "OH": 20.23,           # hydroxyl (SER/THR/TYR, protonated acids)
    "O_double": 17.07,     # carbonyl / each carboxylate O
}

#: Kyte-Doolittle hydropathy
_KD = {
    "ALA": 1.8, "ARG": -4.5, "ASN": -3.5, "ASP": -3.5, "CYS": 2.5,
    "GLN": -3.5, "GLU": -3.5, "GLY": -0.4, "HIS": -3.2, "ILE": 4.5,
    "LEU": 3.8, "LYS": -3.9, "MET": 1.9, "PHE": 2.8, "PRO": -1.6,
    "SER": -0.8, "THR": -0.7, "TRP": -0.9, "TYR": -1.3, "VAL": 4.2,
    # protonation variants map to their parents
    "ASH": -3.5, "GLH": -3.5, "LYN": -3.9,
    "HID": -3.2, "HIE": -3.2, "HIP": -3.2,
}

#: aromatic ring nitrogens by (residue family, atom name)
_AROMATIC_N = {
    ("TRP", "NE1"), ("HIS", "ND1"), ("HIS", "NE2"),
    ("HIE", "ND1"), ("HIE", "NE2"), ("HID", "ND1"), ("HID", "NE2"),
    ("HIP", "ND1"), ("HIP", "NE2"),
}

#: positively charged nitrogens (by residue/atom)
_CHARGED_N = {
    ("LYS", "NZ"), ("ARG", "NH1"), ("ARG", "NH2"), ("ARG", "NE"),
    ("HIP", "ND1"), ("HIP", "NE2"),
}


#: Wildman & Crippen 1999 atomic logP contributions (Table 1) for the
#: atom classes that occur in protein topologies. Values transcribed
#: from the published table; tests/unit/test_descriptors.py pins the
#: per-residue sums so retyping is always an intentional change.
_CRIPPEN = {
    "C1": 0.1441,   # aliphatic CH3/CH2 bonded only to C/H
    "C2": 0.0000,   # aliphatic CH/C bonded only to C/H
    "C3": -0.2035,  # aliphatic CH3/CH2 bonded to a heteroatom
    "C4": -0.2051,  # aliphatic CH/C bonded to a heteroatom
    "C5": -0.2783,  # C double-bonded to a heteroatom (amide/acid/guanidinium)
    "C10": -0.0516,  # aliphatic CH2 attached to an aromatic atom
    "C18": 0.1581,  # aromatic CH
    "C19": 0.2955,  # aromatic bridgehead (three aromatic neighbors)
    "C21": 0.1360,  # aromatic C attached to aliphatic C
    "C23": 0.5437,  # aromatic C attached to O (phenol)
    "N1": -1.0190,  # primary amine NH2 (neutral)
    "N2": -0.7096,  # secondary N-H (amide/backbone)
    "N7": -0.3187,  # tertiary aliphatic N (PRO backbone)
    "N10": -1.9500,  # protonated N (NH3+/=NH2+)
    "N11": -0.3239,  # aromatic n (neutral, with or without H)
    "N12": -1.1190,  # aromatic n+ (HIP)
    "O2": -0.2893,  # hydroxyl O
    "O9": -0.1526,  # carbonyl O (=O)
    "O12": -1.3260,  # carboxylate O-
    "S1": 0.6482,   # thiol/thioether S
    "H1": 0.1230,   # H on C/S
    "H2": -0.2677,  # H on O
    "H3": 0.2142,   # H on N
}

#: aromatic ring heavy atoms by residue family
_AROMATIC_ATOMS = {
    "PHE": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
    "TYR": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
    "TRP": {"CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"},
    "HIS": {"CG", "ND1", "CD2", "CE1", "NE2"},
    "HID": {"CG", "ND1", "CD2", "CE1", "NE2"},
    "HIE": {"CG", "ND1", "CD2", "CE1", "NE2"},
    "HIP": {"CG", "ND1", "CD2", "CE1", "NE2"},
}

#: residue -> aromatic ring count
_RING_COUNT = {"PHE": 1, "TYR": 1, "TRP": 2,
               "HIS": 1, "HID": 1, "HIE": 1, "HIP": 1}

#: sp2 carbons double-bonded to a heteroatom, by (residue base, name);
#: backbone "C" is handled generically
_CARBONYL_C = {
    ("ASP", "CG"), ("ASH", "CG"), ("ASN", "CG"),
    ("GLU", "CD"), ("GLH", "CD"), ("GLN", "CD"),
    ("ARG", "CZ"), ("ACE", "C"),
}

#: monoisotopic masses (amu)
_MONO_MASS = {"H": 1.00782503, "C": 12.0, "N": 14.0030740,
              "O": 15.9949146, "S": 31.9720707}


def _res_base(rn: str) -> str:
    return rn[1:] if len(rn) == 4 and rn[0] in "NC" else rn


def _crippen_type(i, elements, names, resnames, neighbors) -> str:
    """Wildman-Crippen atom class for atom ``i`` of a protein topology."""
    elem = elements[i]
    name = names[i]
    base = _res_base(resnames[i])
    arom_set = _AROMATIC_ATOMS.get(base, set())
    is_arom = name in arom_set
    nbrs = sorted(neighbors[i])
    n_h = sum(1 for j in nbrs if elements[j] == "H")
    heavy = [j for j in nbrs if elements[j] != "H"]
    het = any(elements[j] in ("N", "O", "S") for j in heavy)
    arom_nbrs = sum(
        1 for j in heavy
        if names[j] in _AROMATIC_ATOMS.get(_res_base(resnames[j]), set())
        and resnames[j] == resnames[i]
    )

    if elem == "C":
        if is_arom:
            if arom_nbrs >= 3:
                return "C19"
            if (base, name) == ("TYR", "CZ"):
                return "C23"
            if n_h == 0 and any(
                elements[j] == "C" and names[j] not in arom_set
                for j in heavy
            ):
                return "C21"
            return "C18"
        if name == "C" or (base, name) in _CARBONYL_C:
            return "C5"  # amide/acid/guanidinium carbon
        if arom_nbrs > 0:
            return "C10"
        if het:
            return "C3" if n_h >= 2 else "C4"
        return "C1" if n_h >= 2 else "C2"

    if elem == "N":
        if is_arom:
            if base == "HIP" and name == "ND1":
                return "N12"  # formal + assigned to ND1
            return "N11"
        if n_h >= 3:
            return "N10"  # NH3+ (LYS NZ, N-terminus)
        if (base, name) == ("ARG", "NH1"):
            return "N10"  # =NH2+ (guanidinium formal charge)
        if n_h == 2:
            return "N1"
        if n_h == 1:
            return "N2"
        return "N7"

    if elem == "O":
        if n_h >= 1:
            return "O2"
        if len(heavy) == 1:
            # =O vs carboxylate O-: deprotonated acids carry the formal
            # minus on the second oxygen of the pair
            if (base, name) in (("ASP", "OD2"), ("GLU", "OE2")):
                return "O12"
            if name == "OXT":
                return "O12"
            return "O9"
        return "O2"  # ether-like O (none in standard residues)

    if elem == "S":
        return "S1"

    if elem == "H":
        j = nbrs[0] if nbrs else -1
        if j >= 0 and elements[j] == "O":
            return "H2"
        if j >= 0 and elements[j] == "N":
            return "H3"
        return "H1"

    return "C2"  # neutral fallback for exotic elements


def compute_logp(topology) -> float:
    """Wildman-Crippen additive logP over the protein atom classes."""
    neighbors = topology.neighbor_sets()
    total = 0.0
    for i in range(topology.n_atoms):
        t = _crippen_type(
            i, topology.elements, topology.atom_names,
            topology.residue_names, neighbors,
        )
        total += _CRIPPEN[t]
    return total


def _bond_in_ring(a: int, b: int, neighbors, residue_ids) -> bool:
    """True iff bond (a, b) lies on a cycle (BFS a->b avoiding the bond,
    bounded to the residue pair — protein rings never span residues)."""
    rid = {residue_ids[a], residue_ids[b]}
    from collections import deque

    seen = {a}
    q = deque([(a, 0)])
    while q:
        x, d = q.popleft()
        if d > 8:
            continue
        for y in neighbors[x]:
            if (x, y) in ((a, b), (b, a)) or y in seen:
                continue
            if residue_ids[y] not in rid:
                continue
            if y == b:
                return True
            seen.add(y)
            q.append((y, d + 1))
    return False


def count_rotatable_bonds(topology) -> int:
    """Single non-ring bonds between heavy atoms of heavy-degree >= 2,
    excluding amide/guanidinium C-N (the RDKit strict convention)."""
    neighbors = topology.neighbor_sets()
    elements = topology.elements
    names = topology.atom_names
    resnames = topology.residue_names
    heavy_deg = [
        sum(1 for j in neighbors[i] if elements[j] != "H")
        for i in range(topology.n_atoms)
    ]

    def _is_amide_c(i: int) -> bool:
        if elements[i] != "C":
            return False
        base = _res_base(resnames[i])
        return names[i] == "C" or (base, names[i]) in _CARBONYL_C

    n_rot = 0
    for a, b in topology.bonds:
        a, b = int(a), int(b)
        if elements[a] == "H" or elements[b] == "H":
            continue
        if heavy_deg[a] < 2 or heavy_deg[b] < 2:
            continue
        pair = {elements[a], elements[b]}
        if pair == {"C", "N"} and (_is_amide_c(a) or _is_amide_c(b)):
            continue
        if _bond_in_ring(a, b, neighbors, topology.residue_ids):
            continue
        n_rot += 1
    return n_rot


def compute_descriptors(topology) -> Dict[str, float]:
    """Structural descriptor dict from an md.topology.Topology."""
    neighbors = topology.neighbor_sets()
    elements = topology.elements
    names = topology.atom_names
    resnames = topology.residue_names

    hbd_bonds = 0
    hbd_atoms = 0
    hba = 0
    tpsa = 0.0
    for i, elem in enumerate(elements):
        nbrs = sorted(neighbors[i])
        n_h = sum(1 for j in nbrs if elements[j] == "H")
        n_heavy = len(nbrs) - n_h
        if elem in ("N", "O", "S") and n_h > 0:
            hbd_bonds += n_h
            hbd_atoms += 1
        if elem in ("N", "O"):
            hba += 1
        # --- Ertl TPSA classification -----------------------------------
        key = (resnames[i], names[i])
        base = (resnames[i][:3] if resnames[i][0] in "NC" and
                len(resnames[i]) == 4 else resnames[i])
        key_base = (base, names[i])
        if elem == "N":
            is_arom = key_base in _AROMATIC_N or key in _AROMATIC_N
            charged = (key_base in _CHARGED_N or key in _CHARGED_N
                       or n_h == 3)
            if is_arom:
                tpsa += _TPSA["nH_arom"] if n_h else _TPSA["n_arom"]
            elif n_h == 3:
                tpsa += _TPSA["NH3_plus"]
            elif n_h == 2:
                tpsa += (_TPSA["NH2_plus"] if charged
                         else _TPSA["NH2_1heavy"])
            elif n_h == 1:
                tpsa += (_TPSA["NH_plus_2heavy"] if charged
                         else _TPSA["NH_2heavy"])
            else:
                tpsa += _TPSA["N_3heavy"]
        elif elem == "O":
            if n_h >= 1:
                tpsa += _TPSA["OH"]
            elif n_heavy == 1:
                tpsa += _TPSA["O_double"]   # carbonyl / carboxylate O
            else:
                tpsa += _TPSA["O_2heavy"]

    # GRAVY over residues that have a hydropathy value
    seq: List[str] = []
    seen: Set[int] = set()
    for rid, rn in zip(topology.residue_ids, topology.residue_names):
        if rid in seen:
            continue
        seen.add(rid)
        base = rn[1:] if len(rn) == 4 and rn[0] in "NC" else rn
        if base in _KD:
            seq.append(base)
    gravy = (sum(_KD[r] for r in seq) / len(seq)) if seq else float("nan")

    heavy_atoms = sum(1 for e in elements if e != "H")
    aromatic_rings = sum(
        _RING_COUNT.get(_res_base(rn), 0) for rn in topology.residue_sequence
    )
    exact_mw = sum(_MONO_MASS.get(e, 0.0) for e in elements)

    return {
        "h_bond_donors": hbd_bonds,
        "h_bond_donor_atoms": hbd_atoms,
        "h_bond_acceptors": hba,
        "tpsa": round(tpsa, 2),
        "gravy": round(gravy, 3),
        "logp": round(compute_logp(topology), 3),
        "rotatable_bonds": count_rotatable_bonds(topology),
        "aromatic_rings": aromatic_rings,
        "heavy_atoms": heavy_atoms,
        "exact_molecular_weight": round(exact_mw, 4),
    }


__all__ = [
    "compute_descriptors",
    "compute_logp",
    "count_rotatable_bonds",
]
