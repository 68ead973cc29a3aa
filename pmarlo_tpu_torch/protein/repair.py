"""Missing heavy-atom reconstruction (PDBFixer ``addMissingAtoms`` parity).

The reference repairs incomplete X-ray models through PDBFixer
(src/pmarlo/protein/protein.py:334-373: findMissingAtoms/addMissingAtoms)
before protonation. Here the same capability is first-party: missing
side-chain (and terminal backbone) heavy atoms are rebuilt by internal-
coordinate placement (NeRF) using the force field's own equilibrium bond
lengths and angles (md/ff_params), with torsions chosen from staggered
candidates by clash avoidance. The energy minimizer that precedes any MD
run relaxes the reconstructed geometry, exactly as it does for PDBFixer
output.

Scope: any heavy atom with a placed anchor chain A-B-C (bonded neighbor A,
its neighbor B, and B's neighbor C, all present or previously rebuilt) can
be reconstructed — in practice every truncated side chain and missing
backbone O/OXT. Residues so incomplete that no anchor chain exists (e.g.
missing CA) still raise TopologyError.

Host copy of ``pmarlo_tpu/protein/repair.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure
from ..md.ff_params import TYPE_ELEMENTS, lookup_angle, lookup_bond
from ..md.residues import NUCLEIC_RESNAMES, TEMPLATES, normalize_atom_name
from ..utils.errors import TopologyError

_CLASH_RADIUS_NM = 0.10  # reject candidate torsions closer than this


def _element_of(amber_type: str) -> str:
    return TYPE_ELEMENTS.get(amber_type, amber_type[:1])


def _heavy_template_atoms(resname: str) -> Dict[str, str]:
    """name -> amber type for non-hydrogen atoms of the base template."""
    tpl = TEMPLATES[resname]
    out = {}
    for name, (atype, _q) in tpl["atoms"].items():
        if _element_of(atype) != "H":
            out[name] = atype
    return out


def _nerf_place(
    a: np.ndarray, b: np.ndarray, c: np.ndarray,
    r: float, theta: float, phi: float,
) -> np.ndarray:
    """Position X with |X-a| = r, angle(X,a,b) = theta, dihedral
    (X,a,b,c) = phi (natural extension of reference frame)."""
    bc = a - b
    bn = np.linalg.norm(bc)
    if bn < 1e-10:
        # coincident anchors cannot define a frame — raise the typed
        # error instead of letting the divide emit NaN + RuntimeWarning
        raise TopologyError(
            "degenerate NeRF anchors: coincident atoms in placement frame"
        )
    bc = bc / bn
    nv = np.cross(b - c, bc)
    nn = np.linalg.norm(nv)
    if nn < 1e-10:  # collinear anchors: any perpendicular works
        ref = (
            np.array([1.0, 0.0, 0.0])
            if abs(bc[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        )
        nv = np.cross(bc, ref)
        nn = np.linalg.norm(nv)
    nv = nv / nn
    m = np.cross(nv, bc)
    d = (
        -r * math.cos(theta) * bc
        + r * math.sin(theta) * math.cos(phi) * m
        + r * math.sin(theta) * math.sin(phi) * nv
    )
    return a + d


def _dihedral(p0, p1, p2, p3) -> float:
    b0 = p0 - p1
    b1 = p2 - p1
    b2 = p3 - p2
    b1n = b1 / np.linalg.norm(b1)
    v = b0 - np.dot(b0, b1n) * b1n
    w = b2 - np.dot(b2, b1n) * b1n
    x = np.dot(v, w)
    y = np.dot(np.cross(b1n, v), w)
    return math.atan2(y, x)


def _five_prime_terminal_keys(structure: PDBStructure) -> set:
    """Keys of first-in-chain nucleic residues. Amber 5' termini
    (DX5/RX5) are 5'-hydroxyl — the phosphate is legitimately absent
    there and must never be reported missing or rebuilt."""
    keys = set()
    for chain in _residue_chains(structure):
        first = chain[0]
        if first.name in NUCLEIC_RESNAMES:
            keys.add((first.chain, first.resid, first.name))
    return keys


def find_missing_heavy_atoms(structure: PDBStructure) -> Dict[Tuple, List[str]]:
    """(chain, resid, resname) -> missing heavy-atom names
    (the reference's PDBFixer.findMissingAtoms surface)."""
    missing: Dict[Tuple, List[str]] = {}
    five_prime = _five_prime_terminal_keys(structure)
    for res in structure.residues:
        if res.name not in TEMPLATES:
            continue
        have = {normalize_atom_name(a.name, res.name) for a in res.atoms}
        tpl_heavy = _heavy_template_atoms(res.name)
        miss = [n for n in tpl_heavy if n not in have]
        if (res.chain, res.resid, res.name) in five_prime:
            miss = [n for n in miss if n not in ("P", "OP1", "OP2")]
        if miss:
            missing[(res.chain, res.resid, res.name)] = miss
    return missing


def _residue_chains(structure: PDBStructure) -> List[List[PDBResidue]]:
    chains: Dict[str, List[PDBResidue]] = {}
    for res in structure.residues:
        if res.name in TEMPLATES:
            chains.setdefault(res.chain, []).append(res)
    return list(chains.values())


def placed_names(res: PDBResidue) -> set:
    return {normalize_atom_name(a.name, res.name) for a in res.atoms}


def repair_missing_atoms(structure: PDBStructure) -> PDBStructure:
    """Return a copy of ``structure`` with missing heavy atoms rebuilt.

    Raises TopologyError when a residue has no anchor chain (three
    connected placed atoms) for some missing atom after all passes.
    """
    missing_map = find_missing_heavy_atoms(structure)
    if not missing_map:
        return structure

    new_residues: List[PDBResidue] = []
    still_missing: List[str] = []
    chain_atoms: Dict[str, List[np.ndarray]] = {}
    for res in structure.residues:
        for a in res.atoms:
            chain_atoms.setdefault(res.chain, []).append(np.asarray(a.xyz))

    # predecessor C position per (chain, resid) for inter-residue anchoring
    prev_c: Dict[Tuple[str, int], np.ndarray] = {}
    for chain in _residue_chains(structure):
        for prev, cur in zip(chain, chain[1:]):
            for a in prev.atoms:
                if normalize_atom_name(a.name, prev.name) == "C":
                    prev_c[(cur.chain, cur.resid)] = np.asarray(a.xyz)

    for res in structure.residues:
        key = (res.chain, res.resid, res.name)
        if key not in missing_map:
            new_residues.append(res)
            continue
        tpl = TEMPLATES[res.name]
        tpl_heavy = _heavy_template_atoms(res.name)
        # bond graph over heavy atoms (+ the inter-residue N anchor)
        neigh: Dict[str, List[str]] = {n: [] for n in tpl_heavy}
        for a, b in tpl["bonds"]:
            if a in tpl_heavy and b in tpl_heavy:
                neigh[a].append(b)
                neigh[b].append(a)
        # hydrogens bonded to a missing heavy atom are orphaned: drop them
        # (PDBFixer semantics — addMissingHydrogens re-places them after
        # repair, as does protein.hydrogens.add_hydrogens in prepare())
        missing_set = set(missing_map[key])
        orphan_h = set()
        for a, b in tpl["bonds"]:
            if a in missing_set and b not in tpl_heavy:
                orphan_h.add(b)
            if b in missing_set and a not in tpl_heavy:
                orphan_h.add(a)
        res_atoms = [
            a for a in res.atoms
            if normalize_atom_name(a.name, res.name) not in orphan_h
        ]
        placed: Dict[str, np.ndarray] = {}
        for a in res_atoms:
            placed[normalize_atom_name(a.name, res.name)] = np.asarray(a.xyz)
        ext_prev_c = prev_c.get((res.chain, res.resid))
        if ext_prev_c is not None and "N" in placed_names(res):
            n_pos = next(
                np.asarray(a.xyz) for a in res.atoms
                if normalize_atom_name(a.name, res.name) == "N"
            )
            # a chain break (gap) disqualifies -C as an anchor
            if float(np.linalg.norm(ext_prev_c - n_pos)) > 0.24:
                ext_prev_c = None
        if ext_prev_c is not None:
            placed.setdefault("-C", ext_prev_c)
            if "N" in neigh:
                neigh["N"] = neigh["N"] + ["-C"]
                neigh["-C"] = ["N"]

        missing = [n for n in missing_map[key]]
        built: Dict[str, np.ndarray] = {}
        progress = True
        while missing and progress:
            progress = False
            for name in list(missing):
                pos = _try_place(
                    name, tpl_heavy, neigh, placed,
                    chain_atoms.get(res.chain, []),
                )
                if pos is not None:
                    placed[name] = pos
                    built[name] = pos
                    chain_atoms.setdefault(res.chain, []).append(pos)
                    missing.remove(name)
                    progress = True
        if missing:
            still_missing.append(
                f"{res.name}{res.resid}:{res.chain} missing {sorted(missing)}"
            )
            new_residues.append(res)
            continue
        atoms = list(res_atoms)
        for name, pos in built.items():
            atype = tpl_heavy[name]
            atoms.append(PDBAtom(
                name=name, resname=res.name, resid=res.resid, chain=res.chain,
                xyz=(float(pos[0]), float(pos[1]), float(pos[2])),
                element=_element_of(atype),
            ))
        new_residues.append(PDBResidue(
            name=res.name, resid=res.resid, chain=res.chain, atoms=atoms
        ))

    if still_missing:
        raise TopologyError(
            "cannot rebuild heavy atoms (no anchor chain): "
            + "; ".join(still_missing)
        )
    return PDBStructure(residues=new_residues, n_models=structure.n_models,
                        box=structure.box,
                        tilt=getattr(structure, "tilt", None),
                        seqres=structure.seqres)


def _small_cycles(neigh: Dict[str, List[str]]) -> List[List[str]]:
    """Simple cycles of length <= 6 (amino-acid rings are 5/6-membered):
    for each edge, the shortest alternative path closes the smallest
    cycle through it."""
    cycles: List[List[str]] = []
    seen_keys = set()
    edges = set()
    for u, vs in neigh.items():
        for v in vs:
            edges.add((u, v) if u < v else (v, u))
    for u, v in edges:
        # BFS u -> v avoiding the direct edge
        from collections import deque

        prev = {u: None}
        q = deque([u])
        while q:
            x = q.popleft()
            if x == v:
                break
            for y in neigh.get(x, []):
                if (x, y) in ((u, v), (v, u)) or y in prev:
                    continue
                prev[y] = x
                q.append(y)
        if v not in prev:
            continue
        path = [v]
        while path[-1] != u:
            path.append(prev[path[-1]])
        if len(path) <= 6:
            key = frozenset(path)
            if key not in seen_keys:
                seen_keys.add(key)
                cycles.append(path)
    return cycles


def _consecutive_on_cycle(
    cycles: List[List[str]], x: str, a: str, b: str, c: str
) -> bool:
    """True iff x-a-b-c appear consecutively (either direction) on one
    cycle — their in-ring dihedral is 0 for a planar ring."""
    for cyc in cycles:
        n = len(cyc)
        idx = {name: i for i, name in enumerate(cyc)}
        if not all(t in idx for t in (x, a, b, c)):
            continue
        for d in (1, -1):
            i = idx[x]
            if (
                cyc[(i + d) % n] == a
                and cyc[(i + 2 * d) % n] == b
                and cyc[(i + 3 * d) % n] == c
            ):
                return True
    return False


def _try_place(
    name: str,
    tpl_heavy: Dict[str, str],
    neigh: Dict[str, List[str]],
    placed: Dict[str, np.ndarray],
    clash_atoms: List[np.ndarray],
) -> Optional[np.ndarray]:
    """Attempt NeRF placement of ``name`` from a placed A-B-C anchor chain.

    Torsion selection is geometry-aware: a chain x-a-b-c consecutive on a
    template ring closes planar (in-ring dihedral 0 — PRO's pucker relaxes
    in the minimizer); on sp2 centers (equilibrium angle >= 115 deg) the
    new atom takes whichever of the two planar slots {0, pi} a placed
    sibling does not occupy; sp3 substituents stagger. Candidates are
    ranked by bond-length satisfaction to every placed template-bonded
    neighbor (ring closure), then by clash distance.
    """
    cycles = _small_cycles(neigh)
    anchor_chains = []
    for a_name in neigh.get(name, []):
        if a_name not in placed:
            continue
        for b_name in neigh.get(a_name, []):
            if b_name == name or b_name not in placed:
                continue
            for c_name in neigh.get(b_name, []):
                if c_name in (name, a_name) or c_name not in placed:
                    continue
                # chains consecutive on a ring have a KNOWN dihedral (0):
                # prefer them
                consec = _consecutive_on_cycle(
                    cycles, name, a_name, b_name, c_name
                )
                anchor_chains.append((not consec, a_name, b_name, c_name))
    anchor_chains.sort(key=lambda t: t[0])

    for not_consec, a_name, b_name, c_name in anchor_chains:
        a, b, c = placed[a_name], placed[b_name], placed[c_name]
        t_m = tpl_heavy.get(name, "CT")
        t_a = tpl_heavy.get(a_name) or ("C" if a_name == "-C" else "CT")
        t_b = tpl_heavy.get(b_name) or ("C" if b_name == "-C" else "CT")
        _, r0_ang = lookup_bond(t_m, t_a)
        _, theta0_deg = lookup_angle(t_m, t_a, t_b)
        r = r0_ang / 10.0  # Angstrom -> nm
        theta = math.radians(theta0_deg)
        sp2 = theta0_deg >= 115.0

        sibling_phis = []
        for d_name in neigh.get(a_name, []):
            if d_name in (name, b_name) or d_name not in placed:
                continue
            sibling_phis.append(_dihedral(placed[d_name], a, b, c))

        if not not_consec:
            candidates = [0.0]  # planar ring closure
        elif sp2:
            # planar center: take the {0, pi} slot no sibling occupies
            free = [0.0, math.pi]
            for sp in sibling_phis:
                for slot in list(free):
                    d = abs(math.remainder(sp - slot, 2 * math.pi))
                    if d < math.pi / 3:
                        free.remove(slot)
            candidates = free if free else [math.pi, 0.0]
        elif sibling_phis:
            candidates = []
            for sp in sibling_phis:
                candidates += [sp + 2 * math.pi / 3, sp - 2 * math.pi / 3]
        else:
            candidates = [math.pi, math.pi / 3, -math.pi / 3]

        # template-bonded placed neighbors beyond A: candidate must also
        # satisfy those bonds (this is what closes rings correctly)
        closure = []
        for n2 in neigh.get(name, []):
            if n2 != a_name and n2 in placed:
                t2 = tpl_heavy.get(n2) or ("C" if n2 == "-C" else "CT")
                _, r2 = lookup_bond(t_m, t2)
                closure.append((placed[n2], r2 / 10.0))

        best, best_key = None, None
        for phi in candidates:
            pos = _nerf_place(a, b, c, r, theta, phi)
            bond_err = sum(
                abs(float(np.linalg.norm(pos - q)) - r2) for q, r2 in closure
            )
            dmin = np.inf
            for other in list(placed.values()) + clash_atoms:
                d = float(np.linalg.norm(pos - other))
                if d > 1e-9:
                    dmin = min(dmin, d)
            key = (round(bond_err, 6), -dmin)
            if best_key is None or key < best_key:
                best, best_key = pos, key
        if best is not None:
            return best
    return None


__all__ = ["repair_missing_atoms", "find_missing_heavy_atoms"]
