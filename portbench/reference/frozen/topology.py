"""Frozen copy of ``pmarlo_tpu_torch/md/topology.py`` (pmarlo_tpu_torch at commit be358b3), kept
unchanged under the benchmark as part of its yardstick: the reference
derives its parameters with it and imports nothing of the measured package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .pdb import PDBStructure
from .pdb import TopologyError
from .residues import (
    NONPOLYMER, NUCLEIC_RESNAMES, get_template, normalize_atom_name,
)

_WATER_NAMES = {"HOH", "WAT", "TIP3", "SOL"}
_ION_NAMES = {"NA", "CL", "K", "MG", "ZN", "CA"}


@dataclasses.dataclass
class Topology:
    """Flat atom/bond description of a matched system (host-side)."""

    atom_names: List[str]
    atom_types: List[str]
    charges: np.ndarray            # (N,)
    elements: List[str]
    residue_names: List[str]       # per atom
    residue_ids: List[int]         # per atom
    bonds: np.ndarray              # (NB, 2) int
    positions: np.ndarray          # (N, 3) nm
    residue_atom_ranges: List[Tuple[int, int]]  # per residue [start, stop)
    residue_sequence: List[str]
    #: per-atom chain identifier; feature index derivation (phi/psi/DSSP)
    #: needs it to avoid building dihedrals across chain boundaries when
    #: residue numbering runs continuously through multiple chains
    chain_ids: Optional[List[str]] = None
    #: virtual sites (md/vsites.py): (V, 4) int [site, p0, p1, p2] and
    #: (V, 3) ThreeParticleAverageSite weights. None -> no sites.
    vsites: Optional[np.ndarray] = None
    vsite_weights: Optional[np.ndarray] = None
    #: (V,) int: 0 = three-particle average, 1 = out-of-plane (TIP5P)
    vsite_kind: Optional[np.ndarray] = None

    @property
    def n_atoms(self) -> int:
        return len(self.atom_names)

    def neighbor_sets(self) -> List[Set[int]]:
        # memoized: build_system's parameter/exclusion assembly calls the
        # graph walks repeatedly; on a 12k-atom system the repeated
        # Python traversals (dihedral enumeration especially) dominated
        # prep cost. Topology is treated as immutable after build.
        cached = self.__dict__.get("_neighbor_sets")
        if cached is not None:
            return cached
        neighbors: List[Set[int]] = [set() for _ in range(self.n_atoms)]
        for a, b in self.bonds:
            neighbors[int(a)].add(int(b))
            neighbors[int(b)].add(int(a))
        self.__dict__["_neighbor_sets"] = neighbors
        return neighbors

    def angles(self) -> np.ndarray:
        """All unique bonded triples (i, j, k): paths of length 2."""
        cached = self.__dict__.get("_angles")
        if cached is not None:
            return cached
        neighbors = self.neighbor_sets()
        out = []
        for j in range(self.n_atoms):
            nbrs = sorted(neighbors[j])
            for ii in range(len(nbrs)):
                for kk in range(ii + 1, len(nbrs)):
                    out.append((nbrs[ii], j, nbrs[kk]))
        arr = np.asarray(out, dtype=np.int64).reshape(-1, 3)
        self.__dict__["_angles"] = arr
        return arr

    def proper_dihedrals(self) -> np.ndarray:
        """All unique bonded quadruples (i, j, k, l): paths of length 3."""
        cached = self.__dict__.get("_proper_dihedrals")
        if cached is not None:
            return cached
        neighbors = self.neighbor_sets()
        out = []
        for j, k in ((int(a), int(b)) for a, b in self.bonds):
            for i in neighbors[j]:
                if i == k:
                    continue
                for l in neighbors[k]:
                    if l == j or l == i:
                        continue
                    out.append((i, j, k, l))
        arr = np.asarray(out, dtype=np.int64).reshape(-1, 4)
        self.__dict__["_proper_dihedrals"] = arr
        return arr

    def improper_candidates(self) -> List[Tuple[int, int, int, int]]:
        """(i, j, center, l) quadruples at trivalent centers.

        Amber improper convention: central atom third; the unique
        "out-of-plane" atom last is handled at parameter-match time by
        trying each neighbor permutation.
        """
        neighbors = self.neighbor_sets()
        out = []
        for c in range(self.n_atoms):
            nbrs = sorted(neighbors[c])
            if len(nbrs) != 3:
                continue
            out.append((nbrs[0], nbrs[1], c, nbrs[2]))
        return out

    def exclusion_maps(self) -> Tuple[Set[Tuple[int, int]], Set[Tuple[int, int]]]:
        """Return (excluded12_13, pairs14) as sets of ordered (i<j) tuples."""
        cached = self.__dict__.get("_exclusion_maps")
        if cached is not None:
            return cached
        neighbors = self.neighbor_sets()
        excl: Set[Tuple[int, int]] = set()
        for a, b in self.bonds:
            i, j = int(a), int(b)
            excl.add((min(i, j), max(i, j)))
        for trip in self.angles():
            i, k = int(trip[0]), int(trip[2])
            excl.add((min(i, k), max(i, k)))
        pairs14: Set[Tuple[int, int]] = set()
        for quad in self.proper_dihedrals():
            i, l = int(quad[0]), int(quad[3])
            key = (min(i, l), max(i, l))
            if key not in excl:
                pairs14.add(key)
        self.__dict__["_exclusion_maps"] = (excl, pairs14)
        return excl, pairs14


def build_topology(
    structure: PDBStructure,
    *,
    keep_waters: bool = False,
) -> Topology:
    """Match each residue of a structure to a force-field template.

    Atoms are re-ordered into canonical template order. Terminal residues
    are detected positionally (first/last protein residue per chain) and
    matched against terminal variants when the structure carries the
    terminal atoms (H1..H3 / OXT).
    """
    residues = [
        r for r in structure.residues
        if keep_waters or (r.name not in _WATER_NAMES and r.name not in _ION_NAMES)
    ]
    if not residues:
        raise TopologyError("structure contains no matchable residues")

    # chain boundaries; chains split into segments at broken peptide
    # bonds (C->N distance beyond 2.4 A, vs the 1.33 A equilibrium) so a
    # crystal-structure gap is never bonded across (each fragment gets
    # its own head/tail treatment)
    raw_chains: Dict[str, List[int]] = {}
    for idx, r in enumerate(residues):
        raw_chains.setdefault(r.chain, []).append(idx)

    def _atom_pos(res, name):
        for a in res.atoms:
            if normalize_atom_name(a.name, res.name) == name:
                return np.asarray(a.xyz)
        return None

    chains: Dict[str, List[int]] = {}
    for cid, idxs in raw_chains.items():
        seg = 0
        current: List[int] = [idxs[0]]
        for prev, nxt in zip(idxs[:-1], idxs[1:]):
            # polymer adjacency: peptide C->N, or nucleic O3'->P
            # (md/nucleic.py DNA templates link tail O3' to head P)
            c = _atom_pos(residues[prev], "C")
            n = _atom_pos(residues[nxt], "N")
            if c is None or n is None:
                c = _atom_pos(residues[prev], "O3'")
                n = _atom_pos(residues[nxt], "P")
            # no link pair = non-polymer adjacency (waters/ions sharing
            # the protein's chain id in solvated exports): break here, or
            # the trailing waters would keep the protein's LAST residue
            # from being segment-last and its OXT would mismatch the
            # interior template
            broken = (
                c is None or n is None
                or float(np.linalg.norm(c - n)) > 0.24
            )
            if broken:
                chains[f"{cid}#{seg}"] = current
                seg += 1
                current = [nxt]
            else:
                current.append(nxt)
        chains[f"{cid}#{seg}" if seg else cid] = current

    atom_names: List[str] = []
    atom_types: List[str] = []
    charges: List[float] = []
    elements: List[str] = []
    res_names: List[str] = []
    res_ids: List[int] = []
    chain_list: List[str] = []
    positions: List[Tuple[float, float, float]] = []
    bonds: List[Tuple[int, int]] = []
    ranges: List[Tuple[int, int]] = []
    vsite_rows: List[Tuple[int, int, int, int]] = []
    vsite_w: List[Tuple[float, float, float]] = []
    vsite_kind: List[int] = []
    seq: List[str] = []

    # map (res index in `residues`, template atom name) -> global index
    head_tail: List[Tuple[Optional[int], Optional[int]]] = []

    segment_of: Dict[int, List[int]] = {}
    for seg_ids in chains.values():
        for idx in seg_ids:
            segment_of[idx] = seg_ids

    for ridx, res in enumerate(residues):
        chain_ids = segment_of[ridx]
        is_first = ridx == chain_ids[0]
        is_last = ridx == chain_ids[-1]
        present = {normalize_atom_name(a.name, res.name): a for a in res.atoms}
        is_polymer = res.name not in NONPOLYMER
        if res.name in NUCLEIC_RESNAMES:
            # nucleic termini are positional: 5'-OH (no phosphate) at
            # segment start, 3'-OH at segment end (Amber DX5/DX3)
            wants_nterm = is_first
            wants_cterm = is_last
            if is_first and "P" in present:
                raise TopologyError(
                    f"residue {res.name}{res.resid}: 5'-phosphorylated "
                    "terminus is not supported — the Amber DX5/RX5 "
                    "termini are 5'-hydroxyl; strip P/OP1/OP2 first "
                    "(Protein.prepare()/add_hydrogens does this and "
                    "logs a warning)"
                )
        else:
            wants_nterm = (
                is_polymer and is_first and res.name not in ("ACE", "NME")
                and ("H1" in present or "H2" in present or "H3" in present)
            )
            wants_cterm = (is_polymer and is_last
                           and res.name not in ("ACE", "NME")
                           and "OXT" in present)
        try:
            if res.name in _WATER_NAMES and "L1" in present:
                # 5-site water: lone-pair atoms (L1/L2, EP1/LP1
                # normalized) route to the TIP5P template
                from .residues import TEMPLATES

                template = TEMPLATES["HOH5"]
            elif res.name in _WATER_NAMES and "M" in present:
                # 4-site water: a water residue carrying an M/EPW
                # virtual-site atom routes to the TIP4P-Ew template
                from .residues import TEMPLATES

                template = TEMPLATES["HOH4"]
            else:
                template = get_template(
                    res.name, is_nterm=wants_nterm, is_cterm=wants_cterm
                )
        except KeyError as exc:
            raise TopologyError(str(exc)) from exc

        t_atoms: Dict[str, Tuple[str, float]] = template["atoms"]  # type: ignore[assignment]
        missing = [n for n in t_atoms if n not in present]
        if missing:
            raise TopologyError(
                f"residue {res.name}{res.resid}: missing atoms {missing} "
                f"(present: {sorted(present)})"
            )
        extra = [n for n in present if n not in t_atoms]
        if extra:
            raise TopologyError(
                f"residue {res.name}{res.resid}: unmatched atoms {extra} for "
                f"template ({'N-term' if wants_nterm else 'C-term' if wants_cterm else 'interior'})"
            )

        start = len(atom_names)
        local: Dict[str, int] = {}
        for name in t_atoms:  # template order is canonical
            a = present[name]
            atype, q = t_atoms[name]
            local[name] = len(atom_names)
            atom_names.append(name)
            atom_types.append(atype)
            charges.append(q)
            elements.append(a.element)
            res_names.append(res.name)
            res_ids.append(res.resid)
            chain_list.append(res.chain)
            positions.append(a.xyz)
        ranges.append((start, len(atom_names)))
        seq.append(res.name)
        for a_name, b_name in template["bonds"]:  # type: ignore[union-attr]
            bonds.append((local[a_name], local[b_name]))
        for site, entry in template.get("vsites", {}).items():
            # 6-tuple = ThreeParticleAverageSite weights; a trailing
            # "oop" marker selects the OutOfPlaneSite construction
            # (md/vsites.py) with [w12, w13, wcross] semantics
            p0, p1, p2, w0, w1, w2 = entry[:6]
            vsite_rows.append(
                (local[site], local[p0], local[p1], local[p2]))
            vsite_w.append((w0, w1, w2))
            vsite_kind.append(1 if len(entry) > 6 and entry[6] == "oop"
                              else 0)
        head = local.get(template["head"]) if template["head"] else None  # type: ignore[arg-type]
        tail = local.get(template["tail"]) if template["tail"] else None  # type: ignore[arg-type]
        head_tail.append((head, tail))

    # peptide bonds along each chain (never to/between solvent or ions)
    for chain_ids in chains.values():
        for prev, nxt in zip(chain_ids[:-1], chain_ids[1:]):
            if (residues[prev].name in NONPOLYMER
                    or residues[nxt].name in NONPOLYMER):
                continue
            tail = head_tail[prev][1]
            head = head_tail[nxt][0]
            if tail is None or head is None:
                raise TopologyError(
                    f"cannot bond residues {residues[prev].name}{residues[prev].resid} -> "
                    f"{residues[nxt].name}{residues[nxt].resid}: missing head/tail"
                )
            bonds.append((tail, head))

    # disulfide bridges: bond CYX SG pairs within 2.5 A (the renaming to
    # CYX happens during prep, protein/hydrogens.py)
    sg_idx = [
        i for i, (n, rn) in enumerate(zip(atom_names, res_names))
        if n == "SG" and rn == "CYX"
    ]
    pos_arr = np.asarray(positions)
    bonded_sg: set = set()
    for a_i in range(len(sg_idx)):
        for b_i in range(a_i + 1, len(sg_idx)):
            i, j = sg_idx[a_i], sg_idx[b_i]
            if np.linalg.norm(pos_arr[i] - pos_arr[j]) < 0.25:
                bonds.append((i, j))
                bonded_sg.update((i, j))
    unpaired = [i for i in sg_idx if i not in bonded_sg]
    if unpaired:
        raise TopologyError(
            "CYX residues without a disulfide partner within 2.5 A: atoms "
            f"{[(res_ids[i], atom_names[i]) for i in unpaired]}; rename them "
            "back to CYS or fix the geometry"
        )

    return Topology(
        atom_names=atom_names,
        atom_types=atom_types,
        charges=np.asarray(charges, dtype=np.float64),
        elements=elements,
        residue_names=res_names,
        residue_ids=res_ids,
        bonds=np.asarray(bonds, dtype=np.int64).reshape(-1, 2),
        positions=np.asarray(positions, dtype=np.float64).reshape(-1, 3),
        residue_atom_ranges=ranges,
        residue_sequence=seq,
        chain_ids=chain_list,
        vsites=(np.asarray(vsite_rows, dtype=np.int64).reshape(-1, 4)
                if vsite_rows else None),
        vsite_weights=(np.asarray(vsite_w, dtype=np.float64).reshape(-1, 3)
                       if vsite_rows else None),
        vsite_kind=(np.asarray(vsite_kind, dtype=np.int64)
                    if vsite_rows else None),
    )


__all__ = ["Topology", "build_topology"]
