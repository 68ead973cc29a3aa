"""Missing-residue loop modeling: NeRF extension + CCD closure.

Completes the PDBFixer-parity surface (reference
src/pmarlo/protein/protein.py:334-373 uses PDBFixer, which rebuilds
missing loop residues from SEQRES): given the chain gaps reported by
``Protein.find_missing_residues``, build the absent residues' backbones
by natural-extension (NeRF) growth from the N-side anchor and close
each loop onto the C-side anchor with cyclic coordinate descent (CCD,
Canutescu & Dunbrack 2003) over the loop's phi/psi torsions.

Only the backbone (N, CA, C, O) is built here; side chains and
hydrogens are then filled by the existing repair/protonation machinery
(protein/repair.py NeRF placement from force-field equilibrium
geometry), so a modeled loop flows through ``prepare()`` like any other
incomplete residue.

Residue identities come from the PDB's SEQRES records when the
numbering can be aligned unambiguously; otherwise gaps fill with
alanine (a documented fallback — PDBFixer requires SEQRES too).

Host copy of ``pmarlo_tpu/protein/loops.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.pdb import PDBAtom, PDBResidue, PDBStructure
from ..utils.errors import TopologyError
from .repair import _nerf_place

# ideal backbone internal coordinates (Engh-Huber averages, nm/deg)
_B_N_CA, _B_CA_C, _B_C_N, _B_C_O = 0.1458, 0.1525, 0.1329, 0.1231
_A_CA_C_N, _A_C_N_CA, _A_N_CA_C = 116.2, 121.7, 111.2
_A_CA_C_O = 120.5


def _deg(x: float) -> float:
    return math.radians(x)


def align_seqres_offset(
    seqres: List[str], residues: Sequence[PDBResidue]
) -> Optional[int]:
    """Offset o such that seqres[resid - o - 1] matches every observed
    residue name; None when no unambiguous alignment exists.

    Crystal numbering is only offset-consistent within a contiguous run
    (gaps shift the mapping), so callers align the LOCAL run around a
    gap (gap_sequence_from_seqres), not a whole chain."""
    if not seqres or not residues:
        return None
    min_rid = min(r.resid for r in residues)
    max_rid = max(r.resid for r in residues)
    candidates = []
    for o in range(max_rid - len(seqres), min_rid):
        ok = True
        for r in residues:
            k = r.resid - o - 1
            if k < 0 or k >= len(seqres) or seqres[k] != r.name:
                ok = False
                break
        if ok:
            candidates.append(o)
    return candidates[0] if len(candidates) == 1 else None


def gap_sequence_from_seqres(
    seqres: List[str],
    chain_residues: Sequence[PDBResidue],
    rid_before: int,
    rid_after: int,
) -> Optional[List[str]]:
    """Missing-residue names for a gap, from SEQRES aligned on the
    contiguous observed run ENDING at ``rid_before`` (numbering offsets
    drift across gaps, so only the local run pins the register). The
    alignment is sanity-checked against the residue after the gap."""
    by_rid = {r.resid: r for r in chain_residues}
    run = []
    rid = rid_before
    while rid in by_rid:
        run.append(by_rid[rid])
        rid -= 1
    run.reverse()
    off = align_seqres_offset(seqres, run[-8:] if len(run) > 8 else run)
    if off is None:
        return None
    pos = rid_before - off - 1
    n_missing = rid_after - rid_before - 1
    names = seqres[pos + 1: pos + 1 + n_missing]
    if len(names) != n_missing:
        return None
    after = by_rid.get(rid_after)
    if (after is not None and pos + 1 + n_missing < len(seqres)
            and seqres[pos + 1 + n_missing] != after.name):
        return None
    return names


def _axis_rotation(points: np.ndarray, origin: np.ndarray, axis: np.ndarray,
                   theta: float) -> np.ndarray:
    """Rodrigues rotation of points about (origin, axis). A degenerate
    axis (coincident pivot atoms in a collapsed trial loop) is a no-op
    rotation rather than a NaN factory."""
    nrm = np.linalg.norm(axis)
    if nrm < 1e-9:
        return points
    u = axis / nrm
    p = points - origin
    cos, sin = math.cos(theta), math.sin(theta)
    return (origin + p * cos + np.cross(u, p) * sin
            + u[None] * (p @ u)[:, None] * (1.0 - cos))


def _ccd_angle(moving: np.ndarray, fixed: np.ndarray,
               origin: np.ndarray, axis: np.ndarray) -> float:
    """Closed-form CCD step: the rotation about (origin, axis) that
    minimizes sum |R(theta) m_i - f_i|^2 (Canutescu & Dunbrack eq. 4)."""
    nrm = np.linalg.norm(axis)
    if nrm < 1e-9:
        return 0.0
    u = axis / nrm
    a = b = 0.0
    for m, f in zip(moving, fixed):
        r = m - origin
        r_par = (r @ u) * u
        r_perp = r - r_par
        nrm = np.linalg.norm(r_perp)
        if nrm < 1e-9:
            continue
        f_vec = f - origin - ((f - origin) @ u) * u
        rh = r_perp / nrm
        sh = np.cross(u, rh)
        a += nrm * (f_vec @ rh)
        b += nrm * (f_vec @ sh)
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return 0.0
    return math.atan2(b, a)


def _build_initial_loop(
    prev_n: np.ndarray, prev_ca: np.ndarray, prev_c: np.ndarray,
    n_res: int, phi: float = -60.0, psi: float = -40.0,
) -> List[Dict[str, np.ndarray]]:
    """NeRF-extend ``n_res`` backbone residues plus a VIRTUAL anchor
    triple (the would-be next residue's N, CA, C) used as the CCD
    target handle. Starts helical (compact), which CCD then bends onto
    the real anchor."""
    res: List[Dict[str, np.ndarray]] = []
    a, b, c = prev_n, prev_ca, prev_c
    psi_prev = psi
    for _ in range(n_res + 1):   # last is the virtual anchor residue
        n = _nerf_place(c, b, a, _B_C_N, _deg(_A_CA_C_N), _deg(psi_prev))
        ca = _nerf_place(n, c, b, _B_N_CA, _deg(_A_C_N_CA), _deg(180.0))
        cc = _nerf_place(ca, n, c, _B_CA_C, _deg(_A_N_CA_C), _deg(phi))
        res.append({"N": n, "CA": ca, "C": cc})
        a, b, c = n, ca, cc
        psi_prev = psi
    return res


def close_loop_ccd(
    prev_anchor: Tuple[np.ndarray, np.ndarray, np.ndarray],
    next_anchor: Tuple[np.ndarray, np.ndarray, np.ndarray],
    n_res: int,
    *,
    max_sweeps: int = 1200,
    tol_nm: float = 0.004,
    seed_conformations: Sequence[Tuple[float, float]] = (
        (-60.0, -40.0), (-120.0, 130.0), (-75.0, 150.0),
    ),
) -> Tuple[List[Dict[str, np.ndarray]], float]:
    """Build and CCD-close a loop of ``n_res`` residues between the two
    (N, CA, C) anchor triples. Returns (backbone dicts, final anchor
    RMSD in nm). Several seed conformations are tried; the best kept."""
    prev_n, prev_ca, prev_c = (np.asarray(p, float) for p in prev_anchor)
    target = np.stack([np.asarray(p, float) for p in next_anchor])

    best: Tuple[float, List[Dict[str, np.ndarray]]] = (np.inf, [])
    for phi, psi in seed_conformations:
        try:
            frames = _build_initial_loop(prev_n, prev_ca, prev_c, n_res,
                                         phi=phi, psi=psi)
        except TopologyError:
            # coincident anchor atoms: this seed cannot even be built —
            # treat like a NaN-RMSD seed and fall through to the loud
            # all-seeds-failed error below
            continue
        # flat coordinate array: 3 atoms per built frame
        coords = np.concatenate([
            np.stack([f["N"], f["CA"], f["C"]]) for f in frames
        ])
        n_atoms = coords.shape[0]
        virtual = slice(n_atoms - 3, n_atoms)

        def rmsd() -> float:
            return float(np.sqrt(np.mean(
                np.sum((coords[virtual] - target) ** 2, axis=1))))

        for _ in range(max_sweeps):
            if rmsd() < tol_nm:
                break
            # the N-anchor residue's psi (CA->C axis) is a legitimate
            # closure DOF too — without it a short loop (2 n_res + 1
            # torsions) can stall short of exact closure
            th = _ccd_angle(coords[virtual], target, prev_ca,
                            prev_c - prev_ca)
            coords[:] = _axis_rotation(coords, prev_ca, prev_c - prev_ca, th)
            for m in range(n_res):
                base = 3 * m
                n_pos, ca_pos, c_pos = coords[base], coords[base + 1], coords[base + 2]
                # phi axis: N->CA, rotates everything after CA
                th = _ccd_angle(coords[virtual], target, n_pos, ca_pos - n_pos)
                coords[base + 2:] = _axis_rotation(
                    coords[base + 2:], n_pos, ca_pos - n_pos, th)
                c_pos = coords[base + 2]
                ca_pos = coords[base + 1]
                # psi axis: CA->C, rotates everything after C
                th = _ccd_angle(coords[virtual], target, ca_pos, c_pos - ca_pos)
                coords[base + 3:] = _axis_rotation(
                    coords[base + 3:], ca_pos, c_pos - ca_pos, th)
        final = rmsd()
        if final < best[0]:
            built = [
                {"N": coords[3 * m], "CA": coords[3 * m + 1],
                 "C": coords[3 * m + 2]}
                for m in range(n_res)
            ]
            best = (final, built)
        if best[0] < tol_nm:
            break
    if not best[1]:
        # every seed produced NaN RMSD (degenerate anchors: coincident
        # N/CA/C give zero-norm rotation axes) — returning an empty
        # frame list would let the caller silently build ZERO residues
        raise ValueError(
            "CCD closure failed for every seed conformation (NaN anchor "
            "RMSD) — the anchor N/CA/C geometry is degenerate; repair "
            "the anchor residues before loop building"
        )
    return best[1], best[0]


def _place_carbonyl_o(frames: List[Dict[str, np.ndarray]],
                      next_n: np.ndarray) -> None:
    """O in the peptide plane opposite the next N."""
    for i, f in enumerate(frames):
        nn = frames[i + 1]["N"] if i + 1 < len(frames) else next_n
        # psi torsion of N-CA-C-(next N); O at psi + 180
        from .repair import _dihedral

        psi = _dihedral(f["N"], f["CA"], f["C"], nn)
        f["O"] = _nerf_place(f["C"], f["CA"], f["N"], _B_C_O,
                             _deg(_A_CA_C_O), psi + math.pi)


def build_missing_loops(
    structure: PDBStructure,
    gaps: Dict[Tuple[str, int, int], int],
    *,
    sequences: Optional[Dict[Tuple[str, int, int], List[str]]] = None,
    seqres: Optional[Dict[str, List[str]]] = None,
    tol_nm: float = 0.005,
) -> Tuple[PDBStructure, Dict[Tuple[str, int, int], float]]:
    """Fill every numbering gap with CCD-closed backbone residues.

    ``gaps``: output of ``Protein.find_missing_residues`` (only entries
    whose resid difference implies genuinely absent residues are built —
    broken-geometry-only "gaps" are left alone). ``sequences`` overrides
    residue names per gap; otherwise SEQRES alignment, falling back to
    poly-ALA. Returns (new structure, per-gap final anchor RMSD nm)."""
    by_key: Dict[Tuple[str, int], PDBResidue] = {
        (r.chain, r.resid): r for r in structure.residues
    }
    closures: Dict[Tuple[str, int, int], float] = {}
    new_residues = list(structure.residues)

    for (chain, rid_before, rid_after), _count in sorted(gaps.items()):
        n_missing = rid_after - rid_before - 1
        if n_missing <= 0:
            continue  # broken geometry without absent residues
        prev = by_key.get((chain, rid_before))
        nxt = by_key.get((chain, rid_after))
        if prev is None or nxt is None:
            continue

        def atom(res, name):
            for a in res.atoms:
                if a.name == name:
                    return np.asarray(a.xyz, float)
            return None

        anchors_prev = tuple(atom(prev, n) for n in ("N", "CA", "C"))
        anchors_next = tuple(atom(nxt, n) for n in ("N", "CA", "C"))
        if any(a is None for a in anchors_prev + anchors_next):
            continue

        names = None
        if sequences and (chain, rid_before, rid_after) in sequences:
            names = list(sequences[(chain, rid_before, rid_after)])
        elif seqres and chain in seqres:
            chain_res = [r for r in structure.residues if r.chain == chain]
            names = gap_sequence_from_seqres(
                seqres[chain], chain_res, rid_before, rid_after
            )
        if names is None:
            names = ["ALA"] * n_missing
        if len(names) != n_missing:
            raise ValueError(
                f"gap {chain}:{rid_before}-{rid_after} needs {n_missing} "
                f"residues, got sequence of {len(names)}"
            )

        frames, final_rmsd = close_loop_ccd(
            anchors_prev, anchors_next, n_missing, tol_nm=tol_nm
        )
        closures[(chain, rid_before, rid_after)] = final_rmsd
        _place_carbonyl_o(frames, anchors_next[0])

        built: List[PDBResidue] = []
        for k, (name, f) in enumerate(zip(names, frames)):
            rid = rid_before + 1 + k
            atoms = [
                PDBAtom(name=an, resname=name, resid=rid, chain=chain,
                        xyz=tuple(float(v) for v in f[an]),
                        element=an[0])
                for an in ("N", "CA", "C", "O")
            ]
            built.append(PDBResidue(name=name, resid=rid, chain=chain,
                                    atoms=atoms))
        # splice after prev, preserving order
        pos = new_residues.index(prev)
        new_residues = new_residues[:pos + 1] + built + new_residues[pos + 1:]

    return (PDBStructure(residues=new_residues, n_models=structure.n_models,
                         box=structure.box,
                         tilt=getattr(structure, "tilt", None)), closures)


__all__ = [
    "build_missing_loops", "close_loop_ccd",
    "align_seqres_offset", "gap_sequence_from_seqres",
]
