"""Geometric feature functions over trajectory tensors.

Port of ``pmarlo_tpu/features/builtins.py``. Every function takes a
trajectory tensor ``(T, N, 3)`` (leading dimensions batch) and static index
arrays, returning ``(T, K)`` feature matrices. The topology-aware index
derivation (phi/psi/chi1 quadruples) is host-side numpy, carried over line
for line (``tests/unit/test_torch_host_copies.py`` compares that half with
its source); the geometry is plain PyTorch with the IUPAC dihedral sign of
``md/forces.py dihedral_angles``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..md.forces import dihedral_angles

_EPS = 1e-12


# --- index derivation (host-side, static) ------------------------------------

def _atoms_by_residue(atom_names, residue_ids) -> dict:
    table: dict = {}
    for i, (name, rid) in enumerate(zip(atom_names, residue_ids)):
        table.setdefault(rid, {})[name] = i
    return table


def _residue_groups(atom_names, residue_ids, chain_ids=None):
    """[(rid, chain, {atom_name: index})] grouped by RUNS of equal
    (resid, chain) in atom order — a resid-keyed dict would merge
    residues from different chains that reuse the same numbering
    (homodimers commonly number every chain 1..N). ``chain_ids``
    (per-atom, optional) also lets dihedral derivation reject
    consecutive-resid neighbors that sit in DIFFERENT chains (continuous
    numbering across chains, common in consolidated exports); without
    it every group reports chain None and only resid continuity guards."""
    if chain_ids is None:
        chain_ids = [None] * len(residue_ids)
    groups: list = []
    prev = object()
    for i, (rid, ch, name) in enumerate(
        zip(residue_ids, chain_ids, atom_names)
    ):
        if (rid, ch) != prev:
            groups.append((int(rid), ch, {}))
            prev = (rid, ch)
        atoms = groups[-1][2]
        if name not in atoms:
            atoms[name] = i
    return groups


def phi_psi_indices(
    atom_names: Sequence[str], residue_ids: Sequence[int],
    chain_ids: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(phi_quads, psi_quads, residue_labels).

    phi_i = C(i-1)-N(i)-CA(i)-C(i);  psi_i = N(i)-CA(i)-C(i)-N(i+1).
    Residues missing backbone atoms (caps) are skipped. Neighbors must be
    true peptide predecessors/successors — consecutive resids in atom
    order AND (when per-atom ``chain_ids`` are given) the same chain; a
    resid jump (missing loop) or a wrap to a new chain never produces a
    dihedral across the gap. Without chain_ids, continuous numbering
    across chains cannot be told apart from one chain — pass them
    (TopologyInfo.from_topology does). DELIBERATE deviation from mdtraj:
    phi and psi are returned as PAIRS per interior residue (mdtraj
    computes them independently, keeping the first residue's psi and the
    last residue's phi); Ramachandran/bias consumers need the pairing.
    """
    groups = _residue_groups(atom_names, residue_ids, chain_ids)
    phi, psi, labels = [], [], []
    for g in range(1, len(groups)):
        rid, ch, res = groups[g]
        prev_rid, prev_ch, prev_res = groups[g - 1]
        if not all(a in res for a in ("N", "CA", "C")):
            continue
        if prev_rid != rid - 1 or prev_ch != ch or "C" not in prev_res:
            continue
        phi_quad = (prev_res["C"], res["N"], res["CA"], res["C"])
        if g + 1 >= len(groups):
            continue
        nxt_rid, nxt_ch, nxt_res = groups[g + 1]
        if nxt_rid != rid + 1 or nxt_ch != ch or "N" not in nxt_res:
            continue
        psi_quad = (res["N"], res["CA"], res["C"], nxt_res["N"])
        phi.append(phi_quad)
        psi.append(psi_quad)
        labels.append(rid)
    return (
        np.asarray(phi, dtype=np.int32).reshape(-1, 4),
        np.asarray(psi, dtype=np.int32).reshape(-1, 4),
        labels,
    )


def omega_indices(
    atom_names: Sequence[str], residue_ids: Sequence[int],
    chain_ids: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[int]]:
    """omega_i = CA(i-1)-C(i-1)-N(i)-CA(i) peptide-bond dihedrals
    (consecutive-resid same-chain groups only — no dihedral across a
    chain break or missing-loop gap)."""
    groups = _residue_groups(atom_names, residue_ids, chain_ids)
    quads, labels = [], []
    for g in range(1, len(groups)):
        (prev_rid, prev_ch, a), (cur_rid, cur_ch, b) = groups[g - 1], groups[g]
        if cur_rid != prev_rid + 1 or cur_ch != prev_ch:
            continue
        prev_ca = a.get("CA", a.get("CH3"))
        cur_ca = b.get("CA", b.get("CH3"))
        if prev_ca is not None and "C" in a and "N" in b and cur_ca is not None:
            quads.append((prev_ca, a["C"], b["N"], cur_ca))
            labels.append(cur_rid)
    return np.asarray(quads, dtype=np.int32).reshape(-1, 4), labels


def chi1_indices(
    atom_names: Sequence[str],
    residue_names: Sequence[str],
    residue_ids: Sequence[int],
) -> Tuple[np.ndarray, List[int]]:
    """chi1 = N-CA-CB-*G quadruples for residues that have them
    (reference builtins.py:138)."""
    gamma_by_res = {
        "THR": "OG1", "SER": "OG", "CYS": "SG", "VAL": "CG1", "ILE": "CG1",
    }
    # residue name per GROUP (run of equal resid in atom order): a
    # resid-keyed dict would merge same-numbered residues across chains
    groups = _residue_groups(atom_names, residue_ids)
    quads, labels = [], []
    gnames = []
    prev = object()
    for rid, rn in zip(residue_ids, residue_names):
        if rid != prev:
            gnames.append(rn)
            prev = rid
    for (rid, _ch, res), rn in zip(groups, gnames):
        gamma = gamma_by_res.get(rn, "CG")
        if all(a in res for a in ("N", "CA", "CB")) and gamma in res:
            quads.append((res["N"], res["CA"], res["CB"], res[gamma]))
            labels.append(rid)
    return np.asarray(quads, dtype=np.int32).reshape(-1, 4), labels


def ca_pair_indices(
    atom_names: Sequence[str], residue_ids: Sequence[int], stride: int = 1
) -> np.ndarray:
    """All (strided) C-alpha pair indices (reference _features.py ca distances)."""
    cas = [i for i, n in enumerate(atom_names) if n == "CA"][::stride]
    pairs = [(a, b) for ai, a in enumerate(cas) for b in cas[ai + 1:]]
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


# --- tensor functions -----------------------------------------------------------

def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)


def as_frames(traj) -> torch.Tensor:
    """Promote (N, 3) -> (1, N, 3); a tensor stays on its device."""
    if not isinstance(traj, torch.Tensor):
        traj = torch.as_tensor(np.asarray(traj), dtype=torch.float32)
    if traj.dim() == 2:
        return traj[None]
    if traj.dim() != 3:
        raise ValueError(
            f"trajectory must be (T, N, 3) or (N, 3); got {tuple(traj.shape)}"
        )
    return traj


def compute_dihedrals(traj, quads) -> torch.Tensor:
    """(T, N, 3), (M, 4) -> (T, M) signed dihedrals in (-pi, pi]."""
    traj = as_frames(traj)
    return dihedral_angles(traj, _index(quads, traj.device))


def compute_distances(traj, pairs) -> torch.Tensor:
    """(T, N, 3), (M, 2) -> (T, M) distances (nm)."""
    traj = as_frames(traj)
    pairs = _index(pairs, traj.device)
    d = traj[:, pairs[:, 0]] - traj[:, pairs[:, 1]]
    return torch.sqrt((d * d).sum(-1) + _EPS)


def compute_angles(traj, triples) -> torch.Tensor:
    """(T, N, 3), (M, 3) -> (T, M) angles (rad)."""
    traj = as_frames(traj)
    t = _index(triples, traj.device)
    a, b, c = traj[:, t[:, 0]], traj[:, t[:, 1]], traj[:, t[:, 2]]
    v1, v2 = a - b, c - b
    cos_t = (v1 * v2).sum(-1) / torch.sqrt(
        (v1 * v1).sum(-1) * (v2 * v2).sum(-1) + _EPS
    )
    return torch.arccos(torch.clamp(cos_t, -1.0, 1.0))


def radius_of_gyration(traj, masses=None) -> torch.Tensor:
    """(T, N, 3) -> (T,) mass-weighted Rg."""
    traj = as_frames(traj)
    if masses is None:
        w = torch.ones(traj.shape[-2], dtype=traj.dtype, device=traj.device)
    else:
        w = torch.as_tensor(np.asarray(masses) if not isinstance(masses, torch.Tensor)
                            else masses, dtype=traj.dtype, device=traj.device)
    w = w / w.sum()
    com = (w[:, None] * traj).sum(-2, keepdim=True)
    d2 = ((traj - com) ** 2).sum(-1)
    return torch.sqrt((w * d2).sum(-1))


def contacts(traj, pairs, cutoff_nm: float = 0.8, beta: float = 50.0) -> torch.Tensor:
    """Smooth contact indicator per pair: sigmoid((cutoff - r) * beta)."""
    r = compute_distances(traj, pairs)
    return torch.sigmoid((cutoff_nm - r) * beta)


def align_to_reference(traj, reference) -> torch.Tensor:
    """Kabsch superposition of every frame onto ``reference (N, 3)``:
    ``(T, N, 3)`` frames, centred and rotated (the reference stays
    centred). One batched SVD of the frames' 3 x 3 covariances; a
    reflection is turned into a rotation by flipping the last singular
    direction, as in JAX."""
    traj = as_frames(traj)
    ref = torch.as_tensor(reference, dtype=traj.dtype, device=traj.device)
    ref = ref - ref.mean(0, keepdim=True)
    x = traj - traj.mean(-2, keepdim=True)
    h = x.transpose(-1, -2) @ ref                                 # (T, 3, 3)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(u @ vt))
    s = torch.ones(traj.shape[0], 3, dtype=traj.dtype, device=traj.device)
    s[:, 2] = d
    rot = (u * s[:, None, :]) @ vt
    return x @ rot


def trig_expand_periodic(features: torch.Tensor) -> torch.Tensor:
    """Expand periodic features into (cos, sin) columns."""
    return torch.cat([torch.cos(features), torch.sin(features)], dim=-1)


__all__ = [
    "phi_psi_indices",
    "omega_indices",
    "chi1_indices",
    "ca_pair_indices",
    "compute_dihedrals",
    "compute_distances",
    "compute_angles",
    "radius_of_gyration",
    "contacts",
    "align_to_reference",
    "trig_expand_periodic",
]
