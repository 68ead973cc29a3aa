"""Structural features: SASA, hydrogen bonds, secondary-structure fractions,
Kabsch-Sander DSSP and Baker-Hubbard.

Port of ``pmarlo_tpu/features/structure.py`` in plain PyTorch (JAX leaves
all of it to XLA). The host-side index functions (``_element_of``,
``_golden_spiral_points``, ``find_donors_acceptors``, ``_backbone_indices``)
are carried over as they are (``tests/unit/test_torch_host_copies.py``
holds them to their source); the geometry is rewritten for tensors:

- SASA: Shrake-Rupley sphere sampling, JAX's test exactly (a point of atom
  i is buried when ``d2 < r_j^2 - 1e-10`` for some j != i, ``d2`` the
  difference-then-sum-of-squares distance). JAX materializes an (N, P, N)
  comparison for every frame at once; the port walks chunks of frames and
  of the atoms whose points it tests, each chunk's intermediates bounded by
  ``SASA_CHUNK_BYTES``. A point's test does not depend on the chunk, so a
  chunked call equals an unchunked one bit for bit.
- H-bonds: the geometric donor-acceptor criterion (distance + angle),
  smooth (sigmoid) or hard counting.
- Secondary structure: phi/psi-region fractions, and DSSP from
  Kabsch-Sander backbone H-bond energies (helix, strand, coil).

Every function that takes frames takes ``device=None`` and places them as
``featurize_trajectory`` does (``featurize.frames_on_device``): a tensor is
used on its own device (moved to ``device`` when one is given), a host array
goes to ``device``, or to ``_device.default_device()`` when that is None.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from .base import Feature, TopologyInfo, register_feature
from .builtins import compute_dihedrals, phi_psi_indices
from .featurize import frames_on_device

_EPS = 1e-12

# van der Waals radii (nm) by element for SASA
_VDW_RADII = {"H": 0.120, "C": 0.170, "N": 0.155, "O": 0.152, "S": 0.180}
_PROBE_RADIUS = 0.14  # nm (water)

#: bytes of intermediates a SASA chunk may hold: the (frames, atoms, points,
#: atoms) distance and comparison tensors, ~16 bytes an element at peak.
#: Read at each call.
SASA_CHUNK_BYTES = 1 << 30
_SASA_BYTES_PER_TEST = 16


def _element_of(name: str, fallback: str = "C") -> str:
    """Element guess from a PDB atom name (single shared heuristic —
    SASA radii lookup and H-bond donor/acceptor typing must agree)."""
    stripped = name.lstrip("0123456789")
    return (stripped[:1] or fallback).upper()


def _golden_spiral_points(n: int) -> np.ndarray:
    """n approximately-uniform points on the unit sphere."""
    idx = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * idx / n)
    theta = np.pi * (1.0 + 5**0.5) * idx
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=1,
    )


def sasa_radii(atom_names: Sequence[str]) -> np.ndarray:
    """van der Waals radius (nm) of each atom by its element, 0.17 for an
    element without one: the radii the ``sasa`` feature passes to
    :func:`shrake_rupley_sasa`."""
    return np.asarray([_VDW_RADII.get(SASAFeature._element(n), 0.17) for n in atom_names])


def _sasa_chunks(T: int, N: int, P: int) -> Iterator[Tuple[int, int, int, int]]:
    """(t0, t1, i0, i1) blocks of frames and tested atoms whose (frames,
    atoms, P, N) intermediates fit ``SASA_CHUNK_BYTES``: whole frames while
    one fits, else one frame and as many atoms as fit (at least one)."""
    budget = max(int(SASA_CHUNK_BYTES) // _SASA_BYTES_PER_TEST, 1)
    per_frame = N * P * N
    if per_frame <= budget:
        step = budget // per_frame
        for t0 in range(0, T, step):
            yield t0, min(t0 + step, T), 0, N
        return
    step = max(budget // (P * N), 1)
    for t0 in range(T):
        for i0 in range(0, N, step):
            yield t0, t0 + 1, i0, min(i0 + step, N)


def _buried(x: torch.Tensor, radii: torch.Tensor, sphere: torch.Tensor,
            i0: int, i1: int) -> torch.Tensor:
    """(t, i1 - i0, P) bool: point p of atom i in frame t lies inside some
    other atom's solvent-expanded sphere. ``x`` is (t, N, 3)."""
    pts = x[:, i0:i1, None, :] + radii[i0:i1, None, None] * sphere[None, :, :]
    d2 = None
    for k in range(3):
        dk = pts[:, :, :, None, k] - x[:, None, None, :, k]      # (t, I, P, N)
        dk = dk.mul_(dk)
        d2 = dk if d2 is None else d2.add_(dk)
    inside = d2 < (radii**2 - 1e-10)
    del d2
    # a point on atom i's sphere is inside atom i itself numerically
    atoms = torch.arange(x.shape[1], device=x.device)
    self_mask = (atoms[i0:i1, None] == atoms[None, :])[:, None, :]
    return inside.masked_fill_(self_mask, False).any(dim=-1)


def shrake_rupley_sasa(
    traj,
    radii_nm: "np.ndarray | Sequence[float]",
    n_points: int = 96,
    *,
    device=None,
) -> torch.Tensor:
    """Per-atom SASA (nm^2) for every frame: (T, N, 3) -> (T, N).

    For each atom, sample ``n_points`` on its solvent-expanded sphere and
    count points not buried inside any neighbor's sphere. Frames and tested
    atoms go in chunks whose intermediates stay under ``SASA_CHUNK_BYTES``.
    """
    x = frames_on_device(traj, device)
    sphere = torch.as_tensor(_golden_spiral_points(n_points), dtype=torch.float32,
                             device=x.device)
    radii = torch.as_tensor(np.asarray(radii_nm), dtype=torch.float32,
                            device=x.device) + _PROBE_RADIUS
    T, N = x.shape[0], x.shape[1]
    frac = torch.empty((T, N), dtype=torch.float32, device=x.device)
    for t0, t1, i0, i1 in _sasa_chunks(T, N, n_points):
        buried = _buried(x[t0:t1], radii, sphere, i0, i1)
        # JAX's mean: the float32 count times the reciprocal of n_points
        frac[t0:t1, i0:i1] = 1.0 - buried.to(torch.float32).sum(dim=-1) * (1.0 / n_points)
    return 4.0 * math.pi * radii**2 * frac


def _hbond_geometry(x: torch.Tensor, donors: torch.Tensor, acceptors: torch.Tensor):
    """(dist, cos_angle, same) of every (donor, acceptor) pair in every
    frame: the H..A distance (T, D, A), the cosine of the D-H..A angle at
    the hydrogen (linear bond -> -1), and the (D, A) pairs whose acceptor is
    the donor heavy atom."""
    d_heavy = x[:, donors[:, 0]]                     # (T, D, 3)
    d_h = x[:, donors[:, 1]]
    acc = x[:, acceptors]                            # (T, A, 3)
    ha = acc[:, None, :, :] - d_h[:, :, None, :]     # (T, D, A, 3)
    dist = torch.sqrt(torch.sum(ha * ha, dim=-1) + _EPS)
    hd = d_heavy - d_h                               # (T, D, 3)
    hd_n = hd / torch.sqrt(torch.sum(hd * hd, dim=-1, keepdim=True) + _EPS)
    ha_n = ha / dist[..., None]
    cos_angle = torch.sum(hd_n[:, :, None, :] * ha_n, dim=-1)
    same = donors[:, 0][:, None] == acceptors[None, :]
    return dist, cos_angle, same


def _cos_cutoff(angle_cutoff_deg: float, like: torch.Tensor) -> torch.Tensor:
    """cos of the angle cutoff, computed in float32 as JAX does."""
    return torch.cos(torch.deg2rad(torch.tensor(float(angle_cutoff_deg), dtype=torch.float32,
                                                device=like.device)))


def hydrogen_bonds(
    traj,
    donors: np.ndarray,       # (D, 2) [heavy, H] atom indices
    acceptors: np.ndarray,    # (A,) acceptor atom indices
    *,
    distance_cutoff_nm: float = 0.25,
    angle_cutoff_deg: float = 120.0,
    smooth: bool = False,
    device=None,
) -> torch.Tensor:
    """H-bond count per frame by the geometric criterion: H..A distance
    below cutoff and D-H..A angle above cutoff (Baker-Hubbard-style).

    Excludes pairs where the acceptor is the donor heavy atom.
    """
    x = frames_on_device(traj, device)
    donors = torch.as_tensor(np.asarray(donors), dtype=torch.int64, device=x.device)
    acceptors = torch.as_tensor(np.asarray(acceptors), dtype=torch.int64, device=x.device)
    cos_cut = _cos_cutoff(angle_cutoff_deg, x)
    dist, cos_angle, same = _hbond_geometry(x, donors, acceptors)
    if smooth:
        ind = (
            torch.sigmoid((distance_cutoff_nm - dist) * 100.0)
            * torch.sigmoid((cos_cut - cos_angle) * 20.0)
        )
        ind = torch.where(same, 0.0, ind)
        return torch.sum(ind, dim=(1, 2))
    hit = (dist < distance_cutoff_nm) & (cos_angle < cos_cut) & ~same
    return torch.sum(hit.to(torch.float32), dim=(1, 2))


def find_donors_acceptors(
    atom_names: Sequence[str],
    elements: Sequence[str],
    bonds: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Protein donors (N-H, O-H, S-H pairs) and acceptors (O, N with lone
    pairs approximated as all O plus amide-free N)."""
    neighbors = {}
    for a, b in np.asarray(bonds):
        neighbors.setdefault(int(a), []).append(int(b))
        neighbors.setdefault(int(b), []).append(int(a))
    donors = []
    for i, el in enumerate(elements):
        if el != "H":
            continue
        heavy = neighbors.get(i, [None])[0]
        if heavy is not None and elements[heavy] in ("N", "O", "S"):
            donors.append((heavy, i))
    acceptors = []
    for i, el in enumerate(elements):
        if el == "O":
            acceptors.append(i)
        elif el == "N":
            # lone-pair nitrogens: no bonded hydrogen and at most two
            # heavy neighbors (His ND1/NE2 in their unprotonated
            # tautomer); amide/ammonium N (backbone, LYS NZ, ARG NH*)
            # carry H or a delocalized lone pair and do not accept
            nbrs = neighbors.get(i, [])
            if len(nbrs) <= 2 and not any(elements[j] == "H" for j in nbrs):
                acceptors.append(i)
    return (
        np.asarray(donors, dtype=np.int32).reshape(-1, 2),
        np.asarray(acceptors, dtype=np.int32),
    )


# --- secondary structure from phi/psi regions -------------------------------------

def ss_fractions(traj, top: TopologyInfo, *, device=None) -> torch.Tensor:
    """(T, 3) fractions of (alpha, beta, coil) residues per frame.

    phi/psi-region classification (alpha: phi in [-160, -20], psi in
    [-120, 50]; beta: phi in [-180, -45], psi in [90, 180] or [-180, -150]).
    A documented simplification of DSSP (reference builtins.py:219 uses
    mdtraj's DSSP; this geometric rule has no H-bond energy term).
    """
    phi_q, psi_q, _ = phi_psi_indices(top.atom_names, top.residue_ids, top.chain_ids)
    if phi_q.shape[0] == 0:
        raise ValueError("no phi/psi dihedrals for secondary structure")
    x = frames_on_device(traj, device)
    phi = torch.rad2deg(compute_dihedrals(x, phi_q))
    psi = torch.rad2deg(compute_dihedrals(x, psi_q))
    alpha = (
        (phi >= -160.0) & (phi <= -20.0) & (psi >= -120.0) & (psi <= 50.0)
    )
    beta = (
        (phi >= -180.0) & (phi <= -45.0)
        & ((psi >= 90.0) | (psi <= -150.0))
        & ~alpha
    )
    coil = ~alpha & ~beta
    stack = torch.stack([alpha, beta, coil], dim=-1).to(torch.float32)
    return torch.mean(stack, dim=1)


# --- Kabsch-Sander DSSP (reference builtins.py:219 uses mdtraj's DSSP) -----

#: K&S electrostatic H-bond model: E = q1 q2 f (1/rON + 1/rCH - 1/rOH
#: - 1/rCN) with q1 q2 f = 27.888 kcal/mol*A; bond when E < -0.5 kcal/mol
_KS_COUPLING_KCAL_A = 27.888
_KS_CUTOFF_KCAL = -0.5
_NH_BOND_NM = 0.101


def _backbone_indices(
    top: TopologyInfo,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(R, 4) [N, CA, C, O] indices per residue (-1 where missing) and the
    (R,) index of the amide H (-1 when absent — synthesized from the
    previous C=O direction, the standard DSSP reconstruction).

    Residues are grouped SEQUENTIALLY by runs of equal (residue id,
    chain) in atom order — not by a resid-keyed dict, which would merge
    residues from different chains that reuse the same numbering
    (homodimers commonly number every chain 1..N). The returned chain
    array (group-level) lets contiguity tests reject consecutive resids
    that sit in different chains (continuous numbering across chains)."""
    chains = top.chain_ids if top.chain_ids is not None else (
        [None] * len(top.residue_ids)
    )
    groups: list = []
    prev_key = object()
    for i, (rid, ch, name, rn) in enumerate(zip(
        top.residue_ids, chains, top.atom_names, top.residue_names
    )):
        if (rid, ch) != prev_key:
            groups.append((rid, ch, rn, {}))
            prev_key = (rid, ch)
        atoms = groups[-1][3]
        if name in ("N", "CA", "C", "O", "H", "HN") and name not in atoms:
            atoms[name] = i
    bb = np.full((len(groups), 4), -1, np.int64)
    hh = np.full(len(groups), -1, np.int64)
    resnames, rids, gchains = [], [], []
    for r, (rid, ch, rn, atoms) in enumerate(groups):
        for c, name in enumerate(("N", "CA", "C", "O")):
            bb[r, c] = atoms.get(name, -1)
        hh[r] = atoms.get("H", atoms.get("HN", -1))
        resnames.append(rn)
        rids.append(int(rid))
        gchains.append(ch)
    return (bb, hh, np.asarray(resnames), np.asarray(rids, np.int64),
            gchains)


def kabsch_sander_energies(
    traj, top: TopologyInfo, *, device=None
) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """(E, allowed, resnames): E[t, i, j] (T, R, R) is the K&S energy
    (kcal/mol) of the C=O of residue i accepting from the N-H of residue j;
    ``allowed`` (R, R) holds the pairs that may bond (both residues whole,
    j able to donate, not sequence neighbours).

    The amide H is taken from the structure when present, otherwise
    placed 1.01 A from N along the previous peptide's C->O... C=O
    direction (h = n + 0.101 nm * unit(c_prev - o_prev)), exactly the
    Kabsch-Sander reconstruction. Prolines and chain starts never
    donate."""
    bb, hh, resnames, rids, gchains = _backbone_indices(top)
    R = bb.shape[0]
    valid = (bb >= 0).all(axis=1)
    # donors without an explicit H need the previous residue's C/O for H
    # synthesis — and that previous residue must actually be the peptide
    # predecessor: consecutive resids in the same chain. A resid jump
    # (missing loop) or a wrap to a new chain (homodimers renumber from
    # 1) means the adjacent GROUP is an unrelated residue whose C=O
    # direction must not place this residue's amide H.
    has_h = hh >= 0
    contig = np.zeros(R, bool)
    contig[1:] = (rids[1:] == rids[:-1] + 1) & np.asarray(
        [gchains[r] == gchains[r - 1] for r in range(1, R)], bool
    )
    prev_ok = np.zeros(R, bool)
    prev_ok[1:] = valid[:-1]
    prev_ok &= contig
    can_donate = valid & (resnames != "PRO") & (has_h | prev_ok)
    # contiguous-run id per residue group (chain/gap breaks start a run);
    # the |i-j| < 2 exclusion applies to SEQUENCE neighbors only: two
    # group-adjacent residues across a chain break (different run) may
    # legitimately H-bond
    run = np.cumsum(~contig)
    ij = np.arange(R)
    near = (np.abs(ij[:, None] - ij[None, :]) < 2) & (run[:, None] == run[None, :])
    allowed = valid[:, None] & can_donate[None, :] & ~near

    x = frames_on_device(traj, device)
    dev = x.device
    safe_bb = torch.as_tensor(np.where(bb >= 0, bb, 0), device=dev)
    safe_h = torch.as_tensor(np.where(hh >= 0, hh, 0), device=dev)
    n = x[:, safe_bb[:, 0]]
    c = x[:, safe_bb[:, 2]]
    o = x[:, safe_bb[:, 3]]
    # synthesized H: previous residue's C=O direction
    co_prev = torch.roll(c, 1, dims=1) - torch.roll(o, 1, dims=1)
    co_prev = co_prev / (torch.sqrt(torch.sum(co_prev * co_prev, dim=-1, keepdim=True)) + _EPS)
    h_syn = n + _NH_BOND_NM * co_prev
    h = torch.where(torch.as_tensor(has_h, device=dev)[None, :, None], x[:, safe_h], h_syn)

    def inv_dist(a, b):
        d = a[:, None, :, :] - b[:, :, None, :]     # (i=acceptor, j=donor)
        return 1.0 / (10.0 * torch.sqrt(torch.sum(d * d, dim=-1)) + _EPS)

    # E[i, j]: CO of i (acceptor) with NH of j (donor); distances in A
    e = _KS_COUPLING_KCAL_A * (
        inv_dist(n, o) + inv_dist(h, c) - inv_dist(h, o) - inv_dist(n, c)
    )
    return e, torch.as_tensor(allowed, device=dev), resnames


def kabsch_sander_hbonds(
    traj, top: TopologyInfo, *, device=None
) -> Tuple[torch.Tensor, np.ndarray]:
    """(T, R, R) boolean: HB[t, i, j] = C=O of residue i accepts a
    backbone H-bond from N-H of residue j (K&S energy < -0.5 kcal/mol).

    The amide H is taken from the structure when present, otherwise
    synthesized from the previous C=O (see
    :func:`kabsch_sander_energies`). Prolines and chain starts never
    donate."""
    e, allowed, resnames = kabsch_sander_energies(traj, top, device=device)
    return (e < _KS_CUTOFF_KCAL) & allowed[None], resnames


def dssp(traj, top: TopologyInfo, *, device=None) -> torch.Tensor:
    """(T, R) simplified DSSP codes per residue: 0 = coil, 1 = helix
    (H/G/I), 2 = strand (E/B) — mdtraj's ``dssp(simplified=True)``
    classes, computed from Kabsch-Sander backbone H-bond energies.

    Patterns (Kabsch & Sander 1983):
    * n-turn(i) = HB(i, i+n), n in {3, 4, 5}; two consecutive n-turns
      make a helix over the spanned residues (all map to 'H' in the
      simplified alphabet);
    * parallel bridge(i, j): HB(i-1, j) & HB(j, i+1) or HB(j-1, i) &
      HB(i, j+1); antiparallel: HB(i, j) & HB(j, i) or HB(i-1, j+1) &
      HB(j-1, i+1); bridged residues are strand.
    Priority: 4-helix > strand > 3/5-helix (the DSSP override order
    collapsed to the simplified alphabet)."""
    hb, _ = kabsch_sander_hbonds(traj, top, device=device)
    T, R, _ = hb.shape
    dev = hb.device
    ar = torch.arange(R, device=dev)

    def _edge_ok(di, dj):
        oki = (ar + di >= 0) & (ar + di < R)
        okj = (ar + dj >= 0) & (ar + dj < R)
        return oki[:, None] & okj[None, :]

    def shift(m, di, dj):
        """m[i + di, j + dj] with False padding."""
        return torch.roll(torch.roll(m, -di, dims=1), -dj, dims=2) & _edge_ok(di, dj)

    diag = ar[None, :] - ar[:, None]             # j - i

    def turn(n):
        # turn_n[t, i] = HB[t, i, i + n]
        sel = diag == n
        return torch.any(hb & sel[None], dim=2)

    t3, t4, t5 = turn(3), turn(4), turn(5)

    def helix_from_turns(t, n):
        # consecutive turns at i-1 and i mark residues i .. i+n-1
        start = torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1] & t[:, 1:]], dim=1)
        m = torch.zeros_like(start)
        for k in range(n):
            m = m | torch.roll(start, k, dims=1) & (ar[None, :] >= k)
        return m

    helix4 = helix_from_turns(t4, 4)
    helix3 = helix_from_turns(t3, 3)
    helix5 = helix_from_turns(t5, 5)

    far = torch.abs(diag) >= 3
    hbT = hb.transpose(1, 2)                      # hbT[i, j] = HB(j, i)
    # parallel: HB(i-1, j) & HB(j, i+1)  or  HB(j-1, i) & HB(i, j+1)
    par = (shift(hb, -1, 0) & shift(hbT, 1, 0)) | (
        shift(hbT, 0, -1) & shift(hb, 0, 1)
    )
    # antiparallel: HB(i, j) & HB(j, i)  or  HB(i-1, j+1) & HB(j-1, i+1)
    anti = (hb & hbT) | (shift(hb, -1, 1) & shift(hbT, 1, -1))
    bridge = torch.any((par | anti) & far[None], dim=2)

    strand = bridge & ~helix4
    helix = helix4 | ((helix3 | helix5) & ~strand)
    codes = torch.where(helix, 1, torch.where(strand, 2, 0))
    return codes.to(torch.int8)


def ss_fractions_dssp(traj, top: TopologyInfo, *, device=None) -> torch.Tensor:
    """(T, 3) fractions of (helix, strand, coil) residues per frame from
    the Kabsch-Sander DSSP assignment (reference parity path; the
    phi/psi heuristic ``ss_fractions`` remains as the fast path)."""
    codes = dssp(traj, top, device=device)
    h = torch.mean((codes == 1).to(torch.float32), dim=1)
    e = torch.mean((codes == 2).to(torch.float32), dim=1)
    return torch.stack([h, e, 1.0 - h - e], dim=1)


def baker_hubbard(
    traj,
    top: TopologyInfo,
    *,
    freq: float = 0.1,
    distance_cutoff_nm: float = 0.25,
    angle_cutoff_deg: float = 120.0,
    device=None,
) -> np.ndarray:
    """Identify hydrogen bonds present in >= ``freq`` of frames
    (mdtraj.baker_hubbard semantics: H..A < 2.5 A and D-H..A > 120 deg).
    Returns (K, 3) [donor-heavy, H, acceptor] index triplets (int64, on
    the host).

    The per-frame criterion is the same geometric test as
    :func:`hydrogen_bonds`; this adds the occupancy filter over the
    trajectory that defines the Baker-Hubbard method (on the host)."""
    if top.bonds is None:
        raise ValueError("baker_hubbard needs topology bonds")
    donors, acceptors = find_donors_acceptors(
        top.atom_names, [ _element_of(n) for n in top.atom_names ], top.bonds
    )
    if donors.shape[0] == 0 or acceptors.shape[0] == 0:
        return np.zeros((0, 3), np.int64)
    x = frames_on_device(traj, device)
    donors_t = torch.as_tensor(donors, dtype=torch.int64, device=x.device)
    acceptors_t = torch.as_tensor(acceptors, dtype=torch.int64, device=x.device)
    dist, cos_angle, same = _hbond_geometry(x, donors_t, acceptors_t)
    present = (dist < distance_cutoff_nm) & (cos_angle < _cos_cutoff(angle_cutoff_deg, x)) & ~same
    occupancy = torch.mean(present.to(torch.float32), dim=0).cpu().numpy()
    di, ai = np.where(occupancy >= freq)
    return np.stack([
        donors[di, 0], donors[di, 1], np.asarray(acceptors)[ai]
    ], axis=1).astype(np.int64)


# --- registry entries ------------------------------------------------------------

@register_feature("sasa")
class SASAFeature(Feature):
    """Total SASA per frame (reference builtins.py:171)."""

    name = "sasa"

    def __call__(self, traj, top: TopologyInfo):
        return torch.sum(shrake_rupley_sasa(traj, sasa_radii(top.atom_names)), dim=1,
                         keepdim=True)

    @staticmethod
    def _element(name: str) -> str:
        stripped = name.lstrip("0123456789")
        return stripped[0].upper() if stripped else "C"

    def n_outputs(self, top: TopologyInfo) -> int:
        return 1


@register_feature("hbonds")
class HBondFeature(Feature):
    """H-bond count per frame (reference builtins.py Baker-Hubbard)."""

    name = "hbonds"

    def __call__(self, traj, top: TopologyInfo):
        bonds = getattr(top, "bonds", None)
        if bonds is None:
            raise ValueError(
                "hbonds feature needs TopologyInfo with a 'bonds' attribute"
            )
        elements = [SASAFeature._element(n) for n in top.atom_names]
        donors, acceptors = find_donors_acceptors(top.atom_names, elements, bonds)
        if donors.shape[0] == 0 or acceptors.shape[0] == 0:
            raise ValueError("no donors/acceptors found")
        return hydrogen_bonds(traj, donors, acceptors)[:, None]

    def n_outputs(self, top: TopologyInfo) -> int:
        return 1


@register_feature("ssfrac")
class SecondaryStructureFractionFeature(Feature):
    """(alpha, beta, coil) fractions (reference builtins.py:219)."""

    name = "ssfrac"

    def __call__(self, traj, top: TopologyInfo):
        return ss_fractions(traj, top)

    def n_outputs(self, top: TopologyInfo) -> int:
        return 3


__all__ = [
    "shrake_rupley_sasa",
    "hydrogen_bonds",
    "find_donors_acceptors",
    "ss_fractions",
    "kabsch_sander_energies",
    "kabsch_sander_hbonds",
    "dssp",
    "ss_fractions_dssp",
    "baker_hubbard",
    "SASAFeature",
    "HBondFeature",
    "SecondaryStructureFractionFeature",
]
