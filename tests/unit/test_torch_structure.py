"""``pmarlo_tpu_torch.features.structure`` against
``pmarlo_tpu.features.structure`` on the CPU: the mirrors of
``test_structure_features.py`` and ``test_dssp.py``, case for case, then
parity on chignolin (the JAX package's minimized structure and 240 frames
perturbed from it) and on the ideal helix and strand.

Tolerances:

- SASA per atom equal, except atoms with a sphere point within 1e-6 nm^2 of
  its burial threshold (|d2 - r_j^2|, float64); the total within 1e-5
  relative. A chunked call equals an unchunked one bit for bit.
- Hard H-bond counts equal, except frames with a pair within 1e-6 of a
  cutoff (distance in nm, angle cosine); smooth counts within 1e-5
  relative.
- ``ss_fractions`` equal.
- K&S energies within 1e-5 relative of a float64 evaluation of the same
  formula (relative to the sum of its four terms' magnitudes, which set a
  float32 sum's rounding: E is a difference of ~10 kcal/mol terms); the H-bond matrix
  and the DSSP codes equal to JAX's, except pairs within 1e-4 kcal/mol of
  the -0.5 cutoff.
- Baker-Hubbard triplets equal.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu.features import structure as J
from pmarlo_tpu.features.base import TopologyInfo as JTopologyInfo
from pmarlo_tpu.features.base import get_feature as j_get_feature
from pmarlo_tpu.features.featurize import featurize_trajectory as j_featurize
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import CHIGNOLIN_SOLVATED
from pmarlo_tpu_torch.features import featurize_trajectory, get_feature
from pmarlo_tpu_torch.features import structure as S
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.md.topology import build_topology
from test_dssp import GD8   # the 3gd8 structure JAX's DSSP test reads, where it is mounted
from test_torch_structure_card import sasa_point_margin

CPU = "cpu"


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jinfo(info):
    return JTopologyInfo(atom_names=info.atom_names, residue_names=info.residue_names,
                         residue_ids=info.residue_ids, bonds=info.bonds,
                         chain_ids=info.chain_ids)


@pytest.fixture(scope="module")
def chignolin():
    """(port TopologyInfo, JAX TopologyInfo, minimized positions, 240 frames
    perturbed from them by 0.03 nm) — minimized by the JAX package."""
    from pmarlo_tpu.io.pdb import PDBStructure, read_pdb
    from pmarlo_tpu.md.forcefield import build_system
    from pmarlo_tpu.md.minimize import minimize_energy
    from pmarlo_tpu.md.topology import build_topology as j_build_topology

    solvated = read_pdb(CHIGNOLIN_SOLVATED)
    structure = PDBStructure(residues=[r for r in solvated.residues
                                       if r.name not in ("HOH", "NA", "CL")])
    system, positions = build_system(structure, gb_model="gbn2")
    x_min, _ = minimize_energy(system, positions, max_iterations=200)
    x_min = np.asarray(x_min, np.float32)
    topo = j_build_topology(structure)
    info = TopologyInfo(atom_names=topo.atom_names, residue_names=topo.residue_names,
                        residue_ids=topo.residue_ids, bonds=np.asarray(topo.bonds),
                        chain_ids=getattr(topo, "chain_ids", None))
    rng = np.random.default_rng(17)
    frames = (x_min[None] + rng.normal(0.0, 0.03, (240,) + x_min.shape)).astype(np.float32)
    frames[0] = x_min
    return info, _jinfo(info), x_min, frames


# --- mirrors of tests/unit/test_structure_features.py ----------------------------


def test_sasa_isolated_atom():
    traj = np.zeros((1, 1, 3), dtype=np.float32)
    sasa = _np(S.shrake_rupley_sasa(traj, [0.17], n_points=128, device=CPU))
    expected = 4 * np.pi * (0.17 + 0.14) ** 2
    assert abs(sasa[0, 0] - expected) / expected < 1e-5
    np.testing.assert_array_equal(sasa, np.asarray(J.shrake_rupley_sasa(traj, [0.17],
                                                                          n_points=128)))


def test_sasa_buried_atom():
    traj = np.zeros((1, 7, 3), dtype=np.float32)
    traj[0, 1:] = np.asarray([[0.25, 0, 0], [-0.25, 0, 0], [0, 0.25, 0], [0, -0.25, 0],
                              [0, 0, 0.25], [0, 0, -0.25]])
    sasa = _np(S.shrake_rupley_sasa(traj, [0.17] * 7, n_points=128, device=CPU))
    assert sasa[0, 0] < 0.2 * (4 * np.pi * 0.31**2)
    np.testing.assert_array_equal(sasa, np.asarray(J.shrake_rupley_sasa(traj, [0.17] * 7,
                                                                          n_points=128)))


def test_hbond_geometric():
    x = np.zeros((1, 3, 3), dtype=np.float32)
    x[0, 1] = [0.1, 0.0, 0.0]
    x[0, 2] = [0.3, 0.0, 0.0]
    donors = np.asarray([[0, 1]], dtype=np.int32)
    acceptors = np.asarray([2], dtype=np.int32)
    assert _np(S.hydrogen_bonds(x, donors, acceptors, device=CPU))[0] == 1.0
    x[0, 2] = [0.1, 0.2, 0.0]
    assert _np(S.hydrogen_bonds(x, donors, acceptors, device=CPU))[0] == 0.0


def test_find_donors_acceptors():
    topo = build_topology(alanine_dipeptide_structure())
    donors, acceptors = S.find_donors_acceptors(topo.atom_names, topo.elements, topo.bonds)
    assert donors.shape[0] == 2 and len(acceptors) == 2
    jd, ja = J.find_donors_acceptors(topo.atom_names, topo.elements, topo.bonds)
    np.testing.assert_array_equal(donors, jd)
    np.testing.assert_array_equal(acceptors, ja)


def _alanine():
    structure = alanine_dipeptide_structure()
    topo = build_topology(structure)
    return TopologyInfo.from_topology(topo), structure.coordinates().astype(np.float32)


def test_ss_fractions():
    info, x = _alanine()
    frac = _np(S.ss_fractions(x[None], info, device=CPU))
    assert frac.shape == (1, 3)
    np.testing.assert_allclose(frac.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(frac, np.asarray(J.ss_fractions(x[None], _jinfo(info))))


def test_feature_registry_entries():
    info, x = _alanine()
    traj = x[None]
    sasa = get_feature("sasa")(torch.as_tensor(traj), info)
    assert sasa.shape == (1, 1) and float(sasa[0, 0]) > 0
    assert get_feature("hbonds")(torch.as_tensor(traj), info).shape == (1, 1)
    assert get_feature("ssfrac")(torch.as_tensor(traj), info).shape == (1, 3)
    jinfo = _jinfo(info)
    for name, rtol in (("sasa", 1e-5), ("hbonds", 0), ("ssfrac", 0)):
        # the SASA total sums the atoms in another order than XLA
        np.testing.assert_allclose(_np(get_feature(name)(torch.as_tensor(traj), info)),
                                   np.asarray(j_get_feature(name)(traj, jinfo)),
                                   rtol=rtol, atol=0)


def test_hbonds_feature_needs_bonds():
    info, x = _alanine()
    bare = TopologyInfo(info.atom_names, info.residue_names, info.residue_ids)
    with pytest.raises(ValueError, match="bonds"):
        get_feature("hbonds")(torch.as_tensor(x[None]), bare)


def test_dcd_roundtrip(tmp_path):
    from pmarlo_tpu_torch.io.dcd import probe_dcd, read_dcd, write_dcd

    rng = np.random.default_rng(0)
    coords = rng.normal(size=(5, 22, 3)).astype(np.float32)
    path = write_dcd(tmp_path / "t.dcd", coords, dt_ps=0.002, save_interval=100)
    assert probe_dcd(path) == (5, 22)
    np.testing.assert_allclose(read_dcd(path), coords, atol=1e-5)
    np.testing.assert_allclose(read_dcd(path, start=2, count=2), coords[2:4], atol=1e-5)


def test_single_frame_input_promotes_to_frame_axis():
    x = np.zeros((3, 3), dtype=np.float32)
    x[1] = [0.1, 0.0, 0.0]
    x[2] = [0.3, 0.0, 0.0]
    donors = np.asarray([[0, 1]], dtype=np.int32)
    acceptors = np.asarray([2], dtype=np.int32)
    flat = _np(S.hydrogen_bonds(x, donors, acceptors, device=CPU))
    framed = _np(S.hydrogen_bonds(x[None], donors, acceptors, device=CPU))
    assert flat.shape == (1,)
    np.testing.assert_array_equal(flat, framed)
    s_flat = _np(S.shrake_rupley_sasa(x, [0.17] * 3, n_points=32, device=CPU))
    s_framed = _np(S.shrake_rupley_sasa(x[None], [0.17] * 3, n_points=32, device=CPU))
    assert s_flat.shape == (1, 3)
    np.testing.assert_allclose(s_flat, s_framed)
    with pytest.raises(ValueError, match="trajectory"):
        S.shrake_rupley_sasa(np.zeros((2, 1, 3, 3), np.float32), [0.17], device=CPU)


def test_lone_pair_nitrogen_acceptors():
    elements = ["N", "C", "C", "N", "H", "C"]
    names = ["NE2", "CD2", "CE1", "N", "H", "CA"]
    bonds = np.asarray([[0, 1], [0, 2], [3, 4], [3, 5]])
    donors, acceptors = S.find_donors_acceptors(names, elements, bonds)
    assert 0 in acceptors and 3 not in acceptors
    assert [3, 4] in donors.tolist()


def _backbone_res(offset, with_h):
    names = ["N", "CA", "C", "O"] + (["H"] if with_h else [])
    xyz = np.asarray([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.25, 0.1, 0.0],
                      [0.25, 0.22, 0.0]] + ([[-0.08, 0.06, 0.0]] if with_h else []),
                     np.float32)
    xyz[:, 0] += offset
    return names, xyz


def test_kabsch_sander_chain_break_blocks_h_synthesis():
    names, coords, rids, resnames = [], [], [], []
    for i, (rid, with_h) in enumerate([(1, True), (2, True), (1, False)]):
        n_, x_ = _backbone_res(0.5 * i, with_h)
        names += n_
        coords.append(x_)
        rids += [rid] * len(n_)
        resnames += ["ALA"] * len(n_)
    top = TopologyInfo(atom_names=names, residue_names=resnames, residue_ids=rids)
    x = np.concatenate(coords, axis=0)
    hb, _ = S.kabsch_sander_hbonds(x[None], top, device=CPU)
    assert not bool(hb[0, :, 2].any())
    jhb, _ = J.kabsch_sander_hbonds(x[None], _jinfo(top))
    np.testing.assert_array_equal(_np(hb), np.asarray(jhb))


# --- mirrors of tests/unit/test_dssp.py ------------------------------------------


def _nerf(a, b, c, bond, angle_deg, torsion_deg):
    angle, torsion = np.deg2rad(angle_deg), np.deg2rad(torsion_deg)
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d2 = np.array([-bond * np.cos(angle), bond * np.sin(angle) * np.cos(torsion),
                   bond * np.sin(angle) * np.sin(torsion)])
    return c + d2[0] * bc + d2[1] * m + d2[2] * n


def _ideal_backbone(n_res, phi=-57.0, psi=-47.0, omega=180.0):
    """Poly-ALA backbone (N, CA, C, O per residue) in nm from ideal internal
    coordinates (as ``test_dssp.py`` builds it)."""
    N = [np.array([0.0, 0.0, 0.0])]
    CA = [np.array([1.458, 0.0, 0.0])]
    C = [_nerf(np.array([0.0, 1.0, 0.0]), N[0], CA[0], 1.525, 111.2, 60.0)]
    O = []
    for i in range(n_res - 1):
        n_next = _nerf(N[i], CA[i], C[i], 1.329, 116.2, psi)
        O.append(_nerf(N[i], CA[i], C[i], 1.231, 120.5, psi + 180.0))
        ca_next = _nerf(CA[i], C[i], n_next, 1.458, 121.7, omega)
        c_next = _nerf(C[i], n_next, ca_next, 1.525, 111.2, phi)
        N.append(n_next)
        CA.append(ca_next)
        C.append(c_next)
    O.append(_nerf(N[-1], CA[-1], C[-1], 1.231, 120.5, psi + 180.0))
    coords, names, rids = [], [], []
    for i in range(n_res):
        for nm, p in (("N", N[i]), ("CA", CA[i]), ("C", C[i]), ("O", O[i])):
            coords.append(p / 10.0)
            names.append(nm)
            rids.append(i + 1)
    top = TopologyInfo(atom_names=names, residue_names=["ALA"] * len(names), residue_ids=rids)
    return np.asarray(coords, np.float32), top


def test_ideal_helix_is_helix():
    x, top = _ideal_backbone(16, phi=-57.0, psi=-47.0)
    codes = _np(S.dssp(x[None], top, device=CPU))[0]
    assert (codes[2:-2] == 1).mean() > 0.7, codes
    assert (codes == 2).sum() == 0


def test_extended_strand_is_not_helix():
    x, top = _ideal_backbone(12, phi=-139.0, psi=135.0)
    codes = _np(S.dssp(x[None], top, device=CPU))[0]
    assert (codes == 1).sum() == 0


def test_ks_hbond_pattern_ideal_helix():
    x, top = _ideal_backbone(12)
    hb = _np(S.kabsch_sander_hbonds(x[None], top, device=CPU)[0])[0]
    ij = np.arange(hb.shape[0])
    assert hb[ij[:-4], ij[:-4] + 4][1:-1].mean() > 0.7, np.argwhere(hb)


@pytest.mark.slow
def test_3gd8_matches_crystal_annotation():
    """>= 60% of the residues annotated HELIX in 3gd8 are helix."""
    if not GD8.exists():
        pytest.skip("3gd8 not mounted")
    from pmarlo_tpu_torch.io.pdb import read_pdb

    helix_ranges = [(int(line[21:25]), int(line[33:37]))
                    for line in GD8.read_text().splitlines() if line.startswith("HELIX")]
    assert helix_ranges
    s = read_pdb(GD8)
    names, rids, rnames, coords = [], [], [], []
    for r in s.residues:
        for a in r.atoms:
            names.append(a.name)
            rids.append(r.resid)
            rnames.append(r.name)
            coords.append(a.xyz)
    top = TopologyInfo(atom_names=names, residue_names=rnames, residue_ids=rids)
    x = np.asarray(coords, np.float32)[None]
    codes = _np(S.dssp(x, top, device=CPU))[0]
    order = []
    for rid in rids:
        if rid not in order:
            order.append(rid)
    code_of = dict(zip(order, codes))
    annotated = [rid for lo, hi in helix_ranges for rid in range(lo, hi + 1) if rid in code_of]
    assert np.mean([code_of[rid] == 1 for rid in annotated]) >= 0.6
    frac = _np(S.ss_fractions_dssp(x, top, device=CPU))[0]
    assert 0.3 < frac[0] < 0.95 and frac[2] > 0.03


def test_baker_hubbard_occupancy():
    top = TopologyInfo(atom_names=["O", "H1", "O"], residue_names=["HOH"] * 3,
                       residue_ids=[1, 1, 2], bonds=np.asarray([[0, 1]]))
    good = np.asarray([[0.0, 0.0, 0.0], [0.097, 0.0, 0.0], [0.29, 0.0, 0.0]], np.float32)
    bad = good.copy()
    bad[2, 0] = 1.5
    traj = np.stack([good, bad])
    found = S.baker_hubbard(traj, top, freq=0.4, device=CPU)
    assert found.shape[0] == 1 and tuple(found[0]) == (0, 1, 2) and found.dtype == np.int64
    assert S.baker_hubbard(traj, top, freq=0.6, device=CPU).shape[0] == 0


def test_dssp_multichain_duplicate_resids():
    x1, top1 = _ideal_backbone(12)
    x2 = x1 + np.asarray([5.0, 0.0, 0.0], np.float32)
    top = TopologyInfo(atom_names=list(top1.atom_names) * 2,
                       residue_names=list(top1.residue_names) * 2,
                       residue_ids=list(top1.residue_ids) * 2)
    codes = _np(S.dssp(np.concatenate([x1, x2])[None], top, device=CPU))[0]
    assert codes.shape[0] == 24
    assert (codes[2:10] == 1).mean() > 0.7 and (codes[14:22] == 1).mean() > 0.7


# --- parity with JAX -------------------------------------------------------------


def _sasa_jax(frames, radii, batch=16):
    return np.concatenate([np.asarray(J.shrake_rupley_sasa(frames[i:i + batch], radii))
                           for i in range(0, len(frames), batch)])


def test_sasa_matches_jax_on_chignolin(chignolin):
    info, _, _, frames = chignolin
    frames = frames[:48]
    radii = S.sasa_radii(info.atom_names)
    port = _np(S.shrake_rupley_sasa(frames, radii, device=CPU))
    ref = _sasa_jax(frames, radii)
    assert port.shape == ref.shape == (48, 138)
    assert abs(port.sum() - ref.sum()) <= 1e-5 * ref.sum()
    for t, i in zip(*np.nonzero(port != ref)):
        assert sasa_point_margin(frames[t], radii, i) <= 1e-6, (t, i)
    bound = 4 * np.pi * (radii + 0.14) ** 2
    assert ((port >= 0) & (port <= bound * (1 + 1e-6))).all()


@pytest.mark.parametrize("chunk_bytes", [1, 200_000, 3_000_000, 40_000_000])
def test_chunked_sasa_equals_unchunked(chignolin, chunk_bytes, monkeypatch):
    """Chunks over frames (whole frames fit) and over tested atoms (one
    frame does not) give the unchunked result bit for bit."""
    info, _, _, frames = chignolin
    radii = S.sasa_radii(info.atom_names)
    monkeypatch.setattr(S, "SASA_CHUNK_BYTES", 1 << 34)
    whole = S.shrake_rupley_sasa(frames[:12], radii, device=CPU)
    monkeypatch.setattr(S, "SASA_CHUNK_BYTES", chunk_bytes)
    chunked = S.shrake_rupley_sasa(frames[:12], radii, device=CPU)
    assert torch.equal(whole, chunked)


def test_sasa_chunks_cover_every_block_once(monkeypatch):
    for T, N, budget in ((7, 138, 16 * 138 * 96 * 138 * 3), (2, 300, 16 * 96 * 300 * 70),
                         (3, 5, 1)):
        monkeypatch.setattr(S, "SASA_CHUNK_BYTES", budget)
        seen = np.zeros((T, N), int)
        for t0, t1, i0, i1 in S._sasa_chunks(T, N, 96):
            assert (t1 - t0) * (i1 - i0) * 96 * N * 16 <= max(budget, 16 * 96 * N)
            seen[t0:t1, i0:i1] += 1
        assert (seen == 1).all()


def test_an_assembly_only_buries_points(monkeypatch):
    """Two chignolins side by side: no atom has more SASA than in its own
    copy alone (neighbours can only bury points), and some have less."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly

    structure = chignolin_assembly((2, 1, 1), gap=0.2)
    info = TopologyInfo.from_topology(build_topology(structure))
    x = structure.coordinates().astype(np.float32)
    radii = S.sasa_radii(info.atom_names)
    monkeypatch.setattr(S, "SASA_CHUNK_BYTES", 2_000_000)
    both = _np(S.shrake_rupley_sasa(x, radii, device=CPU))[0]
    alone = np.concatenate([_np(S.shrake_rupley_sasa(x[k * 138:(k + 1) * 138],
                                                     radii[k * 138:(k + 1) * 138],
                                                     device=CPU))[0] for k in range(2)])
    assert (both <= alone).all()
    assert (both < alone).sum() > 0


def _hbond_margin(frames, donors, acceptors, cos_cut):
    """Per frame, the least distance of a pair's H..A distance to 0.25 nm or
    of its angle cosine to the cutoff (float64)."""
    x = frames.astype(np.float64)
    ha = x[:, acceptors][:, None] - x[:, donors[:, 1]][:, :, None]
    dist = np.sqrt((ha**2).sum(-1) + 1e-12)
    hd = x[:, donors[:, 0]] - x[:, donors[:, 1]]
    hd /= np.sqrt((hd**2).sum(-1, keepdims=True) + 1e-12)
    cos = (hd[:, :, None] * ha / dist[..., None]).sum(-1)
    return np.minimum(np.abs(dist - 0.25), np.abs(cos - cos_cut)).reshape(len(x), -1).min(1)


def test_hbonds_match_jax_on_chignolin(chignolin):
    info, _, _, frames = chignolin
    elements = [S._element_of(n) for n in info.atom_names]
    donors, acceptors = S.find_donors_acceptors(info.atom_names, elements, info.bonds)
    assert donors.shape[0] > 10 and acceptors.shape[0] > 10
    hard = _np(S.hydrogen_bonds(frames, donors, acceptors, device=CPU))
    jhard = np.asarray(J.hydrogen_bonds(frames, donors, acceptors))
    differ = hard != jhard
    if differ.any():
        margin = _hbond_margin(frames[differ], donors, acceptors, np.cos(np.deg2rad(120.0)))
        assert (margin <= 1e-6).all()
    assert hard.sum() > 0
    smooth = _np(S.hydrogen_bonds(frames, donors, acceptors, smooth=True, device=CPU))
    jsmooth = np.asarray(J.hydrogen_bonds(frames, donors, acceptors, smooth=True))
    np.testing.assert_allclose(smooth, jsmooth, rtol=1e-5, atol=0)


def test_ss_fractions_match_jax_on_chignolin(chignolin):
    info, jinfo, _, frames = chignolin
    np.testing.assert_array_equal(_np(S.ss_fractions(frames, info, device=CPU)),
                                  np.asarray(J.ss_fractions(frames, jinfo)))


def _ks_energies64(frames, info):
    """The K&S energy of every (acceptor i, donor j) pair in float64, by
    JAX's formula (amide H synthesized where the structure has none), and
    the sum of its four terms' magnitudes (the scale of a float32 sum's
    rounding)."""
    bb, hh, _, _, _ = S._backbone_indices(info)
    x = frames.astype(np.float64)
    n, c, o = (x[:, np.where(bb[:, k] >= 0, bb[:, k], 0)] for k in (0, 2, 3))
    co = np.roll(c, 1, axis=1) - np.roll(o, 1, axis=1)
    co /= np.linalg.norm(co, axis=-1, keepdims=True) + 1e-12
    h = np.where((hh >= 0)[None, :, None], x[:, np.where(hh >= 0, hh, 0)], n + 0.101 * co)

    def inv(a, b):
        d = a[:, None, :, :] - b[:, :, None, :]
        return 1.0 / (10.0 * np.sqrt((d * d).sum(-1)) + 1e-12)

    terms = (inv(n, o), inv(h, c), inv(h, o), inv(n, c))
    return (27.888 * (terms[0] + terms[1] - terms[2] - terms[3]),
            27.888 * sum(np.abs(t) for t in terms))


@pytest.mark.parametrize("case", ["chignolin", "helix", "strand"])
def test_kabsch_sander_and_dssp_match_jax(chignolin, case):
    if case == "chignolin":
        info, jinfo, _, frames = chignolin
    else:
        x, info = _ideal_backbone(16, *((-57.0, -47.0) if case == "helix" else (-139.0, 135.0)))
        jinfo = _jinfo(info)
        rng = np.random.default_rng(5)
        frames = (x[None] + rng.normal(0.0, 0.01, (32,) + x.shape)).astype(np.float32)
    e, allowed, resnames = S.kabsch_sander_energies(frames, info, device=CPU)
    e, allowed = _np(e), _np(allowed)
    e64, scale = _ks_energies64(frames, info)
    assert (np.abs(e - e64) <= 1e-5 * scale).all()
    hb, resnames2 = S.kabsch_sander_hbonds(frames, info, device=CPU)
    jhb, jresnames = J.kabsch_sander_hbonds(frames, jinfo)
    hb, jhb = _np(hb), np.asarray(jhb)
    np.testing.assert_array_equal(resnames, jresnames)
    np.testing.assert_array_equal(hb, (e < -0.5) & allowed[None])
    near = np.abs(e64 + 0.5) <= 1e-4
    assert not (hb != jhb)[~near].any()
    codes = _np(S.dssp(frames, info, device=CPU))
    jcodes = np.asarray(J.dssp(frames, jinfo))
    assert codes.dtype == np.int8 and codes.shape == jcodes.shape
    same = ~(hb != jhb).any(axis=(1, 2))
    np.testing.assert_array_equal(codes[same], jcodes[same])
    frac = _np(S.ss_fractions_dssp(frames, info, device=CPU))
    jfrac = np.asarray(J.ss_fractions_dssp(frames, jinfo))
    np.testing.assert_array_equal(frac[same], jfrac[same])
    if case == "helix":
        assert (codes[:, 2:-2] == 1).mean() > 0.7
    elif case == "strand":
        assert (codes == 1).sum() == 0
    else:
        assert hb.any() and (codes == 2).any()


def test_baker_hubbard_matches_jax_on_chignolin(chignolin):
    info, jinfo, _, frames = chignolin
    for freq in (0.05, 0.1, 0.5):
        port = S.baker_hubbard(frames, info, freq=freq, device=CPU)
        ref = J.baker_hubbard(frames, jinfo, freq=freq)
        assert port.dtype == np.int64
        np.testing.assert_array_equal(port, ref)
    assert S.baker_hubbard(frames, info, freq=0.1, device=CPU).shape[0] > 0


def test_featurize_structure_features_matches_jax(chignolin):
    info, jinfo, _, frames = chignolin
    spec = ["sasa", "hbonds", "ssfrac"]
    X, meta = featurize_trajectory(frames[:16], spec, info, device=CPU)
    jX, jmeta = j_featurize(frames[:16], spec, jinfo)
    assert X.device == torch.device("cpu") and X.shape == (16, 5)
    assert meta["columns"] == jmeta["columns"]
    np.testing.assert_array_equal(meta["periodic"], jmeta["periodic"])
    np.testing.assert_allclose(_np(X), np.asarray(jX), rtol=1e-5, atol=0)
