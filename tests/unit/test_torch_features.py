"""``pmarlo_tpu_torch.features`` against ``pmarlo_tpu.features``: index
derivation (exact), geometry and ``featurize_trajectory`` (1e-5: both run
float32 on the CPU; the dihedral goes through atan2 in each)."""

import numpy as np
import pytest
import torch

from pmarlo_tpu.features import builtins as JB
from pmarlo_tpu.features.base import TopologyInfo as JTopologyInfo
from pmarlo_tpu.features.featurize import featurize_trajectory as j_featurize
from pmarlo_tpu_torch._device import default_device
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly, chignolin_structure
from pmarlo_tpu_torch.features import (
    FEATURE_REGISTRY,
    TopologyInfo,
    builtins as TB,
    featurize_trajectory,
    get_feature,
    parse_feature_spec,
)
from pmarlo_tpu_torch.md.topology import build_topology

ATOL = 1e-5


@pytest.fixture(scope="module", params=["alanine", "chignolin"])
def molecule(request):
    """(TopologyInfo, JAX TopologyInfo, trajectory (T, N, 3) float32)."""
    structure = (alanine_dipeptide_structure() if request.param == "alanine"
                 else chignolin_structure())
    topo = build_topology(structure)
    info = TopologyInfo.from_topology(topo)
    jinfo = JTopologyInfo(
        atom_names=info.atom_names, residue_names=info.residue_names,
        residue_ids=info.residue_ids, bonds=info.bonds, chain_ids=info.chain_ids)
    rng = np.random.default_rng(7)
    x0 = structure.coordinates().astype(np.float32)
    traj = x0[None] + rng.normal(0.0, 0.02, (6,) + x0.shape).astype(np.float32)
    return info, jinfo, traj


def test_phi_psi_indices_equal_jax(molecule):
    info, _, _ = molecule
    args = (info.atom_names, info.residue_ids, info.chain_ids)
    for a, b in zip(TB.phi_psi_indices(*args), JB.phi_psi_indices(*args)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    phi, psi, labels = TB.phi_psi_indices(*args)
    assert phi.shape == psi.shape == (len(labels), 4) and len(labels) >= 1


def test_chignolin_has_sixteen_backbone_dihedrals():
    info = TopologyInfo.from_topology(build_topology(chignolin_structure()))
    phi, psi, labels = TB.phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    assert len(info.atom_names) == 138
    assert phi.shape == (8, 4) and psi.shape == (8, 4)
    assert labels == sorted(labels)


def test_omega_chi1_ca_indices_equal_jax(molecule):
    info, _, _ = molecule
    np.testing.assert_array_equal(
        TB.omega_indices(info.atom_names, info.residue_ids, info.chain_ids)[0],
        JB.omega_indices(info.atom_names, info.residue_ids, info.chain_ids)[0])
    np.testing.assert_array_equal(
        TB.chi1_indices(info.atom_names, info.residue_names, info.residue_ids)[0],
        JB.chi1_indices(info.atom_names, info.residue_names, info.residue_ids)[0])
    np.testing.assert_array_equal(
        TB.ca_pair_indices(info.atom_names, info.residue_ids),
        JB.ca_pair_indices(info.atom_names, info.residue_ids))


def test_dihedrals_never_span_chains():
    """Two chignolin copies number their residues alike: with chain ids the
    dihedral count doubles, and no quadruple mixes the two chains."""
    info = TopologyInfo.from_topology(build_topology(chignolin_assembly((2, 1, 1))))
    phi, psi, _ = TB.phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    assert phi.shape[0] == 16
    for quad in np.concatenate([phi, psi]):
        assert len({info.chain_ids[int(a)] for a in quad}) == 1


def test_compute_dihedrals_match_jax(molecule):
    info, _, traj = molecule
    phi, psi, _ = TB.phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    quads = np.concatenate([phi, psi])
    got = TB.compute_dihedrals(torch.as_tensor(traj), quads).numpy()
    want = np.asarray(JB.compute_dihedrals(traj, quads))
    assert got.shape == (traj.shape[0], len(quads))
    # compare on the circle: +pi and -pi are one angle
    d = np.angle(np.exp(1j * (got - want)))
    assert np.abs(d).max() <= ATOL
    np.testing.assert_allclose(
        TB.trig_expand_periodic(torch.as_tensor(got)).numpy(),
        np.asarray(JB.trig_expand_periodic(want)), atol=ATOL)


def test_distances_angles_rg_contacts_match_jax(molecule):
    info, _, traj = molecule
    n = traj.shape[1]
    rng = np.random.default_rng(3)
    pairs = np.stack([rng.integers(0, n, 12), rng.integers(0, n, 12)], 1)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    triples = np.stack([rng.permutation(n)[:3] for _ in range(8)])
    masses = rng.uniform(1.0, 16.0, n).astype(np.float32)
    t = torch.as_tensor(traj)
    np.testing.assert_allclose(TB.compute_distances(t, pairs).numpy(),
                               np.asarray(JB.compute_distances(traj, pairs)), atol=ATOL)
    np.testing.assert_allclose(TB.compute_angles(t, triples).numpy(),
                               np.asarray(JB.compute_angles(traj, triples)), atol=ATOL)
    np.testing.assert_allclose(TB.radius_of_gyration(t, masses).numpy(),
                               np.asarray(JB.radius_of_gyration(traj, masses)), atol=ATOL)
    np.testing.assert_allclose(TB.radius_of_gyration(t).numpy(),
                               np.asarray(JB.radius_of_gyration(traj)), atol=ATOL)
    np.testing.assert_allclose(TB.contacts(t, pairs).numpy(),
                               np.asarray(JB.contacts(traj, pairs)), atol=1e-4)


@pytest.mark.parametrize("expand", [False, True], ids=["angles", "cos_sin"])
def test_featurize_trajectory_matches_jax(molecule, expand):
    info, jinfo, traj = molecule
    spec = ["phi_psi", "rg"]
    X, meta = featurize_trajectory(torch.as_tensor(traj), spec, info, cos_sin_expand=expand)
    JX, jmeta = j_featurize(traj, spec, jinfo, cos_sin_expand=expand)
    assert isinstance(X, torch.Tensor) and X.dtype == torch.float32
    assert meta["columns"] == jmeta["columns"]
    assert meta["spec"] == jmeta["spec"]
    np.testing.assert_array_equal(meta["periodic"], np.asarray(jmeta["periodic"]))
    got, want = X.numpy(), np.asarray(JX)
    assert got.shape == want.shape
    per = np.asarray(meta["periodic"])
    d = got - want
    d[:, per] = np.angle(np.exp(1j * d[:, per]))
    assert np.abs(d).max() <= ATOL


def test_featurize_takes_numpy_and_single_frames(molecule):
    info, _, traj = molecule
    X, _ = featurize_trajectory(traj, "phi_psi", info, cos_sin_expand=True)
    X1, _ = featurize_trajectory(traj[0], "phi_psi", info, cos_sin_expand=True)
    assert X1.shape == (1, X.shape[1])
    torch.testing.assert_close(X[:1], X1)
    with pytest.raises(ValueError, match=r"\(T, N, 3\)"):
        featurize_trajectory(traj[None], "phi_psi", info)


def test_feature_registry_and_specs_match_jax():
    from pmarlo_tpu.features.base import FEATURE_REGISTRY as JREG
    from pmarlo_tpu.features.base import parse_feature_spec as j_parse

    # every registered name is ported, the structure features (hydrogen
    # bonds, SASA, secondary structure) included
    assert set(JREG) - set(FEATURE_REGISTRY) == set()
    assert set(FEATURE_REGISTRY) <= set(JREG)
    for spec in ("phi_psi", ["phi_psi", "distance(0,4)"], "dihedral(0,1,2,3);rg"):
        got = [fs.canonical() for fs in parse_feature_spec(spec)]
        assert got == [fs.canonical() for fs in j_parse(spec)]
    with pytest.raises(Exception):
        get_feature("no_such_feature")


def test_features_follow_the_trajectory_device(molecule):
    """The feature matrix lies where the trajectory lies; ``default_device``
    is the card when there is one."""
    info, _, traj = molecule
    X, _ = featurize_trajectory(torch.as_tensor(traj), "phi_psi", info)
    assert X.device.type == "cpu"
    assert default_device().type == ("cuda" if torch.cuda.is_available() else "cpu")
