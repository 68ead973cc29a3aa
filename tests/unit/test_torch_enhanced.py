"""``pmarlo_tpu_torch.msm.enhanced`` (``EnhancedMSM``,
``run_complete_msm_analysis``) against ``pmarlo_tpu.msm.enhanced`` on the
CPU: the mirrors of the ``EnhancedMSM`` tests of ``test_msm.py``, then one
run through both packages from the same frames.

The frames are alanine dipeptide turned into four (phi, psi) basins by
rotating its backbone, visited by a latent chain (phi switches rarely, psi
more often) with 0.01 nm of noise: 4 x 400 frames. Both packages
featurize them (cos/sin of phi/psi, within 1e-5), reduce them by TICA
(eigenvalues within 1e-5), cluster to 4 states and estimate the MSM at lag
2. k-means draws its seeds differently in the two packages, so the port's
states are mapped onto JAX's by their centers (the relabeling of
``test_torch_analysis_path.py``); T then agrees within 1e-6 and the ITS
medians lie inside each other's 95% band.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from pmarlo_tpu.msm import enhanced as jax_enhanced
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.io.pdb import read_pdb
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.msm.enhanced import EnhancedMSM, run_complete_msm_analysis

LAG = 2


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --- mirrors of the EnhancedMSM tests of tests/unit/test_msm.py ------------------


def test_enhanced_auto_lag(double_well_dtrajs):
    _, xs = double_well_dtrajs
    feats = [np.stack([x, np.roll(x, 1)], axis=1).astype("float32") for x in xs]
    msm = EnhancedMSM(device="cpu")
    msm.load_trajectories(feats)
    msm.compute_features()  # passthrough for feature matrices
    msm.cluster_features(8, seed=0)
    msm.build_msm("auto")
    assert msm.msm is not None
    assert msm.msm.lag >= 1
    with pytest.raises(ValueError, match="auto"):
        msm.build_msm("best")


def test_state_table_bootstrap_errors(double_well_dtrajs):
    _, xs = double_well_dtrajs
    m = EnhancedMSM(device="cpu")
    m.features = [x[:, None].astype(np.float32) for x in xs]
    m.cluster_features(n_states=6, seed=0)
    m.build_msm(lag_time=5)
    table = m.create_state_table(free_energy_errors=True)
    errs = [r["free_energy_err"] for r in table if r.get("free_energy_err")]
    assert errs and all(e > 0 for e in errs)
    by_err = sorted((r["free_energy_err"], r["count"]) for r in table
                    if r.get("free_energy_err"))
    assert by_err[0][1] >= by_err[-1][1]


def test_enhanced_plot_method_surface(double_well_dtrajs, tmp_path):
    """The plot methods exist on the class; the port has no
    ``visualization`` yet (ROADMAP A14), so each raises
    ``ModuleNotFoundError`` naming it."""
    _, xs = double_well_dtrajs
    m = EnhancedMSM(output_dir=tmp_path, device="cpu")
    m.features = [x[:, None].astype(np.float32) for x in xs]
    m.cluster_features(n_states=6, seed=0)
    m.build_msm(lag_time=5)
    m.compute_implied_timescales(lags=[1, 2, 5, 10], n_samples=8)
    m.compute_ck_test(factors=[2, 3])
    m.generate_free_energy_surface(0, 0, bins=8)
    for call in (lambda: m.plot_implied_rates(tmp_path / "rates.png"),
                 lambda: m.plot_free_energy_profile(0, tmp_path / "pmf.png"),
                 lambda: m.plot_ck_test(tmp_path / "ck.png"),
                 lambda: m.plot_free_energy_surface(tmp_path / "fes.png"),
                 lambda: m.plot_implied_timescales(tmp_path / "its.png")):
        with pytest.raises(ModuleNotFoundError, match="visualization"):
            call()
    assert not list(tmp_path.glob("*.png"))


def test_tica_refreshes_feature_info():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 20, 600)
    X = np.stack([np.sin(t), np.cos(t), rng.normal(0, 0.1, 600),
                  rng.normal(0, 0.1, 600)], axis=1)
    msm = EnhancedMSM(device="cpu")
    msm.load_trajectories([X.astype(np.float32)])
    msm.compute_features(use_tica=True, tica_lag=5, tica_components=2)
    info = msm.feature_info
    assert info["columns"] == ["TIC1", "TIC2"]
    assert info["periodic"] == [False, False]
    assert "tica" in info and msm.features[0].shape[1] == 2


def test_bootstrap_errors_use_analysis_temperature():
    rng = np.random.default_rng(1)
    X = rng.normal(0, 1, (500, 2)).astype(np.float32)

    def build(T_K):
        m = EnhancedMSM(temperature_K=T_K, device="cpu")
        m.load_trajectories([X])
        m.compute_features()
        m.cluster_features(n_states=3, seed=0)
        m.build_msm(lag_time=2)
        return m._bootstrap_free_energy_errors(n_boot=50, seed=0)

    e300, e600 = build(300.0), build(600.0)
    np.testing.assert_allclose(e600, 2.0 * e300, rtol=1e-6)


# --- frames with four (phi, psi) basins -------------------------------------------


def _side(bonds, n_atoms, a, b):
    """Atoms on ``b``'s side of the bond a-b."""
    nbrs = {i: set() for i in range(n_atoms)}
    for i, j in bonds:
        if {int(i), int(j)} != {a, b}:
            nbrs[int(i)].add(int(j))
            nbrs[int(j)].add(int(i))
    seen, todo = {b}, [b]
    while todo:
        for j in nbrs[todo.pop()] - seen:
            seen.add(j)
            todo.append(j)
    return np.asarray(sorted(seen))


def _rotated(x, side, a, b, angle):
    axis = (x[b] - x[a]) / np.linalg.norm(x[b] - x[a])
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    out = x.copy()
    out[side] = (x[side] - x[b]) @ rot.T + x[b]
    return out


def _dihedral(x, q):
    from pmarlo_tpu_torch.features.builtins import compute_dihedrals

    return float(compute_dihedrals(torch.as_tensor(x[None], dtype=torch.float64), [q])[0, 0])


@pytest.fixture(scope="module")
def alanine_basins():
    """(TopologyInfo, four trajectories (400, 22, 3) float32)."""
    from pmarlo_tpu_torch.features.builtins import phi_psi_indices

    structure = alanine_dipeptide_structure()
    topo = build_topology(structure)
    info = TopologyInfo.from_topology(topo)
    x0 = structure.coordinates()
    (phi_q,), (psi_q,) = (q.tolist() for q in phi_psi_indices(
        info.atom_names, info.residue_ids)[:2])
    n_atoms = len(x0)
    templates = {}
    for a, phi in enumerate(np.radians([-70.0, 60.0])):
        for b, psi in enumerate(np.radians([-40.0, 150.0])):
            x = x0.copy()
            for q, target in ((phi_q, phi), (psi_q, psi)):
                side = _side(topo.bonds, n_atoms, q[1], q[2])
                x = _rotated(x, side, q[1], q[2], target - _dihedral(x, q))
                if abs(np.angle(np.exp(1j * (_dihedral(x, q) - target)))) > 1e-6:
                    x = _rotated(x, side, q[1], q[2], 2 * (target - _dihedral(x, q)))
                assert abs(np.angle(np.exp(1j * (_dihedral(x, q) - target)))) < 1e-6
            templates[a, b] = x
    rng = np.random.default_rng(0)
    trajs = []
    for _ in range(4):
        a, b = rng.integers(0, 2, 2)
        frames = np.empty((400, n_atoms, 3))
        for t in range(400):
            a = 1 - a if rng.random() < 0.01 else a
            b = 1 - b if rng.random() < 0.05 else b
            frames[t] = templates[a, b] + rng.normal(0.0, 0.01, (n_atoms, 3))
        trajs.append(frames.astype(np.float32))
    return info, trajs


def _jinfo(info):
    from pmarlo_tpu.features.base import TopologyInfo as JTopologyInfo

    return JTopologyInfo(atom_names=info.atom_names, residue_names=info.residue_names,
                         residue_ids=info.residue_ids, bonds=info.bonds,
                         chain_ids=info.chain_ids)


def test_enhanced_msm_matches_jax_from_the_same_frames(alanine_basins):
    info, trajs = alanine_basins
    raw = EnhancedMSM(trajs, topology=info, device="cpu").compute_features("phi_psi")
    jraw = jax_enhanced.EnhancedMSM(trajs, topology=_jinfo(info)).compute_features("phi_psi")
    assert raw.feature_info["columns"] == jraw.feature_info["columns"]
    assert isinstance(raw.feature_info["periodic"], np.ndarray)
    for a, b in zip(raw.features, jraw.features):
        assert a.dtype == np.float32 and a.shape == (400, 4)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

    port = EnhancedMSM(trajs, topology=info, device="cpu")
    ref = jax_enhanced.EnhancedMSM(trajs, topology=_jinfo(info))
    for m in (port, ref):
        m.compute_features("phi_psi", use_tica=True, tica_lag=LAG, tica_components=2)
        m.cluster_features(4, seed=0)
        m.build_msm(LAG)
    np.testing.assert_allclose(port.feature_info["tica"]["eigenvalues"],
                               ref.feature_info["tica"]["eigenvalues"], atol=1e-5, rtol=0)
    y, jy = np.concatenate(port.features), np.concatenate(ref.features)
    signs = np.sign(np.sum(y * jy, axis=0))
    assert np.abs(y * signs - jy).max() <= 1e-4 * np.abs(jy).max()
    centers = port.clustering.centers * signs
    jcenters = np.asarray(ref.clustering.centers)
    perm = ((centers[:, None, :] - jcenters[None, :, :]) ** 2).sum(-1).argmin(1)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    np.testing.assert_allclose(centers, jcenters[perm], atol=1e-4)
    for d, jd in zip(port.dtrajs, ref.dtrajs):
        np.testing.assert_array_equal(perm[d], jd)
    T, jT = port.msm.transition_matrix, ref.msm.transition_matrix
    np.testing.assert_allclose(T, jT[np.ix_(perm, perm)], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.msm.stationary_distribution,
                               ref.msm.stationary_distribution[perm], atol=1e-6, rtol=0)

    its = port.compute_implied_timescales(lags=[1, 2, 4, 8], n_samples=100)
    jits = ref.compute_implied_timescales(lags=[1, 2, 4, 8], n_samples=100)
    np.testing.assert_array_equal(its.lags, jits.lags)
    med, jmed = its.timescales[:, :2], jits.timescales[:, :2]
    assert np.isfinite(med).all() and (med > 0).all()
    assert ((jits.ci_lower[:, :2] <= med) & (med <= jits.ci_upper[:, :2])).all()
    assert ((its.ci_lower[:, :2] <= jmed) & (jmed <= its.ci_upper[:, :2])).all()


def test_enhanced_msm_chain_writes_states_and_results(alanine_basins, tmp_path):
    """The chain of phase 23 on the CPU: features -> TICA -> k-means -> MSM
    -> ITS -> CK (macro) -> FES -> state table -> representative PDBs ->
    saved results."""
    info, trajs = alanine_basins
    m = EnhancedMSM(output_dir=tmp_path, device="cpu")
    m.topology = info
    m.load_trajectories(trajs)
    m.compute_features("phi_psi", use_tica=True, tica_lag=LAG, tica_components=2)
    m.cluster_features(6, seed=0)
    m.build_msm(LAG)
    m.compute_implied_timescales(n_samples=20)
    ck = m.compute_ck_test(macro=2)
    assert ck.predicted
    fes = m.generate_free_energy_surface(0, 1, bins=16)
    assert np.isfinite(fes.free_energy).any()
    T, pi = m.msm.transition_matrix, m.msm.stationary_distribution
    np.testing.assert_allclose(T.sum(1), 1.0, atol=1e-10)
    np.testing.assert_allclose(pi @ T, pi, atol=1e-10)
    table = m.create_state_table(free_energy_errors=True)
    active = set(m.msm.active_states.tolist())
    assert [r["state"] for r in table if r["active"]] == sorted(active)
    paths = m.extract_representative_structures()
    assert len(paths) == len(active)
    for row, path in zip([r for r in table if r["active"]], paths):
        rep = row["representative"]
        back = read_pdb(path).coordinates()
        np.testing.assert_allclose(back, trajs[rep["traj"]][rep["frame"]], atol=1e-3)
    out = m.save_analysis_results()
    for name in ("transition_matrix.npy", "stationary_distribution.npy", "counts.npy",
                 "dtrajs.npz", "fes.json", "its.json", "ck.json", "state_table.json",
                 "analysis_summary.json"):
        assert (out / name).exists(), name
    assert pickle.loads((out / "msm_result.pkl").read_bytes()).lag == LAG
    assert json.loads((out / "analysis_summary.json").read_text())["n_frames"] == 1600


def test_run_complete_msm_analysis_saves_then_needs_visualization(alanine_basins, tmp_path):
    """From npz trajectory files: without an output directory the analysis
    returns; with one it writes the npy, pickle and json files, then the
    first plot raises ``ModuleNotFoundError`` (no ``visualization`` in the
    port until ROADMAP A14)."""
    from pmarlo_tpu_torch.io.trajectory import TrajectoryWriter

    info, trajs = alanine_basins
    files = []
    for i, frames in enumerate(trajs[:2]):
        path = tmp_path / f"traj_{i}.npz"
        with TrajectoryWriter(path) as w:
            w.write_frames(frames)
        files.append(path)
    kw = dict(temperature_K=300.0, n_states=4, lag_time=LAG, compute_its=False,
              compute_ck=False, device="cpu")
    msm = run_complete_msm_analysis(files, info, **kw)
    assert msm.msm is not None and msm.fes is not None
    with pytest.raises(ModuleNotFoundError, match="visualization"):
        run_complete_msm_analysis(files, info, output_dir=tmp_path / "out", **kw)
    assert (tmp_path / "out" / "transition_matrix.npy").exists()
    assert (tmp_path / "out" / "analysis_summary.json").exists()
