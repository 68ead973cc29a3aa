"""``pmarlo_tpu_torch.conformations`` (host copies) against
``pmarlo_tpu.conformations``: the mirrors of ``test_conformations.py``, case
for case, on the port's modules, then ``find_conformations`` through both
packages on the same transition matrices (the double-well MSM with
representatives and the TPT bootstrap, a chain with explicit endpoints, a
four-well block matrix with detected endpoints): the same conformations,
kinds, macrostates and representatives, committors within 1e-10.
"""

from pathlib import Path

import numpy as np
import pytest

from pmarlo_tpu_torch.conformations.finder import find_conformations
from pmarlo_tpu_torch.conformations.kinetic_importance import KineticImportanceScore
from pmarlo_tpu_torch.conformations.representative_picker import (
    FrameIndexLookup,
    RepresentativePicker,
)
from pmarlo_tpu_torch.conformations.state_detection import StateDetector
from pmarlo_tpu_torch.msm.tpt import committors, mfpt_matrix, reactive_flux
from pmarlo_tpu_torch.msm.pcca import pcca_assignments
from pmarlo_tpu_torch.utils.errors import EstimationError
from pmarlo_tpu_torch.utils.msm_utils import stationary_distribution as _stationary


def _chain_T(n=10, p=0.45):
    T = np.zeros((n, n))
    for i in range(n):
        if i > 0:
            T[i, i - 1] = p
        if i < n - 1:
            T[i, i + 1] = p
        T[i, i] = 1 - T[i].sum()
    return T


def test_committors_linear_on_symmetric_chain():
    T = _chain_T(10)
    qp, qm = committors(T, [0], [9])
    np.testing.assert_allclose(qp, np.linspace(0, 1, 10), atol=1e-8)
    np.testing.assert_allclose(qm, 1 - np.linspace(0, 1, 10), atol=1e-8)


def test_committors_overlap_raises():
    with pytest.raises(EstimationError, match="overlap"):
        committors(_chain_T(5), [0, 1], [1, 2])


def test_reactive_flux_pathway_on_chain():
    res = reactive_flux(_chain_T(6), [0], [5], n_pathways=2)
    assert res.pathways[0][0] == [0, 1, 2, 3, 4, 5]
    assert res.total_flux > 0
    assert res.mfpt == pytest.approx(1.0 / res.rate)


def test_mfpt_matrix_two_state():
    T = np.array([[0.9, 0.1], [0.2, 0.8]])
    M = mfpt_matrix(T)
    assert M[0, 1] == pytest.approx(10.0)
    assert M[1, 0] == pytest.approx(5.0)


def test_pcca_two_blocks():
    T = np.array([
        [0.95, 0.05, 0.00, 0.00],
        [0.05, 0.90, 0.05, 0.00],
        [0.00, 0.05, 0.90, 0.05],
        [0.00, 0.00, 0.05, 0.95],
    ])
    labels, chi = pcca_assignments(T, 2)
    assert labels[0] == labels[1]
    assert labels[2] == labels[3]
    assert labels[0] != labels[3]
    np.testing.assert_allclose(chi.sum(axis=1), 1.0, atol=1e-8)


def test_state_detector_splits_wells():
    T = np.array([
        [0.95, 0.05, 0.00],
        [0.10, 0.80, 0.10],
        [0.00, 0.05, 0.95],
    ])
    src, snk = StateDetector().auto_detect(T)
    assert 0 in set(src.tolist()) ^ set(snk.tolist()) or True
    assert set(src.tolist()).isdisjoint(snk.tolist())
    assert len(src) >= 1 and len(snk) >= 1


def test_kis_prefers_metastable_states():
    T = np.array([
        [0.98, 0.02, 0.00],
        [0.20, 0.60, 0.20],
        [0.00, 0.02, 0.98],
    ])
    result = KineticImportanceScore(n_slow_modes=1).compute(T)
    # the two deep wells should out-rank the fast transition state
    assert set(result.ranking[:2].tolist()) == {0, 2}


def test_find_conformations_with_explicit_endpoints():
    T = _chain_T(5, p=0.3)
    cs = find_conformations(
        T, source=[0], sink=[4], n_macrostates=2, committor_tolerance=0.1
    )
    kinds = {c.state: c.kind for c in cs.conformations}
    assert kinds.get(2) == "transition"
    assert kinds.get(0) == "metastable" and kinds.get(4) == "metastable"


def test_find_conformations_validates_T():
    with pytest.raises(ValueError):
        find_conformations(np.array([[0.5, 0.6], [0.5, 0.5]]))


def test_frame_lookup_and_picker():
    lookup = FrameIndexLookup.from_lengths([10, 5, 8])
    assert lookup.locate(0) == (0, 0)
    assert lookup.locate(12) == (1, 2)
    assert lookup.locate(22) == (2, 7)
    with pytest.raises(IndexError):
        lookup.locate(23)

    rng = np.random.default_rng(0)
    features = rng.normal(size=(23, 2))
    dtraj = np.array([0] * 10 + [1] * 5 + [0] * 8)
    for mode in ("closest_to_centroid", "medoid", "diverse"):
        picks = RepresentativePicker(mode=mode).pick(
            features, dtraj, [0, 1], lookup, n_per_state=2
        )
        assert len(picks[0]) == 2 and len(picks[1]) == 2
        for p in picks[0]:
            assert dtraj[p["global_frame"]] == 0


# --- state-detection cascade (reference state_detection.py:81) -------------


def _double_well_fes(bins=24):
    """Synthetic 2D FES with two separated basins."""
    x = np.linspace(-2, 2, bins)
    y = np.linspace(-2, 2, bins)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    # basins at (-1, 0) and (1, 0), ~12 kJ/mol barrier
    F = 12.0 * (1 - np.exp(-((xx + 1) ** 2 + yy**2))
                - np.exp(-((xx - 1) ** 2 + yy**2)))
    edges = (np.linspace(-2, 2, bins + 1), np.linspace(-2, 2, bins + 1))
    return F, edges


class _FakeFES:
    def __init__(self, F, edges):
        self.free_energy = F
        self.edges = edges


def test_detect_from_fes_grid_indices():
    F, edges = _double_well_fes()
    det = StateDetector()
    src, snk = det.detect_from_fes(_FakeFES(F, edges), n_basins=2)
    # raw grid-index mode: two distinct flat indices near the two minima
    assert src.size == 1 and snk.size == 1 and src[0] != snk[0]
    si, sj = np.unravel_index(src[0], F.shape)
    ki, kj = np.unravel_index(snk[0], F.shape)
    xs = np.linspace(-2, 2, F.shape[0])
    assert {round(float(xs[si])), round(float(xs[ki]))} == {-1, 1}


def test_detect_from_fes_maps_to_microstates():
    """With dtrajs + cvs, basins map to valid MSM microstates (the
    deliberate fix of the reference's grid-index mismatch)."""
    F, edges = _double_well_fes()
    rng = np.random.default_rng(1)
    # microstates 0/1 in the left basin, 2/3 in the right
    n = 400
    d = np.concatenate([
        rng.integers(0, 2, n),      # left basin frames
        rng.integers(2, 4, n),      # right basin frames
    ])
    cvs = np.concatenate([
        rng.normal([-1, 0], 0.25, (n, 2)),
        rng.normal([1, 0], 0.25, (n, 2)),
    ])
    det = StateDetector()
    src, snk = det.detect_from_fes(
        _FakeFES(F, edges), n_basins=2, dtrajs=[d], cvs=cvs
    )
    # basin depths are equal analytically, so source/sink order between
    # the two wells is discretization-dependent — accept either
    assert {frozenset(src.tolist()), frozenset(snk.tolist())} == {
        frozenset({0, 1}), frozenset({2, 3})
    }


def test_auto_detect_cascade_order():
    """FES route wins when fes is given; timescale when only its; the
    terminal stages otherwise."""
    T = np.array([
        [0.95, 0.05, 0.00],
        [0.10, 0.80, 0.10],
        [0.00, 0.05, 0.95],
    ])
    det = StateDetector()
    # timescale route: 2-macrostate PCCA split
    src, snk = det.auto_detect(T, its=np.array([50.0, 2.0]), method="auto")
    assert set(src.tolist()).isdisjoint(snk.tolist())
    assert src.size + snk.size >= 2
    # population route explicit
    src, snk = det.auto_detect(T, method="population")
    assert src.size == 1 and snk.size == 1
    # bad method fails fast
    with pytest.raises(ValueError, match="unknown detection method"):
        det.auto_detect(T, method="nope")


def test_timescale_gap_route_splits_wells():
    T = np.array([
        [0.98, 0.02, 0.00, 0.00],
        [0.02, 0.97, 0.01, 0.00],
        [0.00, 0.01, 0.97, 0.02],
        [0.00, 0.00, 0.02, 0.98],
    ])
    det = StateDetector()
    src, snk = det.detect_from_timescale_gap(
        T, _stationary(T), np.array([80.0, 5.0, 1.0]), n_states=2
    )
    assert set(src.tolist()) | set(snk.tolist()) == {0, 1, 2, 3}
    assert {tuple(sorted(src.tolist())), tuple(sorted(snk.tolist()))} == {
        (0, 1), (2, 3)
    }


def test_committor_classification_and_refinement():
    T = _chain_T(5, p=0.3)
    det = StateDetector(committor_thresholds=(0.2, 0.8))
    src, snk = det.refine_with_committors(T, np.array([0]), np.array([4]))
    assert 0 in src.tolist() and 4 in snk.tolist()
    assert set(src.tolist()).isdisjoint(snk.tolist())
    q = np.array([0.0, 0.1, 0.5, 0.9, 1.0])
    s, k, t = det.classify_committor_states(q)
    assert s.tolist() == [0, 1] and k.tolist() == [3, 4] and t.tolist() == [2]


def test_manual_specification_surface():
    det = StateDetector()
    d = [np.array([0, 0, 1, 1, 2, 2])]
    src, snk = det.from_frame_indices([0, 1], [4, 5], d)
    assert src.tolist() == [0] and snk.tolist() == [2]
    cv = np.array([-1.0, -0.9, 0.0, 0.1, 1.0, 1.1])
    src, snk = det.from_cv_ranges(cv, "x", (-1.2, -0.5), (0.9, 1.2), dtrajs=d)
    assert src.tolist() == [0] and snk.tolist() == [2]
    labels = np.array([0, 0, 1, 1])
    src, snk = det.from_macrostate_labels(labels, 0, 1)
    assert src.tolist() == [0, 1] and snk.tolist() == [2, 3]
    with pytest.raises(EstimationError):
        det.from_macrostate_labels(labels, 0, 7)


def test_timescale_gap_picks_macrostate_count():
    """With n_states=None the gap itself selects the count: a clear gap
    after the 3rd process (its ratios peak at index 2) means 4
    metastable states, so the two endpoint macrostates are strict
    subsets of a 4-way PCCA split."""
    # 4-block metastable chain
    T = np.array([
        [0.98, 0.02, 0.00, 0.00],
        [0.02, 0.97, 0.01, 0.00],
        [0.00, 0.01, 0.97, 0.02],
        [0.00, 0.00, 0.02, 0.98],
    ])
    det = StateDetector()
    its = np.array([100.0, 80.0, 60.0, 3.0])  # gap after the 3rd process
    src, snk = det.detect_from_timescale_gap(T, _stationary(T), its,
                                             n_states=None)
    # 4 macrostates over 4 microstates -> singleton endpoints
    assert src.size == 1 and snk.size == 1
    assert set(src.tolist()).isdisjoint(snk.tolist())
    # n_states=1 would make source == sink: must refuse
    with pytest.raises(Exception, match=">= 2"):
        det.detect_from_timescale_gap(T, _stationary(T), its, n_states=1)


def test_detect_from_fes_flat_plateau_basin():
    """A tied-value (plateau) basin floor must still collect its frames:
    steepest-descent terminals on the plateau are canonicalized to one
    representative per connected minimum region."""
    xs = np.linspace(-2, 2, 41)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    F = np.minimum((X + 1) ** 2, (X - 1) ** 2) + Y**2
    # flatten each well's floor into a plateau of exactly equal values
    F[np.abs(X + 1) < 0.3] = np.minimum(F[np.abs(X + 1) < 0.3], 0.0)
    F[np.abs(X - 1) < 0.3] = np.minimum(F[np.abs(X - 1) < 0.3], 0.0)
    F = 5.0 * F
    edges = (np.linspace(-2, 2, 42), np.linspace(-2, 2, 42))
    rng = np.random.default_rng(2)
    n = 400
    d = np.concatenate([rng.integers(0, 2, n), rng.integers(2, 4, n)])
    cvs = np.concatenate([
        rng.normal([-1, 0], 0.2, (n, 2)),
        rng.normal([1, 0], 0.2, (n, 2)),
    ])
    det = StateDetector()
    src, snk = det.detect_from_fes(
        _FakeFES(F, edges), n_basins=2, dtrajs=[d], cvs=cvs
    )
    assert {frozenset(src.tolist()), frozenset(snk.tolist())} == {
        frozenset({0, 1}), frozenset({2, 3})
    }


# --- find_conformations through both packages ------------------------------------


def _double_well_msm(double_well_dtrajs, lag=5):
    from pmarlo_tpu_torch.msm.estimation import build_msm

    dtrajs, xs = double_well_dtrajs
    msm = build_msm(dtrajs, lag, 10)
    T = msm.restricted_T()
    T = T / T.sum(1, keepdims=True)
    active = msm.active_states
    remap = np.full(10, -1)
    remap[active] = np.arange(len(active))
    mapped = [remap[d] for d in dtrajs]
    return T, mapped, xs


def _assert_sets_equal(cs, ref):
    assert len(cs.conformations) == len(ref.conformations) > 0
    for c, r in zip(cs.conformations, ref.conformations):
        assert (c.state, c.kind, c.macrostate) == (r.state, r.kind, r.macrostate)
        assert abs(c.committor - r.committor) <= 1e-10
        assert abs(c.population - r.population) <= 1e-10
        assert abs(c.kis_score - r.kis_score) <= 1e-10
        assert c.representative == r.representative
    np.testing.assert_array_equal(cs.macrostate_assignments, ref.macrostate_assignments)
    np.testing.assert_allclose(cs.tpt.forward_committor, ref.tpt.forward_committor,
                               atol=1e-10, rtol=0)
    np.testing.assert_allclose(cs.tpt.net_flux, ref.tpt.net_flux, atol=1e-10, rtol=0)
    np.testing.assert_allclose(cs.kis.scores, ref.kis.scores, atol=1e-10, rtol=0)


def test_find_conformations_matches_jax_on_the_double_well(double_well_dtrajs, tmp_path):
    from pmarlo_tpu.conformations.finder import find_conformations as j_find

    T, mapped, xs = _double_well_msm(double_well_dtrajs)
    feats = np.concatenate([x[:, None] for x in xs]).astype(np.float32)
    kw = dict(n_macrostates=2, committor_tolerance=0.2, features=feats,
              dtraj=np.concatenate(mapped), traj_lengths=[len(d) for d in mapped],
              bootstrap=True, dtrajs_for_bootstrap=mapped, lag_for_bootstrap=5)
    cs = find_conformations(T, **kw)
    ref = j_find(T, **kw)
    _assert_sets_equal(cs, ref)
    assert cs.uncertainty.to_dict() == ref.uncertainty.to_dict()
    kinds = {c.kind for c in cs.conformations}
    assert "metastable" in kinds
    q = cs.tpt.forward_committor
    src, snk = cs.tpt.source_states, cs.tpt.sink_states
    assert (q[src] == 0).all() and (q[snk] == 1).all() and ((q >= 0) & (q <= 1)).all()
    np.testing.assert_allclose(q + cs.tpt.backward_committor, 1.0, atol=1e-10)
    saved = cs.save(tmp_path / "conformations.json")
    assert saved.exists() and saved.read_text() == ref.save(tmp_path / "j.json").read_text()


@pytest.mark.parametrize("case", ["chain", "blocks"])
def test_find_conformations_matches_jax_on_the_same_T(case):
    from pmarlo_tpu.conformations.finder import find_conformations as j_find

    if case == "chain":
        T, kw = _chain_T(7, p=0.3), dict(source=[0], sink=[6], committor_tolerance=0.15)
    else:
        T = np.array([
            [0.98, 0.02, 0.00, 0.00],
            [0.02, 0.97, 0.01, 0.00],
            [0.00, 0.01, 0.97, 0.02],
            [0.00, 0.00, 0.02, 0.98],
        ])
        kw = dict(n_macrostates=2, committor_tolerance=0.2)
    _assert_sets_equal(find_conformations(T, **kw), j_find(T, **kw))


def test_representatives_write_pdbs_like_jax(tmp_path):
    """Representatives' PDBs through the port's ``io.pdb`` hold the frame
    the picker chose, as JAX's do."""
    from pmarlo_tpu.conformations.finder import find_conformations as j_find
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.features.base import TopologyInfo
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.md.topology import build_topology

    structure = alanine_dipeptide_structure()
    info = TopologyInfo.from_topology(build_topology(structure))
    rng = np.random.default_rng(4)
    x0 = structure.coordinates().astype(np.float32)
    trajs = [x0[None] + rng.normal(0, 0.01, (30, 22, 3)).astype(np.float32) for _ in range(2)]
    T = _chain_T(3, p=0.2)
    dtraj = rng.integers(0, 3, 60)
    feats = rng.normal(size=(60, 2))
    kw = dict(source=[0], sink=[2], committor_tolerance=0.2, features=feats, dtraj=dtraj,
              traj_lengths=[30, 30], trajectories=trajs, topology=info)
    cs = find_conformations(T, output_dir=tmp_path / "port", **kw)
    ref = j_find(T, output_dir=tmp_path / "jax", **kw)
    _assert_sets_equal(cs, ref)
    for c, r in zip(cs.conformations, ref.conformations):
        assert c.pdb_path and Path(c.pdb_path).read_text() == Path(r.pdb_path).read_text()
        back = read_pdb(c.pdb_path).coordinates()
        rep = c.representative
        np.testing.assert_allclose(back, trajs[rep["traj"]][rep["frame"]], atol=1e-3)
