"""``pmarlo_tpu_torch.api`` against ``pmarlo_tpu.api`` on the CPU.

Mirrors of ``test_api.py``, ``test_api_extended.py`` and
``test_api_surface_parity.py`` run on the port's facade, beside parity
checks on the same inputs made from a numpy seed: the reference's 40 names
and the aliases; ``api/features.py`` (the one ported module: features
within 1e-5, alignment within 1e-5 nm, the expansion within 1e-6, the
universal embedding within 1e-4 up to each column's sign, the content
hash and the cache's hit and eviction); k-means partitions up to
relabelling; the MSM, macrostate, FES-minima and profile functions exactly
(both packages run the same host numpy); the PDB and conformation writers
byte for byte; ``analyze_msm``'s artifacts under ``test_torch_enhanced.py``'s
tolerances, the port's states mapped onto JAX's by their centers.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pmarlo_tpu.api as japi
import pmarlo_tpu_torch
import pmarlo_tpu_torch.api as api
from pmarlo_tpu.api import features as JF
from pmarlo_tpu_torch.api import features as F
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.md.topology import build_topology
from tests.unit.test_torch_enhanced import LAG, _jinfo, alanine_basins  # noqa: F401

# the reference's api/__init__.py __all__, verbatim (test_api_surface_parity.py)
REFERENCE_API_ALL = [
    "align_trajectory", "analyze_msm", "choose_sim_seed",
    "build_msm_from_labels", "cluster_microstates", "coerce_path_list",
    "compute_features", "compute_macrostates", "compute_universal_embedding",
    "compute_universal_metric", "deep_merge", "extract_last_frame_to_pdb",
    "extract_seed", "FEATURE_PROFILES", "FeatureProfile",
    "find_conformations_from_msm", "generate_fes_and_pick_minima",
    "generate_free_energy_surface", "get_feature_profile_info",
    "load_feature_profile", "macro_mfpt", "macro_transition_matrix",
    "macrostate_populations", "normalize_training_metrics", "parse_bins",
    "parse_hidden_layers", "parse_tau_schedule", "parse_temperature_ladder",
    "reduce_features", "relativize", "resolve_deeptica", "sanitize",
    "sanitize_deeptica_payload", "sanitize_label_for_filename",
    "select_fes_pair", "slugify", "timestamp", "trig_expand_periodic",
    "validate_profile_for_cv_biasing", "write_json",
]

REFERENCE_TOP_LEVEL = [
    "Protein", "MarkovStateModel", "candidate_lag_ladder", "api",
    "visualization", "FESResult", "PMFResult", "generate_1d_pmf",
    "generate_2d_fes",
]

#: the functions of ``api/features.py``, each held against JAX's below
FEATURE_FUNCTIONS = ["compute_features", "clear_feature_cache", "align_trajectory",
                     "trig_expand_periodic", "compute_universal_metric",
                     "compute_universal_embedding"]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _empty_caches():
    api.clear_feature_cache()
    japi.clear_feature_cache()
    yield
    api.clear_feature_cache()
    japi.clear_feature_cache()


def _info(structure):
    return TopologyInfo.from_topology(build_topology(structure))


@pytest.fixture(scope="module")
def chignolin_frames():
    """(TopologyInfo, 48 frames (48, 138, 3) float32): chignolin with
    0.03 nm of noise a coordinate."""
    s = chignolin_structure()
    rng = np.random.default_rng(7)
    x0 = s.coordinates()
    frames = x0[None] + rng.normal(0.0, 0.03, (48, *x0.shape))
    return _info(s), frames.astype(np.float32)


@pytest.fixture(scope="module")
def alanine_frames():
    s = alanine_dipeptide_structure()
    rng = np.random.default_rng(3)
    x0 = s.coordinates()
    return _info(s), (x0[None] + rng.normal(0.0, 0.02, (30, *x0.shape))).astype(np.float32)


# --- the names (test_api_surface_parity.py) ----------------------------------------------


@pytest.mark.parametrize("name", REFERENCE_API_ALL)
def test_reference_api_name_present(name):
    assert hasattr(api, name), name
    assert name in api.__all__


def test_api_exports_what_jax_exports():
    assert api.__all__ == japi.__all__
    for name in api.__all__:
        mod = getattr(api, name)
        if callable(mod) and hasattr(mod, "__module__"):
            assert mod.__module__.startswith("pmarlo_tpu_torch."), (name, mod.__module__)


def test_reference_top_level_names_all_present():
    missing = [n for n in REFERENCE_TOP_LEVEL if not hasattr(pmarlo_tpu_torch, n)]
    assert not missing, missing
    assert pmarlo_tpu_torch.api is api
    assert pmarlo_tpu_torch.export_dashboard is pmarlo_tpu_torch.webapp.export_static
    assert pmarlo_tpu_torch.serve_dashboard is pmarlo_tpu_torch.webapp.serve


def test_aliases_are_same_objects():
    assert api.macro_mfpt is api.macrostate_mfpt
    assert api.macro_transition_matrix is api.macrostate_transition_matrix
    assert api.sanitize is api.sanitize_for_json


def test_path_helpers(tmp_path):
    paths = api.coerce_path_list(["a.txt", tmp_path / "b.txt"])
    assert all(p.is_absolute() for p in paths)
    assert paths == japi.coerce_path_list(["a.txt", tmp_path / "b.txt"])
    assert api.relativize(tmp_path / "x" / "y.npz", tmp_path) == "x/y.npz"
    assert api.relativize("/etc/hosts", tmp_path) == "/etc/hosts"


# --- profiles -----------------------------------------------------------------------------


def test_feature_profiles_equal_jax():
    assert list(api.FEATURE_PROFILES) == list(japi.FEATURE_PROFILES)
    for name, p in api.FEATURE_PROFILES.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(japi.FEATURE_PROFILES[name])
        assert api.get_feature_profile_info(name) == japi.get_feature_profile_info(name)
        assert (api.validate_profile_for_cv_biasing(name)
                == japi.validate_profile_for_cv_biasing(name))
    assert api.get_feature_profile("backbone", for_bias=True).bias_compatible
    with pytest.raises(ValueError, match="not CV-bias compatible"):
        api.get_feature_profile("universal", for_bias=True)
    with pytest.raises(KeyError):
        api.get_feature_profile("nope")
    assert api.get_feature_profile_info("nope") == {"exists": False, "name": "nope"}


def test_load_feature_profile_molecular_custom(tmp_path):
    spec = tmp_path / "spec.yaml"
    spec.write_text(
        "features:\n"
        "  - type: distance\n    atom_indices: [0, 5]\n"
        "  - type: angle\n    atom_indices: [0, 1, 2]\n"
        "  - type: dihedral\n    atom_indices: [0, 1, 2, 3]\n"
    )
    prof = api.load_feature_profile("molecular_custom", spec)
    assert prof.spec == ("distance([0, 5])", "angle([0, 1, 2])", "dihedral([0, 1, 2, 3])")
    assert dataclasses.asdict(prof) == dataclasses.asdict(japi.load_feature_profile(
        "molecular_custom", spec))
    info = api.get_feature_profile_info("molecular_custom", spec)
    assert info == japi.get_feature_profile_info("molecular_custom", spec)
    assert info["spec_status"] == "ok" and info["feature_count"] == 3
    with pytest.raises(ValueError, match="spec_path"):
        api.load_feature_profile("molecular_custom")
    with pytest.raises(FileNotFoundError):
        api.load_feature_profile("molecular_custom", tmp_path / "nope.yaml")
    bad = tmp_path / "bad.yaml"
    bad.write_text("features:\n  - type: distance\n    atom_indices: [0]\n")
    with pytest.raises(ValueError, match="atom_indices"):
        api.load_feature_profile("molecular_custom", bad)


def test_training_metrics_and_deeptica_payloads_equal_jax():
    cases = [None, {"best": {"val_vamp2": 1.9, "epoch": 7, "tau": 10}, "epochs": []},
             {"epochs": [{"epoch": 0, "tau": 2, "val_vamp2": 0.5},
                         {"epoch": 1, "tau": 4, "val_vamp2": float("nan")},
                         {"epoch": 2, "tau": 4, "val_vamp2": 1.5}]}]
    for h in cases:
        assert api.normalize_training_metrics(h) == japi.normalize_training_metrics(h)
    n = api.normalize_training_metrics({"val_score_curve": [0.2, 0.8, 0.3, 0.4]},
                                       tau_schedule=[5, 20], epochs_per_tau=2)
    assert n["best_epoch"] == 1 and n["best_tau"] == 5
    for cfg in ({}, {"deeptica": {"enabled": False}},
                {"deeptica": {"min_pairs": "32", "skip_on_failure": 0, "lag": 5}},
                {"deeptica": {"min_pairs": "oops"}}):
        assert api.resolve_deeptica(cfg) == japi.resolve_deeptica(cfg)
    payload = {"applied": True, "secret": "x",
               "attempts": [{"lag": i, "status": "ok"} for i in range(9)]}
    p = api.sanitize_deeptica_payload(payload)
    assert p == japi.sanitize_deeptica_payload(payload)
    assert p["applied"] and "secret" not in p and len(p["attempts"]) == 5


# --- api/features.py, the port --------------------------------------------------------------


def test_feature_functions_are_jax_functions_plus_device():
    """The port's module holds JAX's functions, each with JAX's parameters
    (``device=`` added last, keyword-only, to every function that computes)."""
    import inspect

    assert F.__all__ == JF.__all__ == FEATURE_FUNCTIONS
    for name in FEATURE_FUNCTIONS:
        port = list(inspect.signature(getattr(F, name)).parameters.values())
        ref = list(inspect.signature(getattr(JF, name)).parameters.values())
        if name != "clear_feature_cache":
            assert port[-1].name == "device" and port[-1].default is None
            assert port[-1].kind is inspect.Parameter.KEYWORD_ONLY
            port = port[:-1]
        assert [(p.name, p.kind, p.default) for p in port] == [
            (p.name, p.kind, p.default) for p in ref], name
    assert F._CACHE_LIMIT == JF._CACHE_LIMIT


@pytest.mark.parametrize("spec,expand", [("phi_psi", False), ("phi_psi", True), ("rg", False),
                                         ("ca_distances", False)])
def test_compute_features_matches_jax(chignolin_frames, spec, expand):
    info, traj = chignolin_frames
    X, meta = api.compute_features(traj, spec, info, cos_sin_expand=expand, device="cpu")
    jX, jmeta = japi.compute_features(traj, spec, _jinfo(info), cos_sin_expand=expand)
    assert isinstance(X, np.ndarray) and X.shape == np.asarray(jX).shape
    np.testing.assert_allclose(X, np.asarray(jX), atol=1e-5, rtol=0)
    assert meta["columns"] == jmeta["columns"]
    np.testing.assert_array_equal(meta["periodic"], jmeta["periodic"])


def test_content_hash_is_jax_hash(chignolin_frames):
    info, traj = chignolin_frames
    for spec in (("phi_psi", True), ("rg", False)):
        key = F._content_hash(traj, spec, info)
        assert key == JF._content_hash(traj, spec, _jinfo(info))
        assert F._content_hash(torch.as_tensor(traj), spec, info) == key
    assert F._content_hash(traj[:-1], ("rg", False), info) != F._content_hash(
        traj, ("rg", False), info)


def test_feature_cache_hit_and_eviction(alanine_frames):
    info, traj = alanine_frames
    X1, _ = api.compute_features(traj, "phi_psi", info, device="cpu")
    assert len(F._FEATURE_CACHE) == 1
    X2, _ = api.compute_features(traj, "phi_psi", info, device="cpu")
    assert X2 is X1  # cache hit returns the same object
    X3, _ = api.compute_features(traj, "phi_psi", info, use_cache=False, device="cpu")
    assert X3 is not X1
    np.testing.assert_allclose(X1, X3)
    # a full cache drops its oldest entry, as JAX's does
    first = next(iter(F._FEATURE_CACHE))
    for k in range(F._CACHE_LIMIT):
        api.compute_features(traj + np.float32(0.001 * (k + 1)), "rg", info, device="cpu")
        japi.compute_features(traj + np.float32(0.001 * (k + 1)), "rg", _jinfo(info))
    assert len(F._FEATURE_CACHE) == F._CACHE_LIMIT == len(JF._FEATURE_CACHE)
    assert first not in F._FEATURE_CACHE
    assert list(F._FEATURE_CACHE) == list(JF._FEATURE_CACHE)
    api.clear_feature_cache()
    assert len(F._FEATURE_CACHE) == 0


def test_compute_features_takes_a_tensor(chignolin_frames):
    info, traj = chignolin_frames
    X, _ = api.compute_features(torch.as_tensor(traj), "phi_psi", info, use_cache=False)
    Y, _ = api.compute_features(traj, "phi_psi", info, use_cache=False, device="cpu")
    assert isinstance(X, np.ndarray)
    np.testing.assert_array_equal(X, Y)


def _rotated_copy(frame):
    theta = 0.7
    R = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                  [0, 0, 1]])
    return (frame @ R.T + np.array([1.0, -0.5, 2.0])).astype(np.float32)


def test_align_trajectory_matches_jax(chignolin_frames):
    _, traj = chignolin_frames
    block = np.concatenate([traj[:4], _rotated_copy(traj[2])[None]])
    aligned = api.align_trajectory(block, device="cpu")
    jaligned = np.asarray(japi.align_trajectory(block))
    assert isinstance(aligned, np.ndarray) and aligned.shape == block.shape
    np.testing.assert_allclose(aligned, jaligned, atol=1e-5, rtol=0)
    # the rotated, translated copy of frame 2 comes back onto it
    np.testing.assert_allclose(aligned[4], aligned[2], atol=1e-5, rtol=0)
    ref = traj[1]
    np.testing.assert_allclose(api.align_trajectory(block, ref, device="cpu"),
                               np.asarray(japi.align_trajectory(block, ref)), atol=1e-5, rtol=0)


def test_trig_expand_periodic_matches_jax():
    X = np.random.default_rng(0).uniform(-np.pi, np.pi, (50, 3))
    Z = api.trig_expand_periodic(X, device="cpu")
    assert isinstance(Z, np.ndarray) and Z.shape == (50, 6)
    np.testing.assert_allclose(Z, np.asarray(japi.trig_expand_periodic(X)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(Z[:, :3], np.cos(X), atol=1e-6)
    np.testing.assert_allclose(Z[:, 3:], np.sin(X), atol=1e-6)


def test_universal_embedding_matches_jax_up_to_sign(chignolin_frames):
    info, traj = chignolin_frames
    emb = api.compute_universal_embedding(traj, info, n_components=2, device="cpu")
    jemb = np.asarray(japi.compute_universal_embedding(traj, _jinfo(info), n_components=2))
    assert emb.shape == (len(traj), 2) and np.isfinite(emb).all()
    signs = np.sign(np.sum(emb * jemb, axis=0))
    np.testing.assert_allclose(emb * signs, jemb, atol=1e-4, rtol=0)
    assert emb[:, 0].var() >= emb[:, 1].var()
    metric = api.compute_universal_metric(traj, info, device="cpu")
    np.testing.assert_allclose(metric, emb[:, 0] if emb.shape[1] else metric)


def test_universal_embedding_without_ca_pairs_matches_jax(alanine_frames):
    """Alanine has one CA: the pair block raises and is left out, in both."""
    info, traj = alanine_frames
    emb = api.compute_universal_embedding(traj, info, n_components=2, device="cpu")
    jemb = np.asarray(japi.compute_universal_embedding(traj, _jinfo(info), n_components=2))
    signs = np.sign(np.sum(emb * jemb, axis=0))
    np.testing.assert_allclose(emb * signs, jemb, atol=1e-4, rtol=0)


# --- clustering, MSM, macrostates, FES ---------------------------------------------------


def test_cluster_microstates_same_partition_as_jax():
    rng = np.random.default_rng(0)
    centers = np.array([[-2.0, -2.0], [2.0, -2.0], [-2.0, 2.0], [2.0, 2.0]])
    Y = np.concatenate([rng.normal(c, 0.2, (200, 2)) for c in centers]).astype(np.float32)
    labels = api.cluster_microstates(Y, n_states=4, random_state=1, device="cpu")
    jlabels = np.asarray(japi.cluster_microstates(Y, n_states=4, random_state=1))
    assert labels.shape == (800,) and labels.dtype == np.int64
    pairs = set(zip(labels.tolist(), jlabels.tolist()))
    assert len(pairs) == 4 == len(set(labels.tolist()))  # a bijection of labels
    # a list of trajectories gives the concatenated labels
    split = api.cluster_microstates([Y[:300], Y[300:]], n_states=4, random_state=1,
                                    device="cpu")
    assert len(set(zip(split.tolist(), labels.tolist()))) == 4
    with pytest.raises(ValueError):
        api.cluster_microstates(Y, method="dbscan")


@pytest.fixture(scope="module")
def chain_dtrajs():
    rng = np.random.default_rng(5)
    T = np.array([[0.90, 0.07, 0.02, 0.01], [0.06, 0.90, 0.03, 0.01],
                  [0.01, 0.03, 0.90, 0.06], [0.01, 0.02, 0.07, 0.90]])
    out = []
    for _ in range(3):
        s = [0]
        for _ in range(1999):
            s.append(rng.choice(4, p=T[s[-1]]))
        out.append(np.asarray(s, dtype=np.int64))
    return out


@pytest.mark.parametrize("reversible", [True, False])
def test_msm_and_macrostates_equal_jax(chain_dtrajs, reversible):
    m = api.build_msm_from_labels(chain_dtrajs, 2, reversible=reversible)
    jm = japi.build_msm_from_labels(chain_dtrajs, 2, reversible=reversible)
    np.testing.assert_array_equal(m.transition_matrix, jm.transition_matrix)
    np.testing.assert_array_equal(m.stationary_distribution, jm.stationary_distribution)
    np.testing.assert_allclose(m.transition_matrix.sum(1), 1.0, atol=1e-12)
    T, pi = m.transition_matrix, m.stationary_distribution
    labels, chi = api.compute_macrostates(T, 2)
    jlabels, jchi = japi.compute_macrostates(T, 2)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(chi, jchi)
    for fn in ("macrostate_populations", "macro_transition_matrix", "macro_mfpt"):
        args = (pi, labels) if fn == "macrostate_populations" else (T, pi, labels)
        np.testing.assert_array_equal(getattr(api, fn)(*args), getattr(japi, fn)(*args))
    np.testing.assert_allclose(api.macrostate_populations(pi, labels).sum(), 1.0)
    np.testing.assert_allclose(api.macro_transition_matrix(T, pi, labels).sum(1), 1.0)
    M = api.macro_mfpt(T, pi, labels, dt=2.0)
    np.testing.assert_array_equal(M, japi.macro_mfpt(T, pi, labels, dt=2.0))
    assert (M[~np.eye(2, dtype=bool)] > 0).all()


def test_macro_helpers_on_a_chain():
    T = np.array([[0.95, 0.05, 0.00, 0.00], [0.05, 0.90, 0.05, 0.00],
                  [0.00, 0.05, 0.90, 0.05], [0.00, 0.00, 0.05, 0.95]])
    labels, _ = api.compute_macrostates(T, 2)
    pops = api.macrostate_populations(np.full(4, 0.25), labels)
    np.testing.assert_allclose(pops.sum(), 1.0)
    M = api.macrostate_mfpt(T, np.full(4, 0.25), labels)
    assert (M[M > 0] > 1).all()


def test_select_fes_pair_equals_jax():
    for cols in (["cos(phi[0])", "sin(psi[0])", "rg"], ["a", "b", "c"],
                 ["phi_psi[0]", "phi_psi[1]"], ["rg", "phi[1]", "psi[1]"]):
        assert api.select_fes_pair(cols) == japi.select_fes_pair(cols)
    with pytest.raises(ValueError):
        api.select_fes_pair(["only_one"])


def test_fes_minima_and_frame_picking_equal_jax():
    from pmarlo_tpu.api import fes as jfes
    from pmarlo_tpu_torch.api import fes

    F = np.full((10, 10), 5.0)
    F[2, 2], F[7, 7], F[0, 5] = 0.0, 1.0, np.nan
    assert fes.find_local_minima_2d(F) == jfes.find_local_minima_2d(F)
    assert fes.find_local_minima_2d(F, 4) == jfes.find_local_minima_2d(F, 4)
    assert (2, 2) in fes.find_local_minima_2d(F)
    rng = np.random.default_rng(0)
    cv1 = np.concatenate([rng.normal(-1, 0.1, 500), rng.normal(1, 0.1, 500)])
    cv2 = np.concatenate([rng.normal(-1, 0.1, 500), rng.normal(1, 0.1, 500)])
    for kw in ({"bins": 16, "delta_f_kj": 3.0},
               {"bins": 20, "periodic": (True, True), "weights": rng.uniform(0.5, 1, 1000)}):
        f, picks = api.generate_fes_and_pick_minima(cv1, cv2, **kw)
        jf, jpicks = japi.generate_fes_and_pick_minima(cv1, cv2, **kw)
        np.testing.assert_array_equal(f.free_energy, jf.free_energy)
        assert picks.keys() == jpicks.keys() and len(picks) >= 1
        for k in picks:
            np.testing.assert_array_equal(picks[k], jpicks[k])
    assert sum(len(v) for v in api.generate_fes_and_pick_minima(
        cv1, cv2, bins=16, delta_f_kj=3.0)[1].values()) > 0


def test_generate_free_energy_surface_equals_jax():
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=400), rng.normal(size=400)
    f = api.generate_free_energy_surface(x, y, bins=12, temperature=310.0)
    jf = japi.generate_free_energy_surface(x, y, bins=12, temperature=310.0)
    assert f.temperature_K == 310.0 and np.nanmin(f.free_energy) == 0.0
    np.testing.assert_array_equal(f.free_energy, jf.free_energy)
    np.testing.assert_array_equal(f.xedges, jf.xedges)


def test_reduce_features_and_seeds_equal_jax():
    rng = np.random.default_rng(2)
    X = [rng.normal(size=(300, 4)), rng.normal(size=(200, 4))]
    for kw in ({"method": "pca"}, {"method": "tica", "lag": 3}):
        ys, model = api.reduce_features(X, n_components=2, **kw)
        jys, jmodel = japi.reduce_features(X, n_components=2, **kw)
        np.testing.assert_allclose(model.eigenvalues, np.asarray(jmodel.eigenvalues),
                                   atol=1e-6, rtol=0)
        for y, jy in zip(ys, jys):
            signs = np.sign(np.sum(y * np.asarray(jy), axis=0))
            np.testing.assert_allclose(y * signs, np.asarray(jy), atol=1e-4, rtol=0)
    assert api.choose_sim_seed(3) == japi.choose_sim_seed(3) == 3
    assert api.extract_seed({"seed": 11}) == japi.extract_seed({"seed": 11}) == 11


# --- writers --------------------------------------------------------------------------------


def test_extract_last_frame_to_pdb_byte_equal(chignolin_frames, tmp_path):
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.io.trajectory import TrajectoryWriter

    info, traj = chignolin_frames
    out = api.extract_last_frame_to_pdb(traj, info, tmp_path / "port.pdb")
    jout = japi.extract_last_frame_to_pdb(traj, _jinfo(info), tmp_path / "jax.pdb")
    assert Path(out).read_bytes() == Path(jout).read_bytes()
    assert Path(out).read_text().count("ATOM") >= traj.shape[1]
    np.testing.assert_allclose(read_pdb(out).coordinates(), traj[-1], atol=1e-3)
    # from a trajectory file, as a restart seed
    path = tmp_path / "traj.npz"
    with TrajectoryWriter(path) as w:
        w.write_frames(traj)
    assert Path(api.extract_last_frame_to_pdb(path, info, tmp_path / "f.pdb")).read_bytes() \
        == Path(out).read_bytes()
    with pytest.raises(ValueError):
        api.extract_last_frame_to_pdb(traj[:0], info, tmp_path / "empty.pdb")


def test_conformation_writers_byte_equal(tmp_path):
    from pmarlo_tpu.conformations.finder import find_conformations as jfind

    T = np.array([[0.90, 0.08, 0.02], [0.10, 0.80, 0.10], [0.02, 0.08, 0.90]])
    cs = api.find_conformations_from_msm(T, source=[0], sink=[2])
    jcs = jfind(T, source=[0], sink=[2])
    for writer in ("conformations_to_csv", "conformations_to_json"):
        p = getattr(api, writer)(cs, tmp_path / f"port_{writer}")
        jp = getattr(japi, writer)(jcs, tmp_path / f"jax_{writer}")
        assert Path(p).read_bytes() == Path(jp).read_bytes(), writer
    rows = (tmp_path / "port_conformations_to_csv").read_text().splitlines()
    assert len(rows) == 1 + len(cs.conformations)
    data = json.loads((tmp_path / "port_conformations_to_json").read_text())
    assert len(data["conformations"]) == len(cs.conformations)
    assert api.sanitize_label_for_filename("a:b c") == "a-b_c"


# --- analyze_msm -------------------------------------------------------------------------


def test_analyze_msm_artifacts_match_jax(alanine_basins, tmp_path):
    """Both packages' one-shot analysis from the same four basins-hopping
    trajectories at k = 4, lag 2: the same files; the port's states mapped
    onto JAX's by their centers, T and pi within 1e-6 (as in
    ``test_torch_enhanced.py``), the ITS medians inside each other's 95%
    band, the CK errors within 1e-6; the FES within 1e-6 kJ/mol; the plots
    written."""
    info, trajs = alanine_basins
    port = api.analyze_msm(trajs, info, n_states=4, lag_time=LAG, output_dir=tmp_path / "p")
    ref = japi.analyze_msm(trajs, _jinfo(info), n_states=4, lag_time=LAG,
                           output_dir=tmp_path / "j")
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in ("fes.png", "its.png", "ck.png", "transition_matrix.npy", "its.json"):
        assert name in names, name
    centers, jcenters = port.clustering.centers, np.asarray(ref.clustering.centers)
    perm = ((centers[:, None, :] - jcenters[None, :, :]) ** 2).sum(-1).argmin(1)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    T = np.load(tmp_path / "p" / "transition_matrix.npy")
    jT = np.load(tmp_path / "j" / "transition_matrix.npy")
    np.testing.assert_allclose(T, jT[np.ix_(perm, perm)], atol=1e-6, rtol=0)
    pi = np.load(tmp_path / "p" / "stationary_distribution.npy")
    np.testing.assert_allclose(pi, np.load(tmp_path / "j" / "stationary_distribution.npy")[perm],
                               atol=1e-6, rtol=0)
    summary = json.loads((tmp_path / "p" / "analysis_summary.json").read_text())
    assert summary == json.loads((tmp_path / "j" / "analysis_summary.json").read_text())
    its = json.loads((tmp_path / "p" / "its.json").read_text())
    jits = json.loads((tmp_path / "j" / "its.json").read_text())
    assert its["lags"] == jits["lags"]
    med, jmed = (np.asarray(d["timescales"], float)[:, :2] for d in (its, jits))
    lo, hi = (np.asarray(d, float)[:, :2] for d in (its["ci_lower"], its["ci_upper"]))
    jlo, jhi = (np.asarray(d, float)[:, :2] for d in (jits["ci_lower"], jits["ci_upper"]))
    assert np.isfinite(med).all() and ((jlo <= med) & (med <= jhi)).all()
    assert ((lo <= jmed) & (jmed <= hi)).all()
    ck = json.loads((tmp_path / "p" / "ck.json").read_text())
    jck = json.loads((tmp_path / "j" / "ck.json").read_text())
    assert ck.keys() == jck.keys() and ck["rms"].keys() == jck["rms"].keys()
    for k in ck["rms"]:
        assert abs(ck["rms"][k] - jck["rms"][k]) <= 1e-6
    fes = json.loads((tmp_path / "p" / "fes.json").read_text())
    jfes = json.loads((tmp_path / "j" / "fes.json").read_text())
    F, jF = (np.asarray(d["free_energy"], dtype=float) for d in (fes, jfes))
    np.testing.assert_array_equal(np.isnan(F), np.isnan(jF))
    np.testing.assert_allclose(F, jF, atol=1e-6, rtol=0, equal_nan=True)
