"""Port parity for the analysis half's remaining modules: the KDE FES
(``analysis/fes.py``), the whitening-aware MSM preparation, CV projection,
pair accounting and debug export (``analysis/{msm,project_cv,counting,
debug_export}.py``), the training-metrics helpers (``ml/metrics.py``), the
result persistence (``msm/results.py``) and the builder
(``msm/msm_builder.py``), and the names the port exports beside JAX's.

The KDE density agrees to 1e-5 of its maximum (float32 kernel factors in
both packages); the host modules agree exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import pmarlo_tpu
import pmarlo_tpu.analysis as jax_analysis
import pmarlo_tpu.features as jax_features
import pmarlo_tpu.msm as jax_msm
import pmarlo_tpu_torch
import pmarlo_tpu_torch.analysis as analysis
import pmarlo_tpu_torch.features as features
import pmarlo_tpu_torch.msm as msm
from pmarlo_tpu.analysis import debug_export as jax_debug
from pmarlo_tpu.analysis import fes as jax_fes
from pmarlo_tpu.analysis import msm as jax_amsm
from pmarlo_tpu.ml import metrics as jax_metrics
from pmarlo_tpu.ml.whitening import estimate_whitening
from pmarlo_tpu_torch.analysis import counting, debug_export, fes, project_cv
from pmarlo_tpu_torch.analysis import msm as amsm
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.features import featurize, ramachandran, structure
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.ml import metrics
from pmarlo_tpu_torch.msm import enhanced, its, reduction, results, reversible_sampler
from pmarlo_tpu_torch.msm.msm_builder import MSMBuilder
from pmarlo_tpu_torch.utils.errors import WhiteningError


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    return rng.normal(0, 1.0, 6_000), rng.normal(0, 0.5, 6_000)


# --- the KDE FES ---------------------------------------------------------------------------------


def _assert_kde_equal(res, ref):
    np.testing.assert_array_equal(res.xedges, ref.xedges)
    np.testing.assert_array_equal(res.yedges, ref.yedges)
    assert np.abs(res.counts - ref.counts).max() <= 1e-5 * ref.counts.max()
    # F is finite where the float32 density is positive; XLA flushes a
    # subnormal density to 0 where the port keeps it, so the two masks are
    # held where JAX's density is a normal float32
    normal = ref.counts > 1e-30 * ref.counts.max()
    np.testing.assert_array_equal(np.isfinite(res.free_energy)[normal],
                                  np.isfinite(ref.free_energy)[normal])
    assert (res.smoothing_mode, res.cv_names) == (ref.smoothing_mode, ref.cv_names)
    assert res.temperature_K == ref.temperature_K


@pytest.mark.parametrize("kw", [
    dict(bins=32), dict(bins=(20, 28), bandwidth="silverman", temperature_K=350.0),
    dict(bins=24, bandwidth=0.3), "weights",
])
def test_kde_fes_matches_jax(cloud, kw):
    x, y = cloud
    if kw == "weights":
        kw = dict(bins=24, weights=np.where(x > 0, 4.0, 1.0))
    res = fes.compute_kde_fes(x, y, device="cpu", **kw)
    ref = jax_fes.compute_kde_fes(x, y, **kw)
    _assert_kde_equal(res, ref)
    fin = np.isfinite(res.free_energy)
    assert np.nanmin(res.free_energy) == 0.0 and fin.mean() > 0.9
    # where both surfaces lie within 10 kT of their minimum, they agree to a
    # float32 density's relative rounding times kT
    kT = 0.00831446261815324 * res.temperature_K
    low = fin & (ref.free_energy < 10 * kT)
    assert np.abs(res.free_energy[low] - ref.free_energy[low]).max() <= 1e-3 * kT


def test_kde_fes_recovers_gaussian_well(cloud):
    x, y = cloud
    res = fes.compute_kde_fes(x, y, bins=48, temperature_K=300.0, device="cpu")
    F = res.free_energy
    ix, iy = np.unravel_index(np.nanargmin(F), F.shape)
    xc = 0.5 * (res.xedges[ix] + res.xedges[ix + 1])
    yc = 0.5 * (res.yedges[iy] + res.yedges[iy + 1])
    assert abs(xc) < 0.3 and abs(yc) < 0.3
    kT = 0.00831446261815324 * 300.0
    j = np.searchsorted(res.xedges, 1.0) - 1
    mid_y = np.nanargmin(F[ix])
    assert abs((F[j, mid_y] - F[ix, mid_y]) - 0.5 * kT) < 0.35 * kT


def test_kde_refusals_and_bandwidths_match_jax(cloud):
    x, _ = cloud
    w, ess = fes.normalize_weights(None, 5000)
    for sel in ("scott", "silverman", 0.25):
        assert fes.compute_bandwidth(x[:5000], w, ess, sel) == jax_fes.compute_bandwidth(
            x[:5000], w, ess, sel)
    for bad in (dict(bins=1), dict(bandwidth=-1.0), dict(bandwidth="epanechnikov")):
        with pytest.raises(ValueError):
            fes.compute_kde_fes(x[:100], x[:100], device="cpu", **bad)
    with pytest.raises(ValueError, match="finite"):
        fes.compute_kde_fes(np.array([0.0, np.nan]), np.zeros(2), device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        fes.compute_kde_fes(np.zeros(3), np.zeros(2), device="cpu")


def test_fes_from_dataset_matches_jax(cloud):
    x, y = cloud
    noise = np.random.default_rng(1).normal(0, 0.1, x.shape)
    shards = [{"features": np.stack([x[:3000], noise[:3000], y[:3000]], 1)},
              {"features": np.stack([x[3000:], noise[3000:], y[3000:]], 1),
               "weights": np.full(3000, 2.0)}, ]
    assert fes.select_fes_columns(shards[0]["features"]) == (0, 2)
    res = fes.fes_from_dataset(shards, method="kde", bins=24, device="cpu")
    _assert_kde_equal(res, jax_fes.fes_from_dataset(shards, method="kde", bins=24))
    assert res.free_energy.shape == (24, 24) and res.cv_names == ("CV0", "CV2")
    hist = fes.fes_from_dataset(shards, bins=20)
    jhist = jax_fes.fes_from_dataset(shards, bins=20)
    np.testing.assert_array_equal(hist.free_energy, jhist.free_energy)
    with pytest.raises(ValueError):
        fes.fes_from_dataset(shards, method="spline")


# --- whitening, projection, accounting, debug export ---------------------------------------------


def _dataset(n_shards=2, frames=200, seed=0):
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(n_shards):
        X = np.concatenate([rng.normal(-1, 0.2, (frames // 2, 2)),
                            rng.normal(1, 0.2, (frames - frames // 2, 2))]).astype(np.float32)
        rng.shuffle(X)
        shards.append({"features": X, "metadata": {"stride": 1, "temperature_K": 300.0}})
    return shards


def test_whitening_prep_matches_jax():
    shards = _dataset()
    wh = estimate_whitening(np.concatenate([s["features"] for s in shards]))
    port = amsm.ensure_msm_inputs_whitened(shards, wh)
    ref = jax_amsm.ensure_msm_inputs_whitened(shards, wh)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a["features"], b["features"])
        assert a["metadata"] == b["metadata"] and a["metadata"]["whitening_applied"]
    assert amsm.ensure_msm_inputs_whitened(port, wh) == port   # applied once
    with pytest.raises(WhiteningError, match="mixes"):
        amsm.ensure_msm_inputs_whitened([port[0], shards[1]], wh)
    out, meta = project_cv.apply_whitening_from_metadata(shards[0]["features"], wh)
    np.testing.assert_array_equal(out, port[0]["features"])
    assert meta["applied"]
    projected = project_cv.project_dataset_cvs(shards, wh)
    np.testing.assert_array_equal(projected[1]["features"], port[1]["features"])
    result = amsm.prepare_msm_discretization(shards, whitening=wh, n_states=4, lag=1)
    assert result.artifacts["whitening_applied"]
    assert result.transition_matrix.shape == (4, 4)


def test_expected_pairs_match_jax():
    lengths = {"train": [100, 5, 37], "val": [12]}
    assert counting.expected_pairs_by_split(lengths, 6) == {"train": 94 + 31, "val": 6}
    from pmarlo_tpu.analysis import counting as jax_counting

    assert counting.expected_pairs([100, 5, 37], 6) == jax_counting.expected_pairs([100, 5, 37], 6)


def test_debug_export_matches_jax(tmp_path, double_well_dtrajs):
    dtrajs, _ = double_well_dtrajs
    for lag in (1, 5):
        port = debug_export.compute_analysis_debug(dtrajs, lag, output_json=tmp_path / "d.json")
        ref = jax_debug.compute_analysis_debug(dtrajs, lag)
        assert port.to_dict() == ref.to_dict()
    assert json.loads((tmp_path / "d.json").read_text())["lag"] == 5
    feats = [np.random.default_rng(2).normal(size=(len(d), 3)) for d in dtrajs]
    out = debug_export.export_analysis_debug(dtrajs, 5, tmp_path / "port", features=feats,
                                             extra_metadata={"run": 1})
    jout = jax_debug.export_analysis_debug(dtrajs, 5, tmp_path / "jax", features=feats,
                                           extra_metadata={"run": 1})
    assert (out / "summary.json").read_text() == (jout / "summary.json").read_text()
    a, b = np.load(out / "core_arrays.npz"), np.load(jout / "core_arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


# --- metrics, results, builder -------------------------------------------------------------------


@pytest.mark.parametrize("history, kw", [
    (None, {}),
    ({"best": {"val_vamp2": 1.9, "epoch": 7, "tau": 10}, "epochs": []}, {}),
    ({"epochs": [{"epoch": 0, "tau": 2, "val_vamp2": 0.5},
                 {"epoch": 1, "tau": 4, "val_vamp2": float("nan")},
                 {"epoch": 2, "tau": 4, "val_vamp2": 1.5}]}, {}),
    ({"val_score_curve": [0.2, 0.8, 0.3, 0.4]}, dict(tau_schedule=[5, 20], epochs_per_tau=2)),
])
def test_training_metrics_match_jax(history, kw):
    assert metrics.normalize_training_metrics(history, **kw) == \
        jax_metrics.normalize_training_metrics(history, **kw)


def test_deeptica_config_helpers_match_jax():
    for cfg in ({}, {"deeptica": {"enabled": False}},
                {"deeptica": {"min_pairs": "32", "skip_on_failure": 0, "lag": 5}},
                {"deeptica": {"min_pairs": "oops"}}):
        assert metrics.resolve_deeptica(cfg) == jax_metrics.resolve_deeptica(cfg)
    payload = {"applied": True, "secret": "x",
               "attempts": [{"lag": i, "status": "ok"} for i in range(9)]}
    p = metrics.sanitize_deeptica_payload(payload)
    assert p == jax_metrics.sanitize_deeptica_payload(payload)
    assert p["applied"] and "secret" not in p and len(p["attempts"]) == 5


@dataclasses.dataclass
class Summary(results.BaseResult):
    n_states: int = 0
    lags: list = dataclasses.field(default_factory=list)


def test_results_round_trip_through_json_and_pickle(tmp_path):
    res = its.ITSResult(lags=np.array([1, 2]), timescales=np.ones((2, 1)),
                        ci_lower=np.zeros((2, 1)), ci_upper=np.full((2, 1), 2.0),
                        n_samples=4, plateau_lag=1)
    assert results.ITSResult is its.ITSResult and results.SCHEMA_VERSION == 1
    s = Summary(n_states=5, lags=[1, 2])
    back = Summary.load_json(s.save_json(tmp_path / "s.json"))
    assert back == s
    with pytest.raises(ValueError, match="newer"):
        Summary.from_dict({"version": 99})
    assert results.BaseResult.load_pickle(s.save_pickle(tmp_path / "s.pkl")) == s
    with pytest.raises(TypeError, match="not Summary"):
        Summary.load_pickle(results.BaseResult().save_pickle(tmp_path / "b.pkl"))
    assert json.loads(json.dumps(res.to_dict()))["lags"] == [1, 2]


def test_msm_builder_fits_on_the_port(double_well_dtrajs):
    _, xs = double_well_dtrajs
    X = [x[:, None].astype(np.float32) for x in xs]
    builder = MSMBuilder(n_states=6, lag=5).fit(X)
    assert builder.msm is not None and builder.clustering.n_states == 6
    labels = builder.transform(X[0][:100])
    np.testing.assert_array_equal(labels, builder.clustering.labels_per_traj[0][:100])
    assert labels.shape == (100,) and ((labels >= 0) & (labels < 6)).all()
    with pytest.raises(RuntimeError, match="fit"):
        MSMBuilder().transform(X[0])


# --- the names ----------------------------------------------------------------------------------


def test_msm_and_analysis_export_what_jax_exports():
    assert msm.__all__ == jax_msm.__all__
    assert analysis.__all__ == jax_analysis.__all__
    for module in (msm, analysis):
        for name in module.__all__:
            assert getattr(module, name) is not None


#: the names of ``pmarlo_tpu.features`` whose module the port has not yet:
#: none since ``features/structure.py`` (SASA, DSSP, H-bonds) is ported
FEATURES_STILL_MISSING = set()


def test_features_export_what_jax_exports_but_structure():
    """The port's features export every public name of JAX's, the
    structure features included."""
    assert set(jax_features.__all__) <= set(features.__all__)
    public = {n for n in dir(jax_features) if not n.startswith("_")
              and not type(getattr(jax_features, n)).__name__ == "module"}
    assert public - set(dir(features)) == FEATURES_STILL_MISSING
    for name in public:
        assert getattr(features, name) is not None, name
    for name in ("compute_ramachandran", "compute_ramachandran_fes", "periodic_hist2d"):
        assert name in features.__all__
        assert getattr(features, name).__module__ == "pmarlo_tpu_torch.features.ramachandran"


#: each name of ``pmarlo_tpu._EXPORTS`` the port's registry lacks, beside
#: the queue item of ROADMAP.md that brings its module
REGISTRY_STILL_MISSING = {
    "api": "A14", "visualization": "A14", "export_dashboard": "A14",
    "serve_dashboard": "A14",
}

#: JAX modules the port carries under another name (the Pallas files)
RENAMED = {
    "pmarlo_tpu.md.pallas_pair": "pmarlo_tpu_torch.md.pair_force",
    "pmarlo_tpu.md.pallas_periodic": "pmarlo_tpu_torch.md.periodic_force",
    "pmarlo_tpu.md.pallas_cells": "pmarlo_tpu_torch.md.cell_force",
}


def test_lazy_registry_is_jax_registry_but_the_queued_names():
    port, ref = pmarlo_tpu_torch._EXPORTS, pmarlo_tpu._EXPORTS
    assert set(ref) - set(port) == set(REGISTRY_STILL_MISSING)
    assert set(port) <= set(ref)
    for name, (module, attr) in port.items():
        jmodule, jattr = ref[name]
        assert module == RENAMED.get(jmodule, jmodule.replace("pmarlo_tpu", "pmarlo_tpu_torch",
                                                               1)), name
        assert attr == jattr, name
        assert getattr(pmarlo_tpu_torch, name) is not None


# --- devices -------------------------------------------------------------------------------------


def _entry_points():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(300, 3))
    C = rng.integers(1, 30, (4, 4)).astype(float)
    x, y = rng.normal(size=200), rng.normal(size=200)
    frames = rng.normal(size=(3, 22, 3)).astype(np.float32)
    topo = build_topology(alanine_dipeptide_structure())
    info = TopologyInfo(topo.atom_names, topo.residue_names, topo.residue_ids)
    positions = np.asarray(alanine_dipeptide_structure().coordinates(), np.float32)
    walk = (positions[None] + rng.normal(0.0, 0.01, (6, 22, 3))).astype(np.float32)

    def enhanced_features(**kw):
        m = enhanced.EnhancedMSM([walk, walk[::-1]], topology=info, **kw)
        m.compute_features("phi_psi")
        assert all(f.dtype == np.float32 and isinstance(f, np.ndarray) for f in m.features)
        return np.concatenate(m.features)

    return {
        "tica": (reduction, lambda **kw: reduction.tica(X, 2, **kw).eigenvalues),
        "reduce_features": (reduction, lambda **kw: reduction.reduce_features(
            X, "vamp", lag=2, **kw)[1].eigenvalues),
        "sample_posterior_timescales": (its, lambda **kw: its.sample_posterior_timescales(
            C, 1, n_samples=4, **kw)),
        "sample_reversible_posterior": (its, lambda **kw: reversible_sampler.
                                        sample_reversible_posterior(C, 4, n_burn=2, **kw)),
        "compute_kde_fes": (fes, lambda **kw: fes.compute_kde_fes(x, y, bins=8, **kw).counts),
        "compute_ramachandran": (ramachandran, lambda **kw: ramachandran.compute_ramachandran(
            frames, info, **kw)[0]),
        "featurize_trajectory": (featurize, lambda **kw: featurize.featurize_trajectory(
            walk, "phi_psi", info, **kw)[0]),
        # the structure features place frames through featurize's rule
        "shrake_rupley_sasa": (featurize, lambda **kw: structure.shrake_rupley_sasa(
            walk, np.full(22, 0.15), n_points=32, **kw)),
        "dssp": (featurize, lambda **kw: structure.dssp(walk, info, **kw)),
        "EnhancedMSM.compute_features": (enhanced, enhanced_features),
    }


@pytest.mark.parametrize("name", ["tica", "reduce_features", "sample_posterior_timescales",
                                  "sample_reversible_posterior", "compute_kde_fes",
                                  "compute_ramachandran", "featurize_trajectory",
                                  "shrake_rupley_sasa", "dssp",
                                  "EnhancedMSM.compute_features"])
def test_entry_points_resolve_the_default_device(name, monkeypatch):
    """``device=None`` asks ``_device.default_device()`` once and computes
    there; an explicit device never asks, and gives the same numbers."""
    module, run = _entry_points()[name]
    calls = []

    def fake_default():
        calls.append(name)
        return torch.device("cpu")

    monkeypatch.setattr(module, "default_device", fake_default)
    first = run()
    assert calls == [name]
    calls.clear()
    np.testing.assert_array_equal(first, run(device="cpu"))
    assert not calls


@pytest.mark.parametrize("name", ["featurize_trajectory", "shrake_rupley_sasa", "dssp"])
def test_a_tensor_stays_on_its_device(name, monkeypatch):
    """A tensor trajectory is computed on its own device without asking
    ``default_device()``; an explicit device moves it, with the same
    numbers."""
    rng = np.random.default_rng(3)
    topo = build_topology(alanine_dipeptide_structure())
    info = TopologyInfo(topo.atom_names, topo.residue_names, topo.residue_ids)
    positions = np.asarray(alanine_dipeptide_structure().coordinates(), np.float32)
    walk = torch.as_tensor(positions[None] + rng.normal(0.0, 0.01, (4, 22, 3)),
                           dtype=torch.float32)
    run = {
        "featurize_trajectory": lambda x, **kw: featurize.featurize_trajectory(
            x, "phi_psi", info, **kw)[0],
        "shrake_rupley_sasa": lambda x, **kw: structure.shrake_rupley_sasa(
            x, np.full(22, 0.15), n_points=32, **kw),
        "dssp": lambda x, **kw: structure.dssp(x, info, **kw),
    }[name]
    def never():
        raise AssertionError("default_device() asked for a tensor trajectory")

    monkeypatch.setattr(featurize, "default_device", never)
    out = run(walk)
    assert out.device == walk.device
    moved = run(walk, device="cpu")
    assert moved.device == torch.device("cpu")
    torch.testing.assert_close(out, moved, rtol=0, atol=0)
    on_meta = run(walk, device="meta")
    assert on_meta.device == torch.device("meta") and on_meta.shape == out.shape
