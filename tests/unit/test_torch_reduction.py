"""Port parity for the linear reductions (``msm/reduction.py``), the
Ramachandran analysis (``features/ramachandran.py``) and the CV facade
(``cv``): the same inputs, made from a numpy seed, through the JAX function
and the port's on the CPU.

Tolerances: eigenvalues 1e-5, components 1e-4 of their largest entry up to
sign, ``vamp2_score`` 1e-5, angles 1e-4 degrees, histograms exact and the
smoothed FES 1e-10 when fed the same angles.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
from pmarlo_tpu.features.base import TopologyInfo as JaxTopologyInfo
from pmarlo_tpu.features import ramachandran as jax_rama
from pmarlo_tpu.md.topology import build_topology as jax_build_topology
from pmarlo_tpu.msm import reduction as jax_reduction
from pmarlo_tpu_torch.cv import train_cv_model
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.features import ramachandran
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.msm import reduction
from pmarlo_tpu_torch.utils.errors import EstimationError


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ar1(phi, n, rng, scale=1.0):
    """Stationary AR(1) series with autoregression phi."""
    x = np.empty(n)
    x[0] = rng.normal(0, scale / np.sqrt(1 - phi**2))
    noise = rng.normal(0, scale, n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + noise[t]
    return x


@pytest.fixture(scope="module")
def slow_fast():
    """3-D process: a slow (phi 0.99), a middle (0.7) and a fast (0.1)
    mode, mixed so that no input coordinate is a mode."""
    rng = np.random.default_rng(0)
    modes = np.stack([_ar1(0.99, 6_000, rng), _ar1(0.7, 6_000, rng),
                      _ar1(0.1, 6_000, rng)], axis=1)
    A = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return modes @ A.T, A


def _same_up_to_sign(a, b, rel=1e-4):
    """Each column of ``a`` equals ``b``'s or its negative, within ``rel`` of
    the column's largest entry."""
    for k in range(b.shape[1]):
        s = np.sign(a[:, k] @ b[:, k])
        scale = np.abs(b[:, k]).max()
        assert np.abs(a[:, k] - s * b[:, k]).max() <= rel * scale, k


def _models(method, seqs, lag, n):
    if method == "pca":
        return reduction.pca(seqs, n), jax_reduction.pca(seqs, n)
    port = getattr(reduction, method)(seqs, lag, n, device="cpu")
    return port, getattr(jax_reduction, method)(seqs, lag, n)


@pytest.mark.parametrize("method", ["tica", "vamp", "pca"])
@pytest.mark.parametrize("lag", [1, 10])
def test_reduction_matches_jax(slow_fast, method, lag):
    X, _ = slow_fast
    seqs = [X[:2500], X[2500:4000], X[4000:]]
    port, ref = _models(method, seqs, lag, 3)
    assert port.method == ref.method and port.lag == ref.lag
    np.testing.assert_allclose(port.eigenvalues, ref.eigenvalues, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.mean, ref.mean, atol=1e-12, rtol=0)
    _same_up_to_sign(port.components, ref.components)


def test_streaming_moments_match_jax(slow_fast):
    X, _ = slow_fast
    seqs = [X[:3000], X[3000:3005], X[3005:]]  # the short one holds no pair at lag 7
    port = reduction._streaming_moments(seqs, 7, device="cpu")
    ref = jax_reduction._streaming_moments(seqs, 7)
    assert port[3] == ref[3] == (3000 - 7) + (2995 - 7)
    for a, b in zip(port[:3], ref[:3]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_streaming_moments_match_float64_sums():
    """The float32 products come out as the float64 sums of the float32
    inputs, within float32 accumulation."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(5_000, 3))
    C00a, C0ta, _, na = reduction._streaming_moments([X[:2500], X[2500:]], 7, device="cpu")
    X0 = np.concatenate([X[:2493], X[2500:-7]])
    Xt = np.concatenate([X[7:2500], X[2507:]])
    n = X0.shape[0]
    assert na == n
    m0, mt = X0.mean(0), Xt.mean(0)
    np.testing.assert_allclose(C00a, X0.T @ X0 / n - np.outer(m0, m0), atol=1e-4)
    np.testing.assert_allclose(C0ta, X0.T @ Xt / n - np.outer(m0, mt), atol=1e-4)


@pytest.mark.parametrize("lag", [2, 10])
def test_vamp2_score_matches_jax(slow_fast, lag):
    X, _ = slow_fast
    port = reduction.vamp2_score([X[:3000], X[3000:]], lag, device="cpu")
    ref = jax_reduction.vamp2_score([X[:3000], X[3000:]], lag)
    assert abs(port - ref) <= 1e-5
    noise = np.random.default_rng(2).normal(size=X.shape)
    assert port > reduction.vamp2_score(noise, lag, device="cpu")


@pytest.mark.parametrize("method", ["tica", "vamp", "pca"])
def test_reduce_features_matches_jax(slow_fast, method):
    """NaN imputation, standardization and the fold of the standardization
    into the model, on three sequences with a NaN and an Inf."""
    X, _ = slow_fast
    seqs = [X[:1000].copy(), X[1000:1500].copy(), X[1500:3000].copy()]
    seqs[0][10, 0] = np.nan
    seqs[2][200, 1] = np.inf
    out, model = reduction.reduce_features(seqs, method=method, lag=5, n_components=2,
                                           device="cpu")
    ref_out, ref = jax_reduction.reduce_features(seqs, method=method, lag=5, n_components=2)
    assert [o.shape for o in out] == [(1000, 2), (500, 2), (1500, 2)]
    np.testing.assert_allclose(model.eigenvalues, ref.eigenvalues, atol=1e-5, rtol=0)
    np.testing.assert_allclose(model.mean, ref.mean, atol=1e-10, rtol=0)
    _same_up_to_sign(model.components, ref.components)
    signs = np.sign(np.sum(model.components * ref.components, axis=0))
    for a, b in zip(out, ref_out):
        assert np.isfinite(a).all()
        assert np.abs(a - signs * b).max() <= 1e-4 * np.abs(b).max()
    # callable protocol on the raw (finite) data
    np.testing.assert_allclose(model(X[1000:1500]), out[1], atol=1e-10)


def test_tica_finds_slow_mode(slow_fast):
    X, A = slow_fast
    model = reduction.tica(X, lag=10, n_components=3, device="cpu")
    assert abs(model.eigenvalues[0] - 0.99**10) < 0.05
    assert np.all(model.eigenvalues <= 1.0 + 1e-6)
    assert np.all(np.diff(model.eigenvalues) <= 0)
    y = model.transform(X)[:, 0]
    slow_true = X @ A  # unmix: A is orthogonal
    assert abs(np.corrcoef(y, slow_true[:, 0])[0, 1]) > 0.99


def test_vamp_matches_tica_on_reversible_data(slow_fast):
    X, _ = slow_fast
    t = reduction.tica(X, lag=10, n_components=1, device="cpu")
    v = reduction.vamp(X, lag=10, n_components=1, device="cpu")
    assert abs(np.corrcoef(t.transform(X)[:, 0], v.transform(X)[:, 0])[0, 1]) > 0.99
    assert abs(t.eigenvalues[0] - v.eigenvalues[0]) < 0.05


def test_sym_inv_sqrt_identity_and_singular():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(4, 4))
    C = A @ A.T + 0.1 * np.eye(4)
    W = reduction._sym_inv_sqrt(C, 1e-10)
    np.testing.assert_allclose(W @ C @ W.T, np.eye(4), atol=1e-8)
    np.testing.assert_array_equal(W, jax_reduction._sym_inv_sqrt(C, 1e-10))
    with pytest.raises(EstimationError):
        reduction._sym_inv_sqrt(np.zeros((3, 3)), 1e-6)


def test_refusals():
    with pytest.raises(EstimationError, match="no lagged pairs"):
        reduction.tica([np.zeros((5, 2))], lag=10, device="cpu")
    with pytest.raises(ValueError, match="unknown reduction"):
        reduction.reduce_features([np.zeros((100, 2))], method="umap", device="cpu")


def test_pca_via_reduce_features_standardizes():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(2000, 2)) * np.array([100.0, 0.01])
    out, _ = reduction.reduce_features([X], method="pca", standardize=True)
    assert 0.5 < out[0][:, 0].std() < 2.0


def test_train_cv_model_tica_matches_jax(slow_fast):
    X, _ = slow_fast
    model = train_cv_model([X[:3000], X[3000:]], method="tica", lag=5, n_out=2, device="cpu")
    ref = jax_reduction.tica([X[:3000], X[3000:]], lag=5, n_components=2)
    assert isinstance(model, reduction.ReductionModel)
    np.testing.assert_allclose(model.eigenvalues, ref.eigenvalues, atol=1e-5, rtol=0)
    _same_up_to_sign(model.components, ref.components)
    single = train_cv_model(X, method="tica", lag=5, n_out=1, device="cpu")
    assert single.components.shape == (3, 1)
    with pytest.raises(ValueError, match="unknown CV method"):
        train_cv_model(X, method="umap")


def test_train_cv_model_deeptica_trains_on_the_device():
    from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, DeepTICAModel

    rng = np.random.default_rng(6)
    X = rng.normal(size=(400, 3)).astype(np.float32)
    cfg = DeepTICAConfig(lag=2, n_out=1, hidden=(8,), max_epochs=2, batch_size=64)
    model = train_cv_model([X], method="deeptica", config=cfg, device="cpu")
    assert isinstance(model, DeepTICAModel)
    assert model.device == torch.device("cpu")
    assert model.transform(X).shape == (400, 1)


# --- Ramachandran -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def alanine_frames():
    """20 frames of alanine dipeptide, jittered by 0.02 nm, and both
    packages' topology info."""
    s = alanine_dipeptide_structure()
    x = np.asarray(s.coordinates(), np.float64)
    rng = np.random.default_rng(7)
    frames = (x[None] + rng.normal(0.0, 0.02, (20,) + x.shape)).astype(np.float32)
    topo = build_topology(s)
    jtopo = jax_build_topology(jax_alanine())
    info = TopologyInfo(topo.atom_names, topo.residue_names, topo.residue_ids)
    jinfo = JaxTopologyInfo(jtopo.atom_names, jtopo.residue_names, jtopo.residue_ids)
    return frames, info, jinfo


def _wrapped_deg(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def test_compute_ramachandran_matches_jax(alanine_frames):
    frames, info, jinfo = alanine_frames
    phi, psi, labels = ramachandran.compute_ramachandran(frames, info, device="cpu")
    jphi, jpsi, jlabels = jax_rama.compute_ramachandran(frames, jinfo)
    assert labels == jlabels and phi.shape == jphi.shape == (20, len(labels))
    assert _wrapped_deg(phi, np.asarray(jphi)).max() <= 1e-4
    assert _wrapped_deg(psi, np.asarray(jpsi)).max() <= 1e-4
    # a tensor is read on its own device; a selection keeps its labels
    tphi, _, _ = ramachandran.compute_ramachandran(torch.from_numpy(frames), info,
                                                   residue_ids=labels[:1])
    np.testing.assert_array_equal(tphi[:, 0], phi[:, 0])
    with pytest.raises(ValueError, match="no phi/psi"):
        ramachandran.compute_ramachandran(frames, info, residue_ids=[999], device="cpu")


def test_periodic_histogram_and_fes_match_jax():
    rng = np.random.default_rng(8)
    phi = rng.normal(-70.0, 40.0, 3000)      # wraps past -180
    psi = rng.normal(150.0, 30.0, 3000)      # wraps past 180
    w = rng.uniform(0.5, 2.0, 3000)
    for kw in (dict(bins=36), dict(bins=24, weights=w)):
        H, xe, ye = ramachandran.periodic_hist2d(phi, psi, **kw)
        jH, jxe, jye = jax_rama.periodic_hist2d(phi, psi, **kw)
        np.testing.assert_array_equal(H, jH)
        np.testing.assert_array_equal(xe, jxe)
        np.testing.assert_array_equal(ye, jye)
    assert H.sum() == pytest.approx(w.sum())
    for sigma in (0.0, 1.0, 2.5):
        fes = ramachandran.compute_ramachandran_fes(phi, psi, bins=30, smooth_sigma=sigma,
                                                    temperature_K=350.0)
        ref = jax_rama.compute_ramachandran_fes(phi, psi, bins=30, smooth_sigma=sigma,
                                                temperature_K=350.0)
        F, jF = fes["free_energy"], ref["free_energy"]
        np.testing.assert_array_equal(np.isfinite(F), np.isfinite(jF))
        fin = np.isfinite(F)
        assert np.abs(F[fin] - jF[fin]).max() <= 1e-10
        assert F[fin].min() == 0.0
        np.testing.assert_allclose(fes["histogram"], ref["histogram"], atol=1e-10, rtol=0)
