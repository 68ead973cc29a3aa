"""Port parity for the Bayesian implied timescales (``msm/its.py``) and the
reversible Gibbs sampler (``msm/reversible_sampler.py``).

The deterministic parts are held exactly against JAX: the timescales of
given eigenvalues, the plateau, the lag ladder, the NaN fill from the
reversible estimate, the sampler's schedule and start. Philox cannot replay
JAX's stream, so the draws are held statistically: the Dirichlet mean, the
reversible sampler's two-state answer and detailed balance, each package's
ITS medians inside the other's 95% band, and one generator seed giving the
same samples twice.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu.msm import its as jax_its
from pmarlo_tpu.msm import reversible_sampler as jax_rs
from pmarlo_tpu_torch.msm import its, reversible_sampler as rs


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _chain(T, n, seed):
    """A discrete trajectory of ``n`` steps of transition matrix ``T``."""
    rng = np.random.default_rng(seed)
    cum = np.cumsum(T, axis=1)
    u = rng.uniform(size=n)
    d = np.zeros(n, dtype=np.int64)
    for t in range(1, n):
        d[t] = min(np.searchsorted(cum[d[t - 1]], u[t]), len(T) - 1)
    return d


THREE = np.array([[0.90, 0.08, 0.02],
                  [0.16, 0.80, 0.04],
                  [0.08, 0.08, 0.84]])


def _two_state_counts(p=0.1, q=0.2, n=20_000, seed=0):
    """Counts of a known 2-state chain; analytic t2 = -1/ln(1-p-q)."""
    d = _chain(np.array([[1 - p, p], [q, 1 - q]]), n, seed)
    C = np.zeros((2, 2))
    np.add.at(C, (d[:-1], d[1:]), 1.0)
    return C, -1.0 / np.log(1.0 - p - q)


# --- deterministic parts, exactly ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 6])
def test_timescales_from_eigvals_match_jax(k):
    rng = np.random.default_rng(k)
    evals = rng.uniform(-1.0, 1.0, (7, 5)) + 1j * rng.uniform(-0.1, 0.1, (7, 5))
    evals[:, 0] = 1.0
    evals[0, 1] = 1.0                      # clipped below 1
    evals[1, 2] = 0.0                      # clipped above 0
    np.testing.assert_array_equal(its._timescales_from_eigvals(evals, 3, 0.5, k),
                                  jax_its._timescales_from_eigvals(evals, 3, 0.5, k))


@pytest.mark.parametrize("series", [
    [50.0, 80.0, 100.0, 101.0, 99.0],
    [10.0, np.nan, 10.0, 10.5, 10.2, 30.0],
    [1.0, 5.0, 25.0],
    [np.nan, np.nan],
    [-1.0, -1.0, 3.0, 3.1],
])
def test_detect_plateau_matches_jax(series):
    lags = np.arange(1, len(series) + 1) * 2
    a = np.asarray(series)[:, None]
    assert its.detect_plateau(lags, a) == jax_its.detect_plateau(lags, a)
    assert its.detect_plateau(lags, a, 0.5) == jax_its.detect_plateau(lags, a, 0.5)


def test_lag_ladder_and_padding_match_jax():
    """``lags=None`` builds the same ladder; the columns past the connected
    states are NaN in both; lags past the data are dropped."""
    d = _chain(THREE, 600, seed=1)
    port = its.compute_implied_timescales([d], n_samples=8, n_timescales=4, device="cpu")
    ref = jax_its.compute_implied_timescales([d], n_samples=8, n_timescales=4)
    np.testing.assert_array_equal(port.lags, ref.lags)
    np.testing.assert_array_equal(np.isnan(port.timescales), np.isnan(ref.timescales))
    assert np.isnan(port.timescales[:, 2:]).all()
    assert its.compute_implied_timescales([d], lags=[1, 5, 900], n_samples=4,
                                          device="cpu").lags.tolist() == [1, 5]
    with pytest.raises(its.EstimationError, match="no feasible lags"):
        its.compute_implied_timescales([d[:3]], lags=[5], device="cpu")


@pytest.mark.parametrize("reversible", [False, True])
def test_nan_fill_from_reversible_estimate_matches_jax(monkeypatch, reversible):
    """Where every sample is NaN the median comes from the deterministic
    reversible MLE: the same numbers in both packages."""
    d = [_chain(THREE, 400, seed=s) for s in (2, 3)]

    def nan_samples(C, lag, *, n_samples, n_timescales, **kw):
        return np.full((n_samples, n_timescales), np.nan)

    name = "sample_reversible_timescales" if reversible else "sample_posterior_timescales"
    for mod in ((rs, jax_rs) if reversible else (its, jax_its)):
        monkeypatch.setattr(mod, name, nan_samples)
    port = its.compute_implied_timescales(d, lags=[1, 2, 4], n_samples=4, n_timescales=2,
                                          reversible=reversible, device="cpu")
    ref = jax_its.compute_implied_timescales(d, lags=[1, 2, 4], n_samples=4, n_timescales=2,
                                             reversible=reversible)
    assert np.isfinite(port.timescales).all()
    np.testing.assert_array_equal(port.timescales, ref.timescales)
    assert np.isnan(port.ci_lower).all() and np.isnan(port.ci_upper).all()
    assert port.plateau_lag == ref.plateau_lag


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 9, 16])
def test_schedule_matches_jax_and_covers_every_edge_once(n):
    pairs, m = rs._round_robin_schedule(n)
    jpairs, jm = jax_rs._round_robin_schedule(n)
    assert m == jm
    np.testing.assert_array_equal(pairs, jpairs)
    seen = set()
    for rnd in pairs:
        verts = set()
        for i, j in rnd:
            assert i != j and i not in verts and j not in verts
            verts.update((int(i), int(j)))
            seen.add((int(i), int(j)))
    assert len(seen) == m * (m - 1) // 2


def test_initial_flow_matrix_matches_jax():
    rng = np.random.default_rng(4)
    C = rng.integers(0, 40, (6, 6)).astype(float) + np.eye(6)
    X = rs._init_flow_matrix(C)
    np.testing.assert_array_equal(X, jax_rs._init_flow_matrix(C))
    np.testing.assert_array_equal(X, X.T)
    assert abs(X.sum() - 1.0) < 1e-12


# --- the draws, statistically -------------------------------------------------------------------


def test_dirichlet_mean_within_four_standard_errors():
    """2,000 draws of T from C + prior: every entry's mean lies within 4
    standard errors of (C + prior) / row sum, the zero-count entries too."""
    C = np.array([[40.0, 5.0, 0.0, 1.0],
                  [3.0, 20.0, 7.0, 0.0],
                  [0.0, 2.0, 30.0, 9.0],
                  [4.0, 0.0, 6.0, 12.0]])
    alpha = C + 1e-4
    rows = its.dirichlet_rows(torch.as_tensor(alpha, dtype=torch.float32), 2000, _gen(0))
    T = rows.numpy().astype(np.float64)
    a0 = alpha.sum(1, keepdims=True)
    mean = alpha / a0
    se = np.sqrt(alpha * (a0 - alpha) / (a0**2 * (a0 + 1)) / 2000)
    assert np.isfinite(T).all()
    np.testing.assert_allclose(T.sum(-1), 1.0, atol=1e-5)
    assert (np.abs(T.mean(0) - mean) <= 4 * se + 1e-7).all()


def test_log_space_draw_survives_tiny_concentrations():
    """A row of concentrations 1e-4 (no counts): float32 gammas of that
    shape underflow (to 0, or to the clamp at the smallest normal float), so
    the normalised row would be 0/0 or flat; drawn in log space it is a
    finite row summing to 1 with its mass on one state, as a Dirichlet of
    tiny concentrations has."""
    alpha = torch.full((3, 5), 1e-4)
    rows = its.dirichlet_rows(alpha, 50, _gen(1))
    assert torch.isfinite(rows).all()
    torch.testing.assert_close(rows.sum(-1), torch.ones(50, 3), atol=1e-5, rtol=0)
    assert bool((rows.max(-1).values > 0.99).all())
    naive = torch._standard_gamma(alpha.expand(50, 3, 5).contiguous(), generator=_gen(1))
    # what log space avoids: most naive rows are nothing but underflow
    tiny = torch.finfo(torch.float32).tiny
    assert float((naive.sum(-1) <= 5 * tiny).float().mean()) > 0.9
    lg = its.log_gamma(torch.full((20_000,), 2.5, dtype=torch.float64), _gen(2))
    g = lg.exp().numpy()
    assert abs(g.mean() - 2.5) < 4 * np.sqrt(2.5 / 20_000)
    assert abs(g.var() - 2.5) < 0.15


def test_same_generator_seed_gives_the_same_samples():
    C = 50.0 * THREE
    a = its.sample_posterior_timescales(C, 1, n_samples=16, generator=_gen(5))
    b = its.sample_posterior_timescales(C, 1, n_samples=16, seed=5, device="cpu")
    np.testing.assert_array_equal(a, b)
    c = its.sample_posterior_timescales(C, 1, n_samples=16, seed=6, device="cpu")
    assert not np.array_equal(a, c)
    Ta = rs.sample_reversible_posterior(C, 8, n_burn=5, generator=_gen(7))
    Tb = rs.sample_reversible_posterior(C, 8, n_burn=5, seed=7, device="cpu")
    np.testing.assert_array_equal(Ta, Tb)
    d = [_chain(THREE, 300, 8)]
    ia, ib = (its.compute_implied_timescales(d, lags=[1, 2], n_samples=8, reversible=True,
                                             seed=9, device="cpu") for _ in range(2))
    np.testing.assert_array_equal(ia.timescales, ib.timescales)


def test_draws_use_the_generator_not_the_global_stream():
    C = 50.0 * THREE
    torch.manual_seed(0)
    a = its.sample_posterior_timescales(C, 1, n_samples=8, seed=3, device="cpu")
    Ta = rs.sample_reversible_posterior(C, 8, n_burn=3, seed=3, device="cpu")
    torch.manual_seed(123)
    state = torch.get_rng_state()
    b = its.sample_posterior_timescales(C, 1, n_samples=8, seed=3, device="cpu")
    Tb = rs.sample_reversible_posterior(C, 8, n_burn=3, seed=3, device="cpu")
    assert torch.equal(state, torch.get_rng_state())
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(Ta, Tb)


def test_posterior_timescales_concentrate_with_counts():
    pi = np.array([0.5, 0.3, 0.2])
    C_small = (pi[:, None] * THREE) * 500
    s_small = its.sample_posterior_timescales(C_small, 1, n_samples=60, n_timescales=1,
                                              seed=0, device="cpu")
    s_big = its.sample_posterior_timescales(C_small * 100, 1, n_samples=60, n_timescales=1,
                                            seed=0, device="cpu")
    assert np.nanstd(s_big[:, 0]) < np.nanstd(s_small[:, 0])
    exact = -1 / np.log(np.sort(np.abs(np.linalg.eigvals(THREE)))[::-1][1])
    assert abs(np.nanmean(s_big[:, 0]) - exact) / exact < 0.2


@pytest.mark.parametrize("reversible", [False, True])
def test_its_medians_inside_each_others_band(reversible):
    """On the same dtrajs, the port's medians lie inside JAX's 95% band
    and JAX's inside the port's, at every lag and timescale."""
    d = [_chain(THREE, 1500, seed=s) for s in (10, 11)]
    kw = dict(lags=[1, 3], n_samples=100, n_timescales=2, reversible=reversible)
    port = its.compute_implied_timescales(d, seed=1, device="cpu", **kw)
    ref = jax_its.compute_implied_timescales(d, seed=1, **kw)
    np.testing.assert_array_equal(port.lags, ref.lags)
    assert np.isfinite(port.timescales).all()
    assert (ref.ci_lower <= port.timescales).all() and (port.timescales <= ref.ci_upper).all()
    assert (port.ci_lower <= ref.timescales).all() and (ref.timescales <= port.ci_upper).all()
    assert (port.ci_lower <= port.timescales).all() and (port.timescales <= port.ci_upper).all()


def test_reversible_two_state_known_answer_and_row_posterior():
    """n = 2: every stochastic matrix is reversible, so both posteriors
    share their likelihood: the medians agree and lie near the truth."""
    C, t_true = _two_state_counts()
    rev = rs.sample_reversible_timescales(C, 1, n_samples=200, seed=2, device="cpu")[:, 0]
    row = its.sample_posterior_timescales(C, 1, n_samples=200, seed=2, device="cpu")[:, 0]
    assert abs(np.median(rev) - t_true) / t_true < 0.10
    w_rev = np.quantile(rev, 0.975) - np.quantile(rev, 0.025)
    w_row = np.quantile(row, 0.975) - np.quantile(row, 0.025)
    assert abs(np.median(rev) - np.median(row)) / np.median(row) < 0.05
    assert 0.6 < w_rev / w_row < 1.6


def test_reversible_samples_satisfy_detailed_balance():
    """Each sample's flow matrix is symmetric to 1e-6 of its largest entry
    (float32 chains), each row of T sums to 1, and the stationary flux of T
    is symmetric."""
    rng = np.random.default_rng(3)
    C = rng.integers(1, 60, (5, 5)).astype(float)
    X = rs.sample_reversible_posterior(C, n_samples=16, seed=3, return_flow=True,
                                       device="cpu")
    assert X.shape == (16, 5, 5)
    for x in X:
        assert np.abs(x - x.T).max() <= 1e-6 * np.abs(x).max()
    Ts = rs.sample_reversible_posterior(C, n_samples=16, seed=3, device="cpu")
    for T in Ts:
        assert np.allclose(T.sum(axis=1), 1.0, atol=1e-10)
        evals, evecs = np.linalg.eig(T.T)
        pi = np.abs(np.real(evecs[:, np.argmax(np.real(evals))]))
        pi /= pi.sum()
        flux = pi[:, None] * T
        assert np.allclose(flux, flux.T, atol=1e-8)


def test_reversible_constraint_binds_and_zero_edges_stay_zero():
    C = np.array([[50.0, 40.0, 2.0],
                  [2.0, 50.0, 40.0],
                  [40.0, 2.0, 50.0]])
    rev = rs.sample_reversible_timescales(C, 1, n_samples=100, seed=5, device="cpu")[:, 0]
    row = its.sample_posterior_timescales(C, 1, n_samples=100, seed=5, device="cpu")[:, 0]
    assert np.isfinite(rev).all()
    assert abs(np.median(rev) - np.median(row)) > 0.05 * np.median(row)
    C4 = np.array([[10.0, 5.0, 0.0, 0.0],
                   [5.0, 10.0, 3.0, 0.0],
                   [0.0, 3.0, 10.0, 5.0],
                   [0.0, 0.0, 5.0, 10.0]])
    Ts = rs.sample_reversible_posterior(C4, n_samples=8, seed=7, device="cpu")
    assert (Ts[:, 0, 2] == 0).all() and (Ts[:, 0, 3] == 0).all()
    assert (Ts[:, 1, 3] == 0).all() and (Ts[:, 3, 0] == 0).all()


def test_its_reversible_flag_end_to_end():
    T = np.array([[0.9, 0.1], [0.2, 0.8]])
    d = _chain(T, 4000, seed=6)
    res = its.compute_implied_timescales([d], lags=[1, 2, 5], n_samples=24, reversible=True,
                                         seed=6, device="cpu")
    t_true = -1.0 / np.log(0.7)
    assert res.timescales.shape[0] == 3
    assert abs(res.timescales[0, 0] - t_true) / t_true < 0.25
    assert (res.ci_lower[:, 0] <= res.timescales[:, 0] + 1e-9).all()
    assert (res.ci_upper[:, 0] >= res.timescales[:, 0] - 1e-9).all()
    assert res.to_dict()["lags"] == [1, 2, 5]


def test_sampler_refuses_one_state():
    with pytest.raises(its.EstimationError, match=">= 2 states"):
        rs.sample_reversible_posterior(np.ones((1, 1)), 4, device="cpu")
    assert np.isnan(rs.sample_reversible_timescales(np.ones((1, 1)), 1, n_samples=3,
                                                    device="cpu")).all()
    assert np.isnan(its.sample_posterior_timescales(np.ones((1, 1)), 1, n_samples=3,
                                                    device="cpu")).all()
