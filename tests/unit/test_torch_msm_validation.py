"""Port parity for the MSM validation and lumping: PCCA+ (``msm/pcca.py``),
TPT (``msm/tpt.py``), the Chapman-Kolmogorov test (``msm/ck.py``) and the
CK/ITS lag selector (``msm/ck_its_selector.py``), host copies of their JAX
sources that reach the port's device counting and k-means.

The same matrices and dtrajs go through both packages: memberships,
committors, flux and MFPT to 1e-10 (the k-means fallback up to a
permutation of macrostates), CK matrices and errors and the selector's
evaluations to 1e-10.
"""

import numpy as np
import pytest
import torch

from pmarlo_tpu.msm import ck as jax_ck
from pmarlo_tpu.msm import ck_its_selector as jax_sel
from pmarlo_tpu.msm import pcca as jax_pcca
from pmarlo_tpu.msm import tpt as jax_tpt
from pmarlo_tpu_torch.msm import ck, ck_its_selector as sel, pcca, tpt
from pmarlo_tpu_torch.utils.errors import EstimationError


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _birth_death(p, q, n):
    T = np.zeros((n, n))
    for i in range(n):
        if i + 1 < n:
            T[i, i + 1] = p
        if i - 1 >= 0:
            T[i, i - 1] = q
        T[i, i] = 1.0 - T[i].sum()
    return T


def lattice(width=8, height=8, p_stay=0.2):
    """The drunkard's-walk lattice of examples/11_tpt_drunkards_walk.py."""
    n = width * height
    T = np.zeros((n, n))
    for i in range(width):
        for j in range(height):
            s = i * height + j
            nbs = [(i - 1) * height + j if i > 0 else None,
                   (i + 1) * height + j if i < width - 1 else None,
                   i * height + j - 1 if j > 0 else None,
                   i * height + j + 1 if j < height - 1 else None]
            nbs = [b for b in nbs if b is not None]
            T[s, s] = p_stay
            for b in nbs:
                T[s, b] = (1 - p_stay) / len(nbs)
    return T


def _random_reversible(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (n, n)) ** 4
    X = X + X.T + np.diag(rng.uniform(2.0, 6.0, n))
    return X / X.sum(1, keepdims=True)


def _blocks(n_blocks, per, p_out, seed):
    """Metastable blocks: rows stay in their block but for ``p_out``."""
    rng = np.random.default_rng(seed)
    n = n_blocks * per
    X = rng.uniform(0.5, 1.0, (n, n))
    X = X + X.T
    for i in range(n):
        for j in range(n):
            if i // per != j // per:
                X[i, j] *= p_out
    return X / X.sum(1, keepdims=True)


def _chain(T, n, seed):
    rng = np.random.default_rng(seed)
    cum = np.cumsum(T, axis=1)
    u = rng.uniform(size=n)
    d = np.zeros(n, dtype=np.int64)
    for t in range(1, n):
        d[t] = min(np.searchsorted(cum[d[t - 1]], u[t]), len(T) - 1)
    return d


# --- PCCA+ ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("T, m", [
    (_blocks(2, 2, 0.02, 0), 2),
    (_blocks(3, 4, 0.01, 1), 3),
    (_random_reversible(9, 2), 2),
    (_random_reversible(9, 3), 4),
])
def test_pcca_matches_jax(T, m):
    chi = pcca.pcca_memberships(T, m)
    np.testing.assert_allclose(chi, jax_pcca.pcca_memberships(T, m), atol=1e-10, rtol=0)
    assert (chi >= 0).all() and (chi <= 1).all()
    np.testing.assert_allclose(chi.sum(1), 1.0, atol=1e-8)
    labels, chi2 = pcca.pcca_assignments(T, m)
    jlabels, jchi2 = jax_pcca.pcca_assignments(T, m)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(chi2, jchi2, atol=1e-10, rtol=0)


def test_pcca_blocks_lump_together():
    T = _blocks(2, 2, 0.02, 0)
    labels, _ = pcca.pcca_assignments(T, 2)
    assert labels[0] == labels[1] and labels[2] == labels[3] and labels[0] != labels[2]
    with pytest.raises(EstimationError):
        pcca.pcca_memberships(T, 1)
    with pytest.raises(EstimationError):
        pcca.pcca_memberships(T, 5)


def test_kmeans_fallback_matches_jax_up_to_permutation():
    """The degenerate-spectrum fallback clusters the eigenvectors with each
    package's own k-means: crisp memberships equal after matching the
    macrostates."""
    rng = np.random.default_rng(4)
    centers = np.array([[3.0, 0.0], [0.0, 3.0], [-3.0, -3.0]])
    evecs = np.concatenate([np.ones((60, 1)),
                            centers[np.arange(60) % 3] + rng.normal(0, 0.05, (60, 2))], 1)
    chi = pcca._kmeans_fallback_memberships(evecs, 3)
    jchi = jax_pcca._kmeans_fallback_memberships(evecs, 3)
    assert set(np.unique(chi)) == {0.0, 1.0}
    perm = [int(np.argmax(chi[jchi[:, k] == 1].sum(0))) for k in range(3)]
    assert sorted(perm) == [0, 1, 2]
    np.testing.assert_array_equal(chi[:, perm], jchi)


# --- TPT -----------------------------------------------------------------------------------------


def _assert_tpt_equal(r, j):
    for name in ("source_states", "sink_states"):
        np.testing.assert_array_equal(getattr(r, name), getattr(j, name))
    for name in ("forward_committor", "backward_committor", "gross_flux", "net_flux"):
        np.testing.assert_allclose(getattr(r, name), getattr(j, name), atol=1e-10, rtol=0)
    for name in ("total_flux", "rate", "mfpt"):
        assert abs(getattr(r, name) - getattr(j, name)) <= 1e-10 * max(1.0, abs(getattr(j, name)))
    assert [p for p, _ in r.pathways] == [p for p, _ in j.pathways]
    np.testing.assert_allclose([f for _, f in r.pathways], [f for _, f in j.pathways],
                               atol=1e-10, rtol=0)
    assert r.pathway_convergence_warning == j.pathway_convergence_warning
    assert r.to_dict() == j.to_dict()


@pytest.mark.parametrize("case", ["chain5", "diamond", "lattice", "random"])
def test_tpt_matches_jax(case):
    if case == "chain5":
        T, A, B = _birth_death(0.3, 0.2, 5), [0], [4]
    elif case == "diamond":
        T = np.array([[0.2, 0.5, 0.2, 0.1], [0.3, 0.4, 0.0, 0.3],
                      [0.3, 0.0, 0.4, 0.3], [0.1, 0.3, 0.3, 0.3]])
        A, B = [0], [3]
    elif case == "lattice":
        T, A, B = lattice(), [0], [63]
    else:
        T, A, B = _random_reversible(10, 5), [0, 1], [8, 9]
    qp, qm = tpt.committors(T, A, B)
    jqp, jqm = jax_tpt.committors(T, A, B)
    np.testing.assert_allclose(qp, jqp, atol=1e-10, rtol=0)
    np.testing.assert_allclose(qm, jqm, atol=1e-10, rtol=0)
    r = tpt.reactive_flux(T, A, B, pathway_fraction=0.999)
    _assert_tpt_equal(r, jax_tpt.reactive_flux(T, A, B, pathway_fraction=0.999))
    np.testing.assert_allclose(tpt.mfpt_matrix(T, dt=2.0), jax_tpt.mfpt_matrix(T, dt=2.0),
                               atol=1e-10 * np.abs(tpt.mfpt_matrix(T)).max(), rtol=0)
    # invariants: committors on the sets, flux out of A into B
    assert (qp[A] == 0).all() and (qp[B] == 1).all() and ((qp >= 0) & (qp <= 1)).all()
    out_A, into_B = r.net_flux[A, :].sum(), r.net_flux[:, B].sum()
    assert abs(out_A - into_B) <= 1e-8 * out_A
    assert abs(r.rate * r.mfpt - 1.0) < 1e-12


def test_drunkards_walk_committors_are_symmetric():
    """The lattice walk is reversible: q- = 1 - q+, and by the diagonal
    symmetry of the lattice q+ at (i, j) equals 1 - q+ at (7-i, 7-j)."""
    qp, qm = tpt.committors(lattice(), [0], [63])
    np.testing.assert_allclose(qp + qm, 1.0, atol=1e-10)
    np.testing.assert_allclose(qp, 1.0 - qp[::-1], atol=1e-10)


def test_tpt_refuses_overlapping_sets():
    with pytest.raises(EstimationError):
        tpt.committors(_birth_death(0.3, 0.2, 5), [0, 2], [2, 4])


# --- CK ------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block_dtrajs():
    T = _blocks(2, 3, 0.03, 6)
    return [_chain(T, 2500, seed=s) for s in (7, 8, 9)]


def _assert_ck_equal(r, j):
    assert (r.lag, r.factors, r.insufficient_data) == (j.lag, j.factors, j.insufficient_data)
    np.testing.assert_array_equal(r.states, j.states)
    assert set(r.predicted) == set(j.predicted)
    for k in r.predicted:
        np.testing.assert_allclose(r.predicted[k], j.predicted[k], atol=1e-10, rtol=0)
        np.testing.assert_allclose(r.estimated[k], j.estimated[k], atol=1e-10, rtol=0)
        assert abs(r.rms[k] - j.rms[k]) <= 1e-10 and abs(r.mse[k] - j.mse[k]) <= 1e-10
    assert r.to_dict().keys() == j.to_dict().keys()


@pytest.mark.parametrize("kw", [dict(factors=(2, 3)), dict(factors=(2, 4), top_n_states=4),
                                dict(factors=(2,), reversible=False, min_transitions=200)])
def test_ck_matches_jax(block_dtrajs, kw):
    r = ck.ck_test(block_dtrajs, 3, **kw)
    _assert_ck_equal(r, jax_ck.ck_test(block_dtrajs, 3, **kw))
    assert not r.insufficient_data and r.max_error < 0.1
    for config in (ck.CKConfig(threshold=0.1), ck.CKConfig(mode="ess_adjusted")):
        jconfig = jax_ck.CKConfig(threshold=config.threshold, mode=config.mode)
        assert ck.decide_ck(r, config, {2: 1e4}) == jax_ck.decide_ck(r, jconfig, {2: 1e4})


def test_ck_macrostates_and_insufficient_data_match_jax(block_dtrajs):
    macro = np.array([0, 0, 0, 1, 1, 1])
    _assert_ck_equal(ck.ck_test_macrostates(block_dtrajs, 2, macro),
                     jax_ck.ck_test_macrostates(block_dtrajs, 2, macro))
    short = [d[:40] for d in block_dtrajs]
    r = ck.ck_test(short, 15, factors=(2, 3))
    _assert_ck_equal(r, jax_ck.ck_test(short, 15, factors=(2, 3)))
    assert r.insufficient_data
    assert ck.decide_ck(ck.ck_test([np.zeros(50, np.int64)], 2))["reason"] == "insufficient_data"


def test_run_ck_writes_the_jax_artifacts(tmp_path, block_dtrajs):
    """``run_ck``'s JSON and CSV as JAX writes them; a run with predictions
    also draws ``ck.png`` through the port's ``visualization``, beside the
    same JSON and CSV as JAX's."""
    short = [d[:40] for d in block_dtrajs]
    ck.run_ck(short, 15, tmp_path / "port", factors=(3, 4))
    jax_ck.run_ck(short, 15, tmp_path / "jax", factors=(3, 4))
    for name in ("ck.json", "ck.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    ck.run_ck(block_dtrajs, 3, tmp_path / "full", factors=(2,))
    jax_ck.run_ck(block_dtrajs, 3, tmp_path / "jax_full", factors=(2,))
    for name in ("ck.json", "ck.csv"):
        assert ((tmp_path / "full" / name).read_text()
                == (tmp_path / "jax_full" / name).read_text()), name
    assert (tmp_path / "full" / "ck.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "full" / "ck.png").stat().st_size > 0


# --- the CK/ITS lag selector ---------------------------------------------------------------------


def _assert_evaluations_equal(r, j):
    assert (r.selected_lag, r.reason) == (j.selected_lag, j.reason)
    assert len(r.evaluations) == len(j.evaluations)
    for a, b in zip(r.evaluations, j.evaluations):
        da, db = a.to_dict(), b.to_dict()
        assert da.keys() == db.keys()
        for key in da:
            x, y = da[key], db[key]
            if isinstance(y, float) or (isinstance(y, list) and y and isinstance(y[0], float)):
                np.testing.assert_allclose(x, y, atol=1e-10, rtol=1e-10)
            else:
                assert x == y, key


def test_selector_matches_jax(block_dtrajs):
    r = sel.select_optimal_lag_ck_its(block_dtrajs, candidate_lags=[1, 2, 4, 8],
                                      ck_factors=(2, 3))
    _assert_evaluations_equal(r, jax_sel.select_optimal_lag_ck_its(
        block_dtrajs, candidate_lags=[1, 2, 4, 8], ck_factors=(2, 3)))
    best = {e.lag: e for e in r.evaluations}[r.selected_lag]
    assert best.feasible and best.ck_error < 0.1 and "lag" in r.reason
    assert len(r.to_dict()["evaluations"]) == 4
    later = [e for e in r.evaluations[1:] if e.timescales]
    assert any(e.its_consistency is not None for e in later)


def test_selector_default_ladder_and_refusals_match_jax(block_dtrajs):
    d = block_dtrajs[0][:300]
    _assert_evaluations_equal(sel.select_optimal_lag_ck_its(d),
                              jax_sel.select_optimal_lag_ck_its(d))
    tiny = [np.array([0, 1] * 4, dtype=np.int64)]
    r = sel.select_optimal_lag_ck_its(tiny, candidate_lags=[2])
    _assert_evaluations_equal(r, jax_sel.select_optimal_lag_ck_its(tiny, candidate_lags=[2]))
    assert r.evaluations[0].feasible or r.evaluations[0].failure_reason
    with pytest.raises(EstimationError, match="too short"):
        sel.select_optimal_lag_ck_its([np.zeros(3, dtype=np.int64)], candidate_lags=[5, 10])
    assert sel._lag_score(0.0, 1.0, 10.0, True) - sel._lag_score(None, 1.0, 10.0, True) == 10.0
