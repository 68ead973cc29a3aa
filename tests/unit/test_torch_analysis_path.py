"""The analysis half as a whole: seeded two-well phi/psi-like sequences
(4 x 400 frames) through JAX's chain and the port's, on the CPU:

    reduce_features (TICA) -> k-means -> build_msm ->
    compute_implied_timescales -> ck_test -> pcca_memberships ->
    committors / reactive_flux

k-means draws its seeds from a JAX key in one package and from a torch
Generator in the other, so the state numbers differ; on four separated
basins both find the same partition. Every result after the clustering is
compared after mapping the port's states onto JAX's: deterministic ones to
1e-10, the posterior timescales inside each other's 95% band. A
``ReductionModel`` fitted by JAX, loaded into the port's dataclass field by
field, transforms the port's data alike: the slice's weights carried
across.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu.msm import ck as jax_ck
from pmarlo_tpu.msm import clustering as jax_clustering
from pmarlo_tpu.msm import estimation as jax_estimation
from pmarlo_tpu.msm import its as jax_its
from pmarlo_tpu.msm import pcca as jax_pcca
from pmarlo_tpu.msm import reduction as jax_reduction
from pmarlo_tpu.msm import tpt as jax_tpt
from pmarlo_tpu_torch.msm import (ck, clustering, estimation, its, pcca, reduction, tpt)

LAG = 2


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sequences():
    """Four runs of a latent chain over the four basins (phi well) x (psi
    well): phi switches rarely (p 0.01 a frame), psi more often (0.05).
    Features are cos/sin of phi and psi with 12 degrees of noise."""
    rng = np.random.default_rng(0)
    phi_c, psi_c = np.radians([-70.0, 60.0]), np.radians([-40.0, 150.0])
    seqs = []
    for _ in range(4):
        a, b = rng.integers(0, 2, 2)
        phi, psi = np.empty(400), np.empty(400)
        for t in range(400):
            a = 1 - a if rng.random() < 0.01 else a
            b = 1 - b if rng.random() < 0.05 else b
            phi[t] = phi_c[a] + rng.normal(0.0, np.radians(12.0))
            psi[t] = psi_c[b] + rng.normal(0.0, np.radians(12.0))
        seqs.append(np.stack([np.cos(phi), np.sin(phi), np.cos(psi), np.sin(psi)], 1))
    return seqs


@pytest.fixture(scope="module")
def chains(sequences):
    """Each package's chain up to the MSM, and the map of port states onto
    JAX's (``perm[port state] = JAX state``)."""
    out, model = reduction.reduce_features(sequences, method="tica", lag=LAG, n_components=2,
                                           device="cpu")
    jout, jmodel = jax_reduction.reduce_features(sequences, method="tica", lag=LAG,
                                                 n_components=2)
    signs = np.sign(np.sum(model.components * jmodel.components, axis=0))
    y = np.concatenate(out) * signs                      # the port's, in JAX's orientation
    centers, labels, _ = clustering.kmeans(y, 4, seed=0, device="cpu")
    jcenters, jlabels, _ = jax_clustering.kmeans(np.concatenate(jout), 4, seed=0)
    jcenters, jlabels = np.asarray(jcenters), np.asarray(jlabels)
    perm = ((centers[:, None, :] - jcenters[None, :, :]) ** 2).sum(-1).argmin(1)
    split = np.cumsum([len(s) for s in sequences])[:-1]
    dtrajs = np.split(labels.astype(np.int64), split)
    jdtrajs = np.split(jlabels.astype(np.int64), split)
    msm = estimation.build_msm(dtrajs, LAG, 4)
    jmsm = jax_estimation.build_msm(jdtrajs, LAG, 4)
    return dict(out=out, jout=jout, model=model, jmodel=jmodel, signs=signs, perm=perm,
                centers=centers, jcenters=jcenters, dtrajs=dtrajs, jdtrajs=jdtrajs,
                msm=msm, jmsm=jmsm)


def _permuted(M, perm):
    """JAX's matrix in the port's state order."""
    return M[np.ix_(perm, perm)]


def test_reduction_and_clustering_agree(chains):
    c = chains
    np.testing.assert_allclose(c["model"].eigenvalues, c["jmodel"].eigenvalues, atol=1e-5,
                               rtol=0)
    assert np.all(np.diff(c["model"].eigenvalues) <= 0) and np.all(
        np.abs(c["model"].eigenvalues) <= 1.0)
    for a, b in zip(c["out"], c["jout"]):
        assert np.abs(a * c["signs"] - b).max() <= 1e-4 * np.abs(b).max()
    assert sorted(c["perm"].tolist()) == [0, 1, 2, 3]
    np.testing.assert_allclose(c["centers"], c["jcenters"][c["perm"]], atol=1e-4)
    for d, jd in zip(c["dtrajs"], c["jdtrajs"]):
        np.testing.assert_array_equal(c["perm"][d], jd)


def test_jax_model_carried_into_the_port_transforms_alike(chains, sequences):
    jmodel = chains["jmodel"]
    carried = reduction.ReductionModel(**{f.name: getattr(jmodel, f.name)
                                          for f in dataclasses.fields(jmodel)})
    for s in sequences:
        np.testing.assert_allclose(carried.transform(s), jmodel.transform(s), atol=1e-6, rtol=0)
        np.testing.assert_allclose(carried(s) * chains["signs"], chains["model"](s),
                                   atol=1e-4 * np.abs(carried(s)).max(), rtol=0)


def test_msm_agrees_after_relabeling(chains):
    msm, jmsm, perm = chains["msm"], chains["jmsm"], chains["perm"]
    np.testing.assert_array_equal(msm.counts, _permuted(jmsm.counts, perm))
    np.testing.assert_allclose(msm.transition_matrix,
                               _permuted(jmsm.transition_matrix, perm), atol=1e-10, rtol=0)
    np.testing.assert_allclose(msm.stationary_distribution,
                               jmsm.stationary_distribution[perm], atol=1e-10, rtol=0)
    np.testing.assert_allclose(msm.transition_matrix.sum(1), 1.0, atol=1e-12)


def test_implied_timescales_agree(chains):
    """The ladder and the deterministic fill agree; the posterior medians of
    each package lie inside the other's 95% band, for both posteriors."""
    for reversible, n_samples in ((False, 100), (True, 48)):
        kw = dict(lags=[1, 2, 4, 8], n_timescales=2, n_samples=n_samples,
                  reversible=reversible, seed=0)
        res = its.compute_implied_timescales(chains["dtrajs"], device="cpu", **kw)
        ref = jax_its.compute_implied_timescales(chains["jdtrajs"], **kw)
        np.testing.assert_array_equal(res.lags, ref.lags)
        assert np.isfinite(res.timescales).all() and (res.timescales > 0).all()
        assert (res.ci_lower <= res.timescales).all() and (res.timescales <= res.ci_upper).all()
        assert (ref.ci_lower <= res.timescales).all() and (res.timescales <= ref.ci_upper).all()
        assert (res.ci_lower <= ref.timescales).all() and (ref.timescales <= res.ci_upper).all()


def test_ck_agrees_after_relabeling(chains):
    perm = chains["perm"]
    res = ck.ck_test(chains["dtrajs"], LAG, factors=(2, 3))
    ref = jax_ck.ck_test(chains["jdtrajs"], LAG, factors=(2, 3))
    assert not res.insufficient_data and set(res.rms) == set(ref.rms) == {2, 3}
    order = np.argsort(perm[res.states])         # the port's states in JAX's order
    np.testing.assert_array_equal(perm[res.states][order], ref.states)
    for k in (2, 3):
        for name in ("predicted", "estimated"):
            a = getattr(res, name)[k][np.ix_(order, order)]
            np.testing.assert_allclose(a, getattr(ref, name)[k], atol=1e-10, rtol=0)
        assert abs(res.rms[k] - ref.rms[k]) <= 1e-10


def test_pcca_and_tpt_agree_after_relabeling(chains):
    msm, jmsm, perm = chains["msm"], chains["jmsm"], chains["perm"]
    chi = pcca.pcca_memberships(msm.transition_matrix, 2)
    jchi = jax_pcca.pcca_memberships(jmsm.transition_matrix, 2)
    np.testing.assert_allclose(chi, jchi[perm], atol=1e-10, rtol=0)
    np.testing.assert_allclose(chi.sum(1), 1.0, atol=1e-8)
    crisp, jcrisp = chi.argmax(1), jchi.argmax(1)
    A, B = np.flatnonzero(crisp == 0), np.flatnonzero(crisp == 1)
    jA, jB = np.flatnonzero(jcrisp == 0), np.flatnonzero(jcrisp == 1)
    assert len(A) and len(B)
    np.testing.assert_array_equal(np.sort(perm[A]), jA)
    qp, qm = tpt.committors(msm.transition_matrix, A, B)
    jqp, jqm = jax_tpt.committors(jmsm.transition_matrix, jA, jB)
    np.testing.assert_allclose(qp, jqp[perm], atol=1e-10, rtol=0)
    np.testing.assert_allclose(qm, jqm[perm], atol=1e-10, rtol=0)
    r = tpt.reactive_flux(msm.transition_matrix, A, B)
    jr = jax_tpt.reactive_flux(jmsm.transition_matrix, jA, jB)
    np.testing.assert_allclose(r.net_flux, _permuted(jr.net_flux, perm), atol=1e-10, rtol=0)
    for name in ("total_flux", "rate", "mfpt"):
        assert abs(getattr(r, name) - getattr(jr, name)) <= 1e-10 * max(1.0, getattr(jr, name))
    assert abs(r.net_flux[A, :].sum() - r.net_flux[:, B].sum()) <= 1e-8 * r.total_flux
