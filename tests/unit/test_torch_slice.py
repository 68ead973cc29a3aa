"""The port's main path end to end on the CPU at a small size: 4-replica
alanine GBn2 REMD (400 steps) -> phi/psi -> MSM -> FES, with the same frames
run through the JAX package's MSM stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmarlo_tpu.analysis.discretize import discretize_dataset as jax_discretize
from pmarlo_tpu.md.forces import dihedral_angles as jax_dihedral_angles
from pmarlo_tpu.msm.clustering import assign_to_centers as jax_assign
from pmarlo_tpu.msm.counting import counts_from_dtrajs as jax_counts
from pmarlo_tpu.msm.free_energy import generate_2d_fes as jax_fes
from pmarlo_tpu_torch.analysis.discretize import discretize_dataset
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import dihedral_angles
from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def slice_run():
    torch.set_num_threads(2)
    system, positions = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    cfg = RemdConfig(n_replicas=4, t_min=300.0, t_max=450.0, exchange_frequency=100,
                     report_interval=10, seed=0)
    res = ReplicaExchange(system, positions, cfg, device="cpu").run(400)
    ai = system.atom_index
    quads = np.asarray([
        [ai(1, "C"), ai(2, "N"), ai(2, "CA"), ai(2, "C")],    # phi
        [ai(2, "N"), ai(2, "CA"), ai(2, "C"), ai(3, "N")],    # psi
    ])
    return system, res, quads


def test_remd_frames_are_finite_and_rung_major(slice_run):
    _, res, _ = slice_run
    assert res.positions.shape == (40, 4, 22, 3)
    assert np.isfinite(res.positions).all() and np.isfinite(res.potential_energy).all()
    # hotter rungs sit higher in potential energy on average
    mean_e = res.potential_energy.mean(0)
    assert mean_e[-1] > mean_e[0]


def test_slice_phi_psi_msm_fes_match_jax(slice_run):
    _, res, quads = slice_run
    frames = res.positions                                  # (F, R, N, 3)
    ang = dihedral_angles(torch.from_numpy(frames), torch.from_numpy(quads)).numpy()
    jang = np.stack([
        np.asarray(jax_dihedral_angles(jnp.asarray(frames[f, r]), jnp.asarray(quads)))
        for f in range(frames.shape[0]) for r in range(4)
    ]).reshape(ang.shape)
    np.testing.assert_allclose(ang, jang, atol=1e-5, rtol=0)   # rad, float32

    shards = []
    for r in range(4):
        a = ang[:, r]
        X = np.concatenate([np.cos(a), np.sin(a)], axis=1).astype(np.float32)
        shards.append({"features": X, "metadata": {"stride": 1}})

    # main path: k-means. The same features assigned to the port's centers
    # by the JAX stack give identical dtrajs, counts and transition matrix.
    msm = discretize_dataset(shards, n_states=6, lag=1, seed=0)
    jd = [jax_assign(s["features"], msm.centers).astype(np.int64) for s in shards]
    for a, b in zip(jd, msm.dtrajs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jax_counts(jd, 1, msm.n_states), msm.counts)
    np.testing.assert_allclose(msm.transition_matrix.sum(1), 1.0, atol=1e-12)

    # deterministic grid route through both stacks: identical dtrajs and T
    jg = jax_discretize(shards, n_states=16, lag=1, method="grid")
    tg = discretize_dataset(shards, n_states=16, lag=1, method="grid")
    for a, b in zip(jg.dtrajs, tg.dtrajs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tg.transition_matrix, jg.transition_matrix, atol=1e-6)

    phi, psi = ang[..., 0].ravel(), ang[..., 1].ravel()
    fes = generate_2d_fes(phi, psi, temperature_K=300.0, bins=16, periodic=(True, True))
    jfes = jax_fes(phi, psi, temperature_K=300.0, bins=16, periodic=(True, True))
    assert np.isfinite(fes.free_energy).any()
    np.testing.assert_array_equal(fes.counts, jfes.counts)
    np.testing.assert_allclose(fes.free_energy, jfes.free_energy, equal_nan=True)
