"""Acceptance-targeted temperature ladders (``pmarlo_tpu_torch/remd/ladder.py``)
against the JAX package, and ``run_replica_exchange(target_acceptance=)``
end to end at a CPU size."""

import math

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md.analytic import energy_and_forces, make_dense_params
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.remd.ladder import (
    LadderProbe,
    predicted_acceptance,
    probe_energy_statistics,
    suggest_temperature_ladder,
)
from pmarlo_tpu_torch.remd.remd import RemdConfig, run_replica_exchange

#: injected probe statistics: E(T) and sigma_E(T) of a small protein
PROBE = dict(
    temperatures=np.array([300.0, 320.0, 341.0, 363.0]),
    e_mean=np.array([-5200.0, -4950.0, -4690.0, -4420.0]),
    e_std=np.array([52.0, 55.5, 59.0, 63.0]),
)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_predicted_acceptance_equals_jax():
    from pmarlo_tpu.remd.ladder import predicted_acceptance as jax_predicted

    def mean(T):
        return -5000.0 + 12.5 * (T - 300.0)

    def std(T):
        return 40.0 + 0.1 * (T - 300.0)

    for T1, T2 in ((300.0, 301.0), (300.0, 305.0), (310.0, 330.0), (300.0, 450.0)):
        ours = predicted_acceptance(T1, T2, mean, std)
        assert ours == jax_predicted(T1, T2, mean, std)
        assert 0.0 <= ours <= 1.0
    assert predicted_acceptance(300.0, 300.0, mean, lambda T: 0.0) == 1.0


@pytest.mark.parametrize("target", [0.2, 0.3, 0.5])
def test_ladder_from_injected_probe_equals_jax(target):
    """The same probe statistics give the same rungs and predicted
    acceptances, to the last bit."""
    from pmarlo_tpu.remd.ladder import LadderProbe as JaxProbe
    from pmarlo_tpu.remd.ladder import suggest_temperature_ladder as jax_ladder

    ours, pred = suggest_temperature_ladder(
        None, None, t_min=300.0, t_max=360.0, target_acceptance=target,
        probe=LadderProbe(**PROBE))
    theirs, jpred = jax_ladder(
        None, None, t_min=300.0, t_max=360.0, target_acceptance=target,
        probe=JaxProbe(**PROBE))
    np.testing.assert_array_equal(ours, theirs)
    assert pred == jpred
    assert ours[0] == 300.0 and ours[-1] == 360.0 and np.all(np.diff(ours) > 0)
    assert all(p >= target - 1e-9 for p in pred)
    with pytest.raises(ValueError, match="max_rungs"):
        suggest_temperature_ladder(None, None, t_min=300.0, t_max=360.0,
                                   target_acceptance=0.99, max_rungs=3,
                                   probe=LadderProbe(**PROBE))


def test_probe_statistics_are_measured_per_temperature():
    """The probes (one batched run) give rising mean energies with
    temperature, positive fluctuations and effective sample sizes."""
    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    dense = make_dense_params(system)
    probe = probe_energy_statistics(
        system, pos, [300.0, 400.0, 500.0], probe_steps=400, seed=1,
        force_fn=lambda x: energy_and_forces(dense, x), min_ess=5.0)
    assert probe.e_mean.shape == (3,) and np.all(probe.e_std > 0.0)
    assert probe.e_mean[0] < probe.e_mean[-1]
    assert probe.probe_steps_used >= 400 and np.all(probe.ess > 0.0)
    assert math.isclose(probe.mean_at(350.0), 0.5 * (probe.e_mean[0] + probe.e_mean[1]))


def test_run_replica_exchange_designs_its_ladder():
    """``target_acceptance`` probes the minimized structure, designs a
    ladder between the config's end temperatures and runs on it."""
    cfg = RemdConfig(n_replicas=2, t_min=300.0, t_max=420.0, exchange_frequency=50,
                     report_interval=25, seed=3)
    res, _ = run_replica_exchange(alanine_dipeptide_structure(), n_steps=100,
                                  config=cfg, target_acceptance=0.4)
    T = res.temperatures
    assert T[0] == pytest.approx(300.0) and T[-1] == pytest.approx(420.0)
    assert len(T) >= 2 and np.all(np.diff(T) > 0)
    assert res.positions.shape[1] == len(T)
    assert np.isfinite(res.positions).all()
