"""Port parity for ``pmarlo_tpu_torch.remd.remd`` and ``md.minimize``:
swap decisions with injected energies and uniforms, FIRE, and the run
bookkeeping (frames, identities, i16 frames)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
from pmarlo_tpu.md.forcefield import build_system as jax_build_system
from pmarlo_tpu.md.integrate import MDState as JaxMDState
from pmarlo_tpu.md.minimize import minimize_energy as jax_minimize_energy
from pmarlo_tpu.remd.remd import RemdConfig as JaxRemdConfig
from pmarlo_tpu.remd.remd import ReplicaExchange as JaxReplicaExchange
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.forces import potential_energy
from pmarlo_tpu_torch.md.integrate import MDState
from pmarlo_tpu_torch.md.minimize import minimize_energy
from pmarlo_tpu_torch.remd.remd import (
    RemdConfig,
    RemdResult,
    ReplicaExchange,
    run_replica_exchange,
)

R = 6


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def systems():
    js, jx = jax_build_system(jax_alanine(), gb_model="gbn2")
    ts, tx = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    return js, jx, ts, tx


@pytest.mark.parametrize("parity", [0, 1])
def test_attempt_swaps_match_jax(systems, parity):
    """Same energies, identities, configurations and uniforms
    (``jax.random.uniform(key, (R,))``, as the JAX swap draws them):
    identical accept flags, identities, positions and velocities."""
    js, jx, ts, tx = systems
    kw = dict(n_replicas=R, t_min=300.0, t_max=450.0, seed=0)
    jremd = JaxReplicaExchange(js, jx, JaxRemdConfig(**kw), minimize=False)
    tremd = ReplicaExchange(ts, tx, RemdConfig(**kw), device="cpu", minimize=False)
    rng = np.random.default_rng(11 + parity)
    pos = rng.normal(0.0, 1.0, (R, 22, 3)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (R, 22, 3)).astype(np.float32)
    # spreads of ~100 kJ/mol against beta gaps of ~0.03 mol/kJ: a mix of
    # accepted and rejected pairs
    energies = rng.normal(-100.0, 60.0, R).astype(np.float32)
    ids = rng.permutation(R).astype(np.int32)
    key = jax.random.PRNGKey(100 + parity)
    u = np.array(jax.random.uniform(key, (R,)))

    jstate = JaxMDState(positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
                        key=jax.random.split(key, R), step=jnp.zeros(R, jnp.int32))
    js_new, jids, jacc = jremd._attempt_swaps(
        jstate, jnp.asarray(energies), jnp.asarray(ids), jnp.asarray(parity), key)
    tstate = MDState(positions=torch.from_numpy(pos), velocities=torch.from_numpy(vel),
                     seeds=torch.arange(R, dtype=torch.int32), step=0)
    ts_new, tids, tacc = tremd._attempt_swaps(
        tstate, torch.from_numpy(energies), torch.from_numpy(ids), parity,
        torch.from_numpy(u))

    np.testing.assert_array_equal(np.asarray(jacc), tacc.numpy())  # NaN-aware
    assert np.nansum(tacc.numpy()) >= 1, "expected at least one accepted swap"
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_array_equal(np.asarray(js_new.positions), ts_new.positions.numpy())
    # velocities: the same float32 sqrt(T_self / T_source) rescale
    np.testing.assert_allclose(ts_new.velocities.numpy(), np.asarray(js_new.velocities),
                               rtol=1e-6, atol=0)


def test_minimize_energy_matches_jax(systems):
    """50 FIRE iterations from the crystal geometry: positions to 1e-4 nm
    and the final energy to 1e-4 relative (float32 rounding grown over the
    iterations)."""
    js, jx, ts, tx = systems
    jxm, je = jax_minimize_energy(js, jx, max_iterations=50)
    txm, te = minimize_energy(ts, tx, max_iterations=50)
    np.testing.assert_allclose(txm.numpy(), np.asarray(jxm), atol=1e-4, rtol=0)
    assert abs(float(te) - float(je)) <= 1e-4 * abs(float(je))
    assert float(te) < float(potential_energy(ts, tx))


def test_run_records_frames_identities_and_i16(systems):
    _, _, ts, tx = systems
    kw = dict(n_replicas=4, t_min=300.0, t_max=450.0, exchange_frequency=100,
              report_interval=50, seed=3)
    res = ReplicaExchange(ts, tx, RemdConfig(**kw), device="cpu", minimize=False).run(200)
    assert isinstance(res, RemdResult)
    assert res.positions.shape == (4, 4, 22, 3)
    assert res.potential_energy.shape == (4, 4)
    assert res.replica_ids.shape == (3, 4)
    assert res.exchange_attempts == 2 and res.frames_per_attempt == 2
    assert np.isfinite(res.positions).all() and np.isfinite(res.potential_energy).all()
    for row in res.replica_ids:
        assert sorted(row.tolist()) == [0, 1, 2, 3]
    assert res.acceptance_matrix.shape == (3,)
    # the walker view is a permutation of the rung view
    walker = res.replica_trajectory(0)
    assert walker.shape == (4, 22, 3)
    # i16 frames: the same trajectory quantized to 1e-3 nm on the device
    res16 = ReplicaExchange(
        ts, tx, RemdConfig(frame_precision="i16", **kw), device="cpu", minimize=False
    ).run(200)
    expected = np.round(res.positions.astype(np.float32) * 1000.0) / 1000.0
    np.testing.assert_array_equal(res16.positions, expected.astype(np.float32))
    np.testing.assert_array_equal(res16.replica_ids, res.replica_ids)


def test_second_run_continues_state_and_noise(systems):
    _, _, ts, tx = systems
    kw = dict(n_replicas=2, t_min=300.0, t_max=350.0, exchange_frequency=20,
              report_interval=20, seed=5)
    remd = ReplicaExchange(ts, tx, RemdConfig(**kw), device="cpu", minimize=False)
    first = remd.run(40)
    assert remd.state.step == 40
    second = remd.run(40)
    assert remd.state.step == 80
    assert not np.array_equal(first.positions[-1], second.positions[0])
    np.testing.assert_array_equal(second.replica_ids[0], first.replica_ids[-1])


def test_unported_options_raise(systems):
    _, _, ts, tx = systems
    with pytest.raises(ValueError, match="CUDA"):
        ReplicaExchange(ts, tx, RemdConfig(n_replicas=2), device="cpu",
                        use_kernel=True, minimize=False)
    for kwargs, item in ((dict(bias_fn=lambda x: 0.0), "A9"),
                         (dict(mesh=object()), "A13"),
                         (dict(target_acceptance=0.3), "A11"),
                         (dict(constraints="hbonds"), "A11")):
        with pytest.raises(NotImplementedError, match=item):
            run_replica_exchange(alanine_dipeptide_structure(), n_steps=100, **kwargs)
    with pytest.raises(ValueError, match="report_interval"):
        RemdConfig(exchange_frequency=100, report_interval=30)
