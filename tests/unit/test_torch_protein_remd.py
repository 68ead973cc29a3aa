"""The protein-scale REMD slice on the CPU (``pmarlo_tpu_torch/md/setup.py``,
``remd/remd.py`` with ``force_fn`` and ``constraints``): 276-atom chignolin
pair through the pair path with H-bond SHAKE/RATTLE at 4 fs, swap decisions
against JAX's for injected energies and uniforms, the setup recipe, and
the i16 frame path's poisoning of non-finite coordinates."""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
from pmarlo_tpu_torch.md.analytic import energy_and_forces, make_dense_params
from pmarlo_tpu_torch.md.constraints import build_h_constraints, constraint_violation
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.integrate import MDState
from pmarlo_tpu_torch.md.minimize import minimize_energy
from pmarlo_tpu_torch.md.pair_force import PairForce
from pmarlo_tpu_torch.md.setup import (
    build_explicit_setup,
    build_implicit_setup,
    is_explicit_solvent,
)
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange, run_replica_exchange

PROTEIN = dict(n_replicas=4, t_min=300.0, t_max=330.0, exchange_frequency=100,
               report_interval=50, dt_ps=0.004, seed=0)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair_setup():
    torch.set_num_threads(2)
    return build_implicit_setup(chignolin_assembly((2, 1, 1)), constraints="hbonds",
                                force_path="pair_kernel")


def test_setup_recipe(pair_setup):
    """The pair path builds no (N, N) tables, constrains every X-H bond,
    strips their bond terms from the MD system and minimizes through the
    full system; the auto rule keeps the dense path on the CPU."""
    st = pair_setup
    assert st.force_path == "pair_kernel" and st.system.n_atoms == 276
    assert st.system.scale_elec is None and st.system.gb_neck_d0 is None
    assert isinstance(st.force_fn, PairForce) and isinstance(st.minimize_force_fn, PairForce)
    assert st.force_fn.system is st.md_system and st.minimize_force_fn.system is st.system
    n_h = st.constraints.n_constraints
    assert st.md_system.bond_idx.shape[0] == st.system.bond_idx.shape[0] - n_h
    auto = build_implicit_setup(chignolin_assembly((2, 1, 1)))
    assert auto.force_path == "dense" and auto.force_fn is None and auto.constraints is None
    assert auto.system.scale_elec is not None
    assert not is_explicit_solvent(chignolin_assembly((2, 1, 1)))
    with pytest.raises(NotImplementedError, match="A12"):
        build_explicit_setup(chignolin_assembly((2, 1, 1)), nonbonded="pme")
    with pytest.raises(NotImplementedError, match="A12"):
        build_explicit_setup(chignolin_assembly((2, 1, 1)), pme_precise=True)


def test_small_protein_slice_runs_constrained_at_4_fs(pair_setup):
    """4 replicas, 200 steps of 4 fs, every X-H bond constrained, through
    the pair path's twins: frames finite and on the constraint manifold,
    swaps attempted, the kinetic temperature counted without the
    constrained degrees of freedom."""
    st = pair_setup
    x, _ = minimize_energy(st.system, st.positions, force_fn=st.minimize_force_fn,
                           max_iterations=100)
    remd = ReplicaExchange(st.system, x, RemdConfig(**PROTEIN), device="cpu",
                           force_fn=st.force_fn, constraints=st.constraints,
                           minimize=False)
    res = remd.run(200)
    assert res.positions.shape == (4, 4, 276, 3)
    assert np.isfinite(res.positions).all() and np.isfinite(res.potential_energy).all()
    frames = torch.from_numpy(res.positions)
    assert float(constraint_violation(st.constraints, frames)) <= 1e-4
    assert res.exchange_attempts == 2 and res.acceptance_matrix.shape == (3,)
    for row in res.replica_ids:
        assert sorted(row.tolist()) == [0, 1, 2, 3]
    ratio = res.kinetic_temperature / res.temperatures[None]
    assert np.isfinite(ratio).all() and 0.5 < float(ratio.mean()) < 1.5
    # the swap energies are the force fn's at the recorded positions
    e_last, _ = st.force_fn(frames[-1])
    np.testing.assert_allclose(res.potential_energy[-1], e_last.numpy(), rtol=1e-5)


@pytest.mark.parametrize("parity", [0, 1])
def test_protein_path_swaps_match_jax(pair_setup, parity):
    """The constrained pair-path driver's swaps against JAX's
    ``_attempt_swaps`` on the same energies, identities, configurations and
    uniforms: identical decisions, identities and positions."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.integrate import MDState as JaxMDState
    from pmarlo_tpu.remd.remd import RemdConfig as JaxRemdConfig
    from pmarlo_tpu.remd.remd import ReplicaExchange as JaxReplicaExchange
    from pmarlo_tpu_torch.md.system import System

    st = pair_setup
    R, n = 4, 276
    js_np = {f.name: getattr(st.system, f.name) for f in dataclasses.fields(System)}
    jsys = _jax_system_from_port(js_np)
    kw = {k: v for k, v in PROTEIN.items()}
    jremd = JaxReplicaExchange(jsys, jnp.asarray(st.positions.numpy()), JaxRemdConfig(**kw),
                               force_fn=lambda x: (jnp.zeros(()), jnp.zeros_like(x)),
                               minimize=False)
    tremd = ReplicaExchange(st.system, st.positions, RemdConfig(**kw), device="cpu",
                            force_fn=st.force_fn, constraints=st.constraints,
                            minimize=False)
    rng = np.random.default_rng(21 + parity)
    pos = rng.normal(0.0, 1.0, (R, n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (R, n, 3)).astype(np.float32)
    # protein-scale energies: thousands of kJ/mol, gaps of a few hundred
    energies = rng.normal(-20_000.0, 150.0, R).astype(np.float32)
    ids = rng.permutation(R).astype(np.int32)
    key = jax.random.PRNGKey(200 + parity)
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
    np.testing.assert_array_equal(np.asarray(jacc), tacc.numpy())
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_array_equal(np.asarray(js_new.positions), ts_new.positions.numpy())
    np.testing.assert_allclose(ts_new.velocities.numpy(), np.asarray(js_new.velocities),
                               rtol=1e-6, atol=0)


def _jax_system_from_port(fields):
    """A JAX ``System`` with the port system's arrays."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.system import System as JaxSystem

    kw = {}
    for k, v in fields.items():
        kw[k] = jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
    return JaxSystem(**kw)


def test_i16_frames_poison_non_finite_coordinates():
    """A replica whose positions turn NaN records INT16_MIN (-32.768 nm)
    in i16 frames instead of an implementation-defined cast; the other
    replicas keep their quantized coordinates."""
    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    dense = make_dense_params(system)

    def poisoned(x):
        e, f = energy_and_forces(dense, x)
        f = f.clone()
        f[0] = float("nan")
        e = e.clone()
        e[0] = float("nan")
        return e, f

    kw = dict(n_replicas=3, t_min=300.0, t_max=350.0, exchange_frequency=20,
              report_interval=10, seed=1)
    res = ReplicaExchange(system, pos, RemdConfig(frame_precision="i16", **kw),
                          device="cpu", force_fn=poisoned, minimize=False).run(40)
    assert (res.positions[:, 0] == np.float32(-32.768)).all()
    assert np.isfinite(res.positions).all()
    rest = res.positions[:, 1:]
    assert (np.abs(rest) < 5.0).all()
    np.testing.assert_array_equal(rest, np.round(rest * 1000.0) / 1000.0)


def test_run_replica_exchange_constrains_the_dense_path():
    """``constraints="hbonds"`` through the one-call entry point on a small
    system: the dense path under SHAKE/RATTLE (4 fs), and the fused chunk
    refusing constraints."""
    cfg = RemdConfig(n_replicas=2, t_min=300.0, t_max=330.0, exchange_frequency=50,
                     report_interval=25, dt_ps=0.004, seed=2)
    res, system = run_replica_exchange(alanine_dipeptide_structure(), n_steps=100,
                                       config=cfg, constraints="hbonds")
    spec = build_h_constraints(system)
    assert np.isfinite(res.positions).all()
    assert float(constraint_violation(spec, torch.from_numpy(res.positions))) <= 1e-4
    with pytest.raises(ValueError, match="does not SHAKE"):
        ReplicaExchange(system, torch.zeros(22, 3), cfg, device="cpu", use_kernel=True,
                        constraints=spec, minimize=False)
    with pytest.raises(ValueError, match="constraints must be"):
        run_replica_exchange(alanine_dipeptide_structure(), constraints="allbonds")
