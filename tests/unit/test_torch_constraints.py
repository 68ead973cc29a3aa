"""SHAKE/RATTLE and the constrained integrator
(``pmarlo_tpu_torch/md/constraints.py``, ``md/integrate.py``) against the
JAX package: the H-bond constraint set, one SHAKE and one RATTLE
projection, the stripped bonded terms, and 20 constrained steps through
the pair force path (``run_md`` on both sides), plus the port's
``thermalize`` and its harmonic-oscillator statistics.

JAX runs on the CPU with ``build_h_constraints(layout="onehot")`` and
``build_pair_force_fn(tile=128, interpret=True)``; inputs are made with
numpy from a seed.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.md.constraints import (
    ConstraintSpec,
    build_h_constraints,
    constraint_violation,
    n_constraints,
    rattle,
    shake,
    strip_constrained_bonded,
)
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.integrate import MDState, langevin_step, run_md, thermalize
from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn
from pmarlo_tpu_torch.md.system import system_from_numpy


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def chignolin():
    """JAX system, positions and one-hot constraint spec of chignolin (138
    atoms), and the port's system built from the JAX arrays."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.constraints import build_h_constraints as jax_constraints
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s = chignolin_structure()
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    js, jx = jax_build_system(PDBStructure(residues=residues), gb_model="gbn2")
    jspec = jax_constraints(js, layout="onehot")
    return js, np.array(jx), jspec, system_from_numpy(js.to_dict())


def test_h_constraints_match_jax(chignolin):
    js, _, jspec, ts = chignolin
    spec = build_h_constraints(ts)
    ref = ConstraintSpec.from_numpy(jspec)
    assert spec.n_constraints == n_constraints(spec) == ref.n_constraints == 61
    assert torch.equal(spec.idx1, ref.idx1) and torch.equal(spec.idx2, ref.idx2)
    for name in ("d0", "inv_m1", "inv_m2", "inv_mass_sum"):
        torch.testing.assert_close(getattr(spec, name), getattr(ref, name),
                                   rtol=1e-6, atol=0)
    assert spec.n_iter == ref.n_iter == 30


def test_shake_and_rattle_match_jax(chignolin):
    """One SHAKE of positions pushed 0.01 nm off the manifold and one
    RATTLE of random velocities: to 1e-6 nm (nm/ps) of JAX's, batched over
    three replicas on the port's side."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import constraint_violation as jax_violation
    from pmarlo_tpu.md.constraints import rattle as jax_rattle
    from pmarlo_tpu.md.constraints import shake as jax_shake

    _, jx, jspec, ts = chignolin
    spec = ConstraintSpec.from_numpy(jspec)
    rng = np.random.default_rng(0)
    x_new = (jx[None] + rng.normal(0.0, 0.01, (3,) + jx.shape)).astype(np.float32)
    v = rng.normal(0.0, 1.0, (3,) + jx.shape).astype(np.float32)
    xs = shake(spec, torch.from_numpy(x_new), torch.from_numpy(jx))
    vs = rattle(spec, torch.from_numpy(v), xs)
    for r in range(3):
        jxs = jax_shake(jspec, jnp.asarray(x_new[r]), jnp.asarray(jx))
        jvs = jax_rattle(jspec, jnp.asarray(v[r]), jxs)
        np.testing.assert_allclose(xs[r].numpy(), np.asarray(jxs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(vs[r].numpy(), np.asarray(jvs), rtol=0, atol=1e-6)
        assert abs(float(constraint_violation(spec, xs[r]))
                   - float(jax_violation(jspec, jxs))) <= 1e-6
    assert float(constraint_violation(spec, xs)) <= 1e-5
    assert float(constraint_violation(spec, torch.from_numpy(x_new))) > 1e-3


def test_strip_constrained_bonded_equals_jax(chignolin):
    from pmarlo_tpu.md.constraints import strip_constrained_bonded as jax_strip

    js, _, _, ts = chignolin
    ours, theirs = strip_constrained_bonded(ts), jax_strip(js)
    assert ours.bond_idx.shape[0] < ts.bond_idx.shape[0]
    for name in ("bond_idx", "bond_k", "bond_r0", "angle_idx", "angle_k", "angle_t0"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)


def test_constrained_pair_path_run_md_matches_jax(chignolin):
    """20 steps of constrained ``langevin_step`` at friction 0, 4 fs,
    through each package's pair force path on the stripped system
    (``run_md``, two frames): positions to 1e-4 nm, frame energies to
    1e-5 relative, kinetic temperatures to 1e-3 relative."""
    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.constraints import strip_constrained_bonded as jax_strip
    from pmarlo_tpu.md.integrate import MDState as JaxMDState
    from pmarlo_tpu.md.integrate import run_md as jax_run_md
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx, jspec, ts = chignolin
    rng = np.random.default_rng(1)
    m = ts.masses.numpy()
    v0 = (np.sqrt(BOLTZMANN_CONSTANT_KJ_PER_MOL * 300.0 / m)[:, None]
          * rng.standard_normal(jx.shape)).astype(np.float32)
    kw = dict(n_steps=20, dt=0.004, friction=0.0, temperature_K=300.0,
              report_interval=10)

    jfn = jax_pair(jax_strip(js), tile=128, interpret=True)
    jstate = JaxMDState(positions=jnp.asarray(jx), velocities=jnp.asarray(v0),
                        key=jax.random.PRNGKey(0), step=jnp.asarray(0, jnp.int32))
    jfinal, jframes = jax_run_md(js, jstate, force_fn=jfn, constraints=jspec, **kw)

    spec = build_h_constraints(ts)
    fn = build_pair_force_fn(strip_constrained_bonded(ts))
    state = MDState(positions=torch.from_numpy(jx), velocities=torch.from_numpy(v0),
                    seeds=torch.tensor(0, dtype=torch.int32), step=0)
    final, frames = run_md(ts, state, force_fn=fn, constraints=spec, **kw)

    assert final.step == 20 and frames["positions"].shape == (2,) + jx.shape
    np.testing.assert_allclose(final.positions.numpy(), np.asarray(jfinal.positions),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(frames["positions"].numpy(),
                               np.asarray(jframes["positions"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(frames["potential_energy"].numpy(),
                               np.asarray(jframes["potential_energy"]), rtol=1e-5)
    np.testing.assert_allclose(frames["temperature"].numpy(),
                               np.asarray(jframes["temperature"]), rtol=1e-3)
    assert float(constraint_violation(spec, final.positions)) <= 1e-5


def test_thermalize_draws_com_free_velocities_and_seeds():
    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    gen = torch.Generator().manual_seed(0)
    one = thermalize(system, pos, gen, 300.0)
    assert one.velocities.shape == pos.shape and one.seeds.shape == () and one.step == 0
    temps = torch.tensor([300.0, 350.0, 400.0])
    many = thermalize(system, pos[None].expand(3, -1, -1), gen, temps)
    assert many.velocities.shape == (3,) + tuple(pos.shape) and many.seeds.shape == (3,)
    p = (system.masses[:, None] * many.velocities).sum(-2)
    assert float(p.abs().max()) < 1e-4
    # one step runs on the thermalized batch at per-replica temperatures
    state, e = langevin_step(system, many, dt=0.002, friction=1.0, temperature_K=temps)
    assert e.shape == (3,) and state.step == 1


def test_harmonic_oscillator_statistics():
    """Folded BAOAB with the full-dt kick samples <x^2> = kT/k and
    <v^2> = kT/m (a half kick would give twice the variance); 1,024 wells
    for 2,500 steps, to 5%."""
    k_spring, mass, temperature = 100.0, 10.0, 300.0
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temperature
    n = 1024
    system = SimpleNamespace(masses=torch.full((n,), mass), n_atoms=n, vsite_idx=None)
    state = MDState(positions=torch.zeros(n, 3), velocities=torch.zeros(n, 3),
                    seeds=torch.tensor(7, dtype=torch.int32), step=0)

    def force_fn(x):
        return 0.5 * k_spring * (x * x).sum(), -k_spring * x

    xs, vs = [], []
    for step in range(2_500):
        state, _ = langevin_step(system, state, dt=0.002, friction=5.0,
                                 temperature_K=temperature, force_fn=force_fn)
        if step >= 500:
            xs.append(state.positions)
            vs.append(state.velocities)
    var_x = float(torch.stack(xs).pow(2).mean())
    var_v = float(torch.stack(vs).pow(2).mean())
    assert math.isclose(var_x, kT / k_spring, rel_tol=0.05)
    assert math.isclose(var_v, kT / mass, rel_tol=0.05)


def test_water_constraints_are_explicit_solvent():
    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    wet = dataclasses.replace(system, residue_names=("HOH",) + system.residue_names[1:])
    # a residue that is called water but is not an (O, H1, H2) block
    with pytest.raises(ValueError, match="contiguous"):
        build_h_constraints(wet)
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md.constraints import CompositeConstraintSpec

    structure, box = water_box_structure(2, spacing=0.5, margin=0.0)
    wsys, _ = build_system(structure, box=box, cutoff=0.45)
    spec = build_h_constraints(wsys)
    assert isinstance(spec, CompositeConstraintSpec) and spec.protein is None
    assert spec.n_constraints == 3 * 8
