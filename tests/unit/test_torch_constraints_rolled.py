"""The roll layout of the X-H constraints (``RolledConstraintSpec``,
``shake_rolled``, ``rattle_rolled``, ``build_h_constraints(layout=)``)
against the JAX package's, and against the port's index layout, which
solves a rolled spec's constraints read off its masks.

Alanine and the 138-atom chignolin (GBn2), and alanine in 5^3 lattice
waters (a composite spec). Tolerances: one SHAKE projection from 0.003 nm
off the manifold to 1e-6 nm of JAX's, one RATTLE of velocities of order 1
nm/ps to 3e-6 nm/ps (as ``test_torch_water_constraints.py``), the two
layouts' constrained positions to 1e-6 nm of each other, and 10 friction-0
constrained steps to 1e-5 nm.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.data.water import water_box_structure
from pmarlo_tpu_torch.io.pdb import PDBStructure
from pmarlo_tpu_torch.md import constraints as TC
from pmarlo_tpu_torch.md.integrate import MDState, langevin_step
from pmarlo_tpu_torch.md.system import system_from_numpy

jax = pytest.importorskip("jax")
jnp = jax.numpy


def _solvated_alanine():
    """Alanine dipeptide in the middle of a 5^3 water lattice (waters
    within 0.28 nm of a solute atom left out), box 1.65 nm."""
    waters, box = water_box_structure(5)
    solute = alanine_dipeptide_structure()
    xyz = np.array([a.xyz for r in solute.residues for a in r.atoms])
    shift = 0.5 * box[0] - xyz.mean(0)
    for r in solute.residues:
        for a in r.atoms:
            a.xyz = tuple(float(v) for v in np.asarray(a.xyz) + shift)
    xyz = xyz + shift
    kept = [w for w in waters.residues
            if min(np.linalg.norm(xyz - np.asarray(a.xyz), axis=1).min()
                   for a in w.atoms) > 0.28]
    return PDBStructure(residues=solute.residues + kept, box=box)


CASES = {
    "alanine": alanine_dipeptide_structure,
    "chignolin": chignolin_structure,
    "solvated_alanine": _solvated_alanine,
}


@pytest.fixture(scope="module")
def systems():
    """JAX system and positions, the port's system from its fields."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue
    from pmarlo_tpu.io.pdb import PDBStructure as JaxStructure
    from pmarlo_tpu.md.forcefield import build_system

    cache = {}

    def get(name):
        if name not in cache:
            s = CASES[name]()
            js_struct = JaxStructure(residues=[PDBResidue(
                name=r.name, resid=r.resid, chain=r.chain, atoms=[PDBAtom(
                    name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                    xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues],
                box=s.box)
            if s.box is None:
                js, jx = build_system(js_struct, gb_model="gbn2")
            else:
                js, jx = build_system(js_struct, box=s.box, cutoff=0.6, hydrogen_mass=3.0)
            cache[name] = (js, np.array(jx, np.float32),
                           system_from_numpy(js.to_dict(), device="cpu"))
        return cache[name]

    return get


def _offsets(x, seed, sigma, reps=None):
    rng = np.random.default_rng(seed)
    shape = x.shape if reps is None else (reps,) + x.shape
    return (x + rng.normal(0.0, sigma, shape)).astype(np.float32)


@pytest.mark.parametrize("name", ["alanine", "chignolin"])
def test_rolled_spec_fields_match_jax(systems, name):
    from pmarlo_tpu.md.constraints import _build_rolled_spec as jax_build
    from pmarlo_tpu.md.constraints import build_h_constraints as jax_constraints

    js, _, ts = systems(name)
    jspec = jax_constraints(js, n_iter=24, layout="rolled")
    spec = TC.build_h_constraints(ts, n_iter=24, layout="rolled")
    assert isinstance(spec, TC.RolledConstraintSpec)

    def same(a, b):
        assert a.deltas == b.deltas and a.d_idx == b.d_idx and a.n_iter == b.n_iter == 24
        for field in ("mask", "d0", "inv_m1", "inv_m2", "inv_mass_sum"):
            got = getattr(a, field)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(b, field)), field)

    same(spec, jspec)
    # the copied function, held against its source on the same constraint list
    rng = np.random.default_rng(40)
    pairs = np.asarray(js.bond_idx)[rng.choice(len(js.bond_idx), 12, replace=False)]
    pairs = pairs.astype(np.int64)
    r0 = rng.uniform(0.09, 0.15, 12)
    masses = np.asarray(js.masses)
    same(TC._build_rolled_spec(pairs, r0, masses, 24, device="cpu"),
         jax_build(pairs, r0, masses, 24))
    assert TC.n_constraints(spec) == spec.n_constraints == int(np.asarray(jspec.mask).sum())


@pytest.mark.parametrize("name", ["alanine", "chignolin", "solvated_alanine"])
def test_rolled_spec_reads_the_index_layouts_constraints(systems, name):
    """The index form a rolled spec solves with holds the index layout's
    constraints: the same (i, j) pairs, each with its target and masses
    (to float32 rounding)."""
    _, _, ts = systems(name)
    rolled = TC.build_h_constraints(ts, layout="rolled")
    onehot = TC.build_h_constraints(ts, layout="onehot")
    if isinstance(rolled, TC.CompositeConstraintSpec):
        rolled, onehot = rolled.protein, onehot.protein

    def table(spec):
        return {(int(i), int(j)): (float(d), float(a), float(b), float(c))
                for i, j, d, a, b, c in zip(spec.idx1, spec.idx2, spec.d0, spec.inv_m1,
                                            spec.inv_m2, spec.inv_mass_sum)}

    got, want = table(rolled.indexed), table(onehot)
    assert len(got) == rolled.n_constraints == int(rolled.mask.sum())
    assert got.keys() == want.keys()
    for pair, values in got.items():
        # the roll layout takes 1/m of float32 masses, as JAX's does
        assert values == pytest.approx(want[pair], rel=1e-6), pair
    assert rolled.indexed.n_iter == rolled.n_iter


def test_rolled_spec_refuses_massless_atoms_and_unknown_layouts(systems):
    _, _, ts = systems("alanine")
    masses = ts.masses.numpy().astype(np.float64).copy()
    masses[1] = 0.0
    with pytest.raises(ValueError, match="massless"):
        TC._build_rolled_spec(np.asarray([[0, 1]]), np.asarray([0.1]), masses, 30, device="cpu")
    with pytest.raises(ValueError, match="unknown constraint layout"):
        TC.build_h_constraints(ts, layout="dense")


@pytest.mark.parametrize("name", ["alanine", "chignolin"])
def test_shake_and_rattle_rolled_match_jax(systems, name):
    """One SHAKE from 0.003 nm off the manifold and one RATTLE, batched
    over two replicas on the port's side, against JAX's (also through the
    ``shake`` / ``rattle`` / ``constraint_violation`` dispatch)."""
    from pmarlo_tpu.md import constraints as JC

    js, x, ts = systems(name)
    jspec = JC.build_h_constraints(js, layout="rolled")
    spec = TC.build_h_constraints(ts, layout="rolled")
    x_new = _offsets(x, 41, 0.003, reps=2)
    v = np.random.default_rng(42).normal(0.0, 1.0, (2,) + x.shape).astype(np.float32)
    xs = TC.shake_rolled(spec, torch.from_numpy(x_new), torch.from_numpy(x))
    assert torch.equal(xs, TC.shake(spec, torch.from_numpy(x_new), torch.from_numpy(x)))
    vs = TC.rattle_rolled(spec, torch.from_numpy(v), xs)
    assert torch.equal(vs, TC.rattle(spec, torch.from_numpy(v), xs))
    for r in range(2):
        jxs = JC.shake_rolled(jspec, jnp.asarray(x_new[r]), jnp.asarray(x))
        jvs = JC.rattle_rolled(jspec, jnp.asarray(v[r]), jnp.asarray(xs[r].numpy()))
        np.testing.assert_allclose(xs[r].numpy(), np.asarray(jxs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(vs[r].numpy(), np.asarray(jvs), rtol=0, atol=3e-6)
        dev = float(TC.constraint_violation(spec, xs[r]))
        assert dev == pytest.approx(float(JC.constraint_violation(jspec, jnp.asarray(xs[r].numpy()))),
                                    abs=1e-7)
    assert float(TC.constraint_violation(spec, xs)) <= 1e-5
    assert float(TC.constraint_violation(spec, torch.from_numpy(x_new))) > 1e-3


@pytest.mark.parametrize("name", ["alanine", "chignolin", "solvated_alanine"])
def test_the_two_layouts_give_the_same_constrained_positions(systems, name):
    """The port's default index layout (``"onehot"``) and JAX's default
    roll layout project onto the same manifold: SHAKE and RATTLE agree to
    float32 rounding, and so do 10 constrained friction-0 steps."""
    js, x, ts = systems(name)
    indexed = TC.build_h_constraints(ts)
    onehot = TC.build_h_constraints(ts, layout="onehot")
    assert type(onehot) is type(indexed) and not isinstance(indexed, TC.RolledConstraintSpec)
    xs = torch.from_numpy(x)
    assert torch.equal(TC.shake(onehot, xs + 0.01, xs), TC.shake(indexed, xs + 0.01, xs))
    rolled = TC.build_h_constraints(ts, layout="rolled")
    assert TC.n_constraints(rolled) == TC.n_constraints(indexed)
    x_new = torch.from_numpy(_offsets(x, 43, 0.003))
    a = TC.shake(indexed, x_new, torch.from_numpy(x))
    b = TC.shake(rolled, x_new, torch.from_numpy(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    v = torch.from_numpy(np.random.default_rng(44).normal(0.0, 1.0, x.shape).astype(np.float32))
    np.testing.assert_allclose(TC.rattle(indexed, v, a).numpy(), TC.rattle(rolled, v, a).numpy(),
                               rtol=0, atol=3e-6)
    if ts.box is not None:
        return
    from pmarlo_tpu_torch.md.integrate import make_force_fn

    force_fn = make_force_fn(TC.strip_constrained_bonded(ts))
    x0 = TC.shake(indexed, torch.from_numpy(x), torch.from_numpy(x))
    v0 = TC.rattle(indexed, 0.3 * v, x0)
    states = {}
    for layout, spec in (("onehot", indexed), ("rolled", rolled)):
        st = MDState(positions=x0, velocities=v0, seeds=torch.zeros((), dtype=torch.int32))
        for _ in range(10):
            st, _ = langevin_step(ts, st, dt=0.002, friction=0.0, temperature_K=300.0,
                                  force_fn=force_fn, constraints=spec)
        states[layout] = st
        assert float(TC.constraint_violation(spec, st.positions)) <= 1e-4
    np.testing.assert_allclose(states["onehot"].positions.numpy(),
                               states["rolled"].positions.numpy(), rtol=0, atol=1e-5)


def test_composite_spec_with_water_under_the_rolled_layout(systems):
    """A solvated solute: the solute's X-H bonds in the roll layout beside
    the exact water block, as JAX's default builds it; SHAKE, RATTLE,
    counts and violations against JAX's composite spec."""
    from pmarlo_tpu.md import constraints as JC

    js, x, ts = systems("solvated_alanine")
    jspec = JC.build_h_constraints(js)
    spec = TC.build_h_constraints(ts, layout="rolled")
    assert isinstance(spec, TC.CompositeConstraintSpec)
    assert isinstance(spec.protein, TC.RolledConstraintSpec)
    assert spec.protein.deltas == jspec.protein.deltas
    assert spec.protein.d_idx == jspec.protein.d_idx
    np.testing.assert_array_equal(spec.protein.mask.numpy(), np.asarray(jspec.protein.mask))
    assert (spec.water.start, spec.water.n_waters) == (jspec.water.start, jspec.water.n_waters)
    assert TC.n_constraints(spec) == spec.n_constraints == JC.n_constraints(jspec)
    x_new = _offsets(x, 45, 0.003)
    xs = TC.shake(spec, torch.from_numpy(x_new), torch.from_numpy(x))
    jxs = JC.shake(jspec, jnp.asarray(x_new), jnp.asarray(x))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0, atol=1e-6)
    v = np.random.default_rng(46).normal(0.0, 1.0, x.shape).astype(np.float32)
    vs = TC.rattle(spec, torch.from_numpy(v), xs)
    jvs = JC.rattle(jspec, jnp.asarray(v), jnp.asarray(xs.numpy()))
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=0, atol=3e-6)
    assert float(TC.constraint_violation(spec, xs)) == pytest.approx(
        float(JC.constraint_violation(jspec, jnp.asarray(xs.numpy()))), abs=1e-7)
    moved = dataclasses.replace(spec.protein).to("cpu")
    assert torch.equal(moved.indexed.idx2, spec.protein.indexed.idx2)


def test_constrained_steps_in_the_rolled_layout_match_jax(systems):
    """10 constrained friction-0 steps through the roll layout on both
    sides (JAX's step jitted), from the same positions and velocities."""
    from pmarlo_tpu.md import constraints as JC
    from pmarlo_tpu.md.integrate import MDState as JState
    from pmarlo_tpu.md.integrate import langevin_step as jax_step

    from pmarlo_tpu_torch.md.integrate import make_force_fn

    js, x, ts = systems("alanine")
    jspec = JC.build_h_constraints(js, layout="rolled")
    spec = TC.build_h_constraints(ts, layout="rolled")
    x0 = np.asarray(JC.shake(jspec, jnp.asarray(x), jnp.asarray(x)))
    v0 = np.random.default_rng(47).normal(0.0, 0.3, x.shape).astype(np.float32)
    v0 = np.asarray(JC.rattle(jspec, jnp.asarray(v0), jnp.asarray(x0)))
    step = jax.jit(lambda s: jax_step(js, s, dt=0.002, friction=0.0, temperature_K=300.0,
                                      constraints=jspec))
    jst = JState(positions=jnp.asarray(x0), velocities=jnp.asarray(v0),
                 key=jax.random.PRNGKey(0), step=jnp.int32(0))
    st = MDState(positions=torch.from_numpy(x0), velocities=torch.from_numpy(v0),
                 seeds=torch.zeros((), dtype=torch.int32))
    force_fn = make_force_fn(ts, analytic=False)
    for _ in range(10):
        jst, _ = step(jst)
        st, _ = langevin_step(ts, st, dt=0.002, friction=0.0, temperature_K=300.0,
                              force_fn=force_fn, constraints=spec)
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(jst.positions), rtol=0, atol=1e-5)
